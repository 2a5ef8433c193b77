"""Common layers: Linear, Embedding, Dropout, Flatten, Pad, Upsample, etc.
Port of ``paddle_tpu/nn/layer_common.py``."""
import torch

from ..core.dispatch import apply_op
from .layer_base import Layer
from . import functional as F
from . import initializer as I


class Linear(Layer):
    """y = xW + b with W: [in_features, out_features] (Paddle's layout)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features), weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = self.create_parameter((out_features,), bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f'in_features={self.in_features}, '
                f'out_features={self.out_features}')


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            v = self.weight._value.detach().clone()
            v[padding_idx] = 0
            self.weight._replace_value(v)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode='upscale_in_train', name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format='NCHW', name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format='NCDHW', name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from ..tensor.manipulation import flatten
        return flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode='nearest',
                 align_corners=False, align_mode=0, data_format='NCHW',
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format='NCHW',
                 name=None):
        super().__init__(size, scale_factor, 'nearest',
                         data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format='NCHW',
                 name=None):
        super().__init__(size, scale_factor, 'bilinear', True,
                         data_format=data_format)


class Pad1D(Layer):
    def __init__(self, padding, mode='constant', value=0.0,
                 data_format='NCL', name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode='constant', value=0.0,
                 data_format='NCHW', name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode='constant', value=0.0,
                 data_format='NCDHW', name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Layer):
    def __init__(self, padding, data_format='NCHW', name=None):
        super().__init__()
        self.padding, self.data_format = padding, data_format

    def forward(self, x):
        return F.zeropad2d(x, self.padding, self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return apply_op(
            lambda a, b: torch.pow(
                torch.sum(torch.pow(torch.abs(a - b) + self.epsilon, self.p),
                          -1, keepdim=self.keepdim), 1.0 / self.p), x, y)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format='NCHW', name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), weight_attr)
        self.bias = self.create_parameter((out_features,), bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x
