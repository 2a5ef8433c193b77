"""Norm layers. Port of ``paddle_tpu/nn/layer_norm_layers.py``.

``SyncBatchNorm`` is ``BatchNorm`` in a single process, as the
reference's eager fallback is (``functional/norm.py``); its
cross-process statistics wait for ROADMAP Queue 1 step K4.
"""
import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from ..device import current_device
from .layer_base import Layer
from . import functional as F
from . import initializer as I


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            (num_features,), weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter((num_features,), bias_attr,
                                          is_bias=True)
        dev = current_device()
        self.register_buffer('_mean', Tensor(torch.zeros(
            (num_features,), dtype=torch.float32, device=dev)))
        self.register_buffer('_variance', Tensor(torch.ones(
            (num_features,), dtype=torch.float32, device=dev)))
        self._mesh_axis = None   # set by SyncBatchNorm

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats,
            mesh_axis=self._mesh_axis)


class BatchNorm(_BatchNormBase):
    """fluid-style BatchNorm (accepts act)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, dtype='float32',
                 data_layout='NCHW', in_place=False, use_global_stats=False,
                 **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act == 'relu':
            return F.relu(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format='NCDHW',
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm whose statistics would be reduced across processes; in
    one process it is BatchNorm (across processes ``batch_norm`` raises,
    ROADMAP Queue 1 step K4)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 name=None, mesh_axis='dp'):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format)
        self._mesh_axis = mesh_axis

    @classmethod
    def convert_sync_batchnorm(cls, layer, mesh_axis='dp'):
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format, mesh_axis=mesh_axis)
            new.weight = layer.weight
            new.bias = layer.bias
            new.register_buffer('_mean', layer._mean)
            new.register_buffer('_variance', layer._variance)
            return new
        for name, sub in list(layer._sub_layers.items()):
            layer._sub_layers[name] = cls.convert_sync_batchnorm(sub,
                                                                 mesh_axis)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape, bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            (num_channels,), weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter((num_channels,), bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.group_norm_fn(x, self._num_groups, self.weight, self.bias,
                               self._epsilon, self._data_format)


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format='NCL',
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                (num_features,), weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter((num_features,), bias_attr,
                                              is_bias=True)

    def forward(self, x):
        return F.instance_norm_fn(x, self.weight, self.bias, self._epsilon)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format='NCDHW',
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format='NCHW', name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """Power-iteration spectral norm of a weight tensor; each forward
    continues the iteration from the stored u and v (buffers drawn from
    the port's generator)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype='float32'):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        normal = I.Normal(0.0, 1.0)
        self.register_buffer('weight_u', Tensor(normal((h,))))
        self.register_buffer('weight_v', Tensor(normal((w,))))

    def forward(self, weight):
        dim, eps, iters = self._dim, self._eps, self._power_iters
        u0 = self.weight_u._value
        v0 = self.weight_v._value

        def pure(wt):
            wmat = torch.movedim(wt, dim, 0)
            wmat = wmat.reshape(wmat.shape[0], -1)
            u, v = u0, v0
            for _ in range(iters):
                v = wmat.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = wmat @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            # u and v are the iteration's state: sigma's gradient flows
            # through wmat only
            u, v = u.detach(), v.detach()
            sigma = u @ wmat @ v
            return wt / sigma, u, v
        out, u_new, v_new = apply_op(pure, weight)
        self.weight_u._replace_value(u_new._value)
        self.weight_v._replace_value(v_new._value)
        return out
