"""paddle.nn. Port of ``paddle_tpu/nn/__init__.py``.

The Layer system (``layer_base``), initializers, the activation,
common, norm, loss, attention, conv and pooling functionals and their
layers, containers, the transformer stack, RNNs, decoding, the quantized
layers, the functional extensions, gradient clipping and ``nn.utils``.
"""
from .layer_base import (  # noqa: F401
    Layer, Parameter, ParamAttr, functional_call, param_arrays, buffer_arrays)
from .layer_common import (  # noqa: F401
    AlphaDropout, Bilinear, CosineSimilarity, Dropout, Dropout2D, Dropout3D,
    Embedding, Flatten, Identity, Linear, Pad1D, Pad2D, Pad3D,
    PairwiseDistance, PixelShuffle, Unfold, Upsample, UpsamplingBilinear2D,
    UpsamplingNearest2D, ZeroPad2D)
from .layer_conv import (  # noqa: F401
    Conv1D, Conv2D, Conv3D, Conv1DTranspose, Conv2DTranspose, Conv3DTranspose)
from .layer_norm_layers import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, SpectralNorm, SyncBatchNorm)
from .layer_pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
    AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .layer_activation import (  # noqa: F401
    CELU, ELU, GELU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
    LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, RReLU, SELU,
    Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign, Swish, Tanh,
    Tanhshrink, ThresholdedReLU)
from .layer_loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss, CTCLoss,
    HingeEmbeddingLoss, KLDivLoss, L1Loss, MarginRankingLoss, MSELoss, NLLLoss,
    SmoothL1Loss, TripletMarginLoss)
from .layer_container import (  # noqa: F401
    LayerDict, LayerList, ParameterList, Sequential)
from .layer_rnn import (  # noqa: F401
    BiRNN, GRU, GRUCell, LSTM, LSTMCell, RNN, SimpleRNN, SimpleRNNCell)
from .layer_transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_)
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import utils  # noqa: F401
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: F401
from .layer_rnn import _CellBase as RNNCellBase  # noqa: F401
from . import layer_loss as loss  # noqa: F401
from .utils import spectral_norm, weight_norm, remove_weight_norm  # noqa: F401
from . import quant  # noqa: F401


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid loss over the default tree
    (``functional.hsigmoid_loss``)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None):
        super().__init__()
        self.num_classes = num_classes
        self.weight = self.create_parameter((num_classes - 1, feature_size),
                                            weight_attr)
        self.bias = self.create_parameter((num_classes - 1, 1), bias_attr,
                                          is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return functional.hsigmoid_loss(input, label, self.num_classes,
                                        self.weight, self.bias)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format='NCHW', output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self._args
        return functional.max_unpool2d(x, indices, k, s, p, df, osz)


def deprecated(update_to='', since='', reason=''):
    """Mark an API deprecated: each call warns (DeprecationWarning) and the
    docstring gains the note (``paddle.utils.deprecated``)."""
    import functools
    import warnings

    def decorator(func):
        note = 'Warning: API "{}.{}" is deprecated'.format(
            func.__module__, func.__name__)
        if since:
            note += f' since {since}'
        if update_to:
            note += (', and will be removed in the future. Use '
                     f'"{update_to}" instead')
        if reason:
            note += f'. Reason: {reason}'
        func.__doc__ = note + '\n\n' + (func.__doc__ or '')

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(note, category=DeprecationWarning, stacklevel=2)
            return func(*args, **kwargs)
        return wrapper
    return decorator
