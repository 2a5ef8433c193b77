"""Activation layers. Port of ``paddle_tpu/nn/layer_activation.py``."""
from .layer_base import Layer
from . import functional as F
from . import initializer as I


def _make(name, fn, **defaults):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            kwargs.pop('name', None)
            merged = dict(defaults)
            keys = list(defaults.keys())
            for i, a in enumerate(args):
                merged[keys[i]] = a
            merged.update(kwargs)
            self._kw = merged

        def forward(self, x):
            return fn(x, **self._kw)
    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


CELU = _make('CELU', F.celu, alpha=1.0)
ELU = _make('ELU', F.elu, alpha=1.0)
GELU = _make('GELU', F.gelu, approximate=False)
Hardshrink = _make('Hardshrink', F.hardshrink, threshold=0.5)
Hardswish = _make('Hardswish', F.hardswish)
Hardtanh = _make('Hardtanh', F.hardtanh, min=-1.0, max=1.0)
Hardsigmoid = _make('Hardsigmoid', F.hardsigmoid)
LeakyReLU = _make('LeakyReLU', F.leaky_relu, negative_slope=0.01)
LogSigmoid = _make('LogSigmoid', F.log_sigmoid)
LogSoftmax = _make('LogSoftmax', F.log_softmax, axis=-1)
Maxout = _make('Maxout', F.maxout, groups=2, axis=1)
Mish = _make('Mish', F.mish)
ReLU = _make('ReLU', F.relu)
ReLU6 = _make('ReLU6', F.relu6)
SELU = _make('SELU', F.selu)
Sigmoid = _make('Sigmoid', F.sigmoid)
Silu = _make('Silu', F.silu)
Softmax = _make('Softmax', F.softmax, axis=-1)
Softplus = _make('Softplus', F.softplus, beta=1, threshold=20)
Softshrink = _make('Softshrink', F.softshrink, threshold=0.5)
Softsign = _make('Softsign', F.softsign)
Swish = _make('Swish', F.swish)
Tanh = _make('Tanh', F.tanh)
Tanhshrink = _make('Tanhshrink', F.tanhshrink)
ThresholdedReLU = _make('ThresholdedReLU', F.thresholded_relu, threshold=1.0)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format='NCHW', name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), weight_attr, default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=1. / 8., upper=1. / 3., name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)
