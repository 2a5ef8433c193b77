"""Weight initializers. Port of ``paddle_tpu/nn/initializer.py``.

An initializer is called with (shape, dtype) and returns a new torch
tensor on the current device (``paddle.set_device``). Random ones draw
from the port's generator of that device (``tensor/random.py``), which
``paddle.seed`` seeds, so their values differ from the reference's
threefry draws (ROADMAP Known differences); fans, bounds and the
deterministic initializers (``Constant``, ``Assign``, ``Bilinear``) are
the reference's exactly.
"""
import math

import numpy as np
import torch

from ..device import current_device
from ..tensor.random import generator


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: paddle uses [out_c, in_c, *spatial]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _normal(shape, dtype):
    dev = current_device()
    return torch.randn(tuple(shape), generator=generator(dev),
                       dtype=torch.float32, device=dev).to(dtype)


def _uniform(shape, dtype, low, high):
    dev = current_device()
    u = torch.rand(tuple(shape), generator=generator(dev),
                   dtype=torch.float32, device=dev)
    return (low + (high - low) * u).to(dtype)


class Initializer:
    def __call__(self, shape, dtype=torch.float32):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=current_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32):
        return (self.mean + self.std * _normal(shape, torch.float32)).to(
            dtype)


class TruncatedNormal(Initializer):
    """A standard normal truncated to [-2, 2] (the reference's bounds),
    drawn by the inverse CDF, then scaled and shifted."""

    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32):
        lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2., 2.))
        u = _uniform(shape, torch.float32, 2 * lo - 1, 2 * hi - 1)
        z = (math.sqrt(2) * torch.erfinv(u)).clamp(-2.0, 2.0)
        return (self.mean + self.std * z).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32):
        return _uniform(shape, dtype, self.low, self.high)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def std(self, shape):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return math.sqrt(2.0 / (fi + fo))

    def __call__(self, shape, dtype=torch.float32):
        return (self.std(shape) * _normal(shape, torch.float32)).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def limit(self, shape):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return math.sqrt(6.0 / (fi + fo))

    def __call__(self, shape, dtype=torch.float32):
        lim = self.limit(shape)
        return _uniform(shape, dtype, -lim, lim)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity='relu'):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def std(self, shape):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return gain / math.sqrt(fi)

    def __call__(self, shape, dtype=torch.float32):
        return (self.std(shape) * _normal(shape, torch.float32)).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity='relu'):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def limit(self, shape):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return gain * math.sqrt(3.0 / fi)

    def __call__(self, shape, dtype=torch.float32):
        lim = self.limit(shape)
        return _uniform(shape, dtype, -lim, lim)


class Bilinear(Initializer):
    """Bilinear-interpolation kernel for transposed-conv upsampling: every
    (out_c, in_c) slice gets the same (K, K) interpolation kernel."""

    def __call__(self, shape, dtype=torch.float32):
        shape = tuple(int(d) for d in shape)
        if len(shape) != 4:
            raise ValueError('Bilinear initializer needs a 4-D conv '
                             f'kernel shape, got {shape}')
        if shape[2] != shape[3]:
            raise ValueError('Bilinear initializer needs square kernels '
                             f'(shape[2] == shape[3]), got {shape}')
        size = shape[3]
        f = math.ceil(size / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        k = 1 - np.abs(np.arange(size) / f - c)
        filt = torch.from_numpy(np.outer(k, k).astype('float32'))
        return filt.to(device=current_device(), dtype=dtype).expand(
            shape).contiguous()


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype=torch.float32):
        from ..core.tensor import Tensor, _host_to_torch
        v = self.value
        if isinstance(v, Tensor):
            v = v._value
        if isinstance(v, torch.Tensor):
            v = v.detach().to(device=current_device())
        else:
            v = _host_to_torch(v, device=current_device())
        return v.to(dtype).reshape(tuple(shape)).clone()


def _orthogonal(shape, dtype, gain):
    """jax.nn.initializers.orthogonal's construction (column axis -1): the
    Q of a normal matrix's QR, signs fixed by R's diagonal, transposed
    when the matrix is wide."""
    shape = tuple(shape)
    n_cols = shape[-1]
    n_rows = int(np.prod(shape)) // n_cols
    wide = n_rows < n_cols
    a = _normal((n_cols, n_rows) if wide else (n_rows, n_cols),
                torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if wide:
        q = q.T
    return (gain * q.reshape(shape)).to(dtype)


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype=torch.float32):
        return _orthogonal(shape, dtype, self.gain)


class Dirac(Initializer):
    """jax.nn.initializers.delta_orthogonal, as the reference calls it:
    zeros but the centre of the leading (spatial, in that layout) dims,
    which holds an orthogonal [shape[-2], shape[-1]] matrix."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype=torch.float32):
        shape = tuple(int(d) for d in shape)
        if len(shape) not in (3, 4, 5):
            raise ValueError('Dirac initializer needs a 3-, 4- or 5-D '
                             f'shape, got {shape}')
        if shape[-2] > shape[-1]:
            raise ValueError('`fan_in` must be less or equal than '
                             '`fan_out`.')
        w = torch.zeros(shape, dtype=dtype, device=current_device())
        centre = tuple((k - 1) // 2 for k in shape[:-2])
        w[centre] = _orthogonal(shape[-2:], dtype, 1.0)
        return w


def set_global_initializer(weight_init, bias_init=None):
    """Every parameter made after this call takes these initializers
    unless its ParamAttr names one; ``set_global_initializer(None)``
    restores the defaults. Read by ``Layer.create_parameter``."""
    set_global_initializer.weight = weight_init
    set_global_initializer.bias = bias_init
