"""Math ops. Port of ``paddle_tpu/tensor/math.py``: each body is the
reference's jnp expression in torch ops, with the reference's dtype rules
(``core/dispatch.promote``)."""
import sys

import torch

from ..core import dtype as dtypes
from ..core.dispatch import op, promote, to_float

_mod = sys.modules[__name__]


def _frac(x):
    return x - torch.trunc(x)


def _rsqrt(x):
    return torch.rsqrt(to_float(x))


def _keep_bool(fn):
    """``fn`` where bool inputs pass through unchanged (``jnp.abs``,
    ``ceil``, ``floor`` and ``trunc`` of a bool are that bool)."""
    return lambda x: x if x.dtype == torch.bool else fn(x)


def _sign(x):
    """``jnp.sign``: NaN and -0.0 stay as they are (``torch.sgn`` gives
    0 at NaN); complex x / |x|."""
    if x.is_complex() or not dtypes.is_floating(x.dtype):
        return torch.sgn(x)
    return torch.where(torch.isnan(x) | (x == 0), x, torch.sign(x))


def _digamma(x):
    """``jax.scipy.special.digamma``: NaN at 0 and the negative integers,
    where torch gives +-inf at zero."""
    x = to_float(x)
    pole = (x <= 0) & (x == torch.floor(x))
    return torch.where(pole, float('nan'), torch.digamma(x))


def _angle(x):
    """``jnp.angle``: atan2(0, x) for real x, so ``angle(-0.0)`` is pi."""
    if x.is_complex():
        return torch.angle(x)
    x = to_float(x)
    return torch.atan2(torch.zeros_like(x), x)


# ---- table-generated unary ops --------------------------------------------
_UNARY = {
    'abs': _keep_bool(torch.abs), 'acos': torch.acos, 'asin': torch.asin,
    'atan': torch.atan, 'acosh': torch.acosh, 'asinh': torch.asinh,
    'atanh': torch.atanh, 'ceil': _keep_bool(torch.ceil), 'cos': torch.cos,
    'cosh': torch.cosh, 'exp': torch.exp, 'expm1': torch.expm1,
    'floor': _keep_bool(torch.floor), 'log': torch.log, 'log2': torch.log2,
    'log10': torch.log10, 'log1p': torch.log1p, 'neg': torch.neg,
    'reciprocal': torch.reciprocal, 'round': torch.round, 'rsqrt': _rsqrt,
    'sign': _sign, 'sin': torch.sin, 'sinh': torch.sinh,
    'sqrt': torch.sqrt, 'square': torch.square, 'tan': torch.tan,
    'tanh': torch.tanh, 'erf': torch.erf, 'erfinv': torch.erfinv,
    'digamma': _digamma, 'lgamma': torch.lgamma, 'angle': _angle,
    'conj': torch.conj_physical, 'trunc': _keep_bool(torch.trunc),
    'frac': _frac,
}
for _name, _fn in _UNARY.items():
    def _make(fn):
        def _f(x, name=None):
            return fn(x)
        return _f
    _f = _make(_fn)
    _f.__name__ = _f.__qualname__ = _name
    setattr(_mod, _name, op(_f))


# ---- table-generated binary ops -------------------------------------------
def _int_divmod(x, y):
    """Integer floor division and modulo with XLA's results at a zero
    divisor (``jnp.floor_divide``: x / 0 is -1 before the floor step;
    ``jnp.mod``: x % 0 is 0) and INT_MIN / -1 wrapping, on every device
    and with no host sync: torch raises on the CPU and leaves the card's
    value undefined. Bool operands count as int32, as in the reference."""
    if x.dtype == torch.bool:
        x, y = x.to(torch.int32), y.to(torch.int32)
    signed = x.dtype.is_signed
    zero = y == 0
    neg1 = (y == -1) if signed else torch.zeros_like(zero)
    safe = torch.where(zero | neg1, torch.ones_like(y), y)
    q = torch.div(x, safe, rounding_mode='trunc')
    if signed:
        q = torch.where(neg1, -x, q)
    ones = -1 if signed else torch.iinfo(x.dtype).max     # all bits set
    q = torch.where(zero, torch.full_like(q, ones), q)
    r = torch.fmod(x, safe)
    if signed:                   # jnp skips the floor step for unsigned
        r_xla = torch.where(zero, x, r)        # XLA's x % 0 is x
        step = (torch.sign(x) != torch.sign(y)) & (r_xla != 0)
        q = torch.where(step, q - 1, q)
    mod = torch.where((r != 0) & ((r < 0) != (safe < 0)), r + safe, r)
    return q, mod


def _floor_divide(x, y):
    if dtypes.is_floating(x.dtype) or x.is_complex():
        return torch.floor_divide(x, y)
    return _int_divmod(x, y)[0]


def _modulo(x, y):
    if dtypes.is_floating(x.dtype) or x.is_complex():
        return torch.remainder(x, y)
    return _int_divmod(x, y)[1]


def _pow(x, y):
    if x.dtype == torch.bool:       # two bools: int32, as the reference
        x = x.to(torch.int32)
        y = y.to(torch.int32) if isinstance(y, torch.Tensor) else y
    return torch.pow(x, y)


# (torch function, takes a Python scalar as its second operand)
_BINARY = {
    'add': (torch.add, True), 'subtract': (torch.sub, True),
    'multiply': (torch.mul, True), 'divide': (torch.true_divide, True),
    'floor_divide': (_floor_divide, False), 'mod': (_modulo, False),
    'remainder': (_modulo, False), 'floor_mod': (_modulo, False),
    'pow': (_pow, True),
    'maximum': (torch.maximum, False), 'minimum': (torch.minimum, False),
    'fmax': (torch.fmax, False), 'fmin': (torch.fmin, False),
    'atan2': (lambda x, y: torch.atan2(to_float(x), to_float(y)), False),
    'logaddexp': (lambda x, y: torch.logaddexp(to_float(x), to_float(y)),
                  False),
    'bitwise_and': (torch.bitwise_and, True),
    'bitwise_or': (torch.bitwise_or, True),
    'bitwise_xor': (torch.bitwise_xor, True),
}
for _name, (_fn, _scalar_ok) in _BINARY.items():
    def _make2(fn, scalar_ok):
        def _f(x, y, name=None):
            return fn(*promote(x, y, scalar_ok))
        return _f
    _f = _make2(_fn, _scalar_ok)
    _f.__name__ = _f.__qualname__ = _name
    setattr(_mod, _name, op(_f))


@op
def bitwise_not(x, name=None):
    return torch.bitwise_not(x)


@op
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act == 'relu':
        out = torch.clamp(out, min=0)
    elif act == 'tanh':
        out = torch.tanh(out)
    return out


@op
def clip(x, min=None, max=None, name=None):
    if min is None and max is None:
        return x.clone()
    return torch.clamp(x, min=min, max=max)


@op
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


@op
def multiplex(inputs, index, name=None):
    stacked = torch.stack(list(inputs), 0)          # [n, batch, ...]
    idx = torch.as_tensor(index, device=stacked.device).reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


def _axes(axis, ndim):
    """Paddle's axis (None, an int or a list) as torch's dim argument."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


@op
def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    return torch.sum(x, dim=_axes(axis, x.dim()), keepdim=keepdim,
                     dtype=dtypes.convert_dtype(dtype))


@op
def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return torch.nansum(x, dim=_axes(axis, x.dim()), keepdim=keepdim,
                        dtype=dtypes.convert_dtype(dtype))


@op
def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    dt = dtypes.convert_dtype(dtype)
    dims = _axes(axis, x.dim())
    dims = sorted((d % x.dim() for d in dims), reverse=True) \
        if isinstance(dims, tuple) else [dims]
    if dt is not None:
        x = x.to(dt)
    if not dims:
        return x.clone()
    for d in dims:
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _amax(x, axis, keepdim):
    return torch.amax(x, dim=_axes(axis, x.dim()), keepdim=keepdim)


def _amin(x, axis, keepdim):
    return torch.amin(x, dim=_axes(axis, x.dim()), keepdim=keepdim)


@op
def max(x, axis=None, keepdim=False, name=None):
    return _amax(x, axis, keepdim)


@op
def min(x, axis=None, keepdim=False, name=None):
    return _amin(x, axis, keepdim)


@op
def amax(x, axis=None, keepdim=False, name=None):
    return _amax(x, axis, keepdim)


@op
def amin(x, axis=None, keepdim=False, name=None):
    return _amin(x, axis, keepdim)


@op
def logsumexp(x, axis=None, keepdim=False, name=None):
    return torch.logsumexp(to_float(x), dim=_axes(axis, x.dim()),
                           keepdim=keepdim)


@op
def cumsum(x, axis=None, dtype=None, name=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return torch.cumsum(x, dim=axis, dtype=dtypes.convert_dtype(dtype))


@op
def cumprod(x, dim=None, dtype=None, name=None):
    if dim is None:
        x = x.reshape(-1)
        dim = 0
    return torch.cumprod(x, dim=dim, dtype=dtypes.convert_dtype(dtype))


def _matmul(x, y):
    """``torch.matmul`` after promotion; integer and bool products as a
    broadcast multiply and sum (cuBLAS has no integer GEMM, the
    reference's matmul takes ints on every device)."""
    x, y = promote(x, y)
    if dtypes.is_floating(x.dtype):
        return torch.matmul(x, y)
    xv, yv = x.dim() == 1, y.dim() == 1
    out = ((x.unsqueeze(0) if xv else x).unsqueeze(-1)
           * (y.unsqueeze(-1) if yv else y).unsqueeze(-3)).sum(-2)
    if xv:
        out = out.squeeze(-2)
    if yv:
        out = out.squeeze(-1)
    return out.to(x.dtype)


@op
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return _matmul(x, y)


@op
def mm(x, y, name=None):
    return _matmul(x, y)


@op
def inner(x, y, name=None):
    return torch.inner(*promote(x, y))


@op
def outer(x, y, name=None):
    x, y = promote(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


@op
def dot(x, y, name=None):
    x, y = promote(x, y)
    return torch.sum(x * y, dim=-1)


@op
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * input + alpha * torch.matmul(*promote(x, y))


@op
def multiply_(x, y):
    return torch.mul(*promote(x, y, True))


@op
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2).sum(-1)


@op
def isfinite(x, name=None):
    return torch.isfinite(x)


@op
def isinf(x, name=None):
    return torch.isinf(x)


@op
def isnan(x, name=None):
    return torch.isnan(x)


@op
def all(x, axis=None, keepdim=False, name=None):
    return torch.all(x.bool(), dim=_axes(axis, x.dim()), keepdim=keepdim)


@op
def any(x, axis=None, keepdim=False, name=None):
    return torch.any(x.bool(), dim=_axes(axis, x.dim()), keepdim=keepdim)


@op
def broadcast_shape_op(x, y):
    return list(torch.broadcast_tensors(*promote(x, y)))


def broadcast_shape(x_shape, y_shape):
    import numpy as np
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@op
def increment(x, value=1.0, name=None):
    return x + value


@op
def lerp(x, y, weight, name=None):
    x, y = promote(x, y)
    return x + weight * (y - x)


@op
def rad2deg(x, name=None):
    return torch.rad2deg(to_float(x))


@op
def deg2rad(x, name=None):
    return torch.deg2rad(to_float(x))


@op
def gcd(x, y, name=None):
    return torch.gcd(*promote(x, y))


@op
def lcm(x, y, name=None):
    return torch.lcm(*promote(x, y))


@op
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    def edge(v):
        if v is None:
            return None
        v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
        if v.dim() == 0:
            shape = list(x.shape)
            shape[axis] = 1
            v = v.expand(shape)
        return v
    return torch.diff(x, n=n, dim=axis, prepend=edge(prepend),
                      append=edge(append))


@op
def heaviside(x, y, name=None):
    return torch.heaviside(*promote(to_float(x), to_float(y)))


@op
def log_(x):
    return torch.log(x)


@op
def sigmoid(x, name=None):
    return torch.sigmoid(to_float(x))


def divide_int_aware(x, y):
    return divide(x, y)  # noqa: F821 (table-generated above)


__all__ = [_n for _n, _f in list(globals().items())
           if not _n.startswith('_') and callable(_f)
           and getattr(_f, '__module__', None) == __name__]
