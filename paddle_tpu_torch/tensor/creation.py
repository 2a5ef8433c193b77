"""Creation ops. Port of ``paddle_tpu/tensor/creation.py``. New tensors
are made on the current device (``set_device``; the card by default),
``*_like`` ones beside their input."""
import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.dispatch import apply_op, op, promote, to_float
from ..core.tensor import Tensor, to_tensor, wrap
from ..device import current_device
from .manipulation import _static_shape as _shape


def _dt(dtype, default='float32'):
    return dtypes.convert_dtype(dtype if dtype is not None else default)


def _v(x):
    return x.item() if isinstance(x, Tensor) else x


def ones(shape, dtype=None, name=None):
    return wrap(torch.ones(_shape(shape), dtype=_dt(dtype),
                           device=current_device()))


def zeros(shape, dtype=None, name=None):
    return wrap(torch.zeros(_shape(shape), dtype=_dt(dtype),
                            device=current_device()))


def full(shape, fill_value, dtype=None, name=None):
    return wrap(torch.full(_shape(shape), _v(fill_value), dtype=_dt(dtype),
                           device=current_device()))


@op
def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=dtypes.convert_dtype(dtype))


@op
def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=dtypes.convert_dtype(dtype))


@op
def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, fill_value, dtype=dtypes.convert_dtype(dtype))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _v(start), _v(end), _v(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ('int64' if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step)) else 'float32')
    return wrap(torch.arange(start, end, step, dtype=_dt(dtype),
                             device=current_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return wrap(torch.linspace(_v(start), _v(stop), int(_v(num)),
                               dtype=_dt(dtype), device=current_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return wrap(torch.logspace(_v(start), _v(stop), int(_v(num)),
                               base=_v(base), dtype=_dt(dtype),
                               device=current_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return wrap(torch.eye(num_rows, num_columns if num_columns is not None
                          else num_rows, dtype=_dt(dtype),
                          device=current_device()))


@op
def diag(x, offset=0, padding_value=0, name=None):
    if x.dim() == 1 and padding_value != 0:
        n = x.shape[0] + abs(offset)
        base = torch.full((n, n), padding_value, dtype=x.dtype,
                          device=x.device)
        on = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        return torch.where(on, torch.diag(x, offset), base)
    return torch.diag(x, offset)


@op
def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


@op
def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


@op
def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return apply_op(lambda xs: list(torch.meshgrid(*xs, indexing='ij')),
                    list(args))


@op
def kron(x, y, name=None):
    return torch.kron(x, y)


@op
def complex(real, imag, name=None):
    real, imag = promote(real, imag)
    return torch.complex(to_float(real), to_float(imag))


def assign(x, output=None):
    if isinstance(x, Tensor):
        return x.clone()
    return to_tensor(x)


def clone(x, name=None):
    return x.clone()


def tolist(x):
    return x.tolist()


__all__ = [_n for _n, _f in list(globals().items())
           if not _n.startswith('_') and callable(_f)
           and getattr(_f, '__module__', None) == __name__]
