"""Op dispatch. Port of ``paddle_tpu/core/dispatch.py``.

Every public op body is a plain function over torch tensors. ``op`` /
``apply_op`` unwrap the Tensor arguments (at top level, in keyword
arguments and inside lists/tuples), call the body and wrap what it
returns. They record no tape: torch's autograd records the graph when an
input requires grad and grad mode is on (``no_grad`` is torch's, so it is
thread-local).

Results never carry a 64-bit dtype: the reference runs with 64-bit types
off, so an int64 from torch (``argmax``, ``sum`` of ints, ``bool + 1``)
comes back as int32 (``core/dtype.py``).

``promote`` gives two operands the reference's dtype: Python scalars are
weakly typed (``int32 tensor * 1.5`` is float32, ``float16 tensor * 2.0``
float16), and two tensors of different dtypes meet at
``torch.promote_types`` whatever their ranks (torch's own rule would keep
``float16 * float32 0-d`` in float16; JAX gives float32).

``op`` calls ``amp_cast_hook`` (installed by ``amp/__init__.py``) with
the body's name and its unwrapped positional arguments before the body, as
the reference does (``paddle_tpu/core/dispatch.py:140-153``).

Left out (ROADMAP Queue 1): the static replay stamping (item 12).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import dtype as dtypes
from .tensor import Tensor, _host_to_torch, wrap

_CANON = dtypes._CANON64
_SCALARS = (bool, int, float, complex)


def _unwrap(x):
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(o) for o in x)
    if isinstance(x, dict):
        return {k: _unwrap(v) for k, v in x.items()}
    return x


def wrap_out(out):
    """Tensors over a body's result (a torch tensor, or a list/tuple of
    them); 64-bit results canonicalized; anything else as it is."""
    if isinstance(out, torch.Tensor):
        c = _CANON.get(out.dtype)
        return wrap(out if c is None else out.to(c))
    if isinstance(out, (list, tuple)):
        return type(out)(wrap_out(o) for o in out)
    return out


def apply_op(pure_fn, *args, **kwargs):
    """Run ``pure_fn`` on the unwrapped arguments and wrap its result."""
    return wrap_out(pure_fn(*_unwrap(args),
                            **{k: _unwrap(v) for k, v in kwargs.items()}))


# amp/__init__.py installs a hook here that casts white-listed op inputs
amp_cast_hook = None


def op(pure_fn):
    """Decorator: expose a plain function over torch tensors as an eager
    op over Tensors (its ``name=`` argument is Paddle's, and ignored)."""
    name = pure_fn.__name__

    @functools.wraps(pure_fn)
    def wrapper(*args, **kwargs):
        kwargs.pop('name', None)
        args = [_unwrap(a) for a in args]
        if amp_cast_hook is not None:
            args = amp_cast_hook(name, args)
        return wrap_out(pure_fn(*args,
                                **{k: _unwrap(v) for k, v in kwargs.items()}))
    wrapper.pure = pure_fn
    return wrapper


# ---- operands -----------------------------------------------------------

def as_tensor(x, like=None):
    """``x`` as a torch tensor on ``like``'s device (else the current
    device): tensors pass as they are; host data is copied, 64-bit types
    canonicalized."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        device = like.device
    else:
        from ..device import current_device
        device = current_device()
    return _host_to_torch(x, device=device)


def scalar_tensor(s, like):
    """A Python scalar as a 0-d tensor of the dtype it takes beside
    ``like`` (weak typing: the scalar adopts the tensor's kind where it
    can)."""
    return torch.full((), s, dtype=dtypes.canonical(torch.result_type(like, s)),
                      device=like.device)


def promote(x, y, scalar_ok=False):
    """Both operands as tensors of one dtype, by the reference's rule.
    With ``scalar_ok`` a Python scalar second operand stays a scalar (for
    torch functions that take one, weakly typed)."""
    xt, yt = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
    if not xt:
        if yt and isinstance(x, _SCALARS):
            x = scalar_tensor(x, y)
        else:
            x = as_tensor(x, y if yt else None)
    if not yt:
        if isinstance(y, _SCALARS):
            if scalar_ok:
                return x, y
            y = scalar_tensor(y, x)
        else:
            y = as_tensor(y, x)
    if x.dtype != y.dtype:
        dt = dtypes.canonical(torch.promote_types(x.dtype, y.dtype))
        x, y = x.to(dt), y.to(dt)
    return x, y


def promote_all(xs):
    """A list of operands as tensors of one dtype (concat, stack, einsum)."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    like = ts[0] if ts else None
    xs = [as_tensor(x, like) for x in xs]
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    dt = dtypes.canonical(dt)
    return [x if x.dtype == dt else x.to(dt) for x in xs]


def to_float(x):
    """Integer and bool inputs as float32 (JAX's rule for ops defined on
    floats only); floating and complex inputs as they are."""
    return x if dtypes.is_floating(x.dtype) else x.to(torch.float32)


def index_tensor(idx, like):
    """An index operand as an int64 tensor on ``like``'s device (torch's
    indexing wants int64; the reference's indices are int32)."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=like.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                           device=like.device)
