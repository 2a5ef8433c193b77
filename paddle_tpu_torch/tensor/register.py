"""Attach the op library as Tensor methods and Python operators. Port of
``paddle_tpu/tensor/register.py``.

In-place methods (``add_``, ``zero_``, ``x[i] = v``, ...) compute a new
value and rebind the Tensor (``Tensor._replace_value``): no storage
another Tensor may share is written, and a leaf that requires grad can
be updated (torch's own in-place op on one raises). ``x[i] = v`` keeps
the graph, so gradients flow through it to x's earlier value and to v.

Indexing follows JAX's rule for integer arrays on every device: reads
wrap negative indices and clamp the rest into range; writes wrap and drop
what is out of range.
"""
import numpy as np
import torch

from ..core.dispatch import apply_op, as_tensor
from ..core.tensor import Tensor
from . import creation, linalg, logic, manipulation, math, random, search, stat
from .manipulation import _wrap_index


_METHOD_SOURCES = [math, manipulation, logic, linalg, search, stat]

_EXCLUDE = {'shape', 'rank', 'op', 'apply_op', 'Tensor', 'sys', 'np',
            'builtins_sum', 'builtins_min', 'builtins_bool',
            'broadcast_shape'}

_FROM_CREATION = ['ones_like', 'zeros_like', 'full_like', 'diag',
                  'diagflat', 'tril', 'triu', 'tolist']


def install():
    for mod in _METHOD_SOURCES:
        for name in dir(mod):
            if name.startswith('_') or name in _EXCLUDE or name[0].isupper():
                continue
            fn = getattr(mod, name)
            if (callable(fn) and not isinstance(fn, type)
                    and getattr(fn, '__module__', None) == mod.__name__
                    and not hasattr(Tensor, name)):
                setattr(Tensor, name, fn)
    for name in _FROM_CREATION:
        if not hasattr(Tensor, name):
            setattr(Tensor, name, getattr(creation, name))

    from .. import compat_api as _compat
    from . import attribute as _attr, inplace_and_array as _inplace
    _extra_sources = [_compat, _attr, _inplace, creation] + _METHOD_SOURCES
    for name in ('add_n', 'diagonal', 'scatter_', 'unique_consecutive',
                 'unstack', 'kron', 'rank', 'flatten_'):
        fn = next((getattr(m, name) for m in _extra_sources
                   if hasattr(m, name)), None)
        if fn is None:
            raise AttributeError(f'tensor method {name!r} has no source')
        if not hasattr(Tensor, name):
            setattr(Tensor, name, fn)
    # broadcast_shape operates on SHAPES; the method form uses self's
    if not hasattr(Tensor, 'broadcast_shape'):
        Tensor.broadcast_shape = (
            lambda self, y_shape: math.broadcast_shape(self.shape, y_shape))

    # paddle method-only names
    Tensor.astype = lambda self, dtype: manipulation.cast(self, dtype)
    Tensor.cast = Tensor.astype
    Tensor.t = lambda self, name=None: _compat.t(self)
    Tensor.dim = lambda self: self.ndim
    Tensor.numel = lambda self: stat.numel(self)
    Tensor.uniform_ = _inplace.uniform_
    Tensor.normal_ = lambda self, mean=0.0, std=1.0: _set_inplace(
        self, random.normal(mean, std, self.shape))
    Tensor.zero_ = lambda self: _set_inplace(
        self, torch.zeros_like(self._value))
    Tensor.fill_ = lambda self, v: _set_inplace(
        self, torch.full_like(self._value, v))
    Tensor.exponential_ = random.exponential_

    # in-place arithmetic aliases (functional under the hood)
    for nm in ['add', 'subtract', 'multiply', 'divide', 'clip', 'scale',
               'floor', 'ceil', 'round', 'sqrt', 'rsqrt', 'reciprocal',
               'exp', 'tanh']:
        setattr(Tensor, nm + '_', _make_inplace(getattr(math, nm)))

    # operators
    Tensor.__add__ = math.add
    Tensor.__radd__ = lambda s, o: math.add(o, s)
    Tensor.__sub__ = math.subtract
    Tensor.__rsub__ = lambda s, o: math.subtract(o, s)
    Tensor.__mul__ = math.multiply
    Tensor.__rmul__ = lambda s, o: math.multiply(o, s)
    Tensor.__truediv__ = math.divide
    Tensor.__rtruediv__ = lambda s, o: math.divide(o, s)
    Tensor.__floordiv__ = math.floor_divide
    Tensor.__mod__ = math.mod
    Tensor.__pow__ = math.pow
    Tensor.__rpow__ = lambda s, o: math.pow(o, s)
    Tensor.__neg__ = math.neg
    Tensor.__abs__ = math.abs
    Tensor.__matmul__ = math.matmul
    Tensor.__rmatmul__ = lambda s, o: math.matmul(o, s)
    Tensor.__eq__ = logic.equal
    Tensor.__ne__ = logic.not_equal
    Tensor.__lt__ = logic.less_than
    Tensor.__le__ = logic.less_equal
    Tensor.__gt__ = logic.greater_than
    Tensor.__ge__ = logic.greater_equal
    Tensor.__and__ = math.bitwise_and
    Tensor.__or__ = math.bitwise_or
    Tensor.__xor__ = math.bitwise_xor
    Tensor.__invert__ = math.bitwise_not
    Tensor.__getitem__ = _getitem
    Tensor.__setitem__ = _setitem


def _make_inplace(base):
    def f(self, *args, **kwargs):
        return _set_inplace(self, base(self, *args, **kwargs))
    f.__name__ = f.__qualname__ = base.__name__ + '_'
    return f


def _set_inplace(t, new):
    t._replace_value(new)
    return t


def _index(v, item, write):
    """``item`` as a torch index into ``v``, with the dims the caller
    flips first (torch slices take no negative step: such a slice becomes
    a positive one over the flipped dim) and the dims it pads. Integer
    arrays (Tensors, lists, numpy arrays) follow JAX: negative entries
    wrap; for a read the rest clamp into range; for a write an entry out
    of range points one past the end of its dim, at a spare slot the
    caller appends and cuts off after."""
    items = item if isinstance(item, tuple) else (item,)
    conv = []
    for it in items:
        if isinstance(it, Tensor):
            it = it._value
        elif isinstance(it, (list, np.ndarray)):
            it = as_tensor(np.asarray(it), v)
        conv.append(it)

    def dims_of(it):
        if it is None or it is Ellipsis:
            return 0
        if isinstance(it, torch.Tensor) and it.dtype == torch.bool:
            return it.dim()
        return 1

    n_used = sum(dims_of(it) for it in conv)
    d, out, flips, spare = 0, [], [], []
    for it in conv:
        if it is Ellipsis:
            d += v.dim() - n_used
        elif isinstance(it, slice) and it.step is not None and it.step < 0:
            n = v.shape[d]
            r = range(*it.indices(n))
            start = n - 1 - r[0] if r else 0
            it = slice(start, start - it.step * (len(r) - 1) + 1 if r
                       else 0, -it.step)
            flips.append(d)
        elif isinstance(it, torch.Tensor):
            it = it.to(v.device)
            if it.dtype != torch.bool:
                n = v.shape[d]
                it = _wrap_index(it.to(torch.int64), n)
                if write:
                    it = torch.where((it >= 0) & (it < n), it, n)
                    spare.append(d)
                else:
                    it = it.clamp(0, n - 1)
        out.append(it)
        d += dims_of(it)
    return tuple(out), flips, spare


def _getitem(self, item):
    idx, flips, _ = _index(self._value, item, write=False)
    if flips:
        return apply_op(lambda v: v.flip(flips)[idx], self)
    return apply_op(lambda v: v[idx], self)


def _setitem(self, item, value):
    idx, flips, spare = _index(self._value, item, write=True)

    def pure(v, w):
        out = v.flip(flips) if flips else v
        for d in spare:
            out = torch.cat([out, out.narrow(d, 0, 1)], d)
        if out is v:
            out = v.clone()
        out[idx] = w.to(v.dtype)
        for d in spare:
            out = out.narrow(d, 0, v.shape[d])
        return out.flip(flips) if flips else out

    w = value if isinstance(value, Tensor) else as_tensor(value, self._value)
    out = apply_op(pure, self, w)
    if out._value.requires_grad:
        self._value = out._value          # keeps the graph, as the reference
    else:
        self._replace_value(out)
    return self
