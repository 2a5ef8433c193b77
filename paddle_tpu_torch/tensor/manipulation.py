"""Shape/layout manipulation ops. Port of ``paddle_tpu/tensor/
manipulation.py``.

Index semantics are the reference's, which are JAX's, on every device
(torch's own raise on the CPU and fire a device-side assert on the card):
- ``gather``/``index_select`` (``jnp.take``), ``take_along_axis`` and
  ``index_sample``: a negative index in range wraps; one out of range
  reads the fill value (NaN for floats, the dtype's minimum for integers,
  True for bool);
- ``gather_nd``, like ``x[idx]`` (``tensor/register.py``): wraps, then
  clamps into range;
- ``scatter``, ``scatter_nd_add``, ``put_along_axis`` (``.at[].set/add``):
  wraps; an update out of range is dropped.
Indices go to torch as int64; results keep the reference's dtypes.
"""
import builtins

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.dispatch import apply_op, index_tensor, op, promote_all
from ..core.tensor import Tensor


def _static_shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, (Tensor, torch.Tensor))
                 else int(s) for s in shape)


# ---- index helpers --------------------------------------------------------

def _wrap_index(idx, n):
    """Negative indices in range wrap (Python's rule)."""
    return torch.where(idx < 0, idx + n, idx)


def _fill_value(dtype):
    if dtype == torch.bool:
        return True
    if dtypes.is_floating(dtype):
        return float('nan')
    return torch.iinfo(dtype).min


def _take_fill(x, idx, axis):
    """``jnp.take(x, idx, axis)`` in its default 'fill' mode: ``idx`` any
    shape (int64), out-of-range positions read the fill value."""
    n = x.shape[axis]
    idx = _wrap_index(idx, n)
    ok = (idx >= 0) & (idx < n)
    safe = torch.where(ok, idx, 0)
    out = torch.index_select(x, axis, safe.reshape(-1))
    out = out.reshape(x.shape[:axis % x.dim()] + idx.shape
                      + x.shape[axis % x.dim() + 1:])
    shape = [1] * out.dim()
    a = axis % x.dim()
    shape[a:a + idx.dim()] = idx.shape
    return torch.where(ok.reshape(shape), out,
                       torch.full((), _fill_value(x.dtype), dtype=x.dtype,
                                  device=x.device))


def _take_along_fill(arr, idx, axis):
    """``jnp.take_along_axis`` in 'fill' mode (broadcasting like it)."""
    n = arr.shape[axis]
    idx = _wrap_index(idx, n)
    ok = (idx >= 0) & (idx < n)
    out = torch.take_along_dim(arr, torch.where(ok, idx, 0), dim=axis)
    return torch.where(ok, out, torch.full((), _fill_value(arr.dtype),
                                           dtype=arr.dtype,
                                           device=arr.device))


def _clamp_index(idx, n):
    """JAX's rule for ``x[idx]`` with integer arrays: wrap, then clamp."""
    return _wrap_index(idx, n).clamp(0, n - 1)


def _flat_scatter(x, comps, updates, how):
    """``x.at[tuple(comps)]`` with ``how`` in set/add/multiply over the
    leading ``len(comps)`` dims, JAX's scatter rule: negative indices wrap,
    an update out of range is dropped (routed to a spare row that is cut
    off after)."""
    k = len(comps)
    lead = x.shape[:k]
    rows = int(np.prod(lead)) if lead else 1
    flat = x.reshape((rows,) + x.shape[k:])
    lin = torch.zeros((), dtype=torch.int64, device=x.device)
    ok = torch.ones((), dtype=torch.bool, device=x.device)
    for c, n in zip(comps, lead):
        c = _wrap_index(c, n)
        ok = ok & (c >= 0) & (c < n)
        lin = lin * n + c.clamp(0, n - 1)
    lin = torch.where(ok, lin, rows)
    spare = torch.cat([flat, flat[:1]], 0) if rows else \
        torch.zeros((1,) + x.shape[k:], dtype=x.dtype, device=x.device)
    upd = torch.as_tensor(updates, device=x.device).to(x.dtype)
    upd = upd.broadcast_to(lin.shape + x.shape[k:])
    if how == 'multiply':
        idx = lin.reshape(lin.shape + (1,) * (x.dim() - k))
        idx = idx.expand(lin.shape + x.shape[k:]).reshape(
            (-1,) + x.shape[k:])
        out = spare.scatter_reduce(0, idx, upd.reshape(idx.shape),
                                   reduce='prod', include_self=True)
    else:
        out = spare.index_put((lin,), upd, accumulate=(how == 'add'))
    return out[:rows].reshape(x.shape)


# ---- ops --------------------------------------------------------------------

@op
def reshape(x, shape, name=None):
    return torch.reshape(x, _static_shape(shape))


reshape_ = reshape


@op
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    nd = x.dim()
    if nd == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % nd, stop_axis % nd)


@op
def transpose(x, perm, name=None):
    return x.permute(*[int(p) for p in perm])


@op
def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


@op
def swapaxes(x, axis1, axis2, name=None):
    return torch.swapaxes(x, axis1, axis2)


@op
def squeeze(x, axis=None, name=None):
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, (list, tuple)):
        axis = tuple(a for a in axis if x.shape[a] == 1)
        return torch.squeeze(x, axis) if axis else x
    return torch.squeeze(x, axis) if x.shape[axis] == 1 else x


squeeze_ = squeeze


@op
def unsqueeze(x, axis, name=None):
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        for a in sorted(axis):
            x = torch.unsqueeze(x, a)
        return x
    return torch.unsqueeze(x, axis)


unsqueeze_ = unsqueeze


def concat(x, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return apply_op(lambda xs: torch.cat(promote_all(xs), dim=axis), list(x))


def stack(x, axis=0, name=None):
    return apply_op(lambda xs: torch.stack(promote_all(xs), dim=axis),
                    list(x))


def split(x, num_or_sections, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = [int(s) for s in num_or_sections]
        n_unknown = builtins_sum(1 for s in sections if s < 0)
        if n_unknown:
            known = builtins_sum(s for s in sections if s >= 0)
            sections = [s if s >= 0 else dim - known for s in sections]
    offsets = np.cumsum([0] + sections).tolist()

    def pure(v):
        return [v.narrow(axis, offsets[i], sections[i])
                for i in range(len(sections))]
    return apply_op(pure, x)


def builtins_sum(it):
    return builtins.sum(it)


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(input, axis=0, name=None):
    return apply_op(lambda v: list(torch.unbind(v, axis)), input)


@op
def tile(x, repeat_times, name=None):
    return torch.tile(x, _static_shape(repeat_times))


@op
def expand(x, shape, name=None):
    shape = _static_shape(shape)
    shape = tuple(x.shape[i - (len(shape) - x.dim())] if s == -1 else s
                  for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


@op
def expand_as(x, y, name=None):
    return torch.broadcast_to(x, y.shape)


@op
def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(x, _static_shape(shape))


def broadcast_tensors(input, name=None):
    return apply_op(lambda xs: list(torch.broadcast_tensors(*xs)),
                    list(input))


@op
def flip(x, axis, name=None):
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(x, tuple(axis))


def reverse(x, axis, name=None):
    return flip(x, axis)


@op
def roll(x, shifts, axis=None, name=None):
    return torch.roll(x, shifts, axis)


@op
def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, k, tuple(axes))


@op
def gather(x, index, axis=0, name=None):
    if isinstance(axis, torch.Tensor):
        axis = int(axis.item())
    return _take_fill(x, index_tensor(index, x).reshape(-1), axis)


@op
def gather_nd(x, index, name=None):
    index = index_tensor(index, x)
    comps = tuple(_clamp_index(index[..., d], x.shape[d])
                  for d in range(index.shape[-1]))
    return x[comps]


@op
def scatter(x, index, updates, overwrite=True, name=None):
    index = index_tensor(index, x).reshape(-1)
    if overwrite:
        return _flat_scatter(x, [index], updates, 'set')
    base = _flat_scatter(x, [index], torch.zeros((), dtype=x.dtype,
                                                 device=x.device), 'set')
    return _flat_scatter(base, [index], updates, 'add')


@op
def scatter_nd_add(x, index, updates, name=None):
    index = index_tensor(index, x)
    comps = [index[..., d] for d in range(index.shape[-1])]
    return _flat_scatter(x, comps, updates, 'add')


def scatter_nd(index, updates, shape, name=None):
    from .creation import zeros
    base = zeros(shape, dtype=updates.dtype if isinstance(updates, Tensor)
                 else 'float32')
    return scatter_nd_add(base, index, updates)


@op
def put_along_axis(arr, indices, values, axis, reduce='assign'):
    indices = index_tensor(indices, arr)
    comps = []
    for d in range(arr.dim()):
        if d == axis % arr.dim():
            comps.append(indices)
        else:
            sh = [1] * arr.dim()
            sh[d] = arr.shape[d]
            comps.append(torch.arange(arr.shape[d],
                                      device=arr.device).reshape(sh))
    comps = list(torch.broadcast_tensors(*comps))
    how = {'add': 'add', 'multiply': 'multiply'}.get(reduce, 'set')
    return _flat_scatter(arr, comps, values, how)


@op
def take_along_axis(arr, indices, axis):
    return _take_along_fill(arr, index_tensor(indices, arr), axis)


@op
def index_select(x, index, axis=0, name=None):
    return _take_fill(x, index_tensor(index, x).reshape(-1), axis)


@op
def index_sample(x, index):
    return _take_along_fill(x, index_tensor(index, x), 1)


@op
def slice(input, axes, starts, ends):
    sl = [builtins.slice(None)] * input.dim()
    for ax, st, en in zip(axes, starts, ends):
        dim = input.shape[ax]
        st = int(st.item()) if isinstance(st, torch.Tensor) else int(st)
        en = int(en.item()) if isinstance(en, torch.Tensor) else int(en)
        if st < 0:
            st += dim
        if en < 0:
            en += dim
        sl[ax] = builtins.slice(st, builtins_min(en, dim))
    return input[tuple(sl)]


def builtins_min(a, b):
    return builtins.min(a, b)


@op
def strided_slice(x, axes, starts, ends, strides, name=None):
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        if sd > 0:
            sl = [builtins.slice(None)] * x.dim()
            sl[ax] = builtins.slice(st, en, sd)
            x = x[tuple(sl)]
        else:           # torch slices take no negative step
            keep = range(*builtins.slice(st, en, sd).indices(x.shape[ax]))
            x = torch.index_select(x, ax, torch.tensor(list(keep),
                                                       dtype=torch.int64,
                                                       device=x.device))
    return x


@op
def unique_consecutive_vals(x):
    return x


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype='int64', name=None):
    """On the host, as the reference's (``np.unique``); the values keep
    x's dtype, the index outputs are int32."""
    from ..core.tensor import to_tensor
    vals = np.unique(x.numpy(), return_index=return_index,
                     return_inverse=return_inverse,
                     return_counts=return_counts, axis=axis)
    if not isinstance(vals, tuple):
        return to_tensor(vals, dtype=x.dtype, place=x.place)
    return tuple(to_tensor(a, dtype=x.dtype if i == 0 else None,
                           place=x.place) for i, a in enumerate(vals))


@op
def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(torch.int64)
    return torch.repeat_interleave(x, repeats, dim=axis)


@op
def as_complex(x, name=None):
    return torch.complex(x[..., 0], x[..., 1])


@op
def as_real(x, name=None):
    return torch.stack([torch.real(x), torch.imag(x)], -1)


@op
def real(x, name=None):
    return torch.real(x).clone()


@op
def imag(x, name=None):
    if not x.is_complex():
        return torch.zeros_like(x)
    return torch.imag(x).clone()


@op
def cast(x, dtype):
    return x.to(dtypes.convert_dtype(dtype))


@op
def crop(x, shape=None, offsets=None, name=None):
    shape = _static_shape(shape)
    offsets = (_static_shape(offsets) if offsets is not None
               else (0,) * len(shape))
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offsets, shape))]


@op
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    size = index_num // nshards
    mask = torch.floor_divide(input, size) == shard_id
    return torch.where(mask, torch.remainder(input, size),
                       torch.full((), ignore_value, dtype=input.dtype,
                                  device=input.device))


def tensordot(x, y, axes=2, name=None):
    def pure(a, b):
        a, b = promote_all([a, b])
        return torch.tensordot(a, b, dims=axes)
    return apply_op(pure, x, y)


__all__ = [_n for _n, _f in list(globals().items())
           if not _n.startswith('_') and callable(_f)
           and getattr(_f, '__module__', None) == __name__]
