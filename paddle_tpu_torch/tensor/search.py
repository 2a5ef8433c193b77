"""Search/sort ops. Port of ``paddle_tpu/tensor/search.py``.

Order follows the reference's on every device: sorts are stable, and
``topk`` is a stable sort cut to k, so equal values keep their index
order (lower index first), as ``jax.lax.top_k`` does; ``argmax`` /
``argmin`` take the first of equal extremes.
"""
import torch

from ..core.dispatch import apply_op, op, promote
from ..core.tensor import Tensor, to_tensor, wrap


@op
def argmax(x, axis=None, keepdim=False, dtype='int64', name=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    out = torch.argmax(x, dim=axis).to(torch.int32)
    return torch.unsqueeze(out, axis) if keepdim else out


@op
def argmin(x, axis=None, keepdim=False, dtype='int64', name=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    out = torch.argmin(x, dim=axis).to(torch.int32)
    return torch.unsqueeze(out, axis) if keepdim else out


@op
def argsort(x, axis=-1, descending=False, name=None):
    return torch.argsort(x, dim=axis, descending=descending,
                         stable=True).to(torch.int32)


@op
def sort(x, axis=-1, descending=False, name=None):
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, (axis,)) if descending else out


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """Returns (values, indices); the indices carry no gradient, the
    values are gathered from x by them (so they do)."""
    from .manipulation import take_along_axis
    if isinstance(k, Tensor):
        k = int(k.item())
    if not isinstance(x, Tensor):
        x = to_tensor(x)
    v = x._value
    ax = axis if axis >= 0 else v.dim() + axis
    idx = torch.argsort(v.detach(), dim=ax, descending=largest,
                        stable=True).narrow(ax, 0, k)
    idx_t = wrap(idx.to(torch.int32))
    return take_along_axis(x, idx_t, axis=ax), idx_t


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    from .manipulation import squeeze, take_along_axis
    vals, idx = topk(x, k, axis=axis, largest=False)
    ax = axis if axis >= 0 else x.ndim + axis
    pick = [1 if i == ax else s for i, s in enumerate(vals.shape)]
    at = wrap(torch.full(pick, k - 1, dtype=torch.int32,
                         device=vals._value.device))
    sel = take_along_axis(vals, at, axis=ax)
    sel_idx = take_along_axis(idx, at, axis=ax)
    if not keepdim:
        sel, sel_idx = squeeze(sel, ax), squeeze(sel_idx, ax)
    return sel, sel_idx


@op
def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return tuple(i.to(torch.int32) for i in torch.where(condition))
    cond = condition if condition.dtype == torch.bool else condition != 0
    if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
        x, y = promote(x, y)
    return torch.where(cond, x, y)


def nonzero(x, as_tuple=False):
    nz = torch.nonzero(x._value).to(torch.int32)
    if as_tuple:
        return tuple(wrap(nz[:, i:i + 1]) for i in range(nz.shape[1]))
    return wrap(nz)


@op
def masked_select_dense(x, mask):
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


@op
def masked_select(x, mask, name=None):
    return torch.masked_select(x, mask.broadcast_to(x.shape))


@op
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    s, v = promote(sorted_sequence, values)
    if s.dim() > 1:
        s = s.reshape(-1, s.shape[-1])
        out = torch.searchsorted(s.contiguous(),
                                 v.reshape(-1, v.shape[-1]).contiguous(),
                                 right=right).reshape(v.shape)
    else:
        out = torch.searchsorted(s.contiguous(), v.contiguous(), right=right)
    return out.to(torch.int32)


def index_put(x, indices, value, accumulate=False):
    from .manipulation import _flat_scatter

    def pure(v, idx, val):
        comps = [torch.as_tensor(i, device=v.device).to(torch.int64)
                 for i in idx]
        comps = list(torch.broadcast_tensors(*comps))
        return _flat_scatter(v, comps, val, 'add' if accumulate else 'set')
    return apply_op(pure, x, list(indices), value)


__all__ = [_n for _n, _f in list(globals().items())
           if not _n.startswith('_') and callable(_f)
           and getattr(_f, '__module__', None) == __name__]
