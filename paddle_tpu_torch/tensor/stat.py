"""Statistics ops. Port of ``paddle_tpu/tensor/stat.py``.

Median and quantiles are JAX's 'linear' rule (``jnp.quantile``): sort,
then weigh the two neighbours of ``q * (n - 1)``; torch.median would take
the lower one. The nan variants sort NaN last and count only the finite
rows' length.
"""
import torch

from ..core.dispatch import op, to_float
from .math import _axes


@op
def mean(x, axis=None, keepdim=False, name=None):
    return torch.mean(to_float(x), dim=_axes(axis, x.dim()), keepdim=keepdim)


@op
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(to_float(x), dim=_axes(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@op
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(to_float(x), dim=_axes(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _quantile(x, q, axis, keepdim, ignore_nan):
    """``jnp.(nan)quantile(x, q, axis, keepdims)`` with method 'linear'."""
    x = to_float(x)
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    nd = x.dim()
    if axis is None:
        dims = tuple(range(nd))
    elif isinstance(axis, (list, tuple)):
        dims = tuple(a % nd for a in axis)
    else:
        dims = (axis % nd,)
    keep = [d for d in range(nd) if d not in dims]
    n_red = 1
    for d in dims:
        n_red *= x.shape[d]
    # a 0-d x is one value; sizes spelled out, since -1 is ambiguous when
    # a kept axis is empty
    moved = (x.permute(*keep, *dims) if nd else x).reshape(
        [x.shape[d] for d in keep] + [n_red])
    srt = torch.sort(moved, dim=-1).values          # NaN sorts last
    if ignore_nan:
        n = (~torch.isnan(moved)).sum(-1, keepdim=True)
    else:
        n = torch.full_like(srt[..., :1], srt.shape[-1], dtype=torch.int64)
    qs = q.reshape(-1)
    top = n - 1
    pos = qs.reshape((-1,) + (1,) * srt.dim()) * top.to(x.dtype)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hi_w = pos - lo
    lo_w = 1 - hi_w
    lo_i = torch.minimum(lo.to(torch.int64), top).clamp(min=0)
    hi_i = torch.minimum(hi.to(torch.int64), top).clamp(min=0)
    srt_b = srt.expand((qs.numel(),) + srt.shape)
    val = (torch.gather(srt_b, -1, lo_i) * lo_w
           + torch.gather(srt_b, -1, hi_i) * hi_w)[..., 0]
    if not ignore_nan:        # JAX: a row holding a NaN gives NaN
        val = torch.where(torch.isnan(srt[..., -1]), float('nan'), val)
    if keepdim:
        shape = [1 if d in dims else x.shape[d] for d in range(nd)]
        val = val.reshape((qs.numel(),) + tuple(shape))
    return val.reshape(q.shape + val.shape[1:])


@op
def median(x, axis=None, keepdim=False, name=None):
    return _quantile(x, 0.5, axis, keepdim and axis is not None, False)


@op
def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(x, 0.5, axis, keepdim, True)


@op
def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(x, q, axis, keepdim, False)


@op
def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(x, q, axis, keepdim, True)


@op
def nanmean(x, axis=None, keepdim=False, name=None):
    return torch.nanmean(to_float(x), dim=_axes(axis, x.dim()),
                         keepdim=keepdim)


@op
def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


@op
def mode(x, axis=-1, keepdim=False, name=None):
    """The reference's rule: the value with the most equal entries along
    ``axis`` (a comparison matrix), the first such position on ties."""
    xm = torch.movedim(x, axis, -1)
    counts = torch.sum(xm[..., :, None] == xm[..., None, :], dim=-1)
    idx = torch.argmax(counts, dim=-1)
    vals = torch.take_along_dim(xm, idx[..., None], dim=-1)[..., 0]
    if keepdim:
        vals = torch.unsqueeze(vals, axis)
        idx = torch.unsqueeze(idx, axis)
    return vals, idx.to(torch.int32)


__all__ = [_n for _n, _f in list(globals().items())
           if not _n.startswith('_') and callable(_f)
           and getattr(_f, '__module__', None) == __name__]
