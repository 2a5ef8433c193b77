"""Linear algebra ops. Port of ``paddle_tpu/tensor/linalg.py``.

Decompositions return what the reference returns (``svd``'s third output
is V, not V^H); their signs and order are whatever the solver gives, on
either side, so tests compare reconstructions and invariants. ``lstsq`` is
JAX's own SVD formula (``torch.linalg.lstsq`` on CUDA returns no
residuals, rank or singular values).
"""
import torch

from ..core import dtype as dtypes
from ..core.dispatch import apply_op, op, promote, promote_all, to_float
from .math import _matmul


@op
def transpose_last2(x):
    return x.transpose(-1, -2) if x.dim() >= 2 else x


def _ax(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def _reduce(fn, x, axis, keepdim):
    if axis is None:
        return fn(x) if not keepdim else fn(x, dim=tuple(range(x.dim())),
                                            keepdim=True)
    return fn(x, dim=_ax(axis), keepdim=keepdim)


@op
def norm(x, p='fro', axis=None, keepdim=False, name=None):
    if p == 'fro':
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(x)))
        return torch.sqrt(torch.sum(torch.square(x), dim=_ax(axis),
                                    keepdim=keepdim))
    if p == float('inf'):
        return _reduce(torch.amax, torch.abs(x), axis, keepdim)
    if p == float('-inf'):
        return _reduce(torch.amin, torch.abs(x), axis, keepdim)
    if p == 0:
        return _reduce(torch.sum, (x != 0).to(x.dtype), axis, keepdim)
    return torch.pow(_reduce(torch.sum, torch.pow(torch.abs(x), p), axis,
                             keepdim), 1.0 / p)


@op
def dist(x, y, p=2, name=None):
    d = torch.abs(x - y)
    if p == 0:
        return torch.sum((d != 0).to(x.dtype)).to(x.dtype)
    if p == float('inf'):
        return torch.amax(d)
    if p == float('-inf'):
        return torch.amin(d)
    return torch.pow(torch.sum(torch.pow(d, p)), 1.0 / p)


def _symmetrize(x):
    """``(x + xᴴ) / 2``: ``jnp.linalg``'s Hermitian solvers read both
    triangles this way, where torch's read one."""
    return (x + x.transpose(-1, -2).conj()) / 2


@op
def cond(x, p=None, name=None):
    return torch.linalg.cond(to_float(x), p)


@op
def cholesky(x, upper=False, name=None):
    L = torch.linalg.cholesky(_symmetrize(x))
    return L.transpose(-1, -2).conj() if upper else L


@op
def cholesky_solve(x, y, upper=False, name=None):
    return torch.cholesky_solve(x, y, upper=upper)


@op
def inverse(x, name=None):
    return torch.linalg.inv(x)


@op
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(to_float(x), rtol=rcond, hermitian=hermitian)


@op
def det(x, name=None):
    return torch.linalg.det(x)


@op
def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


@op
def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """JAX's rule: singular values above ``tol`` (an absolute threshold;
    by default max(s) x max(m, n) x eps) count."""
    def pure(v):
        v = to_float(v)
        if v.dim() < 2:
            return (v != 0).any().to(torch.int32)
        if tol is None:
            return torch.linalg.matrix_rank(v)
        return torch.linalg.matrix_rank(v, atol=tol, rtol=0.0)
    return apply_op(pure, x)


@op
def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(to_float(x), full_matrices=full_matrices)
    return u, s, vh.transpose(-1, -2).conj()


@op
def qr(x, mode='reduced', name=None):
    q, r = torch.linalg.qr(to_float(x), mode=mode)
    return r if mode == 'r' else (q, r)


@op
def eig(x, name=None):
    return tuple(torch.linalg.eig(x))


@op
def eigh(x, UPLO='L', name=None):
    return tuple(torch.linalg.eigh(_symmetrize(x), UPLO=UPLO))


@op
def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


@op
def eigvalsh(x, UPLO='L', name=None):
    return torch.linalg.eigvalsh(_symmetrize(x), UPLO=UPLO)


@op
def lstsq(x, y, rcond=None, driver=None, name=None):
    a, b = promote(to_float(x), to_float(y))
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    m, n = a.shape
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(n, m)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum()
    safe_s = torch.where(mask, s, 1).to(a.dtype)
    s_inv = torch.where(mask, 1 / safe_s, 0)[:, None]
    sol = vt.conj().T @ (s_inv * (u.conj().T @ b))
    resid = torch.linalg.vector_norm(b - a @ sol, dim=0) ** 2
    if vec:
        sol = sol.reshape(-1)
    return sol, resid, rank, s


@op
def solve(x, y, name=None):
    return torch.linalg.solve(*promote(x, y))


@op
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a = x.transpose(-1, -2) if transpose else x
    return torch.linalg.solve_triangular(a, y, upper=upper != transpose,
                                         unitriangular=unitriangular)


@op
def cross(x, y, axis=9, name=None):
    if axis == 9:
        axis = next((i for i, s in enumerate(x.shape) if s == 3), -1)
    return torch.linalg.cross(*promote(x, y), dim=axis)


@op
def bmm(x, y, name=None):
    return _matmul(x, y)


@op
def histogram(input, bins=100, min=0, max=0, name=None):
    """``jnp.histogram``'s rule: edges linspace(lo, hi, bins + 1); a value
    equal to hi falls in the last bin; values outside are not counted."""
    x = to_float(input).reshape(-1)
    if min == 0 and max == 0:
        lo, hi = torch.amin(x), torch.amax(x)
    else:
        lo = torch.tensor(float(min), dtype=x.dtype, device=x.device)
        hi = torch.tensor(float(max), dtype=x.dtype, device=x.device)
    flat = lo == hi              # an empty range widens by 0.5 each way
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    steps = torch.arange(bins + 1, dtype=x.dtype, device=x.device)
    edges = lo + (hi - lo) * (steps / bins)
    edges[-1] = hi
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    counts = torch.zeros(bins + 2, dtype=torch.int32, device=x.device)
    counts = counts.index_add(0, idx, torch.ones_like(idx,
                                                      dtype=torch.int32))
    return counts[1:bins + 1]


@op
def bincount(x, weights=None, minlength=0, name=None):
    out = torch.bincount(x.to(torch.int64), weights=weights,
                         minlength=minlength)
    return out if weights is None else out.to(weights.dtype)


@op
def mv(x, vec, name=None):
    return _matmul(x, vec)


@op
def multi_dot(x, name=None):
    return torch.linalg.multi_dot(promote_all(list(x)))


@op
def corrcoef(x, rowvar=True, name=None):
    x = to_float(x)
    return torch.corrcoef(x if rowvar else x.T)


@op
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = to_float(x)
    if fweights is not None:
        fweights = fweights.to(torch.int64)
    out = torch.cov(x if rowvar or x.dim() < 2 else x.T,
                    correction=1 if ddof else 0, fweights=fweights,
                    aweights=aweights)
    return out.to(dtypes.canonical(out.dtype))


# the reference's paddle.linalg exports 'inv' as the canonical name
inv = inverse


__all__ = [_n for _n, _f in list(globals().items())
           if not _n.startswith('_') and callable(_f)
           and getattr(_f, '__module__', None) == __name__]
