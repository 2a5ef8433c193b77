"""Quantized gradient collectives: block-scaled int8/int4/fp8 psum over dp.

Port of ``paddle_tpu/distributed/quant_collectives.py`` (EQuARX-style,
arxiv 2506.17615). Per leaf: flatten and pad to blocks of ``block``; each
block's amax MAX-reduced over the group into one shared scale; ``x /
scale`` rounded onto the narrow grid (int8 +-127, int4 +-7: stochastic
rounding by default, else to nearest even; fp8: an e4m3 cast); the grid
values summed exactly (int32 for int8/int4, f32 for fp8); times the scale
(and 1/N for a mean). ``mode='bf16'`` all-gathers the bf16 cast and sums
it in f32, rounding once (the reference's psum of a bf16 array). The byte
accounting is the reference's analytic ring all-reduce.

Stochastic rounding draws its uniforms from a ``torch.Generator`` seeded
with the leaf's u32 seed mixed with this rank's position in the group
(``mix_seed``): unbiased as the reference's, but not the reference's
``jax.random`` stream (ROADMAP "Known, deliberate differences").
"""
import math

import torch

from .collective import gather_tensor, reduce_tensor

DEFAULT_MIN_SIZE = 2048
DEFAULT_BLOCK = 256

_MODES = ('none', 'bf16', 'int8', 'int4', 'fp8')

# narrow-grid parameters: (quantized max magnitude, payload bytes/element)
_QMAX = {'int8': 127.0, 'int4': 7.0, 'fp8': 448.0}
_PAYLOAD_BYTES = {'int8': 1.0, 'int4': 0.5, 'fp8': 1.0}
_SCALE_BYTES = 2.0          # per-block scale travels as bf16
_M32 = 0xFFFFFFFF


def _check_mode(mode):
    if mode not in _MODES:
        raise ValueError(f'quantized-collective mode must be one of '
                         f'{_MODES}, got {mode!r}')
    return mode


def _blocked(x, block):
    """flatten + zero-pad to [n_blocks, block]."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(nb, block), n


def _uniform(shape, seed, rank, device):
    """U[0, 1) draws for stochastic rounding: the u32 ``seed`` folded with
    the rank, one generator per call."""
    from ..ops.flash_attention import mix_seed
    s = int(mix_seed((int(seed) + rank * 0x9E3779B9) & _M32))
    g = torch.Generator(device=device).manual_seed(s)
    return torch.rand(shape, generator=g, device=device)


def quantized_psum(x, grp, *, mode='int8', block=DEFAULT_BLOCK, seed=None,
                   stochastic=True, mean=False):
    """psum/pmean of ``x`` over the ``Group`` ``grp`` through the quantized
    wire. ``seed``: the u32 driving stochastic rounding (needed with
    ``stochastic`` in int8/int4)."""
    _check_mode(mode)
    if mode in ('int8', 'int4') and stochastic and seed is None:
        raise ValueError('stochastic rounding needs a seed (pass seed=, '
                         'or stochastic=False)')
    n = 1 if grp is None else grp.nranks
    orig = x.dtype
    if mode == 'none':
        out = reduce_tensor(x, grp, 'sum')
        return (out / torch.tensor(n, dtype=orig)) if mean else out
    if mode == 'bf16':
        # the bf16 payload crosses the wire; the sum is taken in f32 and
        # rounded to bf16 once, as the reference's psum of a bf16 array
        wire = gather_tensor(x.to(torch.bfloat16), grp)
        out = wire.float().sum(0).to(torch.bfloat16).float()
        if mean:
            out = out / n
        return out.to(orig)

    xb, size = _blocked(x.float(), block)
    amax = xb.abs().amax(dim=1, keepdim=True)
    # the shared per-block scale: every rank rounds onto one grid, so the
    # sum of grid values is exact
    amax = reduce_tensor(amax, grp, 'max')
    qmax = _QMAX[mode]
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    y = xb / scale
    if mode == 'fp8':
        q = y.to(torch.float8_e4m3fn).float()
        total = reduce_tensor(q, grp, 'sum')
    else:
        if stochastic:
            rank = 0 if grp is None else grp.index
            q = torch.floor(y + _uniform(y.shape, seed, rank, y.device))
        else:
            q = torch.round(y)
        q = torch.clamp(q, -qmax, qmax)
        total = reduce_tensor(q.to(torch.int32), grp, 'sum')
    out = total.float() * scale
    if mean:
        out = out / n
    return out.reshape(-1)[:size].reshape(x.shape).to(orig)


def psum_tree(tree, grp, *, mode='int8', block=DEFAULT_BLOCK, seed=None,
              stochastic=True, mean=True, min_size=DEFAULT_MIN_SIZE):
    """Quantized psum/pmean over a gradient tree (dicts of tensors, leaves
    in sorted-key order as ``jax.tree_util`` flattens a dict). Leaves
    smaller than ``min_size`` take the exact full-width reduction (bf16
    mode casts every leaf); each leaf folds its index into the seed."""
    from ..parallel.partitioner import tree_leaves, tree_rebuild
    _check_mode(mode)
    out = []
    for i, g in enumerate(tree_leaves(tree)):
        leaf_mode = mode if (mode == 'bf16' or g.numel() >= min_size) \
            else 'none'
        leaf_seed = None
        if seed is not None:
            leaf_seed = (int(seed) & _M32) ^ ((i * 0x9E3779B9) & _M32)
        out.append(quantized_psum(g, grp, mode=leaf_mode, block=block,
                                  seed=leaf_seed, stochastic=stochastic,
                                  mean=mean))
    return tree_rebuild(tree, out)


# ---------------------------------------------------------------------------
# analytic wire-byte accounting (ring all-reduce)
# ---------------------------------------------------------------------------

def _ring_factor(n_ranks):
    # reduce-scatter + all-gather: each element crosses the wire
    # 2(n-1)/n times per rank
    return 2.0 * (n_ranks - 1) / n_ranks if n_ranks > 1 else 0.0


def leaf_bytes(size, itemsize, mode, n_ranks, block=DEFAULT_BLOCK,
               min_size=DEFAULT_MIN_SIZE):
    """Wire bytes one leaf contributes to a ring all-reduce over
    ``n_ranks`` in ``mode`` ('f32'/'bf16' = plain cast; int8/int4/fp8 =
    payload + per-block bf16 scales + the f32 amax exchange)."""
    rf = _ring_factor(n_ranks)
    if mode in ('none', 'f32'):
        return rf * size * itemsize
    if mode == 'bf16':
        return rf * size * 2.0
    if size < min_size:
        return rf * size * itemsize      # small leaves stay full width
    nb = math.ceil(size / block)
    payload = rf * size * _PAYLOAD_BYTES[mode]
    scales = rf * nb * _SCALE_BYTES
    amax_exchange = rf * nb * 4.0        # f32 MAX establishing the grid
    return payload + scales + amax_exchange


def _size_itemsize(g):
    if torch.is_tensor(g):
        return g.numel(), g.element_size()
    size = int(math.prod(getattr(g, 'shape', ())))
    return size, getattr(getattr(g, 'dtype', None), 'itemsize', 4)


def collective_bytes(tree, n_ranks, mode='int8', block=DEFAULT_BLOCK,
                     min_size=DEFAULT_MIN_SIZE):
    """Total analytic wire bytes for one gradient all-reduce of ``tree``
    (tensors or numpy arrays)."""
    from ..parallel.partitioner import tree_leaves
    total = 0.0
    for g in tree_leaves(tree):
        size, itemsize = _size_itemsize(g)
        total += leaf_bytes(size, itemsize, mode, n_ranks, block, min_size)
    return total


def bytes_report(tree, n_ranks, modes=('f32', 'bf16', 'int8', 'int4'),
                 block=DEFAULT_BLOCK, min_size=DEFAULT_MIN_SIZE):
    """{mode: wire_bytes} + reduction ratios vs f32 and bf16."""
    out = {m: collective_bytes(tree, n_ranks, m, block, min_size)
           for m in modes}
    rep = {f'bytes_{m}': v for m, v in out.items()}
    for m in modes:
        if m in ('f32', 'bf16'):
            continue
        if out.get('f32'):
            rep[f'reduction_{m}_vs_f32'] = round(out['f32'] / out[m], 3)
        if out.get('bf16'):
            rep[f'reduction_{m}_vs_bf16'] = round(out['bf16'] / out[m], 3)
    return rep
