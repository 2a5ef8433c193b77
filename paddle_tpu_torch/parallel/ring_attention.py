"""Ring attention: exact causal attention over a sequence-sharded axis.

Port of ``paddle_tpu/parallel/ring_attention.py``. Each rank of the sp
group holds a query block [B, S/sp, H, D]; the K/V blocks rotate around
the ring (``ppermute`` by one position a hop) while the partial results
merge through their log-sum-exp, so attention memory stays O(S/sp) a rank.

``ring_attention`` is the plain ring (scores in f32). ``ring_flash_
attention`` computes every block pair with the flash kernels, in the
forward and the backward:

 - forward: kernel 1 (``ops.flash_attention._flash_fwd``: the card's
   kernel, its twin for a CPU tensor) once a hop, the causal instance on
   the diagonal hop (kv block == q block), the dense one on a past hop,
   nothing on a future hop (causal); each hop returns (out, lse) and the
   running pair merges in f32: lse' = logaddexp(lse, lse_b), out' = out *
   exp(lse - lse') + out_b * exp(lse_b - lse');
 - backward: kernels 2 and 3 (``flash_bwd_dq`` / ``flash_bwd_dkv``, the
   twin ``flash_bwd_reference`` on the CPU) once a hop against the GLOBAL
   lse and delta = rowsum(out * dO) (computed once): each hop's kernels
   then emit exactly that pair's share of dq, dk and dv. k, v and their
   gradient accumulators rotate together, so after sp hops each dk/dv is
   home with every rank's share; GQA kv blocks rotate un-repeated.

Rank i's hop h sees the kv block of rank (i - h) mod sp: under causal
attention rank i launches kernel 1 for hops 0..i (i + 1 launches a
layer) and skips the rest, and the backward launches kernels 2 and 3 as
often. Attention dropout is per (q rank, kv rank) pair (``_pair_seed``), in
the forward and the backward alike; each hop's kernel normalizer sums the
undropped probabilities, so the merge gives dropout(global softmax) @ v.
"""
import math

import torch

from ..distributed.collective import ppermute_tensors, ring_perm
from ..ops import flash_attention as fa


def _group(axis_name, mesh):
    """The sp ``Group``: ``axis_name`` itself, or its group on ``mesh``
    (default: the process topology's mesh)."""
    if not isinstance(axis_name, str):
        return axis_name
    if mesh is None:
        from ..distributed.topology import get_mesh
        mesh = get_mesh()
    return mesh.group(axis_name)


def _rotate(xs, grp):
    """Each tensor to the next rank of the ring (one batch of p2p ops)."""
    if grp is None or grp.nranks == 1:
        return list(xs)
    return ppermute_tensors(list(xs), grp, ring_perm(grp.nranks))


def _mask(idx, kv_rank, s, causal, dev):
    if not causal:
        return torch.zeros((1, 1, s, s), device=dev)
    q_pos = idx * s + torch.arange(s, device=dev)[:, None]
    k_pos = kv_rank * s + torch.arange(s, device=dev)[None, :]
    return torch.where(q_pos >= k_pos, 0.0, -1e30)[None, None]


def ring_attention(q, k, v, axis_name='sp', causal=True, mesh=None):
    """q/k/v: [B, S_local, H, D] (this rank's sequence block; k/v with q's
    heads) -> [B, S_local, H, D] in q's dtype: exact softmax over the full
    sequence, through the plain ring (``_block_attn`` of the reference)."""
    grp = _group(axis_name, mesh)
    sp = 1 if grp is None else grp.nranks
    idx = 0 if grp is None else grp.index
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32 = q.float()
    o = torch.zeros((b, s, h, d), device=q.device)
    m = torch.full((b, h, s), -math.inf, device=q.device)
    l = torch.zeros((b, h, s), device=q.device)
    k_cur, v_cur, kv_rank = k, v, idx
    for hop in range(sp):
        sc = torch.einsum('bqhd,bkhd->bhqk', q32, k_cur.float()) * scale
        sc = sc + _mask(idx, kv_rank, s, causal, q.device)
        m_b = sc.amax(-1)
        p = torch.exp(sc - m_b[..., None])
        l_b = p.sum(-1)
        o_b = torch.einsum('bhqk,bkhd->bqhd', p, v_cur.float())
        m_new = torch.maximum(m, m_b)
        alpha, beta = torch.exp(m - m_new), torch.exp(m_b - m_new)
        o = (o * alpha.transpose(1, 2)[..., None]
             + o_b * beta.transpose(1, 2)[..., None])
        l = l * alpha + l_b * beta
        m = m_new
        if hop < sp - 1:
            k_cur, v_cur = _ring_ppermute((k_cur, v_cur), grp)
        kv_rank = (kv_rank - 1) % sp
    out = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _ring_ppermute(xs, grp):
    """Differentiable rotation (the backward rotates the other way)."""
    if grp is None or grp.nranks == 1:
        return xs
    from ..distributed.collective import ppermute
    return ppermute(xs, grp, shift=1)


def _pair_seed(seed, idx, kv_rank, sp):
    """Per-(q rank, kv source rank) dropout seed (the reference's
    ``_pair_seed``): mix_seed(seed + (idx * sp + kv_rank) * 0xB5297A4D),
    u32."""
    pair = ((idx * sp + kv_rank) * 0xB5297A4D) & fa._M32
    return int(fa.mix_seed((int(seed) + pair) & fa._M32))


def _branch(kv_rank, idx, causal):
    """'skip' (a future block), 'dense' (a past block) or 'diag'."""
    if not causal or kv_rank < idx:
        return 'dense'
    return 'diag' if kv_rank == idx else 'skip'


def merge(o, lse, o_b, lse_b):
    """The log-sum-exp merge of two softmax-normalized partials: o [B,S,H,D]
    f32 with lse [B,H,S], and a hop's o_b (any float dtype) with lse_b
    -> (o', lse') in f32."""
    lse_new = torch.logaddexp(lse, lse_b)
    w_a = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_b = torch.exp(lse_b - lse_new).transpose(1, 2)[..., None]
    return o * w_a + o_b.float() * w_b, lse_new


def _ring_fwd(q, k, v, grp, causal, drop_rate, seed):
    """-> (out [B,S,H,D] in q's dtype, lse [B,H,S] f32)."""
    sp = 1 if grp is None else grp.nranks
    idx = 0 if grp is None else grp.index
    b, s, h, d = q.shape
    o = torch.zeros((b, s, h, d), device=q.device)
    lse = torch.full((b, h, s), -math.inf, device=q.device)
    k_cur, v_cur, kv_rank = k, v, idx
    for hop in range(sp):
        br = _branch(kv_rank, idx, causal)
        if br != 'skip':
            o_b, lse_b = fa._flash_fwd(
                q, k_cur, v_cur, br == 'diag', drop_rate=drop_rate,
                seed=(_pair_seed(seed or 0, idx, kv_rank, sp) if drop_rate
                      else None))
            o, lse = merge(o, lse, o_b, lse_b)
        if hop < sp - 1:
            k_cur, v_cur = _rotate((k_cur, v_cur), grp)
        kv_rank = (kv_rank - 1) % sp
    return o.to(q.dtype), lse


def _pair_bwd(q, k, v, g, lse, delta, diag, drop_rate, seed):
    """One hop's (dq, dk, dv): kernels 2 and 3 on the card, the twin on
    the CPU."""
    args = (diag, 0, None, None, drop_rate, seed)
    if q.device.type == 'cpu':
        return fa.flash_bwd_reference(q, k, v, g, lse, delta, *args)
    dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, *args)
    return dq, dk, dv


def _ring_bwd(q, k, v, out, lse, g, grp, causal, drop_rate, seed):
    sp = 1 if grp is None else grp.nranks
    idx = 0 if grp is None else grp.index
    g = g.to(q.dtype).contiguous()
    delta = fa.bwd_delta(out, g)
    dq = torch.zeros(q.shape, device=q.device)
    dk = torch.zeros(k.shape, device=k.device)
    dv = torch.zeros(v.shape, device=v.device)
    k_cur, v_cur, kv_rank = k, v, idx
    for hop in range(sp):
        br = _branch(kv_rank, idx, causal)
        if br != 'skip':
            dq_b, dk_b, dv_b = _pair_bwd(
                q, k_cur, v_cur, g, lse, delta, br == 'diag', drop_rate,
                _pair_seed(seed or 0, idx, kv_rank, sp) if drop_rate
                else None)
            dq += dq_b.float()
            dk += dk_b.float()
            dv += dv_b.float()
        # k, v and their accumulators move together; after sp hops each
        # dk/dv block is home again
        if hop < sp - 1:
            k_cur, v_cur, dk, dv = _rotate((k_cur, v_cur, dk, dv), grp)
        else:
            dk, dv = _rotate((dk, dv), grp)
        kv_rank = (kv_rank - 1) % sp
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, grp, causal, drop_rate, seed):
        out, lse = _ring_fwd(q, k, v, grp, causal, drop_rate, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (grp, causal, drop_rate, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, g, *ctx.args)
        return dq, dk, dv, None, None, None, None


def ring_flash_attention(q, k, v, axis_name='sp', causal=True, drop_rate=0.0,
                         seed=None, mesh=None):
    """q [B, S_local, H, D], k/v [B, S_local, H_kv, D] (H_kv divides H):
    this rank's sequence block -> [B, S_local, H, D] in q's dtype,
    differentiable. ``axis_name``: the sp axis of ``mesh`` (default: the
    process topology's), or a ``Group``. ``drop_rate`` / ``seed`` (a u32):
    attention dropout per ring pair; ``drop_rate > 0`` without a seed
    raises, as the reference does."""
    if drop_rate > 0.0 and seed is None:
        # a silent seed default would make every hop (and every step)
        # reuse the same dropout mask
        raise ValueError('drop_rate > 0 requires seed')
    grp = _group(axis_name, mesh)
    return _RingFlash.apply(q, k, v, grp, causal, float(drop_rate),
                            None if seed is None else int(seed) & fa._M32)


def sequence_parallel_attention(q, k, v, mesh, causal=True):
    """q/k/v: [B, S, H, D] global tensors on every rank -> the global
    output on every rank: this rank's (dp, sp) block through the plain
    ring, gathered back over sp and dp (the reference's shard_map with
    ``P('dp', 'sp')``)."""
    from ..distributed.collective import all_gather_axis
    from .partitioner import PartitionSpec, shard
    spec = PartitionSpec('dp', 'sp', None, None)
    loc = [shard(x, spec, mesh) for x in (q, k, v)]
    out = ring_attention(*loc, 'sp', causal, mesh)
    out = all_gather_axis(out, mesh.group('sp'), dim=1)
    return all_gather_axis(out, mesh.group('dp'), dim=0)
