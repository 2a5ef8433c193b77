"""Flash attention: the attention forward and backward, and the dense
KV-cache decode.

Port of ``paddle_tpu/ops/flash_attention.py``. Five TPU kernels of the
reference become hand-written Hopper kernels, each beside its plain
PyTorch twin:

 - kernel 1, ``_fwd_kernel`` (attention forward with its log-sum-exp and
   attention dropout): ``_flash_fwd`` launches ``csrc/flash_fwd.cu``;
   twin ``flash_fwd_reference``;
 - kernels 2 and 3, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (the
   backward from the saved lse): ``flash_bwd_dq`` and ``flash_bwd_dkv``
   launch ``csrc/flash_bwd.cu``; twin ``flash_bwd_reference``;
 - kernel 4, ``_decode_kernel`` (q rows against a dense KV cache up to a
   device-side position): ``flash_decode`` launches
   ``csrc/flash_decode.cu``; twin ``flash_decode_reference``;
 - kernel 5, ``_decode_kernel_int8`` (the same over int8 cache banks):
   ``flash_decode_int8``, same source; twin
   ``flash_decode_int8_reference``.

Kernels 4 and 5 run the instances of the paged kernels 6 and 7
(``csrc/kv_attention.cuh``) over the dense cache read as pages of
``DENSE_PS`` rows, chosen by ``paged_attention.paged_instance`` with S_max
as the page size: the split-K decode for T <= 16 (twins
``flash_decode_split_reference`` and
``flash_decode_int8_split_reference``), the tensor-core prefill for bf16
at head dim 64/128, and the CUDA-core tile for the rest.

``_Flash`` (a ``torch.autograd.Function``, the counterpart of the
reference's ``_flash`` custom_vjp) joins kernel 1 to kernels 2 and 3.

In bfloat16, kernel 1 and kernels 2 and 3 (head dim 64 or 128) run on the
tensor cores (``wgmma`` fed by TMA, ``csrc/tc_attention.cuh``); float32
keeps their CUDA-core instances, whose f32 products hold the twins' 2e-5
where TF32 would not. The library picks the instance by dtype and head dim,
never after a failed launch; ``tc_launches`` on each wrapper counts the
tensor-core launches beside ``launches``.

The dispatching entries (``flash_attention``, ``_flash_fwd``,
``_flash_bwd``, ``decode_attention``) pick by q's device, as
``ops/paged_attention.py`` does: a CPU tensor runs the twin, a CUDA tensor
launches the kernel or the wrapper raises, anything else raises. The
kernel wrappers take CUDA tensors only. There is no fallback from the card
to the twin.

The twins repeat the Pallas kernels' arithmetic, so the CPU tests hold
them to the reference in interpret mode at f32 rounding: the online
softmax state (m, l, acc) is updated once per key block of the
reference's block size (``_pick_blocks`` for the forward, ``_decode_bk``
for decode); scores are f32 dots times 1/sqrt(D), masked with -1e30; l
sums the unrounded (undropped) p while p.V uses p (times the dropout
multiplier) rounded to V's dtype; the normalizer is floored at 1e-30. The
backward twin walks the reference's blocks too and rounds where its
kernels round. The kernels tile differently and are held to the twins by
tolerance.

Attention dropout is the reference's counter hash (``_dropout_keep``): a
pure function of (seed, attention row b*H + h, local q row, key), so the
forward and both backward kernels regenerate the same mask and never store
it. Seeds are u32, carried as Python ints or int64 tensors masked to 32
bits.

The port needs no padding to block multiples (the reference's
``_pad_seq``): the kernels and the twins mask the ragged edge of the key
range themselves.
"""
import ctypes
import math

import numpy as np
import torch

from . import _build
from .weight_only import is_weight_only

# Copied from paddle_tpu/ops/flash_attention.py:146-148: masked scores are
# filled with -1e30 (not -inf, so a fully masked row stays finite) and the
# softmax normalizer is floored at 1e-30.
_NEG_INF = -1e30
_EPS = 1e-30

HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_CAP = 512   # the reference's default q/k block cap (_BQ_CAP, _BK_CAP)

# ---------------------------------------------------------------------------
# Counter-hash dropout (paddle_tpu/ops/flash_attention.py:173-233), in u32
# arithmetic on int64 tensors masked to 32 bits
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 tensors holding u32 values, split in
    16-bit halves so no intermediate overflows int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _u32(x):
    """An int, or an integer tensor, as an int64 tensor of u32 values."""
    return torch.as_tensor(x).long() & _M32


def mix_seed(x):
    """The reference's murmur-style finalizer over u32 values (every
    derived-seed fold goes through it, so linear index arithmetic never
    lines up with the hash's coordinate multipliers)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def per_layer_seeds(seed, n_layers):
    """One mixed dropout seed per layer: int64 [n_layers] of u32 values,
    on the CPU for an int seed."""
    seed = _u32(seed)
    idx = torch.arange(n_layers, device=seed.device, dtype=torch.int64)
    return mix_seed((seed + _mul32(idx, 0x27D4EB2F)) & _M32)


def _dropout_keep(seed, row, q_pos, k_pos, rate):
    """Bool keep mask with P(keep) = 1 - rate: the hash of (seed,
    attention row, local q position, global key position), broadcast over
    the integer tensors ``row``, ``q_pos``, ``k_pos``; the top 24 bits
    against the f32 of ``rate * 2**24``. Bit for bit the reference's."""
    x = mix_seed(_mul32(_u32(q_pos), 0x9E3779B1)
                 + _mul32(_u32(k_pos), 0x85EBCA77)
                 + _mul32(_u32(row), 0xC2B2AE3D) + _u32(seed))
    return (x >> 8).float() >= _drop_thr(rate)


def _drop_thr(rate):
    return float(np.float32(rate * (1 << 24)))


def _drop_mult_value(rate):
    return float(np.float32(1.0 / (1.0 - rate)))


def _drop_mult(seed, row, q_pos, k_pos, rate):
    """f32 dropout multiplier: 1/(1-rate) where kept, 0 where dropped."""
    keep = _dropout_keep(seed, row, q_pos, k_pos, rate)
    return torch.where(keep, _drop_mult_value(rate), 0.0)


def _attention_rows(b, h, device):
    """[B, H, 1, 1] int64: each (batch, query head)'s hash row b*H + h."""
    return torch.arange(b * h, device=device).reshape(b, h, 1, 1)


def _check_dropout(rate, seed):
    rate = float(rate or 0.0)
    if rate >= 1.0:
        raise ValueError('flash_attention dropout_rate must be < 1')
    if rate > 0.0 and seed is None:
        raise ValueError('dropout_rate > 0 requires dropout_seed')
    return rate


def repeat_kv(k, v, n_q_heads):
    """Materialize GQA kv heads ([B, S, H_kv, D]) up to ``n_q_heads``
    (plain paths only — the kernels share kv rows across the group)."""
    h_kv = int(k.shape[2])
    if h_kv == n_q_heads:
        return k, v
    rep = n_q_heads // h_kv
    return (torch.repeat_interleave(k, rep, dim=2),
            torch.repeat_interleave(v, rep, dim=2))


# ---------------------------------------------------------------------------
# Block sizes and masks, copied from the reference
# ---------------------------------------------------------------------------

def _pick_block(s, cap=_BLOCK_CAP):
    """Largest block <= cap dividing the 128-padded length
    (``flash_attention.py:61``)."""
    sp = -(-s // 128) * 128
    for b in (cap, 512, 256, 128):
        if 0 < b <= cap and sp % b == 0:
            return b
    return 128


def _pick_blocks(s_q, s_k):
    """(bq, bk) of the reference's forward kernel (``flash_attention.py:73``)."""
    bq = _pick_block(s_q)
    bk = min(_pick_block(s_k), bq)
    while bq % bk and bk > 128:
        bk = max(128, bk // 2)
    return bq, bk


def _decode_bk(s_max):
    """Key-block size of the reference's decode kernels."""
    return 256 if s_max % 256 == 0 else 128


def _key_mask_normalizable(mask, b, s_k):
    """True for a per-key padding mask: [S_k], [B, S_k], [B, 1, S_k] or
    [B, 1, 1, S_k] (leading dim B or 1). A per-head [B, H, S_k] or dense
    [.., S_q, S_k] mask is not, and takes the plain path."""
    if mask is None:
        return False
    shape = tuple(int(x) for x in mask.shape)
    if not shape or shape[-1] != s_k or len(shape) > 4:
        return False
    return (len(shape) == 1 or
            (shape[0] in (1, b) and all(x == 1 for x in shape[1:-1])))


def _normalize_key_mask(mask, b, s_k):
    """-> additive f32 [B, S_k] (0 keep / -1e30 drop for bool masks)."""
    m = mask
    if m.dtype == torch.bool:
        m = torch.where(m, 0.0, _NEG_INF)
    m = m.float().reshape(-1, s_k)
    return m.expand(b, s_k) if m.shape[0] == 1 else m


def lift_mask_4d(m):
    """Broadcast an attention mask to [B,H,S_q,S_k] rank: 1-D = per-key,
    2-D = [B,S_k] key padding, 3-D = [B,H,S_k] per-head key padding."""
    if m.dim() == 1:
        return m[None, None, None, :]
    if m.dim() == 2:
        return m[:, None, None, :]
    if m.dim() == 3:
        return m[:, :, None, :]
    return m


# ---------------------------------------------------------------------------
# Plain paths
# ---------------------------------------------------------------------------

def attention_reference(q, k, v, causal, mask=None, drop_rate=0.0,
                        seed=None):
    """The reference's plain softmax attention (``_jnp_attention``),
    [B,S,H,D] layout: scores in q's dtype, then f32 with causal (aligned
    ends: query i sees keys <= S_k - S_q + i) and mask applied, softmax in
    f32, dropout (``drop_rate``: the counter-hash mask of the kernels, row
    b*H + h), p cast to V's dtype for p.V. Differentiable by autograd."""
    k, v = repeat_kv(k, v, int(q.shape[2]))
    d = q.shape[-1]
    scores = torch.einsum('bqhd,bkhd->bhqk', q, k).float()
    scores = scores * (1.0 / math.sqrt(d))
    if causal:
        qlen, klen = scores.shape[-2], scores.shape[-1]
        cm = torch.ones((qlen, klen), dtype=torch.bool,
                        device=q.device).tril(klen - qlen)
        scores = torch.where(cm, scores, _NEG_INF)
    if mask is not None:
        m = lift_mask_4d(mask)
        if m.dtype == torch.bool:
            scores = torch.where(m, scores, _NEG_INF)
        else:
            scores = scores + m.float()
    p = torch.softmax(scores, dim=-1)
    if drop_rate:
        b, h, s_q, s_k = p.shape
        p = p * _drop_mult(seed, _attention_rows(b, h, q.device),
                           torch.arange(s_q, device=q.device)[:, None],
                           torch.arange(s_k, device=q.device)[None, :],
                           drop_rate)
    return torch.einsum('bhqk,bkhd->bqhd', p.to(v.dtype), v)


def _online_update(m, l, s):
    """One key block of the online softmax over the block's masked f32
    scores ``s`` [.., rows, keys]: -> (m_new, l_new, p, alpha), where l
    sums the unrounded p and the caller adds p.V to ``acc * alpha``."""
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    return m_new, l * alpha + p.sum(dim=-1, keepdim=True), p, alpha


def flash_fwd_reference(q, k, v, causal, q_off=0, kv_valid=None,
                        kmask=None, drop_rate=0.0, seed=None):
    """Plain twin of kernel 1 (the reference's ``_fwd_kernel``).

    q [B,S_q,H,D], k/v [B,S_k,H_kv,D] (H_kv divides H; head h reads kv
    head h // (H / H_kv)); ``causal``: query row i sees keys <= i + q_off;
    ``kv_valid``: keys >= kv_valid are masked; ``kmask``: additive f32
    [B, S_k] or None; ``drop_rate``/``seed``: attention dropout on p (l
    sums the undropped p). Blocks are the reference's (``_pick_blocks``):
    each q block visits the key blocks the reference visits and updates the
    online softmax once per key block; a ragged last block is simply
    shorter. -> (out [B,S_q,H,D] in q's dtype, lse [B,H,S_q] f32 =
    m + log(max(l, 1e-30)))."""
    b, s_q, h, d = q.shape
    s_k, h_kv = int(k.shape[1]), int(k.shape[2])
    g = h // h_kv
    bq, bk = _pick_blocks(s_q, s_k)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qf = q.float().permute(0, 2, 1, 3)                        # [B,H,Sq,D]
    kt = k.permute(0, 2, 1, 3)                                # [B,Hkv,Sk,D]
    vt = v.permute(0, 2, 1, 3)
    if g > 1:
        kt = torch.repeat_interleave(kt, g, dim=1)
        vt = torch.repeat_interleave(vt, g, dim=1)
    nkb = -(-s_k // bk)
    n_valid = nkb if kv_valid is None else min(nkb, -(-kv_valid // bk))
    rows = _attention_rows(b, h, dev) if drop_rate else None
    outs, lses = [], []
    for q0 in range(0, s_q, bq):
        q1 = min(s_q, q0 + bq)
        n_iter = n_valid
        if causal:
            n_iter = min(n_iter, (q0 + bq + q_off + bk - 1) // bk)
        n_rows = q1 - q0
        acc = torch.zeros((b, h, n_rows, d), dtype=torch.float32, device=dev)
        m = torch.full((b, h, n_rows, 1), _NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, n_rows, 1), dtype=torch.float32, device=dev)
        q_pos = torch.arange(q0, q1, device=dev)[:, None]
        for kb in range(max(0, n_iter)):
            c0, c1 = kb * bk, min(s_k, kb * bk + bk)
            s = (qf[:, :, q0:q1] @ kt[:, :, c0:c1].float().transpose(-1, -2)
                 ) * scale
            if kmask is not None:
                s = s + kmask[:, None, None, c0:c1].float()
            k_pos = torch.arange(c0, c1, device=dev)[None, :]
            if causal:
                s = torch.where(q_pos + q_off >= k_pos, s, _NEG_INF)
            if kv_valid is not None:
                s = torch.where(k_pos < kv_valid, s, _NEG_INF)
            m, l, p, alpha = _online_update(m, l, s)
            if drop_rate:
                p = p * _drop_mult(seed, rows, q_pos, k_pos, drop_rate)
            vb = vt[:, :, c0:c1]
            acc = acc * alpha + p.to(vb.dtype).float() @ vb.float()
        outs.append(acc / torch.clamp(l, min=_EPS))
        lses.append((m + torch.log(torch.clamp(l, min=_EPS)))[..., 0])
    out = torch.cat(outs, dim=2).to(q.dtype).permute(0, 2, 1, 3)
    return out, torch.cat(lses, dim=2)


def bwd_delta(out, g):
    """delta = rowsum(out * dO) in f32 (the reference's ``bwd_broadcasts``
    without the TPU's lane broadcast): [B,S,H,D] -> [B,H,S] contiguous."""
    return (out.float() * g.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_reference(q, k, v, g, lse, delta, causal, q_off=0,
                        kv_valid=None, kmask=None, drop_rate=0.0, seed=None):
    """Plain twin of kernels 2 and 3 (the reference's ``_bwd_dq_kernel``
    and ``_bwd_dkv_kernel`` as ``_bwd_pallas_pre`` runs them), block by
    block at the reference's ``_pick_blocks``.

    q, g (dO) [B,S_q,H,D]; k, v [B,S_k,H_kv,D]; lse, delta [B,H,S_q] f32;
    the mask arguments as ``flash_fwd_reference``. Each tile recomputes
    p = exp(s - lse); dp = dO.v (times the dropout multiplier);
    ds = p * (dp - delta), rounded to k's dtype before ds.K (dq) and to q's
    dtype before ds^T.Q (dk); pd = p (times the multiplier) rounded to dO's
    dtype before pd^T.dO (dv); the scale is folded into dq and dk at the
    end. dq visits the key blocks up to its causal limit, dk/dv the q
    blocks from the first that can see the key block. GQA: per-query-head
    dk/dv partials rounded to k's dtype, then summed in f32.
    -> (dq in q's dtype, dk, dv in k's dtype)."""
    b, s_q, h, d = q.shape
    s_k, h_kv = int(k.shape[1]), int(k.shape[2])
    grp = h // h_kv
    bq, bk = _pick_blocks(s_q, s_k)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qt = q.float().permute(0, 2, 1, 3)                        # [B,H,Sq,D]
    gt = g.float().permute(0, 2, 1, 3)
    kt = k.permute(0, 2, 1, 3)                                # [B,Hkv,Sk,D]
    vt = v.permute(0, 2, 1, 3)
    if grp > 1:
        kt = torch.repeat_interleave(kt, grp, dim=1)
        vt = torch.repeat_interleave(vt, grp, dim=1)
    kf, vf = kt.float(), vt.float()
    rows = _attention_rows(b, h, dev) if drop_rate else None
    nkb, nqb = -(-s_k // bk), -(-s_q // bq)
    n_valid = nkb if kv_valid is None else min(nkb, -(-kv_valid // bk))

    def tile(q0, q1, c0, c1):
        """(ds, pd) f32 [B,H,q1-q0,c1-c0] of one (q block, key block)."""
        s = (qt[:, :, q0:q1] @ kf[:, :, c0:c1].transpose(-1, -2)) * scale
        if kmask is not None:
            s = s + kmask[:, None, None, c0:c1].float()
        q_pos = torch.arange(q0, q1, device=dev)[:, None]
        k_pos = torch.arange(c0, c1, device=dev)[None, :]
        if causal:
            s = torch.where(q_pos + q_off >= k_pos, s, _NEG_INF)
        if kv_valid is not None:
            s = torch.where(k_pos < kv_valid, s, _NEG_INF)
        p = torch.exp(s - lse[:, :, q0:q1, None])
        dp = gt[:, :, q0:q1] @ vf[:, :, c0:c1].transpose(-1, -2)
        pd = p
        if drop_rate:
            mult = _drop_mult(seed, rows, q_pos, k_pos, drop_rate)
            dp = dp * mult
            pd = p * mult
        return p * (dp - delta[:, :, q0:q1, None]), pd

    dq = torch.zeros((b, h, s_q, d), dtype=torch.float32, device=dev)
    for qb in range(nqb):
        q0, q1 = qb * bq, min(s_q, qb * bq + bq)
        n_iter = n_valid
        if causal:
            n_iter = min(n_iter, (q0 + bq + q_off + bk - 1) // bk)
        for kb in range(max(0, n_iter)):
            c0, c1 = kb * bk, min(s_k, kb * bk + bk)
            ds, _ = tile(q0, q1, c0, c1)
            dq[:, :, q0:q1] += ds.to(k.dtype).float() @ kf[:, :, c0:c1]
    dk = torch.zeros((b, h, s_k, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for kb in range(nkb):
        c0, c1 = kb * bk, min(s_k, kb * bk + bk)
        start = max(0, (kb * bk - q_off) // bq) if causal else 0
        for qb in range(start, nqb):
            q0, q1 = qb * bq, min(s_q, qb * bq + bq)
            ds, pd = tile(q0, q1, c0, c1)
            dv[:, :, c0:c1] += (pd.to(g.dtype).float().transpose(-1, -2)
                                @ gt[:, :, q0:q1])
            dk[:, :, c0:c1] += (ds.to(q.dtype).float().transpose(-1, -2)
                                @ qt[:, :, q0:q1])
    dq = (dq * scale).to(q.dtype).permute(0, 2, 1, 3)
    dk = (dk * scale).to(k.dtype)
    dv = dv.to(v.dtype)
    if grp > 1:
        dk = dk.float().reshape(b, h_kv, grp, s_k, d).sum(2).to(k.dtype)
        dv = dv.float().reshape(b, h_kv, grp, s_k, d).sum(2).to(v.dtype)
    return dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _decode_twin(q, k, v, pos, ks=None, vs=None):
    """Shared body of the decode twins. q [B,T,H,D]; k/v [B,S_max,H_kv,D]
    (int8 with ``ks``/``vs`` [B,S_max,H_kv] f32 scales); q row j sees cache
    positions <= pos + j. Key blocks of ``_decode_bk(S_max)`` are visited
    in order; blocks past every row's last key change no number (each row
    sees key 0, so m is finite after block 0 and a fully masked block adds
    p = 0), so all of them are visited and ``pos`` never leaves the
    device."""
    b, t, h, d = q.shape
    s_max, h_kv = int(k.shape[1]), int(k.shape[2])
    g = h // h_kv
    bk = _decode_bk(s_max)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    int8 = ks is not None
    qf = q.float().permute(0, 2, 1, 3)                        # [B,H,T,D]

    def heads(x):                                # [B,S,Hkv,..] -> [B,H,S,..]
        x = x.transpose(1, 2)
        return torch.repeat_interleave(x, g, dim=1) if g > 1 else x

    kt, vt = heads(k), heads(v)
    if int8:
        kst, vst = heads(ks), heads(vs)                       # [B,H,S]
    q_pos = (torch.as_tensor(pos, device=dev).reshape(()).long()
             + torch.arange(t, device=dev))[:, None]          # [T,1]
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, t, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t, 1), dtype=torch.float32, device=dev)
    for c0 in range(0, s_max, bk):
        c1 = min(s_max, c0 + bk)
        kb = kt[:, :, c0:c1]
        if int8:
            kb = kb.to(q.dtype)
        s = (qf @ kb.float().transpose(-1, -2)) * scale       # [B,H,T,bk]
        if int8:
            s = s * kst[:, :, None, c0:c1]
        k_pos = torch.arange(c0, c1, device=dev)[None, :]
        s = torch.where(k_pos <= q_pos, s, _NEG_INF)
        m, l, p, alpha = _online_update(m, l, s)
        vb = vt[:, :, c0:c1]
        if int8:
            p = p * vst[:, :, None, c0:c1]
            pv = p.to(q.dtype).float() @ vb.to(q.dtype).float()
        else:
            pv = p.to(vb.dtype).float() @ vb.float()
        acc = acc * alpha + pv
    out = acc / torch.clamp(l, min=_EPS)
    return out.to(q.dtype).permute(0, 2, 1, 3)


def flash_decode_reference(q, k_cache, v_cache, pos):
    """Plain twin of kernel 4 (``_decode_kernel``): q [B,T,H,D] at
    absolute positions pos..pos+T-1 against caches [B,S_max,H_kv,D];
    ``pos`` an int or an integer tensor of one element."""
    return _decode_twin(q, k_cache, v_cache, pos)


def flash_decode_int8_reference(q, k_bank, v_bank, pos):
    """Plain twin of kernel 5 (``_decode_kernel_int8``): int8 rows are cast
    to q's dtype; the k scale multiplies the score columns after the q.k
    dot, the v scale multiplies p before p is cast to q's dtype for p.V;
    l sums p without the v scale."""
    return _decode_twin(q, k_bank['int8'], v_bank['int8'], pos,
                        k_bank['scale'], v_bank['scale'])


def _dense_split_twin(q, k, v, ks, vs, pos, n_split, pages_per_split):
    """The split-K instance's twin over the dense cache read as a pool of
    ``DENSE_PS``-row pages through the implicit table (page p of batch row
    b is its rows p * DENSE_PS ..; S_max padded with zero rows to whole
    pages, the padding masked), then kernel 6 and 7's split twin with every
    batch row at ``pos``; ``ks``/``vs`` the int8 rows' scales or None."""
    from .paged_attention import paged_decode_split_reference
    b, s_max, h_kv, d = k.shape
    p_max = -(-s_max // DENSE_PS)
    pad = p_max * DENSE_PS - s_max

    def pool(x, sc):
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        x = x.reshape(b * p_max, DENSE_PS, h_kv, d)
        if sc is None:
            return x
        if pad:
            sc = torch.nn.functional.pad(sc, (0, 0, 0, pad))
        return {'int8': x, 'scale': sc.reshape(b * p_max, DENSE_PS, h_kv)}

    table = torch.arange(b * p_max, dtype=torch.int32,
                         device=q.device).reshape(b, p_max)
    pos_b = torch.as_tensor(pos, device=q.device).reshape(-1)[:1].to(
        torch.int32).expand(b)
    return paged_decode_split_reference(q, pool(k, ks), pool(v, vs), table,
                                        pos_b, n_split, pages_per_split,
                                        n_keys=s_max)


def flash_decode_split_reference(q, k_cache, v_cache, pos, n_split,
                                 pages_per_split):
    """Plain twin of kernel 4's split-K instance: the bf16/f32 dense cache
    read as ``DENSE_PS``-row pages through the implicit table, split into
    ``n_split`` runs of ``pages_per_split`` pages, the runs merged by
    log-sum-exp. Same arguments and result as ``flash_decode_reference``,
    plus the split plan."""
    return _dense_split_twin(q, k_cache, v_cache, None, None, pos, n_split,
                             pages_per_split)


def flash_decode_int8_split_reference(q, k_bank, v_bank, pos, n_split,
                                      pages_per_split):
    """Plain twin of kernel 5's split-K instance: kernel 4's
    (``flash_decode_split_reference``) over int8 banks. Same arguments and
    result as ``flash_decode_int8_reference``, plus the split plan."""
    return _dense_split_twin(q, k_bank['int8'], v_bank['int8'],
                             k_bank['scale'], v_bank['scale'], pos, n_split,
                             pages_per_split)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U32, _F32 = ctypes.c_uint32, ctypes.c_float
_FLAG = ctypes.POINTER(ctypes.c_int)     # set to 1 by a tensor-core launch
# pointers, element strides, ints, the dropout arguments, then the stream
# (csrc/*.cu, extern "C"); the decode entries go on with the split-K
# partials and tickets, n_split, pps and the instance they ran
_DECODE_ARGS = ([_P] * 8 + [_I64] * 6 + [_I32] * 7 + [_P] + [_P] * 4
                + [_I32] * 2 + [_FLAG])
_DROP_ARGS = [_I32, _U32, _F32, _F32]
_BWD_ARGS = ([_P] * 10 + [_I64] * 10 + [_I32] * 9 + _DROP_ARGS
             + [_I32, _FLAG, _P])
_ENTRY_POINTS = {
    'flash_decode': {'flash_decode': _DECODE_ARGS,
                     'flash_decode_int8': _DECODE_ARGS},
    'flash_fwd': {'flash_fwd': [_P] * 6 + [_I64] * 7 + [_I32] * 9
                  + _DROP_ARGS + [_FLAG, _P]},
    'flash_bwd': {'flash_bwd_dq': _BWD_ARGS, 'flash_bwd_dkv': _BWD_ARGS},
}
_libs = {}


def _kernel_lib(name):
    """The library of ``csrc/<name>.cu``, built on first use, with its
    entry points' argument types declared."""
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        for fn, argtypes in _ENTRY_POINTS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I32
        lib.attn_error_string.argtypes = [_I32]
        lib.attn_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _rows_aligned(x):
    """True when every row of ``x`` [B,S,H,D] starts 16-byte aligned."""
    es = x.element_size()
    return not (x.data_ptr() % 16
                or any((st * es) % 16 for st in x.stride()[:3]))


def _check_rows(name, x, dev):
    """A [B, S, H, D] operand the kernels read row by row: on ``dev``, the
    head dim contiguous, and every row 16-byte aligned."""
    if x.device != dev:
        raise ValueError(f'{name} is on {x.device}, q on {dev}')
    if x.dim() != 4 or x.stride(3) != 1:
        raise ValueError(f'{name} must be [B, S, H, D] with a contiguous '
                         'head dim')
    if not _rows_aligned(x):
        raise ValueError(f'{name} rows must be 16-byte aligned')


def _check_q(q, op):
    if q.device.type != 'cuda':
        raise ValueError(f'{op} needs CUDA tensors, q is on {q.device}')
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f'q dtype {q.dtype} not in float32/bfloat16')
    if int(q.shape[-1]) not in HEAD_DIMS:
        raise ValueError(f'head_dim {int(q.shape[-1])} not in {HEAD_DIMS}')


def _drop_args(drop_rate, seed):
    """(dropout, seed, threshold, multiplier) as the kernels take them."""
    if not drop_rate:
        return 0, 0, 0.0, 0.0
    return (1, int(_u32(seed)), _drop_thr(drop_rate),
            _drop_mult_value(drop_rate))


def _check_attn_args(q, k, v, kmask, op):
    """Shared checks of kernels 1-3: -> (b, s_q, h, d, s_k, h_kv)."""
    _check_q(q, op)
    dev = q.device
    b, s_q, h, d = q.shape
    if k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError('k and v must be [B, S_k, H_kv, D] alike')
    _, s_k, h_kv, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f'k {tuple(k.shape)} does not fit q '
                         f'{tuple(q.shape)}')
    if h_kv == 0 or h % h_kv:
        raise ValueError(f'kv heads {h_kv} must divide q heads {h}')
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("k and v must have q's dtype")
    for name, x in (('q', q), ('k', k), ('v', v)):
        _check_rows(name, x, dev)
    if k.stride() != v.stride():
        raise ValueError('k and v must have the same strides')
    if kmask is not None:
        if (kmask.dtype != torch.float32 or kmask.device != dev
                or tuple(kmask.shape) != (b, s_k) or kmask.stride(1) != 1):
            raise ValueError('kmask must be additive f32 [B, S_k] on q\'s '
                             'device with contiguous keys')
    return b, s_q, h, d, s_k, h_kv


def _launch_done(lib, err, op):
    if err != 0:
        msg = lib.attn_error_string(err).decode()
        raise RuntimeError(f'{op} launch failed ({err}): {msg}')


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _pos_arg(pos, dev):
    """``pos`` as the int32 [1] device tensor the decode kernels read (the
    counterpart of the TPU's scalar prefetch): a tensor stays where it is,
    an int is copied over once."""
    if isinstance(pos, torch.Tensor):
        if pos.device != dev or pos.dtype != torch.int32 or pos.numel() != 1:
            raise ValueError('pos must be an int32 tensor of one element on '
                             "q's device")
        return pos
    return torch.tensor([int(pos)], dtype=torch.int32, device=dev)


DENSE_PS = 128    # the split-K pages of kernels 4 and 5: rows p * 128 ..
# the instance a C entry point reports it ran (kernels 4-7)
INSTANCE = {0: 'cuda-core', 1: 'split-k', 2: 'tensor-core'}


def _decode_launch(q, k, v, pos, ks=None, vs=None):
    """Check the arguments and launch kernel 4, or kernel 5 with the int8
    rows' scales ``ks``/``vs``; raises on a refused launch. -> (out, the
    instance that ran: 'split-k', 'tensor-core' or 'cuda-core', the rule
    of ``paged_attention.paged_instance`` with S_max as the page size)."""
    from . import paged_attention as pa
    op = 'flash_decode_int8' if ks is not None else 'flash_decode'
    _check_q(q, op)
    dev = q.device
    b, t, h, d = q.shape
    if k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError('k and v caches must be [B, S_max, H_kv, D] alike')
    _, s_max, h_kv, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f'cache {tuple(k.shape)} does not fit q '
                         f'{tuple(q.shape)}')
    if h_kv == 0 or h % h_kv:
        raise ValueError(f'kv heads {h_kv} must divide q heads {h}')
    want = torch.int8 if ks is not None else q.dtype
    if k.dtype != want or v.dtype != want:
        raise ValueError(f'the caches must be {want}')
    for name, x in (('q', q), ('k_cache', k), ('v_cache', v)):
        _check_rows(name, x, dev)
    if k.stride() != v.stride():
        raise ValueError('k and v caches must have the same strides')
    if ks is not None:
        for name, x in (('k scale', ks), ('v scale', vs)):
            if (x.dtype != torch.float32 or x.device != dev
                    or tuple(x.shape) != (b, s_max, h_kv)
                    or not x.is_contiguous()):
                raise ValueError(f'{name} must be f32 [B, S_max, H_kv], '
                                 'contiguous, on q\'s device')
    pos_t = _pos_arg(pos, dev)
    lib = _kernel_lib('flash_decode')
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
    flag = ctypes.c_int(0)
    with torch.cuda.device(dev):
        scratch, n_split, pps, keep = (0, 0, 0, 0), 0, 0, None
        if pa.paged_instance(q.dtype, t, d, s_max, k.dtype) == 'split-k':
            scratch, n_split, pps, keep = pa.split_scratch(
                b, t, h, h_kv, d, -(-s_max // DENSE_PS), dev)
        err = getattr(lib, op)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if ks is None else ks.data_ptr(),
            0 if vs is None else vs.data_ptr(),
            pos_t.data_ptr(), out.data_ptr(), None,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            b, t, h, h_kv, d, s_max, _DTYPE_CODE[q.dtype], _stream(dev),
            *scratch, n_split, pps, ctypes.byref(flag))
        del keep
    _launch_done(lib, err, op)
    return out, INSTANCE[flag.value]


def _count(kernel, inst):
    kernel.launches += 1
    kernel.split_launches += inst == 'split-k'
    kernel.tc_launches += inst == 'tensor-core'


def flash_decode(q, k_cache, v_cache, pos):
    """Kernel 4 on the card. q [B,T,H,D] (any T; rows may be strided views
    with a contiguous head dim); caches [B,S_max,H_kv,D] in q's dtype, read
    in place (one layer's view of the [L,B,S_max,H_kv,D] cache); ``pos`` an
    int32 [1] tensor on the card (an int is copied over) -> [B,T,H,D].
    Launches on the current stream without synchronising; raises on
    arguments the kernel does not take. The instance is kernel 6's rule
    (``paged_attention.paged_instance``) with S_max as the page size: the
    split-K decode for T <= 16 over pages of ``DENSE_PS`` rows, the
    tensor-core prefill for bf16 at D 64/128 with S_max a multiple of 64,
    else the CUDA-core tile. ``flash_decode.launches`` counts launches;
    ``split_launches`` and ``tc_launches`` those of the split-K and
    tensor-core instances."""
    out, inst = _decode_launch(q, k_cache, v_cache, pos)
    _count(flash_decode, inst)
    return out


flash_decode.launches = 0
flash_decode.split_launches = 0
flash_decode.tc_launches = 0


def flash_decode_int8(q, k_bank, v_bank, pos):
    """Kernel 5 on the card: ``flash_decode`` over int8 banks
    ``{'int8': [B,S_max,H_kv,D] int8, 'scale': [B,S_max,H_kv] f32}``, by
    the same instances and rule. Counters as ``flash_decode``'s."""
    out, inst = _decode_launch(q, k_bank['int8'], v_bank['int8'], pos,
                               k_bank['scale'], v_bank['scale'])
    _count(flash_decode_int8, inst)
    return out


flash_decode_int8.launches = 0
flash_decode_int8.split_launches = 0
flash_decode_int8.tc_launches = 0


def flash_fwd(q, k, v, causal, q_off=0, kv_valid=None, kmask=None,
              drop_rate=0.0, seed=None):
    """Kernel 1 on the card. q [B,S_q,H,D], k/v [B,S_k,H_kv,D] (strided
    views with a contiguous head dim are read in place, as ``_block_qkv``
    returns them); ``kmask`` additive f32 [B, S_k] (a zero batch stride
    broadcasts one row); ``drop_rate``/``seed`` (a u32) attention dropout
    -> (out [B,S_q,H,D] contiguous in q's dtype, lse [B,H,S_q] f32).
    bfloat16 runs the tensor-core kernel, float32 the CUDA-core tile (the
    library picks by dtype). ``flash_fwd.launches`` counts launches,
    ``flash_fwd.tc_launches`` those of the tensor-core kernel."""
    b, s_q, h, d, s_k, h_kv = _check_attn_args(q, k, v, kmask, 'flash_fwd')
    dev = q.device
    n_keys = s_k if kv_valid is None else max(0, min(s_k, int(kv_valid)))
    lib = _kernel_lib('flash_fwd')
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=dev)
    tc = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if kmask is None else kmask.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            0 if kmask is None else kmask.stride(0),
            b, s_q, h, h_kv, d, n_keys, int(bool(causal)), int(q_off),
            _DTYPE_CODE[q.dtype], *_drop_args(drop_rate, seed),
            ctypes.byref(tc), _stream(dev))
    _launch_done(lib, err, 'flash_fwd')
    flash_fwd.launches += 1
    flash_fwd.tc_launches += tc.value
    return out, lse


flash_fwd.launches = 0
flash_fwd.tc_launches = 0


def _bwd_launch(entry, q, k, v, g, lse, delta, causal, q_off, kv_valid,
                kmask, drop_rate, seed):
    b, s_q, h, d, s_k, h_kv = _check_attn_args(q, k, v, kmask, entry)
    dev = q.device
    if tuple(g.shape) != tuple(q.shape) or g.dtype != q.dtype:
        raise ValueError("dO must have q's shape and dtype")
    _check_rows('dO', g, dev)
    for name, x in (('lse', lse), ('delta', delta)):
        if (x.dtype != torch.float32 or x.device != dev
                or tuple(x.shape) != (b, h, s_q) or not x.is_contiguous()):
            raise ValueError(f'{name} must be contiguous f32 [B, H, S_q] on '
                             "q's device")
    n_keys = s_k if kv_valid is None else max(0, min(s_k, int(kv_valid)))
    lib = _kernel_lib('flash_bwd')
    tc = ctypes.c_int(0)
    if entry == 'flash_bwd_dq':
        outs = (torch.empty((b, s_q, h, d), dtype=q.dtype, device=dev),)
        ptrs = (outs[0].data_ptr(), 0, 0)
    else:
        outs = tuple(torch.empty((b, s_k, h_kv, d), dtype=k.dtype,
                                 device=dev) for _ in range(2))
        ptrs = (0, outs[0].data_ptr(), outs[1].data_ptr())
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            0 if kmask is None else kmask.data_ptr(), *ptrs,
            q.stride(0), q.stride(1), q.stride(2),
            g.stride(0), g.stride(1), g.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            0 if kmask is None else kmask.stride(0),
            b, s_q, s_k, h, h_kv, d, n_keys, int(bool(causal)), int(q_off),
            *_drop_args(drop_rate, seed), _DTYPE_CODE[q.dtype],
            ctypes.byref(tc), _stream(dev))
    _launch_done(lib, err, entry)
    return outs, tc.value


def flash_bwd_dq(q, k, v, g, lse, delta, causal, q_off=0, kv_valid=None,
                 kmask=None, drop_rate=0.0, seed=None):
    """Kernel 2 on the card: dq [B,S_q,H,D] (contiguous, q's dtype) from q,
    k, v and dO (``g``, [B,S_q,H,D], read through its strides), the
    forward's ``lse`` and ``delta = bwd_delta(out, g)`` ([B,H,S_q] f32);
    the mask and dropout arguments are the forward's. bfloat16 at head dim
    64 or 128 runs the tensor-core kernel, float32 and head dim 256 the
    CUDA-core kernel (the library picks by dtype and head dim).
    ``flash_bwd_dq.launches`` counts launches, ``flash_bwd_dq.tc_launches``
    those of the tensor-core kernel."""
    (dq,), tc = _bwd_launch('flash_bwd_dq', q, k, v, g, lse, delta, causal,
                            q_off, kv_valid, kmask, drop_rate, seed)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.tc_launches += tc
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.tc_launches = 0


def flash_bwd_dkv(q, k, v, g, lse, delta, causal, q_off=0, kv_valid=None,
                  kmask=None, drop_rate=0.0, seed=None):
    """Kernel 3 on the card: (dk, dv) [B,S_k,H_kv,D] (contiguous, k's
    dtype), each kv head's gradient summed over its query group in f32;
    arguments as ``flash_bwd_dq``. bfloat16 at head dim 64 or 128 runs the
    tensor-core kernel, float32 and head dim 256 the CUDA-core kernel (the
    library picks by dtype and head dim). ``flash_bwd_dkv.launches`` counts
    launches, ``flash_bwd_dkv.tc_launches`` those of the tensor-core
    kernel."""
    (dk, dv), tc = _bwd_launch('flash_bwd_dkv', q, k, v, g, lse, delta,
                               causal, q_off, kv_valid, kmask, drop_rate,
                               seed)
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.tc_launches += tc
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.tc_launches = 0


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _on(q, op):
    """'cpu' or 'cuda' for q's device; raises for any other."""
    if q.device.type in ('cpu', 'cuda'):
        return q.device.type
    raise ValueError(f'{op} runs on cuda or cpu, not {q.device}')


def _flash_fwd(q, k, v, causal, q_off=0, kv_valid=None, kmask=None,
               drop_rate=0.0, seed=None):
    """Kernel 1 for a CUDA tensor, its twin for a CPU tensor. [B,S,H,D]
    layout -> (out [B,S_q,H,D], lse [B,H,S_q] f32)."""
    fn = (flash_fwd_reference if _on(q, '_flash_fwd') == 'cpu'
          else flash_fwd)
    return fn(q, k, v, causal, q_off, kv_valid, kmask, drop_rate, seed)


def _flash_bwd(q, k, v, g, out, lse, causal, q_off=0, kv_valid=None,
               kmask=None, drop_rate=0.0, seed=None):
    """The backward of ``_flash_fwd``: delta = rowsum(out * dO) in f32,
    then kernels 2 and 3 for a CUDA tensor (the twin for a CPU tensor)
    -> (dq, dk, dv)."""
    delta = bwd_delta(out, g)
    args = (causal, q_off, kv_valid, kmask, drop_rate, seed)
    if _on(q, '_flash_bwd') == 'cpu':
        return flash_bwd_reference(q, k, v, g, lse, delta, *args)
    g = g.to(q.dtype)
    # a broadcast dO (a zero stride) is copied out too: kernel 3's TMA
    # tensor maps describe real strides
    if g.stride(3) != 1 or not _rows_aligned(g) or 0 in g.stride()[:3]:
        g = g.contiguous()
    dq = flash_bwd_dq(q, k, v, g, lse, delta, *args)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, *args)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Kernel 1 with kernels 2 and 3 as its backward (the reference's
    ``_flash`` custom_vjp). The forward saves q, k, v, out and lse (the
    mask and the seed ride on ``ctx``); the key mask and the seed get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, causal, q_off, kv_valid, drop_rate,
                seed):
        out, lse = _flash_fwd(q, k, v, causal, q_off, kv_valid, kmask,
                              drop_rate, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_off, kv_valid, kmask, drop_rate, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, g, out, lse, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def decode_attention(q, k_cache, v_cache, pos):
    """Attention of q rows at positions pos.. against a dense cache (raw
    [B,S_max,H_kv,D], or int8 banks): kernel 4 or 5 for a CUDA tensor,
    its twin for a CPU tensor."""
    int8 = is_weight_only(k_cache)
    if _on(q, 'decode_attention') == 'cpu':
        return (flash_decode_int8_reference if int8
                else flash_decode_reference)(q, k_cache, v_cache, pos)
    return (flash_decode_int8 if int8 else flash_decode)(
        q, k_cache, v_cache, pos)


def flash_attention(q, k, v, causal=False, mask=None, dropout_rate=0.0,
                    dropout_seed=None):
    """q: [B, S_q, H, D]; k/v: [B, S_k, H_kv, D] -> [B, S_q, H, D],
    differentiable (kernels 2 and 3 on the card, their twin on the CPU).

    ``mask``: optional key-padding mask, bool (True = attend) or additive,
    shaped [S_k], [B, S_k], [B, 1, S_k] or [B, 1, 1, S_k]. Causal
    cross-attention uses aligned ends (query i attends keys <= S_k - S_q + i).
    ``dropout_rate``/``dropout_seed``: attention dropout on the
    post-softmax probabilities (inverted scaling), the mask a counter hash
    of (seed, row b*H + h, q row, key) that the backward regenerates;
    ``dropout_seed`` is a u32 (an int, or an integer tensor of one value).

    Routing. Kernel 1 (its twin on the CPU) takes every call except those
    the reference sends to its plain path for a reason of meaning, which
    take ``attention_reference`` here too: causal with S_q > S_k (rows
    before the first key), and a per-head or dense mask. (The third such
    case, ``use_flash=False``, never calls this function: the model's
    ``_attention`` runs the reference's own einsum path.) The reference's
    TPU limits (S_k >= 128, head dim 64/128/256 on its platform) are not
    carried over: the twin takes any shape, and on the card a head dim
    without a kernel instance raises."""
    drop = _check_dropout(dropout_rate, dropout_seed)
    seed = int(_u32(dropout_seed)) if drop else None
    b, s_q = int(q.shape[0]), int(q.shape[1])
    s_k = int(k.shape[1])
    if ((mask is not None and not _key_mask_normalizable(mask, b, s_k))
            or (causal and s_q > s_k)):
        return attention_reference(q, k, v, causal, mask, drop, seed)
    kmask = _normalize_key_mask(mask, b, s_k) if mask is not None else None
    q_off = (s_k - s_q) if causal else 0
    return _Flash.apply(q, k, v, kmask, causal, q_off, None, drop, seed)
