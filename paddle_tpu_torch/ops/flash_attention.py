"""Flash attention: the attention forward and the dense KV-cache decode.

Port of ``paddle_tpu/ops/flash_attention.py`` for inference. Three TPU
kernels of the reference become hand-written Hopper kernels, each beside
its plain PyTorch twin:

 - kernel 1, ``_fwd_kernel`` (attention forward with its log-sum-exp):
   ``_flash_fwd`` launches ``csrc/flash_fwd.cu``; twin
   ``flash_fwd_reference``;
 - kernel 4, ``_decode_kernel`` (q rows against a dense KV cache up to a
   device-side position): ``flash_decode`` launches
   ``csrc/flash_decode.cu``; twin ``flash_decode_reference``;
 - kernel 5, ``_decode_kernel_int8`` (the same over int8 cache banks):
   ``flash_decode_int8``, same source; twin
   ``flash_decode_int8_reference``.

The dispatching entries (``flash_attention``, ``_flash_fwd``,
``decode_attention``) pick by q's device, as ``ops/paged_attention.py``
does: a CPU tensor runs the twin, a CUDA tensor launches the kernel or the
wrapper raises, anything else raises. The kernel wrappers (``flash_fwd``,
``flash_decode``, ``flash_decode_int8``) take CUDA tensors only. There is
no fallback from the card to the twin.

The twins repeat the Pallas kernels' arithmetic, so the CPU tests hold
them to the reference in interpret mode at f32 rounding: the online
softmax state (m, l, acc) is updated once per key block of the
reference's block size (``_pick_blocks`` for the forward, ``_decode_bk``
for decode); scores are f32 dots times 1/sqrt(D), masked with -1e30; l
sums the unrounded p while p.V uses p rounded to V's dtype; the
normalizer is floored at 1e-30. The kernels tile differently and are held
to the twins by tolerance.

The port needs no padding to block multiples (the reference's
``_pad_seq``): the kernels and the twins mask the ragged edge of the key
range themselves. Attention dropout (``dropout_rate > 0``) comes with the
training slice and raises here.
"""
import ctypes
import math

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

_TRAINING_TODO = ('attention dropout comes with the training slice (ROADMAP '
                  'Queue 1 item 4: kernel 1 dropout with kernels 2 and 3)')


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

def attention_reference(q, k, v, causal, mask=None):
    """The reference's plain softmax attention (``_jnp_attention``, without
    dropout), [B,S,H,D] layout: scores in q's dtype, then f32 with causal
    (aligned ends: query i sees keys <= S_k - S_q + i) and mask applied,
    softmax in f32, p cast to V's dtype for p.V."""
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
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', p, v)


def _online_update(m, l, s):
    """One key block of the online softmax over the block's masked f32
    scores ``s`` [.., rows, keys]: -> (m_new, l_new, p, alpha), where l
    sums the unrounded p and the caller adds p.V to ``acc * alpha``."""
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    return m_new, l * alpha + p.sum(dim=-1, keepdim=True), p, alpha


def flash_fwd_reference(q, k, v, causal, q_off=0, kv_valid=None,
                        kmask=None):
    """Plain twin of kernel 1 (the reference's ``_fwd_kernel``).

    q [B,S_q,H,D], k/v [B,S_k,H_kv,D] (H_kv divides H; head h reads kv
    head h // (H / H_kv)); ``causal``: query row i sees keys <= i + q_off;
    ``kv_valid``: keys >= kv_valid are masked; ``kmask``: additive f32
    [B, S_k] or None. Blocks are the reference's (``_pick_blocks``): each
    q block visits the key blocks the reference visits and updates the
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
    outs, lses = [], []
    for q0 in range(0, s_q, bq):
        q1 = min(s_q, q0 + bq)
        n_iter = n_valid
        if causal:
            n_iter = min(n_iter, (q0 + bq + q_off + bk - 1) // bk)
        rows = q1 - q0
        acc = torch.zeros((b, h, rows, d), dtype=torch.float32, device=dev)
        m = torch.full((b, h, rows, 1), _NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, rows, 1), dtype=torch.float32, device=dev)
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
            vb = vt[:, :, c0:c1]
            acc = acc * alpha + p.to(vb.dtype).float() @ vb.float()
        outs.append(acc / torch.clamp(l, min=_EPS))
        lses.append((m + torch.log(torch.clamp(l, min=_EPS)))[..., 0])
    out = torch.cat(outs, dim=2).to(q.dtype).permute(0, 2, 1, 3)
    return out, torch.cat(lses, dim=2)


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


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# pointers, element strides, ints, then the stream (csrc/*.cu, extern "C")
_DECODE_ARGS = [_P] * 8 + [_I64] * 6 + [_I32] * 7 + [_P]
_ENTRY_POINTS = {
    'flash_decode': {'flash_decode': _DECODE_ARGS,
                     'flash_decode_int8': _DECODE_ARGS},
    'flash_fwd': {'flash_fwd': [_P] * 6 + [_I64] * 7 + [_I32] * 9 + [_P]},
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


def _check_rows(name, x, dev):
    """A [B, S, H, D] operand the kernels read row by row: on ``dev``, the
    head dim contiguous, and every row 16-byte aligned."""
    if x.device != dev:
        raise ValueError(f'{name} is on {x.device}, q on {dev}')
    if x.dim() != 4 or x.stride(3) != 1:
        raise ValueError(f'{name} must be [B, S, H, D] with a contiguous '
                         'head dim')
    es = x.element_size()
    if x.data_ptr() % 16 or any((st * es) % 16 for st in x.stride()[:3]):
        raise ValueError(f'{name} rows must be 16-byte aligned')


def _check_q(q, op):
    if q.device.type != 'cuda':
        raise ValueError(f'{op} needs CUDA tensors, q is on {q.device}')
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f'q dtype {q.dtype} not in float32/bfloat16')
    if int(q.shape[-1]) not in HEAD_DIMS:
        raise ValueError(f'head_dim {int(q.shape[-1])} not in {HEAD_DIMS}')


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


def _decode_launch(q, k, v, pos, ks=None, vs=None):
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
    fn = lib.flash_decode_int8 if ks is not None else lib.flash_decode
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 0 if ks is None else ks.data_ptr(),
                 0 if vs is None else vs.data_ptr(),
                 pos_t.data_ptr(), out.data_ptr(), None,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 b, t, h, h_kv, d, s_max, _DTYPE_CODE[q.dtype],
                 _stream(dev))
    _launch_done(lib, err, op)
    return out


def flash_decode(q, k_cache, v_cache, pos):
    """Kernel 4 on the card. q [B,T,H,D] (any T; rows may be strided views
    with a contiguous head dim); caches [B,S_max,H_kv,D] in q's dtype, read
    in place (one layer's view of the [L,B,S_max,H_kv,D] cache); ``pos`` an
    int32 [1] tensor on the card (an int is copied over) -> [B,T,H,D].
    Launches on the current stream without synchronising; raises on
    arguments the kernel does not take. ``flash_decode.launches`` counts
    launches."""
    out = _decode_launch(q, k_cache, v_cache, pos)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_int8(q, k_bank, v_bank, pos):
    """Kernel 5 on the card: ``flash_decode`` over int8 banks
    ``{'int8': [B,S_max,H_kv,D] int8, 'scale': [B,S_max,H_kv] f32}``.
    ``flash_decode_int8.launches`` counts launches."""
    out = _decode_launch(q, k_bank['int8'], v_bank['int8'], pos,
                         k_bank['scale'], v_bank['scale'])
    flash_decode_int8.launches += 1
    return out


flash_decode_int8.launches = 0


def flash_fwd(q, k, v, causal, q_off=0, kv_valid=None, kmask=None):
    """Kernel 1 on the card. q [B,S_q,H,D], k/v [B,S_k,H_kv,D] (strided
    views with a contiguous head dim are read in place, as ``_block_qkv``
    returns them); ``kmask`` additive f32 [B, S_k] (a zero batch stride
    broadcasts one row) -> (out [B,S_q,H,D] contiguous in q's dtype,
    lse [B,H,S_q] f32). ``flash_fwd.launches`` counts launches."""
    _check_q(q, 'flash_fwd')
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
    n_keys = s_k if kv_valid is None else max(0, min(s_k, int(kv_valid)))
    lib = _kernel_lib('flash_fwd')
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if kmask is None else kmask.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            0 if kmask is None else kmask.stride(0),
            b, s_q, h, h_kv, d, n_keys, int(bool(causal)), int(q_off),
            _DTYPE_CODE[q.dtype], _stream(dev))
    _launch_done(lib, err, 'flash_fwd')
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _on(q, op):
    """'cpu' or 'cuda' for q's device; raises for any other."""
    if q.device.type in ('cpu', 'cuda'):
        return q.device.type
    raise ValueError(f'{op} runs on cuda or cpu, not {q.device}')


def _flash_fwd(q, k, v, causal, q_off=0, kv_valid=None, kmask=None):
    """Kernel 1 for a CUDA tensor, its twin for a CPU tensor. [B,S,H,D]
    layout -> (out [B,S_q,H,D], lse [B,H,S_q] f32)."""
    if _on(q, '_flash_fwd') == 'cpu':
        return flash_fwd_reference(q, k, v, causal, q_off, kv_valid, kmask)
    return flash_fwd(q, k, v, causal, q_off, kv_valid, kmask)


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
    """q: [B, S_q, H, D]; k/v: [B, S_k, H_kv, D] -> [B, S_q, H, D].

    ``mask``: optional key-padding mask, bool (True = attend) or additive,
    shaped [S_k], [B, S_k], [B, 1, S_k] or [B, 1, 1, S_k]. Causal
    cross-attention uses aligned ends (query i sees keys <= S_k - S_q + i).

    Routing. Kernel 1 (its twin on the CPU) takes every call except those
    the reference sends to its plain path for a reason of meaning, which
    take ``attention_reference`` here too: causal with S_q > S_k (rows
    before the first key), and a per-head or dense mask. (The third such
    case, ``use_flash=False``, never calls this function: the model's
    ``_attention`` runs the reference's own einsum path.) The reference's
    TPU limits (S_k >= 128, head dim 64/128/256 on its platform) are not
    carried over: the twin takes any shape, and on the card a head dim
    without a kernel instance raises."""
    if dropout_rate:
        raise NotImplementedError(_TRAINING_TODO)
    b, s_q = int(q.shape[0]), int(q.shape[1])
    s_k = int(k.shape[1])
    if ((mask is not None and not _key_mask_normalizable(mask, b, s_k))
            or (causal and s_q > s_k)):
        return attention_reference(q, k, v, causal, mask)
    kmask = _normalize_key_mask(mask, b, s_k) if mask is not None else None
    q_off = (s_k - s_q) if causal else 0
    out, _ = _flash_fwd(q, k, v, causal, q_off=q_off, kmask=kmask)
    return out
