"""Paged attention: attention of q rows over the paged KV cache.

Port of ``paddle_tpu/ops/paged_attention.py``. The continuous-batching
engine (serving/generation.py) stores each slot's KV rows in
non-contiguous fixed-size pages (ops/paged_kv.py). This module attends q
rows to that paged cache three ways:

 - ``paged_flash_decode`` and ``paged_flash_decode_int8``: the
   hand-written Hopper kernels (``csrc/paged_decode.cu``), replacing the
   Pallas TPU kernels ``_paged_decode_kernel`` (kernel 6, bf16/f32 pages)
   and ``_paged_decode_kernel_int8`` (kernel 7, int8 pages with per-row f32
   scales). They read each page straight out of the pool through the page
   table and never materialize the gathered cache. Both kernels have three
   instances, which the C entry point picks by T, q's dtype, the page dtype
   and the head dim (``paged_instance`` mirrors the rule): the split-K
   decode for T <= 16 (``split_plan`` sizes its splits and partial
   buffers), the tensor-core prefill for bf16 q at D 64/128 over pages a
   multiple of 64 rows, and the CUDA-core kernel for the rest;
 - ``paged_decode_reference`` and ``paged_decode_int8_reference``: their
   plain PyTorch twins, the same arithmetic (per-page online softmax, p
   rounded to V's dtype before p.V; int8 rows cast to q's dtype, the k
   scale on the score after the dot, the v scale into p before p is
   rounded) in ordinary tensor ops; ``chunk=64`` updates the softmax per
   64-key chunk of a page, as the CUDA-core kernel does, and
   ``paged_decode_split_reference`` is the split-K instance's twin
   (per-split partials merged by log-sum-exp);
 - ``paged_attention_fallback``: the reference's gather-then-softmax
   path, op for op (kept for parity with the reference's own fallback).

``paged_attention`` dispatches on the tensor's device: a CPU tensor runs
the twin, a CUDA tensor launches the kernel (or the wrapper raises), and
anything else raises. There is no silent fallback on the card.

Prefill padding. The engine pads each prompt to ``prefill_width`` rows and
passes the real length per slot as ``valid`` ([B] int32, on the device).
Given it, the kernels and the twins write zeros to the rows
``t >= valid[b]``, and the kernels skip the q tiles that hold only such
rows; the rows below ``valid[b]`` are computed as without it. Nothing reads
a padding row's output: the engine's first token comes from row
``valid - 1``, and padding rows' K/V land in the trash page.

Differences from the TPU kernel's gate (``paged_attention_available``):
the TPU limits its kernel to T <= 128 q rows (its 128-row q tile) and to
page sizes that are multiples of 128, so on the TPU an engine prefill
(``prefill_width`` rows, default ``max_seq_len``) took the gather
fallback. These kernels take every T and page size, so on the card every
attention call of the engine, prefill and decode, is a kernel launch. Head
dims are 64, 128 and 256, dtypes float32 and bfloat16; the pool must have
q's dtype, or be int8 banks.

``pos`` is a PER-SLOT [B] int32 vector (slots decode at different depths);
q row j of slot b attends virtual positions <= pos[b] + j. Inference only
(no backward).
"""
import ctypes
import math

import torch

from . import _build
from .flash_attention import _EPS, _NEG_INF, INSTANCE, _count, repeat_kv
from .paged_kv import gather_virtual
from .weight_only import dequantize_kv, is_weight_only

HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_MAX_T = 16        # T at or below takes the split-K decode
PREFILL_BK = 64         # the tensor-core prefill's chunk: pages a multiple
CHUNK = 64              # the CUDA-core kernel's keys a softmax update
SPLIT_BLOCKS_PER_SM = 8  # split-K: blocks aimed at per SM

_lib = None
_sms = {}
_ticket_bufs = {}


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load('paged_decode')
        # pointers (kernel 7: + the scales), ints, the instance, the stream
        for fn, n_ptr in (('paged_decode', 11), ('paged_decode_int8', 13)):
            getattr(lib, fn).argtypes = (
                [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 11
                + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
            getattr(lib, fn).restype = ctypes.c_int
        lib.paged_decode_error_string.argtypes = [ctypes.c_int]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _paged_partial(q, k_pages, v_pages, page_table, pos, ks, vs, p_lo,
                   p_hi, chunk=None, n_keys=None):
    """The online-softmax state (m, l, acc) [B, H, T, 1 / 1 / D] f32 of q's
    rows over pages ``p_lo <= p < p_hi`` of each slot, in order, stopping at
    the slot's last needed page; (m, l, acc) start at (-1e30, 0, 0). The
    state is updated once per page, or once per ``chunk`` keys of a page;
    keys at or past ``n_keys`` are masked. Also returns each slot's needed
    page count [B]."""
    int8 = ks is not None
    b, t, h, d = q.shape
    _, ps, h_kv, _ = k_pages.shape
    p_max = int(page_table.shape[1])
    g = h // h_kv
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    step = chunk or ps
    qf = q.float().permute(0, 2, 1, 3)                        # [B,H,T,D]
    pos_l = pos.to(dev).long()
    table = page_table.to(dev).long()
    needed = torch.clamp((pos_l + t + ps - 1) // ps, max=p_max)   # [B]
    q_pos = pos_l[:, None, None, None] + torch.arange(
        t, device=dev)[None, None, :, None]                   # [B,1,T,1]
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, t, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t, 1), dtype=torch.float32, device=dev)
    def heads(x):                     # [B, ps, Hkv, ..] -> [B, H, ps, ..]
        x = x.transpose(1, 2)
        return torch.repeat_interleave(x, g, dim=1) if g > 1 else x

    for p in range(p_lo, min(p_hi, int(needed.max()))):
        pid = table[:, p]
        kb, vb = heads(k_pages[pid]), heads(v_pages[pid])     # [B,H,ps,D]
        if int8:
            kb, vb = kb.to(q.dtype), vb.to(q.dtype)
        s = (qf @ kb.float().transpose(-1, -2)) * scale       # [B,H,T,ps]
        if int8:
            s = s * heads(ks[pid])[:, :, None, :]
            v_scale = heads(vs[pid])[:, :, None, :]
        k_pos = p * ps + torch.arange(ps, device=dev)
        seen = k_pos <= q_pos
        if n_keys is not None:
            seen = seen & (k_pos < n_keys)
        s = torch.where(seen, s, _NEG_INF)
        live = (p < needed)[:, None, None, None]
        for c0 in range(0, ps, step):
            c = slice(c0, c0 + step)
            m_new = torch.maximum(m, s[..., c].amax(dim=-1, keepdim=True))
            pr = torch.exp(s[..., c] - m_new)
            alpha = torch.exp(m - m_new)
            l_new = l * alpha + pr.sum(dim=-1, keepdim=True)
            if int8:
                pr = pr * v_scale[..., c]
            acc_new = (acc * alpha
                       + pr.to(vb.dtype).float() @ vb[:, :, c].float())
            acc = torch.where(live, acc_new, acc)
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
    return m, l, acc, needed


def _zero_past(out, valid):
    """``out`` [B, T, H, D] with rows t >= valid[b] set to zero."""
    if valid is None:
        return out
    keep = (torch.arange(out.shape[1], device=out.device)[None, :]
            < valid.to(out.device).long()[:, None])           # [B, T]
    return torch.where(keep[:, :, None, None], out, torch.zeros(
        (), dtype=out.dtype, device=out.device))


def paged_decode_reference(q, k_pages, v_pages, page_table, pos, ks=None,
                           vs=None, valid=None, chunk=None):
    """Plain PyTorch twin of kernel 6 (the TPU's ``_paged_decode_kernel``),
    and of kernel 7 with the int8 pages' scales ``ks``/``vs``
    ([N, page_size, H_kv] f32): pages are visited in order, each slot
    stops at its last needed page ``min(ceil((pos+T)/ps), P_max)``, and
    the online-softmax state (m, l, acc) is updated once per page in f32
    (once per ``chunk`` keys of a page with ``chunk``: the CUDA-core
    kernel's 64). Scores are f32 dots times 1/sqrt(D) (int8: times the k
    scale, after the dot), masked with -1e30; l sums the unrounded p,
    while p.V uses p (int8: times the v scale) rounded to V's dtype (int8:
    q's dtype, the int8 values cast to it). Rows t >= valid[b] are zeros.

    q: [B, T, H, D]; pages [N, page_size, H_kv, D]; page_table [B, P_max]
    int; pos [B] int; valid [B] int or None -> [B, T, H, D] in q's
    dtype."""
    _, l, acc, _ = _paged_partial(q, k_pages, v_pages, page_table, pos, ks,
                                  vs, 0, int(page_table.shape[1]), chunk)
    out = acc / torch.clamp(l, min=_EPS)
    return _zero_past(out.to(q.dtype).permute(0, 2, 1, 3), valid)


def paged_decode_int8_reference(q, k_bank, v_bank, page_table, pos,
                                valid=None):
    """Plain twin of kernel 7 over int8 banks ``{'int8': [N, page_size,
    H_kv, D] int8, 'scale': [N, page_size, H_kv] f32}``."""
    return paged_decode_reference(q, k_bank['int8'], v_bank['int8'],
                                  page_table, pos, k_bank['scale'],
                                  v_bank['scale'], valid)


def paged_instance(dtype, t, d, page_size, page_dtype):
    """The instance kernels 6 and 7 take in the C entry point for q of
    ``dtype`` with ``t`` rows and head dim ``d`` over pages of
    ``page_size`` rows of ``page_dtype``: 'split-k' for T <= 16,
    'tensor-core' for bf16 q at D 64/128 over bf16 or int8 pages a multiple
    of 64 rows, else 'cuda-core'. Kernels 4 and 5 take the same rule over
    their implicit pages, with S_max for ``page_size``."""
    if t <= SPLIT_MAX_T:
        return 'split-k'
    if (dtype == torch.bfloat16 and page_dtype in (torch.bfloat16, torch.int8)
            and d in (64, 128) and page_size % PREFILL_BK == 0):
        return 'tensor-core'
    return 'cuda-core'


def split_plan(b, t, h, h_kv, d, p_max, sms):
    """The split-K decode's launch plan, from shapes and the card's SM
    count only (never from pos, which stays on the device): about
    SPLIT_BLOCKS_PER_SM blocks an SM over the B x H_kv (slot, kv head)
    pairs, at most one split a page; the pages of a slot are cut into
    ``n_split`` runs of ``pages_per_split``, the last possibly shorter. ->
    dict of n_split, pages_per_split and the shapes of the partial buffers
    (f32): m and l [B * T * H, n_split], acc [B * T * H, n_split, D]."""
    want = -(-SPLIT_BLOCKS_PER_SM * sms // max(1, b * h_kv))
    n = max(1, min(p_max, want))
    pps = -(-p_max // n)
    n = -(-p_max // pps)
    rows = b * t * h
    return {'n_split': n, 'pages_per_split': pps, 'm': (rows, n),
            'l': (rows, n), 'acc': (rows, n, d)}


def paged_decode_split_reference(q, k_pages, v_pages, page_table, pos,
                                 n_split, pages_per_split, valid=None,
                                 n_keys=None):
    """Plain twin of the split-K instance of kernels 6 and 7: each split's
    (m, l, acc) over its pages ``[i * pages_per_split, (i + 1) *
    pages_per_split)`` (as ``paged_decode_reference`` computes them, from
    a fresh state), then the splits that start before the slot's last
    needed page merged by log-sum-exp: out = sum_i w_i acc_i /
    max(sum_i w_i l_i, 1e-30), w_i = exp(m_i - max_j m_j). The pools are
    bf16/f32 pages or int8 banks; keys at or past ``n_keys`` are masked;
    rows t >= valid[b] are zeros. Same result as
    ``paged_decode_reference`` / ``paged_decode_int8_reference``."""
    ks = vs = None
    if is_weight_only(k_pages):
        ks, vs = k_pages['scale'], v_pages['scale']
        k_pages, v_pages = k_pages['int8'], v_pages['int8']
    parts = []
    needed = None
    for i in range(n_split):
        m, l, acc, needed = _paged_partial(
            q, k_pages, v_pages, page_table, pos, ks, vs,
            i * pages_per_split, (i + 1) * pages_per_split, n_keys=n_keys)
        parts.append((m, l, acc))
    m = torch.stack([x[0] for x in parts])              # [S,B,H,T,1]
    l = torch.stack([x[1] for x in parts])
    acc = torch.stack([x[2] for x in parts])
    starts = torch.arange(n_split, device=q.device) * pages_per_split
    live = (starts[:, None] < needed[None, :])[:, :, None, None, None]
    m = torch.where(live, m, -math.inf)
    w = torch.exp(m - m.amax(dim=0, keepdim=True))      # dead splits: 0
    den = (w * l).sum(0)
    out = (w * acc).sum(0) / torch.clamp(den, min=_EPS)
    return _zero_past(out.to(q.dtype).permute(0, 2, 1, 3), valid)


def _sm_count(dev):
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _tickets(dev, n):
    """At least ``n`` int32 zeros on ``dev`` for the split-K decode's merge
    on the current stream, kept across calls (each launch leaves them zero;
    one buffer a stream, so launches that may overlap never share one). A
    buffer outgrown by a larger launch stays allocated: a captured CUDA
    graph may hold its address."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    bufs = _ticket_bufs.setdefault(key, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 1024), dtype=torch.int32,
                                device=dev))
    return bufs[-1]


def split_scratch(b, t, h, h_kv, d, p_max, dev):
    """The split-K instance's launch arguments on ``dev``: (the m, l, acc
    partial buffers' and the tickets' pointers, n_split, pages_per_split,
    the tensors to keep alive until the launch is queued)."""
    plan = split_plan(b, t, h, h_kv, d, p_max, _sm_count(dev))
    sizes = [math.prod(plan[k]) for k in ('m', 'l', 'acc')]
    # one allocation; freed on return while the kernels may still run,
    # which is safe: the caching allocator hands the memory only to later
    # work on this stream
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    tickets = _tickets(dev, b * h_kv)
    ptrs = (buf.data_ptr(), buf[sizes[0]:].data_ptr(),
            buf[sizes[0] + sizes[1]:].data_ptr(), tickets.data_ptr())
    return ptrs, plan['n_split'], plan['pages_per_split'], (buf, tickets)


def _check_kernel_args(q, k_pages, v_pages, page_table, pos, ks=None,
                       vs=None, valid=None):
    op = 'paged_flash_decode_int8' if ks is not None else 'paged_flash_decode'
    if q.device.type != 'cuda':
        raise ValueError(f'{op} needs CUDA tensors, q is on {q.device}')
    for name, x in (('k_pages', k_pages), ('v_pages', v_pages),
                    ('page_table', page_table), ('pos', pos)):
        if x.device != q.device:
            raise ValueError(f'{name} is on {x.device}, q on {q.device}')
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError('q must be [B,T,H,D] and pages [N,page_size,H_kv,D]')
    b, t, h, d = q.shape
    n, ps, h_kv, dk = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError('k_pages and v_pages differ in shape')
    if dk != d or d not in HEAD_DIMS:
        raise ValueError(f'head_dim {d} (pages {dk}) not in {HEAD_DIMS}')
    if h_kv == 0 or h % h_kv:
        raise ValueError(f'kv heads {h_kv} must divide q heads {h}')
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f'q dtype {q.dtype} not in float32/bfloat16')
    want = torch.int8 if ks is not None else q.dtype
    if k_pages.dtype != want or v_pages.dtype != want:
        raise ValueError(f'the pools must have dtype {want}')
    if ks is not None:
        for name, x in (('k scale', ks), ('v scale', vs)):
            if (x.dtype != torch.float32 or x.device != q.device
                    or tuple(x.shape) != (n, ps, h_kv)
                    or not x.is_contiguous()):
                raise ValueError(f'{name} must be contiguous f32 [N, '
                                 "page_size, H_kv] on q's device")
    if (page_table.dtype != torch.int32 or page_table.dim() != 2
            or page_table.shape[0] != b):
        raise ValueError('page_table must be int32 [B, P_max]')
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b,):
        raise ValueError('pos must be int32 [B]')
    if valid is not None and (
            valid.dtype != torch.int32 or tuple(valid.shape) != (b,)
            or valid.device != q.device or not valid.is_contiguous()):
        raise ValueError("valid must be a contiguous int32 [B] on q's device")
    for name, x in (('q', q), ('k_pages', k_pages), ('v_pages', v_pages),
                    ('page_table', page_table), ('pos', pos)):
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    for name, x in (('q', q), ('k_pages', k_pages), ('v_pages', v_pages)):
        if x.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')


def _paged_launch(q, k_pages, v_pages, page_table, pos, ks=None, vs=None,
                  valid=None):
    """Check the arguments and launch kernel 6, or kernel 7 with the int8
    pages' scales ``ks``/``vs``; raises on a refused launch. -> (out, the
    instance the library ran: 'cuda-core', 'split-k' or 'tensor-core')."""
    _check_kernel_args(q, k_pages, v_pages, page_table, pos, ks, vs, valid)
    lib = _kernel_lib()
    b, t, h, d = q.shape
    n_pages, ps, h_kv, _ = k_pages.shape
    p_max = int(page_table.shape[1])
    out = torch.empty_like(q)
    inst = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # the split-K instance's partial buffers (T <= 16)
        scratch, n_split, pps, keep = (0, 0, 0, 0), 0, 0, None
        if paged_instance(q.dtype, t, d, ps, k_pages.dtype) == 'split-k':
            scratch, n_split, pps, keep = split_scratch(
                b, t, h, h_kv, d, p_max, q.device)
        scales = () if ks is None else (ks.data_ptr(), vs.data_ptr())
        op = 'paged_decode' if ks is None else 'paged_decode_int8'
        err = getattr(lib, op)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
            page_table.data_ptr(), pos.data_ptr(),
            0 if valid is None else valid.data_ptr(), out.data_ptr(),
            *scratch, b, t, h, h_kv, d, ps, p_max, n_pages, n_split, pps,
            _DTYPE_CODE[q.dtype], ctypes.byref(inst), stream)
        del keep
    if err != 0:
        msg = lib.paged_decode_error_string(err).decode()
        raise RuntimeError(f'{op} launch failed ({err}): {msg}')
    return out, INSTANCE[inst.value]


def paged_flash_decode(q, k_pages, v_pages, page_table, pos, valid=None):
    """Kernel 6 on the card. q: [B,T,H,D]; pages [N, page_size, H_kv, D]
    in q's dtype (one layer of the pool, read in place); page_table
    [B, P_max] int32; pos [B] int32; valid [B] int32 (rows t >= valid[b]
    come out zero) or None -> [B,T,H,D]. Launches on the current stream
    without synchronising; raises on arguments the kernel does not take and
    on a refused launch. ``paged_flash_decode.launches`` counts launches;
    ``split_launches`` and ``tc_launches`` those that ran the split-K decode
    and the tensor-core prefill (``paged_instance``)."""
    out, inst = _paged_launch(q, k_pages, v_pages, page_table, pos,
                              valid=valid)
    _count(paged_flash_decode, inst)
    return out


paged_flash_decode.launches = 0
paged_flash_decode.split_launches = 0
paged_flash_decode.tc_launches = 0


def paged_flash_decode_int8(q, k_bank, v_bank, page_table, pos, valid=None):
    """Kernel 7 on the card: ``paged_flash_decode`` over int8 banks
    ``{'int8': [N, page_size, H_kv, D] int8, 'scale': [N, page_size, H_kv]
    f32}`` (one layer of the pool, read in place); q and the output in
    float32 or bfloat16. Counters as ``paged_flash_decode``'s."""
    out, inst = _paged_launch(q, k_bank['int8'], v_bank['int8'], page_table,
                              pos, k_bank['scale'], v_bank['scale'], valid)
    _count(paged_flash_decode_int8, inst)
    return out


paged_flash_decode_int8.launches = 0
paged_flash_decode_int8.split_launches = 0
paged_flash_decode_int8.tc_launches = 0


def paged_attention_fallback(q, k_pages, v_pages, page_table, pos, cdt):
    """The reference's gather path, op for op: gather each slot's virtual
    dense cache through the page table (int8 banks dequantized to the
    compute dtype), then einsum in the compute dtype, f32 masked softmax,
    cast back."""
    kc = gather_virtual(k_pages, page_table)
    vc = gather_virtual(v_pages, page_table)
    if is_weight_only(kc):
        kc = dequantize_kv(kc['int8'], kc['scale'], cdt)
        vc = dequantize_kv(vc['int8'], vc['scale'], cdt)
    kc, vc = repeat_kv(kc, vc, int(q.shape[2]))
    B, T = q.shape[:2]
    S = kc.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum('bqhd,bkhd->bhqk', q, kc) * scale          # [B,H,T,S]
    q_pos = (pos.long()[:, None, None]
             + torch.arange(T, device=q.device)[None, :, None])  # [B,T,1]
    k_pos = torch.arange(S, device=q.device)[None, None, :]      # [1,1,S]
    mask = (k_pos <= q_pos)[:, None]                             # [B,1,T,S]
    s = torch.where(mask, s.float(), _NEG_INF)
    p = torch.softmax(s, dim=-1).to(cdt)
    return torch.einsum('bhqk,bkhd->bqhd', p, vc)


def paged_attention(q, k_pages, v_pages, page_table, pos, valid=None):
    """Attention over a paged KV pool, dispatched on q's device: the plain
    twin for a CPU tensor, the Hopper kernel for a CUDA tensor.

    q: [B, T, H, D]; pools: [N, page_size, H_kv, D] tensors (kernel 6) or
    int8 banks (kernel 7); page_table: [B, P_max] int32; pos: [B] int32
    (first q row's absolute position per slot); valid: [B] int32 real rows
    per slot (rows t >= valid[b] come out zero), or None -> [B, T, H, D]."""
    int8 = is_weight_only(k_pages)
    if q.device.type == 'cpu':
        return (paged_decode_int8_reference if int8
                else paged_decode_reference)(q, k_pages, v_pages, page_table,
                                             pos, valid=valid)
    if q.device.type == 'cuda':
        return (paged_flash_decode_int8 if int8 else paged_flash_decode)(
            q, k_pages, v_pages, page_table, pos, valid)
    raise ValueError(f'paged_attention runs on cuda or cpu, not {q.device}')
