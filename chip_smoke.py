#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--report PATH]

Phases, all of them on every run, in order; any failure raises and exits
non-zero:
 1. the card: nvidia-smi name and power limit, torch's device name/count;
 2. build every kernel of the port from the sources in the checkout, one
    nvcc (sm_90a) for each source, all started together; print the build
    time and ptxas report;
 3. each kernel against its plain PyTorch twin on the card, at the shapes
    its main path gives it, plus GQA, float32 and other head-dim cases;
    max abs error against the stated tolerance (scaled to each output
    row's size in bfloat16), kernel / plain / library times and the bound;
    for every kernel, which instance ran, failing when a case took another
    than the library's rule gives (kernel 1: tensor-core for bfloat16;
    kernels 2 and 3: tensor-core for bfloat16 at head dim 64 or 128;
    kernels 4-7: split-K for T <= 16, tensor-core for bfloat16 at head dim
    64 or 128 over pages (kernels 4 and 5: S_max) a multiple of 64 rows,
    CUDA-core otherwise):
    paged_decode and paged_decode_int8 (the engine's decode T=1 at ragged
    positions, prefill T=1024, and with 200 real rows; T 1-1024 at page-edge positions, GQA 4 and 2, head dims
    64/128/256, f32 q, pages of 512 and 1024 rows, prefills with valid <
    T whose padding rows must come out zero),
    flash_decode and flash_decode_int8
    (generate()'s decode step and prefill; every instance of kernel 4 with
    its bound and library time: split-K at T 1, 2, 16, tensor-core at T
    128, 300, 1000, CUDA-core for f32 at T > 16, S_max 1000 and head dim
    256; kernel 5's other instances),
    flash_fwd (forward() over
    [8, 1024], and with dropout 0.1), flash_bwd_dq and flash_bwd_dkv (the
    train step's backward over [8, 1024], and with dropout 0.1; library:
    PyTorch's own flash backward, for the two together);
 4. the serving path at full width: the bench GPT (vocab 32768, hidden
    1024, 24 layers, 16 heads, bf16, random weights from a seed) as a
    GPTForCausalLM in GenerationEngine(model, num_slots=8, page_size=128)
    answering 8 greedy requests with ragged prompts, first eager (a
    private switch, for the comparison only), then on its captured CUDA
    graphs (the prefill and the step, two captures at warmup and none from
    traffic); tokens/s, TTFT p50 and mean step of both, and their streams
    equal; every launch counter is set to 0 just before each run and read
    just after: paged_decode must equal 24 x (prefills + steps) under
    replay too, the 24 x prefills on the tensor-core instance and the
    24 x steps on the split-K one; the share of prefill q tiles the kernel
    skipped as padding; a profiled rerun of each;
 5. card against CPU at reduced depth (hidden 1024, 2 layers, float32), the
    engine at its default 1024-row prefill on both: prefill logits agree
    and greedy streams are equal;
 6. dense generate() at full width: the same bench GPT, 8 prompts of 128
    tokens (numpy seed), 128 greedy tokens, with the bf16 cache and with
    the int8 cache, each eager and on captured graphs (the prefill and one
    step replayed per token, captured by a warm-up call); tokens/s,
    prefill ms, mean step ms, a profiled window of decode steps for each;
    launches == 24 x 128 per run (kernels 4 and 5: the 24 prefill launches
    on the tensor-core instance, the 24 x 127 steps on the split-K one),
    captured and eager tokens equal, and the int8 run's prefill logits
    within cosine 0.999 of the bf16 run's;
 7. forward() on [8, 1024] (flash_fwd launches == 24), then generate() on
    8 prompts of 1000 tokens with 32 new, on graphs captured by a warm-up
    call: 25 cached tokens and 7 on the sliding window (flash_decode
    24 x 25, the 24 prefill launches tensor-core and the 24 x 24 steps
    split-K; flash_fwd 24 x 7 launches); every flash_fwd launch of both
    on the tensor-core instance;
 8. card against CPU at 2 layers in float32: greedy generate() streams
    equal on the dense, int8 and window-crossing paths, forward() logits
    within 1e-3;
 9. the engine over the int8 page pool (kv_cache_int8) at full width, the
    requests of phase 4, eager and captured as in phase 4:
    paged_decode_int8 launches == 24 x (prefills + steps), the
    24 x prefills on the tensor-core instance and the 24 x steps on the
    split-K instance; a profiled rerun's device time; int8 prefill logits
    within cosine 0.999 of a bf16 pool's;
10. the int8 engine card against CPU at 2 layers in float32: streams
    equal, or held to phase 8's int8 rule;
11. the single-device train step at full width (the bench rung: [8, 1024],
    bf16 over f32 params, AdamW(2e-4, weight_decay=0.01), remat 'dots',
    xent_chunk 8192, targets = tokens): 2 warm-up and 8 timed steps on one
    batch; tokens/s, step ms, MFU, peak memory, a profiled step; launches
    per step flash_fwd 48 (24 + 24 recomputed under remat), flash_bwd_dq
    24, flash_bwd_dkv 24, every flash_fwd, flash_bwd_dq and flash_bwd_dkv
    launch on the tensor-core instance; the loss finite and falling;
12. the train step card against CPU at 2 layers in float32: the first
    step's gradients and a 6-step loss curve, dropout 0 and 0.1.
Every launch counter is set to 0 just before each main-path run (phases 4,
6, 7, 9 and 11) and read just after. Then one line of kernel records (JSON), and
the last line ``{"ok": true, "device": {...}}``.

Without a CUDA card, or without the rest of the repository beside it, it
exits non-zero and prints no result.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # f32 outside the tensor cores
# kernel vs twin: the largest |got - want| of each output row (b, t, h) over
# that row's max |want|. The kernel repeats the twin's arithmetic and only
# sums in another order, so a bfloat16 output may land one rounding step
# away; 2**-6 is two bfloat16 ulps at the row's largest value. Rows that
# see hundreds of keys read ~0.05 while pos-0 rows read ~3, so one flat
# absolute limit would be loose for the first and tight for the second.
TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2e-5}
TIMED_ITERS = 240                  # launches per kernel timing
LAYERS = 24                        # timing rotates over one pool per layer,
                                   # as the engine does (each call finds its
                                   # pages cold in L2)


SOURCES = ('paged_decode', 'flash_decode', 'flash_fwd', 'flash_bwd')
SOURCE_OF = {   # kernel -> its source; kernels sharing a template share one
    'paged_decode': 'paddle_tpu_torch/csrc/paged_decode.cu',
    'paged_decode_int8': 'paddle_tpu_torch/csrc/paged_decode.cu',
    'flash_decode': 'paddle_tpu_torch/csrc/flash_decode.cu',
    'flash_decode_int8': 'paddle_tpu_torch/csrc/flash_decode.cu',
    'flash_fwd': 'paddle_tpu_torch/csrc/flash_fwd.cu',
    'flash_bwd_dq': 'paddle_tpu_torch/csrc/flash_bwd.cu',
    'flash_bwd_dkv': 'paddle_tpu_torch/csrc/flash_bwd.cu',
}
REPLACES = {    # the TPU kernel each one ports
    'paged_decode': 'paddle_tpu/ops/paged_attention.py:70',
    'paged_decode_int8': 'paddle_tpu/ops/paged_attention.py:119',
    'flash_decode': 'paddle_tpu/ops/flash_attention.py:825',
    'flash_decode_int8': 'paddle_tpu/ops/flash_attention.py:861',
    'flash_fwd': 'paddle_tpu/ops/flash_attention.py:236',
    'flash_bwd_dq': 'paddle_tpu/ops/flash_attention.py:427',
    'flash_bwd_dkv': 'paddle_tpu/ops/flash_attention.py:479',
}


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of fn(i) over ``iters`` calls (CUDA events)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, warmup=3):
    """Mean device time of fn(i) over ``iters`` calls: the summed duration
    of every kernel and copy the calls put on the card, from
    torch.profiler's CUDA activity. Unlike CUDA events around back-to-back
    calls it leaves out the gaps while the host prepares the next launch,
    which for a kernel of tens of microseconds can take longer than the
    kernel itself."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in p.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise AssertionError('the profiler saw no device time')
    return us / 1e3 / iters


# ---------------------------------------------------------------------------
# phase 3: paged-decode kernel against its twin
# ---------------------------------------------------------------------------

def make_case(b, t, h, h_kv, d, pos, dtype, ps=128, p_max=8, seed=0,
              int8=False, layers=LAYERS, valid=None):
    """q, ``layers`` page pools (int8 banks with ``int8``), a table of
    scattered pages, ``pos`` and ``valid`` (real rows per slot, or None),
    on the card. Entries past a slot's needed pages stay 0 (the trash
    page), as the engine leaves them."""
    from paddle_tpu_torch.ops.weight_only import quantize_kv
    g = torch.Generator(device='cuda').manual_seed(seed)
    n = b * p_max + 1
    q = torch.randn((b, t, h, d), generator=g, device='cuda').to(dtype)

    def pool():
        x = torch.randn((layers, n, ps, h_kv, d), generator=g, device='cuda')
        if int8:
            return dict(zip(('int8', 'scale'), quantize_kv(x)))
        return x.to(dtype)

    kp, vp = pool(), pool()
    perm = np.random.RandomState(seed).permutation(np.arange(1, n))
    table = np.zeros((b, p_max), np.int32)
    for i, p0 in enumerate(pos):
        need = min(-(-(p0 + t) // ps), p_max)
        table[i, :need] = perm[i * p_max:i * p_max + need]
    return dict(q=q, k=kp, v=vp, int8=int8,
                table=torch.from_numpy(table).cuda(),
                pos=torch.tensor(pos, dtype=torch.int32, device='cuda'),
                valid=(None if valid is None else torch.tensor(
                    valid, dtype=torch.int32, device='cuda')),
                ps=ps, p_max=p_max)


def bound(c):
    """Least time for the call: each input byte read once (the KV rows the
    slots' real rows can see, int8: a byte a value and an f32 scale a row,
    the real q rows, table, pos, valid), the output written once, and 4*D
    flops per (real row, visible key, head); the larger of bytes / HBM rate
    and operations / peak rate for the dtype."""
    q = c['q']
    b, t, h, d = q.shape
    kv = c['k']['int8'] if c['int8'] else c['k']
    h_kv = kv.shape[3]
    es = q.element_size()
    row = d * kv.element_size() + (4 if c['int8'] else 0)
    cap = c['p_max'] * c['ps']
    real = (c['valid'].tolist() if c['valid'] is not None else [t] * b)
    real = [min(max(n, 0), t) for n in real]
    keys = [min(p0 + n, cap) for p0, n in zip(c['pos'].tolist(), real)]
    kv_bytes = 2 * sum(keys) * h_kv * row
    nbytes = (kv_bytes + (sum(real) + b * t) * h * d * es
              + c['table'].numel() * 4 + b * 4 * (1 + (c['valid'] is not None)))
    ops = 0
    for p0, n in zip(c['pos'].tolist(), real):
        vis = sum(min(p0 + j + 1, cap) for j in range(n))
        ops += 4 * d * h * vis
    return bound_of(nbytes, ops, q.dtype)


def bound_of(nbytes, ops, dtype):
    """(ms, 'bytes' or 'operations', bytes, ops): the larger of bytes / HBM
    rate and operations / peak rate for the dtype."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops
            else 'operations', nbytes, ops)


def sdpa_ms(c, iters):
    """Yardstick only (never called by the port): one
    F.scaled_dot_product_attention over the cache gathered through the
    table (the gather, and for int8 the dequantization, done beforehand
    and not timed)."""
    from paddle_tpu_torch.ops.paged_kv import gather_virtual
    from paddle_tpu_torch.ops.weight_only import dequantize_kv, kv_layer
    import torch.nn.functional as F
    q = c['q']
    b, t, h, d = q.shape
    rot = 8

    def dense(bank):
        g = gather_virtual(bank, c['table'])               # [B,S,Hkv,D]
        return (dequantize_kv(g['int8'], g['scale'], q.dtype)
                if c['int8'] else g)

    ks, vs = [], []
    for layer in range(rot):
        kg = dense(kv_layer(c['k'], layer))
        vg = dense(kv_layer(c['v'], layer))
        ks.append(kg.permute(0, 2, 1, 3).contiguous())
        vs.append(vg.permute(0, 2, 1, 3).contiguous())
    s = ks[0].shape[2]
    if c['valid'] is not None:          # the real rows only (one slot)
        n = int(c['valid'][0])
        q, t = q[:, :n], n
    qpos = c['pos'].long()[:, None, None] + torch.arange(
        t, device='cuda')[None, :, None]
    mask = (torch.arange(s, device='cuda')[None, None, :] <= qpos)[:, None]
    qt = q.permute(0, 2, 1, 3).contiguous()
    return device_ms(lambda i: F.scaled_dot_product_attention(
        qt, ks[i % rot], vs[i % rot], attn_mask=mask), iters)


def kernel_err(got, want, floor=0.0):
    """(max |got - want|, max over output rows of that row's largest
    |got - want| / its largest |want|). ``floor``: each row's scale is at
    least that share of the tensor's largest |want| (gradients: a row can
    be pure cancellation, rounding noise on both sides)."""
    w = want.float()
    d = (got.float() - w).abs().amax(-1)
    scale = w.abs().amax(-1).clamp_min(floor * w.abs().max().item() + 1e-30)
    return d.max().item(), (d / scale).max().item()


GRAD_FLOOR = 0.01   # gradients: rows scaled by at least 1% of the tensor


# instance counters a kernel wrapper may carry beside ``launches``
INSTANCE_COUNTERS = (('split_launches', 'split-k'),
                     ('tc_launches', 'tensor-core'))


def instance_counts(kernel):
    return {attr: getattr(kernel, attr) for attr, _ in INSTANCE_COUNTERS
            if hasattr(kernel, attr)}


def hold_kernel(kname, name, kernel, call, twin, tol, timing=None,
                lse=False, floor=0.0, instance=None, check=None):
    """Hold one kernel call against its twin on the same inputs, and on a
    main-path shape (``timing``: dict of ``iters``, ``bound`` as
    ``bound_of`` returns it, ``library(iters)``) time it. ``call(i)`` and
    ``twin(i)`` run on the inputs of layer i; with ``lse`` they return
    (out, lse). ``instance``: the instance the call must take
    ('tensor-core', 'split-k' or 'cuda-core'), read from the wrapper's
    instance counters. The launches made here only compare and time, so
    the kernel's counters are put back. Raises when the two disagree or
    the wrong instance ran; ``check(out)`` may raise on the call's output
    too."""
    before = kernel.launches
    inst_before = instance_counts(kernel)
    got = call(0)
    torch.cuda.synchronize()
    if check is not None:
        check(got)
    want = twin(0)
    rec = {}
    if instance is not None:
        took = 'cuda-core'
        for attr, label in INSTANCE_COUNTERS:
            if getattr(kernel, attr, 0) > inst_before.get(attr, 0):
                took = label
        rec['instance'] = took
        if took != instance:
            raise AssertionError(f'{kname} {name}: ran the {took} instance, '
                                 f'want {instance}')
    if lse:
        (got, got_lse), (want, want_lse) = got, want
        rec['lse_err'] = (got_lse - want_lse).abs().max().item()
    if isinstance(got, tuple):          # several outputs: the worst of them
        errs = [kernel_err(a, b, floor) for a, b in zip(got, want)]
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    else:
        err, rel = kernel_err(got, want, floor)
    rec.update(max_abs_err=err, max_row_rel_err=rel, tol=tol)
    if timing:
        it = timing['iters']
        b_ms, b_by, nbytes, ops = timing['bound']
        rec.update(ms=device_ms(call, it), ms_events=cuda_ms(call, it),
                   plain_ms=cuda_ms(twin, max(4, it // 10), warmup=1),
                   library_ms=timing['library'](it), bound_ms=b_ms,
                   bound_by=b_by, bytes=nbytes, ops=ops)
    kernel.launches = before
    for attr, n in inst_before.items():
        setattr(kernel, attr, n)
    ok = math.isfinite(err) and rel <= tol
    extra = f'; {rec["instance"]} instance' if instance is not None else ''
    if lse:
        ok = ok and rec['lse_err'] <= LSE_TOL
        extra += f'; lse {rec["lse_err"]:.3e} (tol {LSE_TOL:g})'
    if timing:
        extra += (f'; kernel {rec["ms"]:.4f} ms (events '
                  f'{rec["ms_events"]:.4f}), plain {rec["plain_ms"]:.4f} ms,'
                  f' sdpa {rec["library_ms"]:.4f} ms, bound '
                  f'{rec["bound_ms"]:.4f} ms ({rec["bound_by"]})')
    print(f'  kernel {kname} {name}: max_abs_err {err:.3e}, row-scaled '
          f'{rel:.3e} (tol {tol:g}) {"OK" if ok else "FAIL"}{extra}',
          flush=True)
    if not ok:
        raise AssertionError(f'{kname} {name}: kernel and twin differ '
                             f'({rec})')
    return rec


# kernels 6 and 7 beyond the engine's shapes, one case per instance and
# edge: pos at page edges (0, 127, 128, 1023), the table shuffled with its
# unused entries on the trash page, GQA groups of 4 and 2, head dims
# 64/128/256, f32 q; T 1, 2, 16 (split-K), 17-1024 (tensor-core in bf16 at D
# 64/128); kernel 6 over pages of the pool's dtype, kernel 7 over int8 banks
BF, FP = torch.bfloat16, torch.float32
EDGES = [0, 127, 128, 1023]
PAGED_CASES = [
    ('T1_edges', dict(b=4, t=1, h=16, h_kv=16, d=64, pos=EDGES, dtype=BF)),
    ('T1_gqa4', dict(b=4, t=1, h=16, h_kv=4, d=64, pos=EDGES, dtype=BF)),
    ('T2_gqa4_d128', dict(b=4, t=2, h=8, h_kv=2, d=128,
                          pos=[0, 127, 128, 1000], dtype=BF)),
    ('T16_gqa4_d256', dict(b=2, t=16, h=8, h_kv=2, d=256, pos=[127, 900],
                           dtype=BF)),
    ('T1_f32_edges', dict(b=4, t=1, h=16, h_kv=16, d=64, pos=EDGES,
                          dtype=FP)),
    ('T16_f32_d128', dict(b=2, t=16, h=4, h_kv=4, d=128, pos=[128, 1000],
                          dtype=FP)),
    ('T17_gqa4', dict(b=2, t=17, h=16, h_kv=4, d=64, pos=[0, 127],
                      dtype=BF)),
    ('T64_gqa4_d128', dict(b=2, t=64, h=8, h_kv=2, d=128, pos=[128, 900],
                           dtype=BF)),
    ('T65', dict(b=2, t=65, h=8, h_kv=8, d=64, pos=[127, 300], dtype=BF)),
    ('T300_gqa4', dict(b=2, t=300, h=16, h_kv=4, d=64, pos=[0, 517],
                       dtype=BF)),
    ('T1024_gqa2_d128', dict(b=1, t=1024, h=4, h_kv=2, d=128, pos=[0],
                             dtype=BF)),
    ('T300_gqa2_d256', dict(b=2, t=300, h=4, h_kv=2, d=256, pos=[0, 517],
                            dtype=BF)),
    ('T65_f32_gqa4', dict(b=2, t=65, h=8, h_kv=2, d=64, pos=[127, 128],
                          dtype=FP)),
    ('T1024_f32', dict(b=1, t=1024, h=4, h_kv=4, d=64, pos=[0], dtype=FP)),
    # pages of 512 and 1024 rows (ROADMAP Q3.2): the CUDA-core kernel's
    # shared memory no longer grows with the page size
    ('T300_f32_ps512_d128', dict(b=2, t=300, h=4, h_kv=2, d=128,
                                 pos=[0, 600], dtype=FP, ps=512, p_max=2)),
    ('T300_f32_ps1024', dict(b=2, t=300, h=4, h_kv=2, d=64, pos=[0, 700],
                             dtype=FP, ps=1024, p_max=1)),
    ('T200_ps512_d128', dict(b=2, t=200, h=4, h_kv=2, d=128, pos=[0, 700],
                             dtype=BF, ps=512, p_max=2)),
    ('T3_ps1024', dict(b=2, t=3, h=4, h_kv=2, d=64, pos=[5, 1020], dtype=BF,
                       ps=1024, p_max=1)),
    # prefill padding: rows at or past valid come out zero, their q tiles
    # skipped (tensor-core, CUDA-core)
    ('T1024_valid', dict(b=3, t=1024, h=4, h_kv=2, d=64, pos=[0, 0, 0],
                         dtype=BF, valid=[5, 129, 1000])),
    ('T300_f32_valid', dict(b=2, t=300, h=4, h_kv=2, d=64, pos=[0, 0],
                            dtype=FP, valid=[1, 250])),
]
# the engine's prefill at its real rows: one prompt of 200 padded to 1024
ENGINE_VALID = 200


def kernel_cases(pa, timed_iters):
    """Kernels 6 and 7 (paged decode over bf16/f32 and int8 pools)."""
    from paddle_tpu_torch.ops.weight_only import kv_layer
    rng = np.random.RandomState(1)
    ragged = [int(x) for x in rng.randint(16, 1023, size=8)]
    ragged[0], ragged[1] = 0, 1023          # both ends of the window
    engine = [
        ('decode_T1', dict(b=8, t=1, h=16, h_kv=16, d=64, pos=ragged,
                           dtype=BF), True),
        ('prefill_T1024', dict(b=1, t=1024, h=16, h_kv=16, d=64, pos=[0],
                               dtype=BF), True),
        ('prefill_T1024_valid200', dict(b=1, t=1024, h=16, h_kv=16, d=64,
                                        pos=[0], dtype=BF,
                                        valid=[ENGINE_VALID]), True),
        ('decode_T1_gqa_hkv4', dict(b=8, t=1, h=16, h_kv=4, d=64,
                                    pos=ragged, dtype=BF), False),
        ('decode_T1_d128', dict(b=8, t=1, h=8, h_kv=8, d=128, pos=ragged,
                                dtype=BF), False),
        ('decode_T1_d256', dict(b=8, t=1, h=4, h_kv=4, d=256, pos=ragged,
                                dtype=BF), False),
        ('decode_T1_f32', dict(b=8, t=1, h=16, h_kv=16, d=64, pos=ragged,
                               dtype=FP), False),
        ('prefill_T300_f32_gqa', dict(b=2, t=300, h=16, h_kv=4, d=64,
                                      pos=[0, 517], dtype=FP), False),
    ]
    cases = (engine + [(name, kw, False) for name, kw in PAGED_CASES]
             + [(name, dict(kw, int8=True), timed)
                for name, kw, timed in engine[:3]]
             + [(name, dict(kw, int8=True), False)
                for name, kw in PAGED_CASES])
    results = {'paged_decode': {}, 'paged_decode_int8': {}}
    for name, kw, engine_shape in cases:
        c = make_case(layers=LAYERS if engine_shape else 1, **kw)
        kname = 'paged_decode_int8' if c['int8'] else 'paged_decode'
        kern = (pa.paged_flash_decode_int8 if c['int8']
                else pa.paged_flash_decode)
        twin = (pa.paged_decode_int8_reference if c['int8']
                else pa.paged_decode_reference)
        n_layers = (c['k']['int8'] if c['int8'] else c['k']).shape[0]
        args = lambda i: (c['q'], kv_layer(c['k'], i % n_layers),  # noqa: E731
                          kv_layer(c['v'], i % n_layers), c['table'],
                          c['pos'])
        timing = (dict(iters=timed_iters, bound=bound(c),
                       library=lambda it: sdpa_ms(c, it))
                  if engine_shape else None)
        # the library's instance for the case: split-K, tensor-core or
        # CUDA-core, by T, dtype, head dim and page size
        inst = pa.paged_instance(kw['dtype'], kw['t'], kw['d'], c['ps'],
                                 torch.int8 if c['int8'] else kw['dtype'])
        results[kname][name] = hold_kernel(
            kname, name, kern,
            lambda i: kern(*args(i), valid=c['valid']),
            lambda i: twin(*args(i), valid=c['valid']), TOL[kw['dtype']],
            timing, instance=inst,
            check=(None if c['valid'] is None else
                   lambda out: expect_zero_past_valid(kname, name, out,
                                                      c['valid'])))
        del c
        torch.cuda.empty_cache()
    return results


def expect_zero_past_valid(kname, name, out, valid):
    """Rows at or past valid[b] of a kernel's output are exactly zero."""
    for b, n in enumerate(valid.tolist()):
        if out[b, n:].any():
            raise AssertionError(f'{kname} {name}: slot {b} has nonzero rows '
                                 f'past valid {n}')


# ---------------------------------------------------------------------------
# phase 3 (continued): the dense decode kernels and the forward kernel
# ---------------------------------------------------------------------------

GEN_POS = 191      # mean position of phase 6's decode steps (128 .. 254)
PF_TILE = 128      # q rows a block of the tensor-core prefill
BF16, F32 = torch.bfloat16, torch.float32
# (name, case arguments, timing: 'main' for a main-path shape, timed over
# LAYERS rotating caches; 'shape' for kernel 4's other instances, timed
# lightly; None untimed)
DECODE_CASES = [
    # kernel 4, one case per instance and edge: split-K at T 1, 2, 16 (GQA,
    # head dims 64-256, f32, S_max 1000), tensor-core at T 128 (generate()'s
    # prefill), 300 and 1000 (the prefill past the window), CUDA-core for
    # f32 at T > 16, S_max 1000 and head dim 256
    ('decode_T1', dict(b=8, t=1, h=16, h_kv=16, d=64, s_max=1024,
                       pos=GEN_POS, dtype=BF16), 'main'),
    ('prefill_T128', dict(b=8, t=128, h=16, h_kv=16, d=64, s_max=1024,
                          pos=0, dtype=BF16), 'main'),
    ('decode_T2_gqa_hkv4_d128', dict(b=8, t=2, h=16, h_kv=4, d=128,
                                     s_max=1024, pos=700, dtype=BF16),
     'shape'),
    ('decode_T16_gqa_d256_smax1000', dict(b=2, t=16, h=8, h_kv=4, d=256,
                                          s_max=1000, pos=984, dtype=BF16),
     'shape'),
    ('decode_T3_f32_d256', dict(b=2, t=3, h=4, h_kv=4, d=256, s_max=512,
                                pos=300, dtype=F32), 'shape'),
    ('decode_T1_f32_smax1000', dict(b=4, t=1, h=8, h_kv=2, d=64,
                                    s_max=1000, pos=128, dtype=F32),
     'shape'),
    ('prefill_T300_gqa_d128', dict(b=2, t=300, h=8, h_kv=2, d=128,
                                   s_max=512, pos=100, dtype=BF16), 'shape'),
    ('prefill_T1000', dict(b=8, t=1000, h=16, h_kv=16, d=64, s_max=1024,
                           pos=0, dtype=BF16), 'shape'),
    ('prefill_T128_f32', dict(b=2, t=128, h=4, h_kv=4, d=64, s_max=1024,
                              pos=0, dtype=F32), 'shape'),
    ('prefill_T128_smax1000', dict(b=2, t=128, h=4, h_kv=4, d=64,
                                   s_max=1000, pos=0, dtype=BF16), 'shape'),
    ('prefill_T70_d256', dict(b=2, t=70, h=4, h_kv=2, d=256, s_max=512,
                              pos=30, dtype=BF16), 'shape'),
    ('decode_T1_int8', dict(b=8, t=1, h=16, h_kv=16, d=64, s_max=1024,
                            pos=GEN_POS, dtype=BF16, int8=True), 'main'),
    ('prefill_T128_int8', dict(b=8, t=128, h=16, h_kv=16, d=64, s_max=1024,
                               pos=0, dtype=BF16, int8=True), 'main'),
    ('decode_T2_int8_f32_gqa', dict(b=4, t=2, h=8, h_kv=2, d=64, s_max=512,
                                    pos=400, dtype=F32, int8=True), None),
    # kernel 5's instances beyond generate()'s shapes: S_max not a
    # multiple of the split-K's 128-row pages, T 16 at D 256, the
    # tensor-core prefill at D 128 and GQA, the CUDA-core tile
    ('decode_T16_int8_d256_smax200', dict(b=2, t=16, h=8, h_kv=2, d=256,
                                          s_max=200, pos=150, dtype=BF16,
                                          int8=True), None),
    ('prefill_T300_int8_gqa_d128', dict(b=2, t=300, h=8, h_kv=2, d=128,
                                        s_max=512, pos=100, dtype=BF16,
                                        int8=True), None),
    ('prefill_T128_int8_smax1000', dict(b=2, t=128, h=4, h_kv=4, d=64,
                                        s_max=1000, pos=0, dtype=BF16,
                                        int8=True), None),
    ('prefill_T128_int8_f32', dict(b=2, t=128, h=4, h_kv=4, d=64, s_max=1024,
                                   pos=0, dtype=F32, int8=True), None),
]
FWD_CASES = [
    ('fwd_S1024', dict(b=8, s=1024, h=16, h_kv=16, d=64, dtype=BF16), True),
    ('fwd_S300_gqa_d128_f32', dict(b=2, s=300, h=8, h_kv=4, d=128,
                                   dtype=F32), False),
    ('fwd_S300_gqa_d128', dict(b=2, s=300, h=8, h_kv=4, d=128, dtype=BF16),
     False),
    ('fwd_S200_mask_noncausal', dict(b=2, s=200, h=4, h_kv=4, d=64,
                                     dtype=BF16, causal=False, masked=True),
     False),
    ('fwd_S130_d256', dict(b=1, s=130, h=2, h_kv=2, d=256, dtype=BF16),
     False),
    # attention dropout (training): the forward's shape at rate 0.1
    ('fwd_S1024_drop0.1', dict(b=8, s=1024, h=16, h_kv=16, d=64, dtype=BF16,
                               drop=0.1), True),
]
DROP_SEED = 2 ** 31 + 12345     # a u32 past the int32 range
# kernels 2 and 3 (the flash backward): the train step's shape first
BWD_CASES = [
    ('bwd_S1024', dict(b=8, s=1024, h=16, h_kv=16, d=64, dtype=BF16), True),
    ('bwd_S1024_drop0.1', dict(b=8, s=1024, h=16, h_kv=16, d=64, dtype=BF16,
                               drop=0.1), True),
    ('bwd_S300_gqa_d128_f32', dict(b=2, s=300, h=8, h_kv=4, d=128,
                                   dtype=F32), False),
    ('bwd_S300_gqa_d128', dict(b=2, s=300, h=8, h_kv=4, d=128, dtype=BF16),
     False),
    ('bwd_S512_f32', dict(b=2, s=512, h=4, h_kv=4, d=64, dtype=F32), False),
    ('bwd_S200_mask_noncausal_drop0.25', dict(b=2, s=200, h=4, h_kv=2, d=64,
                                              dtype=BF16, causal=False,
                                              masked=True, drop=0.25),
     False),
    ('bwd_S130_d256', dict(b=1, s=130, h=2, h_kv=2, d=256, dtype=BF16),
     False),
]
LSE_TOL = 1e-4     # lse is f32 from the same scores: order of sums only


def dense_case(b, t, h, h_kv, d, s_max, pos, dtype, int8=False, layers=1,
               seed=0):
    """q, ``layers`` dense caches [B, S_max, H_kv, D] (int8 banks with
    ``int8``) and pos as the int32 [1] tensor generate() passes. q is a
    strided view of a packed [B, T, H_kv, g + 2, D] projection, as
    ``_block_qkv`` hands it over (MHA: a view; GQA: a copy)."""
    from paddle_tpu_torch.ops.weight_only import quantize_kv
    g = torch.Generator(device='cuda').manual_seed(seed)
    grp = h // h_kv
    packed = torch.randn((b, t, h_kv, grp + 2, d), generator=g,
                         device='cuda').to(dtype)
    q = packed[..., :grp, :].reshape(b, t, h, d)

    def plane():
        out = []
        for _ in range(layers):
            x = torch.randn((b, s_max, h_kv, d), generator=g, device='cuda')
            if int8:
                qx, sx = quantize_kv(x)
                out.append({'int8': qx, 'scale': sx})
            else:
                out.append(x.to(dtype))
        return out

    return dict(q=q, k=plane(), v=plane(), s_max=s_max, int8=int8,
                pos=torch.tensor([pos], dtype=torch.int32, device='cuda'))


def decode_bound(c):
    """Each K/V row the rows can see read once (int8: its byte per value
    and its f32 scale), q, out and pos once; 4*D flops per (row, visible
    key, head)."""
    q = c['q']
    b, t, h, d = q.shape
    kv = c['k'][0]['int8'] if c['int8'] else c['k'][0]
    h_kv = kv.shape[2]
    pos, s_max = int(c['pos']), c['s_max']
    row = d * kv.element_size() + (4 if c['int8'] else 0)
    nbytes = (2 * b * min(pos + t, s_max) * h_kv * row
              + 2 * q.numel() * q.element_size() + 4)
    ops = 4 * d * h * b * sum(min(pos + j + 1, s_max) for j in range(t))
    return bound_of(nbytes, ops, q.dtype)


def decode_sdpa_ms(c, iters):
    """Yardstick only: one F.scaled_dot_product_attention over the keys the
    rows can see, the cache transposed (and int8 dequantized) beforehand,
    not timed."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.weight_only import dequantize_kv
    q = c['q']
    b, t, h, d = q.shape
    pos = int(c['pos'])
    keys = min(pos + t, c['s_max'])
    rot = min(8, len(c['k']))

    def dense(x):
        if c['int8']:
            x = dequantize_kv(x['int8'], x['scale'], q.dtype)
        return x[:, :keys].transpose(1, 2).contiguous()

    ks = [dense(c['k'][i]) for i in range(rot)]
    vs = [dense(c['v'][i]) for i in range(rot)]
    qt = q.transpose(1, 2).contiguous()
    mask = (torch.arange(keys, device='cuda')[None, :]
            <= pos + torch.arange(t, device='cuda')[:, None])
    gqa = ks[0].shape[1] != h
    return device_ms(lambda i: F.scaled_dot_product_attention(
        qt, ks[i % rot], vs[i % rot], attn_mask=mask, enable_gqa=gqa), iters)


def fwd_case(b, s, h, h_kv, d, dtype, causal=True, masked=False, layers=1,
             seed=0, drop=0.0):
    """q, k, v as ``_block_qkv`` gives them, per layer: strided views of
    one packed projection [B, S, H_kv, g+2, D] (q is copied when g > 1),
    and dO per layer."""
    g = h // h_kv
    gen = torch.Generator(device='cuda').manual_seed(seed)
    parts = []
    for _ in range(layers):
        x = torch.randn((b, s, h_kv, g + 2, d), generator=gen,
                        device='cuda').to(dtype)
        parts.append((x[..., :g, :].reshape(b, s, h, d), x[..., g, :],
                      x[..., g + 1, :]))
    dos = [torch.randn((b, s, h, d), generator=gen, device='cuda').to(dtype)
           for _ in range(layers)]
    kmask = None
    if masked:
        valid = torch.tensor([s, s - 77], device='cuda')[:b, None]
        kmask = torch.where(torch.arange(s, device='cuda')[None] < valid,
                            0.0, -1e30)
    return dict(parts=parts, dos=dos, causal=causal, kmask=kmask, drop=drop,
                seed=DROP_SEED if drop else None)


def fwd_bound(c):
    """q, k, v and out each moved once, lse written once; 4*D flops per
    (row, visible key, head)."""
    q, k, _ = c['parts'][0]
    b, s, h, d = q.shape
    es = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * es + b * h * s * 4
    vis = s * (s + 1) // 2 if c['causal'] else s * s
    return bound_of(nbytes, 4 * d * h * b * vis, q.dtype)


def fwd_sdpa_ms(c, iters):
    """Yardstick only: one F.scaled_dot_product_attention (causal, with
    the case's dropout rate and its own random mask) over q, k, v made
    contiguous in [B, H, S, D] beforehand, not timed."""
    import torch.nn.functional as F
    rot = min(8, len(c['parts']))
    qkv = [[x.transpose(1, 2).contiguous() for x in c['parts'][i]]
           for i in range(rot)]
    return device_ms(lambda i: F.scaled_dot_product_attention(
        *qkv[i % rot], is_causal=c['causal'], dropout_p=c['drop']), iters)


def dense_kernel_cases(fa, pa, timed_iters):
    """The dense decode kernels (4, 5) and the forward kernel (1) against
    their twins; the main-path shapes are timed over LAYERS rotating
    caches or projections, as generate() and forward() find them."""
    results = {'flash_decode': {}, 'flash_decode_int8': {}, 'flash_fwd': {}}
    for name, kw, timed in DECODE_CASES:
        layers = {'main': LAYERS, 'shape': 4}.get(timed, 1)
        c = dense_case(layers=layers, **kw)
        kname = 'flash_decode_int8' if c['int8'] else 'flash_decode'
        kern = getattr(fa, kname)
        twin = getattr(fa, kname + '_reference')
        n = len(c['k'])
        args = lambda i: (c['q'], c['k'][i % n], c['v'][i % n], c['pos'])  # noqa: E731
        iters = timed_iters if timed == 'main' else max(8, timed_iters // 5)
        timing = (dict(iters=iters, bound=decode_bound(c),
                       library=lambda it: decode_sdpa_ms(c, it))
                  if timed else None)
        # kernels 4 and 5 take kernel 6 and 7's rule over their implicit
        # pages, S_max for the page size
        inst = pa.paged_instance(kw['dtype'], kw['t'], kw['d'], kw['s_max'],
                                 torch.int8 if c['int8'] else kw['dtype'])
        results[kname][name] = hold_kernel(
            kname, name, kern, lambda i: kern(*args(i)),
            lambda i: twin(*args(i)), TOL[kw['dtype']], timing,
            instance=inst)
        del c
        torch.cuda.empty_cache()
    for name, kw, timed in FWD_CASES:
        c = fwd_case(layers=LAYERS if timed else 1, **kw)
        n = len(c['parts'])
        # self-attention: q_off = S_k - S_q = 0
        args = lambda i: (*c['parts'][i % n], c['causal'])  # noqa: E731
        timing = (dict(iters=max(4, timed_iters // 4), bound=fwd_bound(c),
                       library=lambda it: fwd_sdpa_ms(c, it))
                  if timed else None)
        extra = dict(kmask=c['kmask'], drop_rate=c['drop'], seed=c['seed'])
        results['flash_fwd'][name] = hold_kernel(
            'flash_fwd', name, fa.flash_fwd,
            lambda i: fa.flash_fwd(*args(i), **extra),
            lambda i: fa.flash_fwd_reference(*args(i), **extra),
            TOL[kw['dtype']], timing, lse=True,
            instance='tensor-core' if kw['dtype'] == BF16 else 'cuda-core')
        del c
        torch.cuda.empty_cache()
    return results


def bwd_bound(c, dots):
    """q, k, v, dO, lse and delta read once and the kernel's outputs (dq;
    or dk and dv) written once; ``dots`` dots of 2*D flops per (row,
    visible key, head): 3 for dq (s, dp, ds.K), 4 for dk/dv."""
    q, k, _ = c['parts'][0]
    b, s, h, d = q.shape
    es = q.element_size()
    ins = (2 * q.numel() + 2 * k.numel()) * es + 2 * b * h * s * 4
    outs = q.numel() * es if dots == 3 else 2 * k.numel() * es
    vis = s * (s + 1) // 2 if c['causal'] else s * s
    return bound_of(ins + outs, dots * 2 * d * h * b * vis, q.dtype)


def sdpa_bwd_ms(c, iters):
    """Yardstick only (the port never calls it): PyTorch's own flash
    backward, ``aten._scaled_dot_product_flash_attention_backward``, which
    computes dq, dk and dv together (kernels 2 and 3 at once), on q, k, v
    and dO made contiguous in [B, H, S, D] and its own forward's out and
    lse, all made beforehand and not timed."""
    rot = min(8, len(c['parts']))
    ops = torch.ops.aten
    args = []
    for i in range(rot):
        q, k, v = (x.transpose(1, 2).contiguous() for x in c['parts'][i])
        o = ops._scaled_dot_product_flash_attention(q, k, v, c['drop'],
                                                    c['causal'])
        g = c['dos'][i].transpose(1, 2).contiguous()
        args.append((g, q, k, v, o[0], o[1], o[2], o[3], o[4], o[5],
                     c['drop'], c['causal'], o[6], o[7]))
    return device_ms(lambda i: ops._scaled_dot_product_flash_attention_backward(
        *args[i % rot]), iters)


def bwd_kernel_cases(fa, timed_iters):
    """Kernels 2 and 3 against their twin on the same inputs (q, k, v,
    dO, and kernel 1's own out and lse), each kernel timed alone at the
    train step's shape over LAYERS rotating inputs; the twin computes
    dq, dk and dv together, so its time stands for both."""
    results = {'flash_bwd_dq': {}, 'flash_bwd_dkv': {}}
    for name, kw, timed in BWD_CASES:
        c = fwd_case(layers=LAYERS if timed else 1, **kw)
        n = len(c['parts'])
        extra = dict(kmask=c['kmask'], drop_rate=c['drop'], seed=c['seed'])
        fwd = [fa.flash_fwd(*c['parts'][i], c['causal'], **extra)
               for i in range(n)]
        delta = [fa.bwd_delta(fwd[i][0], c['dos'][i]) for i in range(n)]

        def inputs(i):
            j = i % n
            return (*c['parts'][j], c['dos'][j], fwd[j][1], delta[j],
                    c['causal'])

        library = {}

        def lib_ms(it):
            if 'ms' not in library:
                library['ms'] = sdpa_bwd_ms(c, it)
            return library['ms']

        for kname, dots, pick in (('flash_bwd_dq', 3, lambda r: r[0]),
                                  ('flash_bwd_dkv', 4, lambda r: r[1:])):
            kern = getattr(fa, kname)
            timing = (dict(iters=max(4, timed_iters // 4),
                           bound=bwd_bound(c, dots), library=lib_ms)
                      if timed else None)
            # kernels 2 and 3 run their tensor-core instances for bf16 at
            # head dim 64 and 128
            tc = kw['dtype'] == BF16 and kw['d'] in (64, 128)
            results[kname][name] = hold_kernel(
                kname, name, kern,
                lambda i: kern(*inputs(i), **extra),
                lambda i: pick(fa.flash_bwd_reference(*inputs(i), **extra)),
                TOL[kw['dtype']], timing, floor=GRAD_FLOOR,
                instance='tensor-core' if tc else 'cuda-core')
        del c, fwd, delta
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phases 4 and 5: the engine
# ---------------------------------------------------------------------------

def bench_config(gpt, **over):
    kw = dict(vocab_size=32768, hidden_size=1024, num_layers=24,
              num_heads=16, max_seq_len=1024, dtype='bfloat16')
    kw.update(over)
    return gpt.GPTConfig(**kw)


def prompts(n, lo, hi, vocab, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=int(t)).astype(np.int32)
            for t in rng.randint(lo, hi + 1, size=n)]


def prefill_pad_share(lens, width, ps, tq=64):
    """Share of the kernel's prefill work spent on q tiles that hold only
    padding rows. The engine pads every prompt to ``width`` rows at pos 0;
    a tile of ``tq`` rows works rows x the keys of every page up to its
    last row's, and the tiles at or past the prompt's length are the ones
    a kernel told the prompt's length could skip."""
    total = pad = 0
    for n in lens:
        for q0 in range(0, width, tq):
            rows = min(tq, width - q0)
            work = rows * ps * -(-(q0 + rows) // ps)
            total += work
            pad += work if q0 >= n else 0
    return pad / total


def prefill_tiles_skipped(lens, width, tq):
    """Share of the prefills' q tiles of ``tq`` rows that start at or past
    the prompt's length: the tiles the kernel, given valid, skips."""
    tiles = -(-width // tq)
    return sum(sum(q0 >= n for q0 in range(0, width, tq))
               for n in lens) / (tiles * len(lens))


def serve(engine, reqs, max_new):
    t0 = time.perf_counter()
    futs = [engine.submit(p, max_new_tokens=max_new) for p in reqs]
    out = [f.result(timeout=600) for f in futs]
    return out, time.perf_counter() - t0


MODES = (('eager', False), ('captured', True))


def engine_run(GenerationEngine, net, config, kname, kernels, reqs, new,
               capture, card, what):
    """One engine over the bench GPT (8 slots, page 128), eager (a private
    switch, for this comparison only) or on captured CUDA graphs: warmed
    up, every launch counter set to 0, then the requests served. Checks
    the tokens, the exact launches (kernel ``kname``: 24 x (prefills +
    steps), the prefills on the tensor-core instance and the steps on the
    split-K one), two captures at warmup and none from traffic; then a
    profiled rerun. -> (record, the streams)."""
    args = (net,) if config is None else (net, config)
    eng = GenerationEngine(*args, num_slots=8, page_size=128)
    eng._capture = capture
    try:
        w = eng.warmup()
        traces = eng._trace_count
        zero_launches(kernels)
        out, wall = serve(eng, reqs, new)
        torch.cuda.synchronize()
        counts = launch_counts(kernels)
        k = kernels[kname]
        inst = {'tensor-core': k.tc_launches, 'split-k': k.split_launches}
        st = eng.stats()
        after = eng._trace_count
        graphs = [f.captured for f in eng._fns.values()]
        prof = profile_serving(eng, reqs, new)
        width, ps = eng.prefill_width, eng.page_size
    finally:
        eng.shutdown()
    mode = 'captured' if capture else 'eager'
    vocab = (config or net.config).vocab_size
    L = (config or net.config).num_layers
    for i, toks in enumerate(out):
        if len(toks) != new or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f'{what} {mode}, request {i}: {len(toks)} '
                                 f'tokens, want {new} in [0, {vocab})')
    if graphs != [capture] * 2:
        raise AssertionError(f'{what} {mode}: captured {graphs}')
    if (w['prebuilt'], traces, after) != (2, 2, 2):
        raise AssertionError(f'{what} {mode}: {w["prebuilt"]} built at '
                             f'warmup, _trace_count {traces} after warmup '
                             f'and {after} after traffic, want 2, 2, 2')
    expect_launches(f'{what} {mode} ({st["prefills"]} prefills + '
                    f'{st["steps"]} steps)', counts,
                    {kname: L * (st['prefills'] + st['steps'])})
    if counts[kname] == 0:
        raise AssertionError('the main path launched no kernel')
    want = {'tensor-core': L * st['prefills'], 'split-k': L * st['steps']}
    if inst != want:
        raise AssertionError(f'{what} {mode}: {kname} instances {inst}, '
                             f'want {want}')
    res = {'mode': mode, 'requests': len(out), 'new_tokens': new,
           'wall_s': wall, 'tokens_per_s': len(out) * new / wall,
           'ttft_ms_p50': st['ttft_ms_p50'], 'ttft_ms_p99': st['ttft_ms_p99'],
           'step_ms_mean': st['decode_step_ms_mean'],
           'prefill_ms_mean': st['prefill_ms_mean'],
           'prefills': st['prefills'], 'steps': st['steps'],
           'launches': counts[kname], 'instances': inst,
           'warmup_s': w['seconds'], 'traces': after,
           'prefill_width': width, 'page_size': ps,
           'kernel_device_ms': {
               'split-k': kernel_ms(prof, 'split_kernel'),
               'tensor-core': kernel_ms(prof, 'prefill_tc_kernel'),
               'cuda-core': kernel_ms(prof, 'paged_decode_kernel')},
           'profile': prof}
    print(f'  {what} {mode}: {len(out)} requests x {new} tokens in '
          f'{wall:.3f} s; {res["tokens_per_s"]:.1f} tokens/s, TTFT p50 '
          f'{res["ttft_ms_p50"]:.1f} ms, mean step {res["step_ms_mean"]:.2f}'
          f' ms, mean prefill {res["prefill_ms_mean"]:.2f} ms; {kname} '
          f'instances {inst}; captures {after} [{card}]', flush=True)
    return res, out


def print_profiles(what, runs, kname):
    for mode, _ in MODES:
        prof, r = runs[mode]['profile'], runs[mode]
        print(f'  {what} {mode}, profiled rerun: window '
              f'{prof["window_ms"]:.1f} ms, device busy '
              f'{prof["device_ms"]:.1f} ms ({100 * prof["busy_share"]:.1f}%),'
              f' {prof["kernels"]} kernel launches; {kname} device ms by '
              f'instance {r["kernel_device_ms"]}', flush=True)
        for name, ms in prof['top']:
            print(f'    {ms:9.3f} ms  {name}', flush=True)


def phase_engine(gpt, GenerationEngine, kernels, card):
    cfg = bench_config(gpt)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device='cuda').manual_seed(0)
    params = gpt.init_params(cfg, gen, 'cuda')
    n_params = sum(v.numel() for k, v in params.items() if k != 'blocks')
    n_params += sum(v.numel() for v in params['blocks'].values())
    # the engine takes the model object (ROADMAP Q3.1)
    model = gpt.GPTForCausalLM(cfg, params, device='cuda')
    reqs = prompts(8, 16, 400, cfg.vocab_size, seed=0)
    new = 32
    runs, streams = {}, {}
    for mode, capture in MODES:
        runs[mode], streams[mode] = engine_run(
            GenerationEngine, model, None, 'paged_decode', kernels, reqs, new,
            capture, card, f'engine ({n_params / 1e6:.1f}M params)')
    if streams['captured'] != streams['eager']:
        raise AssertionError('engine: captured and eager greedy streams '
                             'differ')
    print('  engine greedy streams, captured against eager: equal',
          flush=True)
    res = dict(runs['captured'], eager=runs['eager'], params=n_params,
               prompt_lens=[len(p) for p in reqs])
    lens = res['prompt_lens']
    width, ps = res['prefill_width'], res['page_size']
    res.update(prefill_pad_share=prefill_pad_share(lens, width, ps),
               prefill_work_skipped=prefill_pad_share(lens, width, ps,
                                                      PF_TILE),
               prefill_tiles_skipped=prefill_tiles_skipped(lens, width,
                                                           PF_TILE),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f'  prefill attention work on padding-only q tiles (prompts '
          f'{min(lens)}-{max(lens)} rows padded to {width}): '
          f'{100 * res["prefill_pad_share"]:.1f}% of 64-row tiles; the '
          f'tensor-core prefill skipped {100 * res["prefill_tiles_skipped"]:.1f}'
          f'% of its {PF_TILE}-row q tiles, '
          f'{100 * res["prefill_work_skipped"]:.1f}% of its work', flush=True)
    print_profiles('engine', runs, 'kernel 6')
    return res


def profile_serving(eng, reqs, new):
    return profile_window(lambda: serve(eng, reqs, new))


def profile_window(fn):
    """fn() once under torch.profiler: the window's wall time (to a
    synchronize), the device time summed over every kernel and copy, and
    the kernels that took most of it. The profiler adds host time of its
    own, so the busy share it gives is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, n = {}, 0
    for e in p.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.name] = (dev.get(e.name, 0.0)
                          + e.time_range.elapsed_us() / 1e3)
            n += 1
    total = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    return {'window_ms': wall * 1e3, 'device_ms': total,
            'busy_share': total / (wall * 1e3), 'kernels': n,
            'top': [(k[:90], v) for k, v in top], 'by_name': dev}


def kernel_ms(prof, *names):
    """Device ms of a profiled window in the kernels whose names contain
    one of ``names`` (the port's __global__ functions)."""
    return sum(v for k, v in prof['by_name'].items()
               if any(n in k for n in names))


def phase_card_vs_cpu(gpt, GenerationEngine):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bench_config(gpt, num_layers=2, dtype='float32')
    gen = torch.Generator(device='cpu').manual_seed(1)
    params = gpt.init_params(cfg, gen, 'cpu')
    reqs = prompts(4, 16, 200, cfg.vocab_size, seed=1)

    # prefill logits, one prompt, both devices
    logits = {}
    for dev in ('cuda', 'cpu'):
        p = {k: ({bk: bv.to(dev) for bk, bv in v.items()}
                 if k == 'blocks' else v.to(dev)) for k, v in params.items()}
        pool = gpt.init_paged_kv_cache(cfg, 9, 128, dev)
        table = torch.arange(1, 9, dtype=torch.int32, device=dev)[None]
        t = len(reqs[0])
        cache = dict(pool, page_table=table,
                     valid=torch.tensor([t], dtype=torch.int32, device=dev))
        with torch.no_grad():
            lg, _ = gpt.forward_with_cache(
                p, torch.from_numpy(reqs[0][None]).to(dev), cache,
                torch.zeros(1, dtype=torch.int32, device=dev), cfg,
                last_only=True)
        logits[dev] = lg.float().cpu()
    if not torch.isfinite(logits['cuda']).all():
        raise AssertionError('non-finite prefill logits on the card')
    err = (logits['cuda'] - logits['cpu']).abs().max().item()
    print(f'  prefill logits card vs cpu (2 layers, f32): max abs err '
          f'{err:.3e} (tol 1e-3)', flush=True)
    if not err <= 1e-3:
        raise AssertionError(f'card and CPU prefill logits differ by {err}')

    streams = {}
    for dev in ('cuda', 'cpu'):
        eng = GenerationEngine(params, cfg, device=dev, num_slots=8,
                               page_size=128)
        try:
            streams[dev], _ = serve(eng, reqs, 8)
        finally:
            eng.shutdown()
    same = streams['cuda'] == streams['cpu']
    print(f'  greedy streams card vs cpu ({len(reqs)} requests x 8 tokens):'
          f' {"equal" if same else "DIFFERENT"}', flush=True)
    if not same:
        raise AssertionError(f'greedy streams differ: card {streams["cuda"]}'
                             f' cpu {streams["cpu"]}')
    return {'prefill_logits_max_abs_err': err, 'streams_equal': same}


# ---------------------------------------------------------------------------
# phases 6-8: dense generate(), forward() and the sliding window
# ---------------------------------------------------------------------------

def zero_launches(kernels):
    for k in kernels.values():
        k.launches = 0
        for attr in instance_counts(k):
            setattr(k, attr, 0)


def launch_counts(kernels):
    return {name: k.launches for name, k in kernels.items()}


# kernels whose every launch on a bf16 main path is tensor-core
TC_KERNELS = ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')


def expect_tensor_core(what, kernels):
    """Every launch of kernels 1, 2 and 3 since their counters were zeroed
    took the tensor-core instance (the bf16 main paths). -> the counts."""
    got = {name: (kernels[name].tc_launches, kernels[name].launches)
           for name in TC_KERNELS}
    bad = {k: v for k, v in got.items() if v[0] != v[1]}
    if bad:
        raise AssertionError(f'{what}: CUDA-core launches of the bf16 '
                             f'path (tensor-core, all): {bad}')
    tc = {k: v[0] for k, v in got.items()}
    print(f'  tensor-core launches {what}: {tc}', flush=True)
    return tc


def expect_launches(what, got, want):
    """Every counter of ``got`` must equal ``want`` (0 where unnamed)."""
    full = {name: want.get(name, 0) for name in got}
    if got != full:
        raise AssertionError(f'{what}: launches {got}, want {full}')
    print(f'  launches {what}: {got}', flush=True)


def check_tokens(out, shape, vocab, what):
    if tuple(out.shape) != shape or out.dtype != torch.int32:
        raise AssertionError(f'{what}: tokens {tuple(out.shape)} '
                             f'{out.dtype}, want {shape} int32')
    if not bool(((out >= 0) & (out < vocab)).all()):
        raise AssertionError(f'{what}: a token outside [0, {vocab})')


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def generate_run(gpt, m, prompt, new, kname, kernels, card, what):
    """generate() of ``new`` greedy tokens on model ``m`` (eager or
    captured, as ``m._capture`` says) after a warm-up call that captures:
    every launch counter set to 0, then the run, its launches checked
    exactly (kernel ``kname``: 24 prefill launches on the tensor-core
    instance, 24 x (new - 1) steps on the split-K one); a second run; the
    same run in its two parts, each timed to a synchronize; a profiled
    window of 16 steps. -> (record, tokens, prefill logits)."""
    c = m.config
    b, t0 = prompt.shape
    L = c.num_layers
    mode = 'captured' if m._capture else 'eager'
    m.generate(prompt, max_new_tokens=2, temperature=0)     # warm-up
    zero_launches(kernels)
    out, wall = timed(lambda: m.generate(prompt, max_new_tokens=new,
                                         temperature=0))
    launches = launch_counts(kernels)
    check_tokens(out, (b, t0 + new), c.vocab_size, f'generate {what}')
    expect_launches(f'generate {what} {mode} (prefill + {new - 1} steps)',
                    launches, {kname: L * new})
    inst = instance_counts(kernels[kname])
    want = {'tc_launches': L, 'split_launches': L * (new - 1)}
    if inst != want:
        raise AssertionError(f'generate {what} {mode}: {kname} instances '
                             f'{inst}, want {want}')
    # once more, uncounted: how far one run's time is from the next
    again, wall2 = timed(lambda: m.generate(prompt, max_new_tokens=new,
                                            temperature=0))
    if not torch.equal(again, out):
        raise AssertionError(f'generate {what} {mode}: a second run gave '
                             'other tokens')
    # the same run in its two parts: the model's prefill and loop, each
    # timed to a synchronize
    entry = m._decode_entry(b, t0, 0, None, None, False)
    first, pre_s = timed(lambda: entry['prefill'].replay(
        prompt=prompt).clone())
    pos0 = torch.full((1,), t0, dtype=torch.int32, device='cuda')
    (rest, _), loop_s = timed(lambda: entry['loop'](
        entry['params'], first, pos0, entry['cache'], None, new - 1))
    if not torch.equal(torch.cat([first[:, None], rest], 1), out[:, t0:]):
        raise AssertionError(f'generate {what} {mode}: the timed prefill + '
                             'loop gave other tokens than generate()')
    # the prefill's logits, eagerly over a cache of its own
    prefill, _ = gpt.make_decode_fns(c)
    lg, _ = prefill(entry['params'], prompt, gpt.init_kv_cache(c, b, 'cuda'))
    rec = {'mode': mode, 'wall_s': wall, 'tokens_per_s': b * new / wall,
           'wall_s_second_run': wall2, 'prefill_ms': pre_s * 1e3,
           'step_ms_mean': loop_s * 1e3 / (new - 1),
           'launches': launches[kname], 'instances': inst,
           'distinct_tokens': int(out[:, t0:].unique().numel())}
    prof = rec['profile'] = profile_window(lambda: entry['loop'](
        entry['params'], first, pos0, entry['cache'], None, 16))
    prof['kernel_ms'] = kernel_ms(prof, 'split_kernel', 'attn_tile_kernel')
    print(f'  generate {what} {mode}: {b} x {new} tokens in {wall:.3f} s'
          f' (again: {wall2:.3f} s); {rec["tokens_per_s"]:.1f} tokens/s, '
          f'prefill {rec["prefill_ms"]:.2f} ms, mean step '
          f'{rec["step_ms_mean"]:.2f} ms; {kname} instances {inst} '
          f'[{card}]', flush=True)
    return rec, out, lg.float()


def phase_generate(gpt, kernels, card):
    """generate() at full width, bf16 cache then int8 cache, each eager
    and on captured graphs."""
    cfg = bench_config(gpt)
    torch.cuda.reset_peak_memory_stats()
    model = gpt.GPTForCausalLM(cfg, device='cuda', seed=0)
    b, t0, new = 8, 128, 128
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, t0)).astype(np.int32)).cuda()
    res, prefill_logits = {}, {}
    for label, kname in (('bf16', 'flash_decode'),
                         ('int8', 'flash_decode_int8')):
        c = cfg if label == 'bf16' else bench_config(gpt, kv_cache_int8=True)
        runs, outs = {}, {}
        for mode, capture in MODES:
            m = (model if label == 'bf16' and capture else
                 gpt.GPTForCausalLM(c, model.param_dict(), device='cuda'))
            m._capture = capture
            runs[mode], outs[mode], lg = generate_run(
                gpt, m, prompt, new, kname, kernels, card,
                f'{label} cache')
            if capture:
                prefill_logits[label] = lg
            if m is not model:
                del m
            torch.cuda.empty_cache()
        if not torch.equal(outs['captured'], outs['eager']):
            raise AssertionError(f'generate {label}: captured and eager '
                                 'tokens differ')
        print(f'  generate {label} cache, captured against eager: equal '
              'tokens', flush=True)
        res[label] = dict(runs['captured'], eager=runs['eager'])
    a, c8 = prefill_logits['bf16'], prefill_logits['int8']
    cos = float((a * c8).sum() / (a.norm() * c8.norm()))
    if not (torch.isfinite(a).all() and torch.isfinite(c8).all()):
        raise AssertionError('non-finite prefill logits')
    print(f'  prefill logits int8 vs bf16 cache: cosine {cos:.6f} '
          f'(want > 0.999)', flush=True)
    if not cos > 0.999:
        raise AssertionError(f'int8 cache prefill logits cosine {cos}')
    for label in ('bf16', 'int8'):
        for mode, _ in MODES:
            r = res[label] if mode == 'captured' else res[label]['eager']
            prof = r['profile']
            print(f'  profiled 16 decode steps, {label} cache, {mode}: '
                  f'window {prof["window_ms"]:.1f} ms, device busy '
                  f'{prof["device_ms"]:.1f} ms '
                  f'({100 * prof["busy_share"]:.1f}%), {prof["kernels"]} '
                  f'kernel launches; attention {prof["kernel_ms"]:.3f} ms',
                  flush=True)
            for name, ms in prof['top']:
                print(f'    {ms:9.3f} ms  {name}', flush=True)
    res['int8_prefill_cosine'] = cos
    res['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
    return model, res


def phase_forward_sliding(gpt, model, kernels, card):
    """forward() on [8, 1024], then generate() past the window."""
    cfg = model.config
    b, s = 8, cfg.max_seq_len
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    zero_launches(kernels)
    logits, fwd_s = timed(lambda: model(toks))
    fwd_launches = launch_counts(kernels)
    expect_launches('forward [8, 1024]', fwd_launches,
                    {'flash_fwd': cfg.num_layers})
    fwd_tc = expect_tensor_core('forward [8, 1024]', kernels)
    if (tuple(logits.shape) != (b, s, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f'forward logits {tuple(logits.shape)}, '
                             'finite?')
    del logits
    prof = profile_window(lambda: model(toks))
    t0, new = 1000, 32
    cached = s - t0 + 1
    # the warm-up call captures this prompt length's prefill and loop
    model.generate(toks[:, :t0], max_new_tokens=2, temperature=0)
    zero_launches(kernels)
    out, wall = timed(lambda: model.generate(toks[:, :t0], max_new_tokens=new,
                                             temperature=0))
    launches = launch_counts(kernels)
    check_tokens(out, (b, t0 + new), cfg.vocab_size, 'generate past window')
    expect_launches(f'generate T0={t0} +{new} ({cached} cached, '
                    f'{new - cached} sliding)', launches,
                    {'flash_decode': cfg.num_layers * cached,
                     'flash_fwd': cfg.num_layers * (new - cached)})
    # kernel 4: the prefill (T 1000, bf16) tensor-core, the steps split-K
    inst = instance_counts(kernels['flash_decode'])
    want = {'tc_launches': cfg.num_layers,
            'split_launches': cfg.num_layers * (cached - 1)}
    if inst != want:
        raise AssertionError(f'generate past the window: kernel 4 instances '
                             f'{inst}, want {want}')
    print(f'  kernel 4 instances past the window: {inst}', flush=True)
    slide_tc = expect_tensor_core('generate past the window', kernels)
    # one sliding step as generate() runs it, over the serving parameters
    # it already holds
    sp = model._serving_params()
    _, slide_s = timed(lambda: model._generate_sliding(
        out[:, -s:], 1, 0, None, params=sp))
    res = {'forward_ms': fwd_s * 1e3, 'wall_s': wall,
           'tokens_per_s': b * new / wall, 'sliding_step_ms': slide_s * 1e3,
           'forward_launches': fwd_launches, 'launches': launches,
           'tensor_core_launches': {'forward': fwd_tc, 'sliding': slide_tc},
           'forward_profile': prof}
    print(f'  forward [8, 1024]: {res["forward_ms"]:.2f} ms; generate '
          f'{b} x {new} past the window in {wall:.3f} s '
          f'({res["tokens_per_s"]:.1f} tokens/s), one sliding step '
          f'{res["sliding_step_ms"]:.2f} ms [{card}]', flush=True)
    print(f'  profiled forward [8, 1024]: window {prof["window_ms"]:.1f} ms, '
          f'device busy {prof["device_ms"]:.1f} ms '
          f'({100 * prof["busy_share"]:.1f}%), {prof["kernels"]} kernel '
          'launches', flush=True)
    for name, ms in prof['top']:
        print(f'    {ms:9.3f} ms  {name}', flush=True)
    return res


INT8_SHARE = 0.25    # see phase_generate_card_vs_cpu


def int8_split(lg_cpu, lg_card, lg_f32, took):
    """Phase 8's rule for int8 streams that split (see
    phase_generate_card_vs_cpu): given the card's tokens ``took`` [R, new],
    the two devices' int8 logits [R, new, V] differ by at most INT8_SHARE
    of what the int8 cache itself changes (the CPU's logits over an f32
    cache, ``lg_f32``), and each card token is the CPU's best up to twice
    that difference. -> (ok, record, message)."""
    disc = (lg_cpu - lg_card).abs().max().item()
    quant = (lg_f32 - lg_cpu).abs().max().item()
    got = lg_cpu.gather(-1, took[..., None].long())[..., 0]
    gap = (lg_cpu.amax(-1) - got).max().item()
    rec = dict(teacher_forced_logit_diff=disc,
               int8_vs_f32_cache_logit_diff=quant, card_gap_under_cpu=gap)
    msg = (f"given the card's tokens the logits differ by {disc:.2e} (int8 "
           f'vs f32 cache: {quant:.2e}; tol {INT8_SHARE:g} of it) and each '
           f"card token is within {gap:.2e} of the CPU's best (<= 2 x "
           f'{disc:.2e})')
    return disc <= INT8_SHARE * quant and gap <= 2 * disc, rec, msg


def teacher_forced_logits(gpt, model, stream, t0):
    """``model``'s logits for every new token of ``stream`` given the
    stream's own prefix: one cached prefill over the stream (each row
    quantizes as the decode steps quantized it) -> [B, new, V] f32 on the
    CPU."""
    cfg = model.config
    params = gpt.serving_params(model.param_dict(), cfg)
    cache = gpt.init_kv_cache(cfg, stream.shape[0], model.device)
    zero = torch.zeros(1, dtype=torch.int32, device=model.device)
    with torch.no_grad():
        lg, _ = gpt.forward_with_cache(params, stream[:, :-1].to(
            model.device), cache, zero, cfg)
    return lg[:, t0 - 1:].float().cpu()


def phase_generate_card_vs_cpu(gpt):
    """Greedy generate() card vs CPU at 2 layers in f32 (block matrices
    x10, so streams depend on their context), and forward() logits.

    The dense and window-crossing streams must be equal. The int8 cache
    quantizes each row as it is written, and a value that lands within f32
    noise of a rounding boundary quantizes one step apart on the two
    devices (it moves by a 127th of its row's largest), so a near-tie late
    in a stream may break the other way. Where the int8 streams differ,
    both devices compute the logits of every token of the card's stream
    given its own prefix. Their largest difference must stay within
    INT8_SHARE of what the int8 cache itself changes (the CPU's logits
    with the int8 cache against the f32 cache, on the same tokens): a
    wrong int8 kernel errs by as much as the quantization or more. And
    each token the card took must be the CPU's best up to twice that
    difference, which is all a near-tie between the two can explain.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    cases = [('dense', dict(), (4, 100, 24)),
             ('int8', dict(kv_cache_int8=True), (4, 100, 24)),
             ('window', dict(max_seq_len=256), (2, 240, 24))]
    for label, over, (b, t0, new) in cases:
        cfg = bench_config(gpt, num_layers=2, dtype='float32', **over)
        params = gpt.init_params(cfg, torch.Generator().manual_seed(2), 'cpu')
        for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
            params['blocks'][k] = params['blocks'][k] * 10
        prompt = np.random.RandomState(3).randint(
            0, cfg.vocab_size, (b, t0)).astype(np.int32)
        streams, models = {}, {}
        for dev in ('cuda', 'cpu'):
            m = models[dev] = gpt.GPTForCausalLM(cfg, params, device=dev)
            streams[dev] = m.generate(torch.from_numpy(prompt),
                                      max_new_tokens=new,
                                      temperature=0).cpu()
            if label == 'window':
                toks = torch.from_numpy(np.random.RandomState(4).randint(
                    0, cfg.vocab_size, (2, cfg.max_seq_len)).astype(
                        np.int32))
                res.setdefault('logits', {})[dev] = m(toks).float().cpu()
        same = torch.equal(streams['cuda'], streams['cpu'])
        distinct = int(streams['cpu'][:, t0:].unique().numel())
        rec = {'streams_equal': same, 'distinct_tokens': distinct}
        msg = 'equal' if same else 'DIFFERENT'
        if not same and label == 'int8':
            diff = (streams['cuda'] != streams['cpu']).nonzero()[0]
            card = streams['cuda']
            lg_cpu = teacher_forced_logits(gpt, models['cpu'], card, t0)
            lg_card = teacher_forced_logits(gpt, models['cuda'], card, t0)
            f32_cache = gpt.GPTForCausalLM(
                bench_config(gpt, num_layers=2, dtype='float32'), params,
                device='cpu')
            lg_f32 = teacher_forced_logits(gpt, f32_cache, card, t0)
            same, split, msg = int8_split(lg_cpu, lg_card, lg_f32,
                                          card[:, t0:])
            rec.update(first_difference=[int(x) for x in diff], **split)
            msg = f'equal up to row {diff[0]} token {diff[1]}; ' + msg
        print(f'  greedy generate() card vs cpu, {label} ({b} x {t0} + '
              f'{new}): {msg} ({distinct} distinct new tokens)', flush=True)
        if not same:
            raise AssertionError(f'{label}: card {streams["cuda"].tolist()}'
                                 f' cpu {streams["cpu"].tolist()}')
        res[label] = rec
    lg = res.pop('logits')
    err = (lg['cuda'] - lg['cpu']).abs().max().item()
    print(f'  forward() logits card vs cpu (2 layers, f32, [2, 256]): max '
          f'abs err {err:.3e} (tol 1e-3)', flush=True)
    if not (torch.isfinite(lg['cuda']).all() and err <= 1e-3):
        raise AssertionError(f'forward logits card vs cpu differ by {err}')
    res['forward_logits_max_abs_err'] = err
    return res


# ---------------------------------------------------------------------------
# phases 9 and 10: the engine over the int8 page pool (kernel 7)
# ---------------------------------------------------------------------------

def paged_prefill_logits(gpt, params, cfg, reqs, dev, rows=None):
    """Logits of a paged prefill over a fresh pool of ``cfg``'s kind (bf16 /
    f32, or int8 banks), one slot per request padded to the longest:
    [R, 1, V] at each request's last row, or with ``rows`` (one count per
    request) the last ``rows[i]`` rows of each as [R, max rows, V] f32 on
    the CPU."""
    ps = 128
    width = max(len(r) for r in reqs)
    per = -(-cfg.max_seq_len // ps)
    pool = gpt.init_paged_kv_cache(cfg, 1 + per * len(reqs), ps, dev)
    table = (torch.arange(per * len(reqs), dtype=torch.int32, device=dev)
             .reshape(len(reqs), per) + 1)
    toks = np.zeros((len(reqs), width), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r)] = r
    valid = torch.tensor([len(r) for r in reqs], dtype=torch.int32,
                         device=dev)
    cache = dict(pool, page_table=table, valid=valid)
    with torch.no_grad():
        lg, _ = gpt.forward_with_cache(
            params, torch.from_numpy(toks).to(dev), cache,
            torch.zeros(len(reqs), dtype=torch.int32, device=dev), cfg,
            last_only=rows is None)
    if rows is None:
        return lg.float().cpu()
    n = max(rows)
    return torch.stack([lg[i, len(r) - n:len(r)].float().cpu()
                        for i, r in enumerate(reqs)])


def phase_engine_int8(gpt, GenerationEngine, kernels, card):
    """The bench GPT in GenerationEngine(kv_cache_int8=True) answering the
    requests of phase 4, eager and captured; then the prefill logits of an
    int8 pool against a bf16 pool's, both through the paged forward the
    engine runs."""
    cfg = bench_config(gpt, kv_cache_int8=True)
    params = gpt.init_params(cfg, torch.Generator(device='cuda').manual_seed(0),
                             'cuda')
    reqs = prompts(8, 16, 400, cfg.vocab_size, seed=0)
    new = 32
    runs, streams = {}, {}
    for mode, capture in MODES:
        runs[mode], streams[mode] = engine_run(
            GenerationEngine, params, cfg, 'paged_decode_int8', kernels,
            reqs, new, capture, card, 'int8 engine')
    if streams['captured'] != streams['eager']:
        raise AssertionError('int8 engine: captured and eager greedy '
                             'streams differ')
    print('  int8 engine greedy streams, captured against eager: equal',
          flush=True)
    print_profiles('int8 engine', runs, 'kernel 7')
    sp = gpt.serving_params(params, cfg)
    lg8 = paged_prefill_logits(gpt, sp, cfg, reqs, 'cuda')
    lgb = paged_prefill_logits(gpt, sp, bench_config(gpt), reqs, 'cuda')
    if not (torch.isfinite(lg8).all() and torch.isfinite(lgb).all()):
        raise AssertionError('non-finite int8 / bf16 prefill logits')
    cos = float((lg8 * lgb).sum() / (lg8.norm() * lgb.norm()))
    res = dict(runs['captured'], eager=runs['eager'],
               prefill_cosine_vs_bf16=cos)
    print(f'  prefill logits int8 vs bf16 pool: cosine {cos:.6f} (want > '
          '0.999)', flush=True)
    if not cos > 0.999:
        raise AssertionError(f'int8 pool prefill logits cosine {cos}')
    return res


def phase_engine_int8_card_vs_cpu(gpt, GenerationEngine):
    """The int8 engine at 2 layers in f32 (block matrices x10, as phase 8)
    on the card and on the CPU: greedy streams equal, or where they split
    at a near-tie, held to phase 8's int8 rule on teacher-forced logits
    through the paged forward."""
    cfg = bench_config(gpt, num_layers=2, dtype='float32',
                       kv_cache_int8=True)
    params = gpt.init_params(cfg, torch.Generator().manual_seed(2), 'cpu')
    for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
        params['blocks'][k] = params['blocks'][k] * 10
    reqs = prompts(4, 16, 200, cfg.vocab_size, seed=1)
    new = 16
    streams = {}
    for dev in ('cuda', 'cpu'):
        eng = GenerationEngine(params, cfg, device=dev, num_slots=8,
                               page_size=128)
        try:
            streams[dev], _ = serve(eng, reqs, new)
        finally:
            eng.shutdown()
    same = streams['cuda'] == streams['cpu']
    rec = {'streams_equal': same}
    msg = 'equal'
    if not same:
        full = [np.concatenate([r, np.asarray(c[:-1], np.int32)])
                for r, c in zip(reqs, streams['cuda'])]
        rows = [new] * len(reqs)

        def tf(c, dev):
            p = {k: ({bk: bv.to(dev) for bk, bv in v.items()}
                     if k == 'blocks' else v.to(dev))
                 for k, v in params.items()}
            return paged_prefill_logits(gpt, gpt.serving_params(p, c), c,
                                        full, dev, rows)

        f32 = bench_config(gpt, num_layers=2, dtype='float32')
        took = torch.tensor(streams['cuda'])
        same, split, msg = int8_split(tf(cfg, 'cpu'), tf(cfg, 'cuda'),
                                      tf(f32, 'cpu'), took)
        rec.update(split)
        msg = 'DIFFERENT; ' + msg
    print(f'  int8 engine greedy streams card vs cpu ({len(reqs)} requests x'
          f' {new} tokens): {msg}', flush=True)
    if not same:
        raise AssertionError(f'int8 engine streams: card {streams["cuda"]} '
                             f'cpu {streams["cpu"]}')
    return rec


# ---------------------------------------------------------------------------
# phases 11 and 12: the single-device train step
# ---------------------------------------------------------------------------

PEAK_BF16 = PEAK_OPS_PER_S[torch.bfloat16]


def phase_train(gpt, topt, kernels, card):
    """The bench rung (bench.py _child_train rung 1): the bench GPT, B=8,
    S=1024, bf16 compute over f32 params, AdamW(2e-4, weight_decay=0.01),
    remat 'dots', xent_chunk 8192, targets = tokens, one numpy-seeded
    batch; 2 warm-up steps (the first counted alone), then 8 timed."""
    cfg = bench_config(gpt, remat=True, remat_policy='dots', xent_chunk=8192)
    b, s = 8, cfg.max_seq_len
    torch.cuda.reset_peak_memory_stats()
    params = gpt.init_params(cfg, torch.Generator(device='cuda').manual_seed(0),
                             'cuda')
    n_params = sum(v.numel() for k, v in params.items() if k != 'blocks')
    n_params += sum(v.numel() for v in params['blocks'].values())
    opt = topt.AdamW(learning_rate=2e-4, weight_decay=0.01)
    state = opt.functional_init(params)
    step = gpt.make_train_step(cfg, opt)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    losses = []

    def one():
        nonlocal params, state
        loss, params, state = step(params, state, 0, 2e-4, toks, toks)
        losses.append(loss)

    L = cfg.num_layers
    # kernel 1 runs 2 x L a step: once in the forward, once more when the
    # backward recomputes each block under remat (the reference recomputes
    # its custom call the same way); kernels 2 and 3 once a layer
    per_step = {'flash_fwd': 2 * L, 'flash_bwd_dq': L, 'flash_bwd_dkv': L}
    zero_launches(kernels)
    one()
    torch.cuda.synchronize()
    expect_launches('one train step', launch_counts(kernels), per_step)
    one()
    n = 8
    zero_launches(kernels)
    _, wall = timed(lambda: [one() for _ in range(n)])
    launches = launch_counts(kernels)
    expect_launches(f'{n} timed train steps', launches,
                    {k: n * v for k, v in per_step.items()})
    train_tc = expect_tensor_core(f'{n} timed train steps', kernels)
    vals = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f'non-finite train loss {vals}')
    if not vals[-1] < vals[0]:
        raise AssertionError(f'the train loss did not fall: {vals}')
    tok_s = b * s * n / wall
    prof = profile_window(one)
    attn_ms = {name: kernel_ms(prof, kern) for name, kern in (
        ('flash_fwd', 'flash_fwd_tc_kernel'),
        ('flash_bwd_dq', 'flash_bwd_dq_tc_kernel'),
        ('flash_bwd_dkv', 'flash_bwd_dkv_tc_kernel'))}
    res = {'params': n_params, 'losses': vals, 'step_ms': wall * 1e3 / n,
           'tokens_per_s': tok_s,
           'mfu': 6 * n_params * tok_s / PEAK_BF16,
           'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
           'launches': launches, 'tensor_core_launches': train_tc,
           'profile': prof, 'attention_device_ms': attn_ms}
    print(f'  train step at full width ({n_params / 1e6:.1f}M params, '
          f'[{b}, {s}], bf16, remat dots): {res["step_ms"]:.1f} ms a step, '
          f'{tok_s:.0f} tokens/s, MFU {100 * res["mfu"]:.2f}% of 989 '
          f'TFLOP/s, peak {res["peak_mem_gb"]:.2f} GB [{card}]', flush=True)
    print(f'  losses {" ".join(f"{x:.4f}" for x in vals)}', flush=True)
    print(f'  profiled step: window {prof["window_ms"]:.1f} ms, device busy '
          f'{prof["device_ms"]:.1f} ms ({100 * prof["busy_share"]:.1f}%), '
          f'{prof["kernels"]} kernel launches', flush=True)
    for name, ms in prof['top']:
        print(f'    {ms:9.3f} ms  {name}', flush=True)
    print('  attention kernels in the profiled step, device ms: '
          + ', '.join(f'{k} {v:.3f}' for k, v in attn_ms.items()),
          flush=True)
    del params, state
    torch.cuda.empty_cache()
    return res


# card vs CPU train step, f32 at 2 layers: gradients and losses sum in
# other orders (cuBLAS, the kernels' tiles) but in f32 throughout
TRAIN_GRAD_TOL = 1e-3      # each gradient's largest error / its largest value
TRAIN_LOSS_TOL = 1e-4      # relative, each of 6 losses


def phase_train_card_vs_cpu(gpt, topt):
    """The train step at 2 layers in f32 (hidden 1024, vocab 32768, [2,
    256]) on the card and on the CPU, from the same weights and tokens:
    the first step's gradients and a 6-step AdamW loss curve, without
    dropout and with dropout 0.1 under the same u32 seeds."""
    res = {}
    for drop in (0.0, 0.1):
        cfg = bench_config(gpt, num_layers=2, dtype='float32',
                           max_seq_len=256, dropout=drop)
        params = gpt.init_params(cfg, torch.Generator().manual_seed(3), 'cpu')
        rng = np.random.RandomState(5)
        toks = rng.randint(0, cfg.vocab_size, (2, 256)).astype(np.int32)
        tgts = rng.randint(0, cfg.vocab_size, (2, 256)).astype(np.int32)
        seeds = [2 ** 31 + 7919 * i for i in range(7)]
        grads, curves = {}, {}
        for dev in ('cuda', 'cpu'):
            p = {k: ({bk: bv.to(dev).clone() for bk, bv in v.items()}
                     if k == 'blocks' else v.to(dev).clone())
                 for k, v in params.items()}
            t, y = (torch.from_numpy(x).to(dev) for x in (toks, tgts))
            leaves = gpt._leaves(p)
            live = [x.detach().clone().requires_grad_() for x in leaves]
            loss = gpt.loss_fn(gpt._rebuild(p, live), t, y, cfg, seeds[0])
            grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, live)]
            opt = topt.AdamW(learning_rate=1e-3, weight_decay=0.01)
            state = opt.functional_init(p)
            step = gpt.make_train_step(cfg, opt)
            curve = []
            for i in range(6):
                loss, p, state = step(p, state, seeds[i + 1], 1e-3, t, y)
                curve.append(float(loss))
            curves[dev] = curve
        g_err = max((a - b).abs().max().item() / b.abs().max().clamp_min(
            1e-30).item() for a, b in zip(grads['cuda'], grads['cpu']))
        l_err = max(abs(a - b) / abs(b) for a, b in zip(curves['cuda'],
                                                        curves['cpu']))
        ok = (g_err <= TRAIN_GRAD_TOL and l_err <= TRAIN_LOSS_TOL
              and curves['cpu'][-1] < curves['cpu'][0])
        print(f'  train card vs cpu (2 layers, f32, dropout {drop}): grads '
              f'{g_err:.2e} (tol {TRAIN_GRAD_TOL:g}), 6-step losses '
              f'{l_err:.2e} (tol {TRAIN_LOSS_TOL:g}): card '
              f'{" ".join(f"{x:.5f}" for x in curves["cuda"])} '
              f'{"OK" if ok else "FAIL"}', flush=True)
        if not ok:
            raise AssertionError(f'train card vs cpu, dropout {drop}: grads '
                                 f'{g_err}, losses {curves}')
        res[f'dropout_{drop}'] = {'grad_rel_err': g_err,
                                  'loss_rel_err': l_err, 'curves': curves}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--report', default=None,
                    help='also write the full report (JSON) to this path')
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 2
    # the port itself: absent when this script stands alone
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.serving import GenerationEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {'paged_decode': pa.paged_flash_decode,
                'paged_decode_int8': pa.paged_flash_decode_int8,
                'flash_decode': fa.flash_decode,
                'flash_decode_int8': fa.flash_decode_int8,
                'flash_fwd': fa.flash_fwd,
                'flash_bwd_dq': fa.flash_bwd_dq,
                'flash_bwd_dkv': fa.flash_bwd_dkv}

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f'phase 1: card {card!r}; torch {torch.__version__} cuda '
          f'{torch.version.cuda}; device {kind!r} x {count}', flush=True)

    report = {'card': card}
    t0 = time.perf_counter()
    _build.build(SOURCES)
    secs = time.perf_counter() - t0
    print(f'phase 2: built {", ".join(SOURCES)} (nvcc sm_90a, in parallel) '
          f'in {secs:.1f} s', flush=True)
    for name in SOURCES:
        log = _build.build_log[name]
        print(f'  {name}: nvcc {log["seconds"]:.1f} s', flush=True)
        for line in log['ptxas'].splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'    ptxas: {line.strip()}', flush=True)
    report['build_s'] = secs
    print('phase 3: kernels against their plain twins on the card',
          flush=True)
    report['kernel'] = kr = kernel_cases(pa, TIMED_ITERS)
    report['dense_kernels'] = dk = dense_kernel_cases(fa, pa, TIMED_ITERS)
    report['bwd_kernels'] = bk = bwd_kernel_cases(fa, TIMED_ITERS)
    print('phase 4: GenerationEngine at full width', flush=True)
    report['engine'] = phase_engine(gpt, GenerationEngine, counters,
                                    card)
    print('phase 5: card against CPU at 2 layers', flush=True)
    report['card_vs_cpu'] = phase_card_vs_cpu(gpt, GenerationEngine)
    print('phase 6: dense generate() at full width', flush=True)
    model, report['generate'] = phase_generate(gpt, counters, card)
    print('phase 7: forward() and the sliding window at full width',
          flush=True)
    report['forward'] = phase_forward_sliding(gpt, model, counters, card)
    del model
    torch.cuda.empty_cache()
    print('phase 8: generate() card against CPU at 2 layers', flush=True)
    report['generate_card_vs_cpu'] = phase_generate_card_vs_cpu(gpt)
    print('phase 9: GenerationEngine over the int8 page pool at full width',
          flush=True)
    report['engine_int8'] = phase_engine_int8(gpt, GenerationEngine,
                                              counters, card)
    print('phase 10: int8 engine card against CPU at 2 layers', flush=True)
    report['engine_int8_card_vs_cpu'] = phase_engine_int8_card_vs_cpu(
        gpt, GenerationEngine)
    print('phase 11: the train step at full width', flush=True)
    report['train'] = phase_train(gpt, topt, counters, card)
    print('phase 12: the train step card against CPU at 2 layers',
          flush=True)
    report['train_card_vs_cpu'] = phase_train_card_vs_cpu(gpt, topt)

    gen, fwd = report['generate'], report['forward']
    train = report['train']['launches']
    main_path = {
        'paged_decode': report['engine']['launches'],
        'paged_decode_int8': report['engine_int8']['launches'],
        'flash_decode': gen['bf16']['launches']
        + fwd['launches']['flash_decode'],
        'flash_decode_int8': gen['int8']['launches'],
        'flash_fwd': fwd['forward_launches']['flash_fwd']
        + fwd['launches']['flash_fwd'] + train['flash_fwd'],
        'flash_bwd_dq': train['flash_bwd_dq'],
        'flash_bwd_dkv': train['flash_bwd_dkv'],
    }
    timed_shape = {'paged_decode': 'decode_T1',
                   'paged_decode_int8': 'decode_T1',
                   'flash_decode': 'decode_T1',
                   'flash_decode_int8': 'decode_T1_int8',
                   'flash_fwd': 'fwd_S1024', 'flash_bwd_dq': 'bwd_S1024',
                   'flash_bwd_dkv': 'bwd_S1024'}
    cases = dict(dk, **kr, **bk)
    kernels = []
    for name in SOURCE_OF:
        recs = cases[name]
        main_rec = recs[timed_shape[name]]
        kernels.append({
            'name': name,
            'route': 'cuda',
            'source': SOURCE_OF[name],
            'replaces': REPLACES[name],
            'launches': main_path[name],
            'max_abs_err': max(r['max_abs_err'] for r in recs.values()),
            'ms': main_rec['ms'], 'plain_ms': main_rec['plain_ms'],
            'bound_ms': main_rec['bound_ms'],
            'bound_by': main_rec['bound_by'],
            'library_ms': main_rec['library_ms'],
            'shapes': {k: v for k, v in recs.items() if 'ms' in v},
        })
    report['seconds'] = time.perf_counter() - t_start
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, 'w') as f:
            json.dump(report, f, indent=1)
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': kind, 'count': count}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
