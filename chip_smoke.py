#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--report PATH]

Phases, all of them on every run, in order; any failure raises and exits
non-zero:
 1. the card: nvidia-smi name and power limit, torch's device name/count;
 2. build every kernel of the serving path from the sources in the
    checkout (nvcc, sm_90a) and print the build time and ptxas report;
 3. each kernel against its plain PyTorch twin on the card, at the shapes
    the engine gives it (decode T=1 at ragged positions, prefill T=1024),
    plus GQA, float32 and other head-dim cases; max abs error against the
    stated tolerance (scaled to each output row's size in bfloat16),
    kernel / plain / library times and the bound;
 4. the serving path at full width: the bench GPT (vocab 32768, hidden
    1024, 24 layers, 16 heads, bf16, random weights from a seed) in
    GenerationEngine(num_slots=8, page_size=128) answering 8 greedy
    requests with ragged prompts; every launch counter is set to 0 just
    before and read just after, and must equal 24 x (prefills + steps);
 5. card against CPU at reduced depth (hidden 1024, 2 layers, float32), the
    engine at its default 1024-row prefill on both: prefill logits agree
    and greedy streams are equal.
Then one line of kernel records (JSON), and the last line
``{"ok": true, "device": {...}}``.

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


# ---------------------------------------------------------------------------
# phase 3: paged-decode kernel against its twin
# ---------------------------------------------------------------------------

def make_case(b, t, h, h_kv, d, pos, dtype, ps=128, p_max=8, seed=0):
    """q, LAYERS page pools, a table of scattered pages and ``pos``, on the
    card. Entries past a slot's needed pages stay 0 (the trash page), as
    the engine leaves them."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    n = b * p_max + 1
    q = torch.randn((b, t, h, d), generator=g, device='cuda').to(dtype)
    kp = torch.randn((LAYERS, n, ps, h_kv, d), generator=g,
                     device='cuda').to(dtype)
    vp = torch.randn((LAYERS, n, ps, h_kv, d), generator=g,
                     device='cuda').to(dtype)
    perm = np.random.RandomState(seed).permutation(np.arange(1, n))
    table = np.zeros((b, p_max), np.int32)
    for i, p0 in enumerate(pos):
        need = min(-(-(p0 + t) // ps), p_max)
        table[i, :need] = perm[i * p_max:i * p_max + need]
    return dict(q=q, k=kp, v=vp,
                table=torch.from_numpy(table).cuda(),
                pos=torch.tensor(pos, dtype=torch.int32, device='cuda'),
                ps=ps, p_max=p_max)


def bound(c):
    """Least time for the call: each input byte read once (the KV rows the
    slots can see, q, table, pos), the output written once, and 4*D flops
    per (row, visible key, head); the larger of bytes / HBM rate and
    operations / peak rate for the dtype."""
    q = c['q']
    b, t, h, d = q.shape
    h_kv = c['k'].shape[3]
    es = q.element_size()
    cap = c['p_max'] * c['ps']
    keys = [min(p0 + t, cap) for p0 in c['pos'].tolist()]
    kv_bytes = 2 * sum(keys) * h_kv * d * es
    nbytes = kv_bytes + 2 * q.numel() * es + c['table'].numel() * 4 + b * 4
    ops = 0
    for p0 in c['pos'].tolist():
        vis = sum(min(p0 + j + 1, cap) for j in range(t))
        ops += 4 * d * h * vis
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[q.dtype] * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops
            else 'operations', nbytes, ops)


def sdpa_ms(c, iters):
    """Yardstick only (never called by the port): one
    F.scaled_dot_product_attention over the cache gathered through the
    table (the gather is done beforehand and not timed)."""
    from paddle_tpu_torch.ops.paged_kv import gather_virtual
    import torch.nn.functional as F
    q = c['q']
    b, t, h, d = q.shape
    rot = 8
    ks, vs = [], []
    for layer in range(rot):
        kg = gather_virtual(c['k'][layer], c['table'])     # [B,S,Hkv,D]
        vg = gather_virtual(c['v'][layer], c['table'])
        ks.append(kg.permute(0, 2, 1, 3).contiguous())
        vs.append(vg.permute(0, 2, 1, 3).contiguous())
    s = ks[0].shape[2]
    qpos = c['pos'].long()[:, None, None] + torch.arange(
        t, device='cuda')[None, :, None]
    mask = (torch.arange(s, device='cuda')[None, None, :] <= qpos)[:, None]
    qt = q.permute(0, 2, 1, 3).contiguous()
    return cuda_ms(lambda i: F.scaled_dot_product_attention(
        qt, ks[i % rot], vs[i % rot], attn_mask=mask), iters)


def kernel_err(got, want):
    """(max |got - want|, max over output rows of that row's largest
    |got - want| / its largest |want|)."""
    d = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    return d.max().item(), (d / scale).max().item()


def kernel_cases(pa, timed_iters):
    rng = np.random.RandomState(1)
    ragged = [int(x) for x in rng.randint(16, 1023, size=8)]
    ragged[0], ragged[1] = 0, 1023          # both ends of the window
    cases = [
        ('decode_T1', dict(b=8, t=1, h=16, h_kv=16, d=64, pos=ragged,
                           dtype=torch.bfloat16), True),
        ('prefill_T1024', dict(b=1, t=1024, h=16, h_kv=16, d=64, pos=[0],
                               dtype=torch.bfloat16), True),
        ('decode_T1_gqa_hkv4', dict(b=8, t=1, h=16, h_kv=4, d=64,
                                    pos=ragged, dtype=torch.bfloat16), False),
        ('decode_T1_d128', dict(b=8, t=1, h=8, h_kv=8, d=128, pos=ragged,
                                dtype=torch.bfloat16), False),
        ('decode_T1_d256', dict(b=8, t=1, h=4, h_kv=4, d=256, pos=ragged,
                                dtype=torch.bfloat16), False),
        ('decode_T1_f32', dict(b=8, t=1, h=16, h_kv=16, d=64, pos=ragged,
                               dtype=torch.float32), False),
        ('prefill_T300_f32_gqa', dict(b=2, t=300, h=16, h_kv=4, d=64,
                                      pos=[0, 517], dtype=torch.float32),
         False),
    ]
    results = {}
    for name, kw, engine_shape in cases:
        c = make_case(**kw)
        args = lambda i: (c['q'], c['k'][i % LAYERS], c['v'][i % LAYERS],  # noqa: E731
                          c['table'], c['pos'])
        before = pa.paged_flash_decode.launches
        got = pa.paged_flash_decode(*args(0))
        torch.cuda.synchronize()
        want = pa.paged_decode_reference(*args(0))
        err, rel = kernel_err(got, want)
        tol = TOL[kw['dtype']]
        ok = math.isfinite(err) and rel <= tol
        rec = {'max_abs_err': err, 'max_row_rel_err': rel, 'tol': tol}
        if engine_shape:
            b_ms, b_by, nbytes, ops = bound(c)
            rec.update(
                ms=cuda_ms(lambda i: pa.paged_flash_decode(*args(i)),
                           timed_iters),
                plain_ms=cuda_ms(lambda i: pa.paged_decode_reference(
                    *args(i)), max(4, timed_iters // 10), warmup=1),
                library_ms=sdpa_ms(c, timed_iters),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops)
        # launches made here only compare and time: not the main path's
        pa.paged_flash_decode.launches = before
        print(f'  kernel paged_decode {name}: max_abs_err {err:.3e}, '
              f'row-scaled {rel:.3e} (tol {tol:g}) {"OK" if ok else "FAIL"}'
              + (f'; kernel {rec["ms"]:.4f} ms, plain {rec["plain_ms"]:.4f}'
                 f' ms, sdpa {rec["library_ms"]:.4f} ms, bound '
                 f'{rec["bound_ms"]:.4f} ms ({rec["bound_by"]})'
                 if engine_shape else ''), flush=True)
        if not ok:
            raise AssertionError(f'paged_decode {name}: kernel and twin '
                                 f'differ by {rel} of a row > {tol}')
        results[name] = rec
        del c
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


def serve(engine, reqs, max_new):
    t0 = time.perf_counter()
    futs = [engine.submit(p, max_new_tokens=max_new) for p in reqs]
    out = [f.result(timeout=600) for f in futs]
    return out, time.perf_counter() - t0


def phase_engine(gpt, pa, GenerationEngine, card):
    cfg = bench_config(gpt)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device='cuda').manual_seed(0)
    params = gpt.init_params(cfg, gen, 'cuda')
    n_params = sum(v.numel() for k, v in params.items() if k != 'blocks')
    n_params += sum(v.numel() for v in params['blocks'].values())
    eng = GenerationEngine(params, cfg, num_slots=8, page_size=128)
    try:
        w = eng.warmup()
        reqs = prompts(8, 16, 400, cfg.vocab_size, seed=0)
        new = 32
        pa.paged_flash_decode.launches = 0
        out, wall = serve(eng, reqs, new)
        torch.cuda.synchronize()
        launches = pa.paged_flash_decode.launches
        st = eng.stats()
        prof = profile_serving(eng, reqs, new)
    finally:
        eng.shutdown()
    for i, toks in enumerate(out):
        if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                       for t in toks):
            raise AssertionError(f'request {i}: {len(toks)} tokens, want '
                                 f'{new} in [0, {cfg.vocab_size})')
    calls = st['prefills'] + st['steps']
    if launches != cfg.num_layers * calls:
        raise AssertionError(
            f'paged_decode launched {launches} times, want '
            f'{cfg.num_layers} x ({st["prefills"]} prefills + '
            f'{st["steps"]} steps) = {cfg.num_layers * calls}')
    if launches == 0:
        raise AssertionError('the main path launched no kernel')
    res = {'params': n_params, 'requests': len(out), 'new_tokens': new,
           'prompt_lens': [len(p) for p in reqs], 'wall_s': wall,
           'tokens_per_s': len(out) * new / wall,
           'ttft_ms_p50': st['ttft_ms_p50'],
           'ttft_ms_p99': st['ttft_ms_p99'],
           'step_ms_mean': st['decode_step_ms_mean'],
           'prefill_ms_mean': st['prefill_ms_mean'],
           'prefills': st['prefills'], 'steps': st['steps'],
           'launches': launches, 'warmup_s': w['seconds'],
           'prefill_pad_share': prefill_pad_share(
               [len(p) for p in reqs], eng.prefill_width, eng.page_size),
           'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
           'profile': prof}
    print(f'  engine at full width ({n_params / 1e6:.1f}M params, 8 slots, '
          f'page 128): {len(out)}/{len(reqs)} requests x {new} tokens in '
          f'{wall:.3f} s; {res["tokens_per_s"]:.1f} tokens/s, TTFT p50 '
          f'{res["ttft_ms_p50"]:.1f} ms, mean step {res["step_ms_mean"]:.2f}'
          f' ms, mean prefill {res["prefill_ms_mean"]:.2f} ms [{card}]',
          flush=True)
    print(f'  launches {launches} == {cfg.num_layers} x ({st["prefills"]} '
          f'prefills + {st["steps"]} steps)', flush=True)
    print(f'  prefill attention work on padding-only q tiles (prompts '
          f'{min(res["prompt_lens"])}-{max(res["prompt_lens"])} rows padded '
          f'to {eng.prefill_width}): {100 * res["prefill_pad_share"]:.1f}%',
          flush=True)
    print(f'  profiled rerun: window {prof["window_ms"]:.1f} ms, device busy '
          f'{prof["device_ms"]:.1f} ms ({100 * prof["busy_share"]:.1f}%), '
          f'{prof["kernels"]} kernel launches', flush=True)
    for name, ms in prof['top']:
        print(f'    {ms:9.3f} ms  {name}', flush=True)
    return res


def profile_serving(eng, reqs, new):
    """The same traffic again under torch.profiler: the window's wall
    time, the device time summed over every kernel and copy, and the
    kernels that took most of it. The profiler adds host time of its
    own, so the busy share it gives is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        _, wall = serve(eng, reqs, new)
        torch.cuda.synchronize()
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
            'top': [(k[:90], v) for k, v in top]}


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
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import GenerationEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f'phase 1: card {card!r}; torch {torch.__version__} cuda '
          f'{torch.version.cuda}; device {kind!r} x {count}', flush=True)

    report = {'card': card}
    t0 = time.perf_counter()
    _build.load('paged_decode')
    secs = time.perf_counter() - t0
    log = _build.build_log['paged_decode']
    print(f'phase 2: built paged_decode (nvcc sm_90a) in {secs:.1f} s '
          f'(nvcc {log["seconds"]:.1f} s)', flush=True)
    for line in log['ptxas'].splitlines():
        if 'registers' in line or 'spill' in line:
            print(f'  ptxas: {line.strip()}', flush=True)
    report['build_s'] = secs
    print('phase 3: kernel against plain twin on the card', flush=True)
    report['kernel'] = kr = kernel_cases(pa, TIMED_ITERS)
    print('phase 4: GenerationEngine at full width', flush=True)
    report['engine'] = phase_engine(gpt, pa, GenerationEngine, card)
    print('phase 5: card against CPU at 2 layers', flush=True)
    report['card_vs_cpu'] = phase_card_vs_cpu(gpt, GenerationEngine)

    main_rec = kr['decode_T1']
    kernels = [{
        'name': 'paged_decode',
        'route': 'cuda',
        'source': 'paddle_tpu_torch/csrc/paged_decode.cu',
        'replaces': 'paddle_tpu/ops/paged_attention.py:70',
        'launches': report['engine']['launches'],
        'max_abs_err': max(r['max_abs_err'] for r in kr.values()),
        'ms': main_rec['ms'], 'plain_ms': main_rec['plain_ms'],
        'bound_ms': main_rec['bound_ms'],
        'bound_by': main_rec['bound_by'],
        'library_ms': main_rec['library_ms'],
        'shapes': {k: v for k, v in kr.items() if 'ms' in v},
    }]
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
