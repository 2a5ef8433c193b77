#!/usr/bin/env python3
"""Where a warm prefix-cache request's TTFT goes, on one NVIDIA card.

    python3 ttft_probe.py [--waves N] [--handoff-s S] [--report PATH]

Builds kernel 6 (paged_decode), then serves ``chip_smoke.py`` phase 15's
traffic over its bf16 pool (the bench GPT, 8 slots, pages of 128, numpy
seed 0): the 12-request wave once on a cache-off engine and once cold on
a cache-on engine, then ``--waves`` warm waves, each request submitted
after the previous one's stream ended. Every warm TTFT (submit to the
first streamed token) is split at the request's own timeline: submit to
``enqueue``, ``enqueue`` to ``admit``, ``admit`` to ``first_emit``, and
``first_emit`` to the client holding the token. It counts the waves whose
worst request is over phase 15's gate (``TTFT_RATIO_MAX`` x the cold
wave's p99) and lists the requests over it with their segments and any
garbage collection that overlapped them.

Then, for ``--handoff-s`` seconds, a bare two-thread handoff of the same
shape in plain Python: the client notifies a worker, the worker spins 0.5
ms and notifies back; the same count over 12-handoff windows says how
much of the tail the host's thread wake-ups alone give.

Prints a summary, and one JSON object as the last line. It imports the
port and ``chip_smoke`` from the directory it sits in, so a copy placed in
another checkout measures that checkout's engine.
"""
import argparse
import gc
import json
import os
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEGMENTS = ('submit->enqueue', 'enqueue->admit', 'admit->emit',
            'emit->client')


def warm_wave(eng, reqs, new, reqtrace):
    """chip_smoke.wave with each request's timeline split. -> rows."""
    rows = []
    for p, seed in reqs:
        t0 = time.perf_counter()
        fut = eng.submit(p, max_new_tokens=new, seed=seed)
        rec = reqtrace.recorder()._active.get(fut.request_id)
        it = fut.stream(timeout=600)
        next(it)
        t1 = time.perf_counter()
        list(it)
        ev = {e['ev']: e['t_ms'] for e in rec.timeline}
        at = (rec._mono0 - t0) * 1e3          # the record's origin
        marks = [0.0, at + ev['enqueue'], at + ev['admit'],
                 at + ev['first_emit'], (t1 - t0) * 1e3]
        rows.append({'ttft_ms': marks[-1], 't0': t0, 't1': t1,
                     'segments_ms': np.diff(marks).tolist()})
    return rows


def handoff(seconds, work_s=0.0005):
    """Round trips of a bare two-thread handoff (ms), one every 10 ms."""
    cv = threading.Condition()
    box = {'req': False, 'resp': False, 'stop': False}

    def worker():
        while True:
            with cv:
                while not box['req'] and not box['stop']:
                    cv.wait(0.05)
                if box['stop']:
                    return
                box['req'] = False
            t = time.perf_counter()
            while time.perf_counter() - t < work_s:
                pass
            with cv:
                box['resp'] = True
                cv.notify_all()

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    out, end = [], time.perf_counter() + seconds
    while time.perf_counter() < end:
        t0 = time.perf_counter()
        with cv:
            box['req'] = True
            cv.notify_all()
            while not box['resp']:
                cv.wait()
            box['resp'] = False
        out.append((time.perf_counter() - t0) * 1e3)
        time.sleep(0.01)
    with cv:
        box['stop'] = True
        cv.notify_all()
    th.join()
    return out


def windows_over(xs, limit, n=12):
    return sum(max(xs[i:i + n]) > limit for i in range(0, len(xs) - n + 1, n))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--waves', type=int, default=25)
    ap.add_argument('--handoff-s', type=float, default=15.0)
    ap.add_argument('--report', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('ttft_probe: no CUDA device; nothing was run', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.observability import reqtrace
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving import GenerationEngine

    card = cs.card_line()
    print(f'card {card!r}; engine from {os.path.dirname(gpt.__file__)}',
          flush=True)
    _build.build(('paged_decode',))
    collections = []
    started = {}

    def on_gc(phase, info):
        if phase == 'start':
            started['t'] = time.perf_counter()
        else:
            collections.append((started['t'], time.perf_counter(),
                                info['generation']))

    gc.callbacks.append(on_gc)
    rng = np.random.RandomState(0)
    cfg = cs.bench_config(gpt)
    system = rng.randint(1, cfg.vocab_size, cs.PFX_SYSTEM).astype(np.int32)
    shared = [(np.concatenate([system, rng.randint(
        1, cfg.vocab_size, int(n)).astype(np.int32)]), i)
        for i, n in enumerate(rng.randint(64, 256, cs.PFX_REQUESTS))]
    params = gpt.init_params(cfg, torch.Generator(device='cuda').manual_seed(0),
                             'cuda')
    off = GenerationEngine(params, cfg, num_slots=8, page_size=128)
    on = GenerationEngine(params, cfg, num_slots=8, page_size=128,
                          prefix_cache=True)
    try:
        off.warmup()
        on.warmup()
        want, _ = cs.wave(off, shared)
        cold, cold_ttft = cs.wave(on, shared)
        limit = cs.TTFT_RATIO_MAX * cs.p99(cold_ttft)
        rows = []
        for _ in range(args.waves):
            before = len(rows)
            rows += warm_wave(on, shared, cs.PFX_NEW, reqtrace)
            assert len(rows) - before == len(shared)
        full_hits = on.stats()['prefix_full_hits']
    finally:
        on.shutdown()
        off.shutdown()
        gc.callbacks.remove(on_gc)
    if cold != want:
        raise AssertionError('cache-on cold streams differ from cache-off')
    ttft = [r['ttft_ms'] for r in rows]
    seg = np.median([r['segments_ms'] for r in rows], axis=0)
    over = [r for r in rows if r['ttft_ms'] > limit]
    res = {'card': card, 'waves': args.waves, 'requests': len(rows),
           'full_hits': full_hits, 'cold_ttft_ms_p99': cs.p99(cold_ttft),
           'limit_ms': limit, 'warm_ttft_ms_p50': float(np.median(ttft)),
           'warm_ttft_ms_p99': float(np.percentile(ttft, 99)),
           'warm_ttft_ms_max': max(ttft),
           'segments_ms_p50': dict(zip(SEGMENTS, seg.tolist())),
           'waves_over': windows_over(ttft, limit),
           'requests_over': [
               {'ttft_ms': r['ttft_ms'],
                'segments_ms': dict(zip(SEGMENTS, r['segments_ms'])),
                'gc': [g for s, e, g in collections
                       if s < r['t1'] and e > r['t0']]} for r in over]}
    print(f'warm TTFT over {len(rows)} requests: p50 '
          f'{res["warm_ttft_ms_p50"]:.3f} p99 {res["warm_ttft_ms_p99"]:.3f} '
          f'max {res["warm_ttft_ms_max"]:.3f} ms; gate {limit:.3f} ms '
          f'(cold p99 {res["cold_ttft_ms_p99"]:.3f}); waves over '
          f'{res["waves_over"]}/{args.waves}; segments p50 '
          + ', '.join(f'{k} {v:.3f}' for k, v in
                      res['segments_ms_p50'].items()) + f' [{card}]',
          flush=True)
    for r in res['requests_over']:
        print(f'  over: {r["ttft_ms"]:.3f} ms = '
              + ', '.join(f'{k} {v:.3f}' for k, v in
                          r['segments_ms'].items()) + f'; gc {r["gc"]}',
              flush=True)
    hand = handoff(args.handoff_s)
    res['handoff'] = {'n': len(hand), 'p50_ms': float(np.median(hand)),
                      'p99_ms': float(np.percentile(hand, 99)),
                      'max_ms': max(hand),
                      'windows_over': windows_over(hand, limit),
                      'windows': len(hand) // 12}
    h = res['handoff']
    print(f'bare handoff (0.5 ms of work) x {h["n"]}: p50 {h["p50_ms"]:.3f} '
          f'p99 {h["p99_ms"]:.3f} max {h["max_ms"]:.3f} ms; 12-windows over '
          f'the gate {h["windows_over"]}/{h["windows"]}', flush=True)
    if args.report:
        with open(args.report, 'w') as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != 'requests_over'}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
