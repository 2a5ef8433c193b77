#!/usr/bin/env python3
"""Where a warm prefix-cache request's TTFT goes, on one NVIDIA card.

    python3 ttft_probe.py [--waves N] [--pools bf16,int8] [--handoff-s S]
                          [--report PATH]

Builds ``paged_decode.cu`` (kernels 6 and 7), then serves
``chip_smoke.py`` phase 15's traffic over each pool named (the bench GPT,
8 slots, pages of 128, numpy seed 0): the 12-request wave once on a
cache-off engine and once cold on a cache-on engine, then ``--waves``
warm waves, each request submitted after the previous one's stream ended.
Every warm TTFT (submit to the first streamed token) is split at the
request's own timeline: submit to ``enqueue``, ``enqueue`` to ``admit``,
``admit`` to ``first_emit``, and ``first_emit`` to the client holding the
token. Beside it stand the client thread's CPU time over the request and
its context switches (voluntary: it blocked, on the GIL or a lock;
involuntary: the OS preempted it), read from /proc before and after. It
counts the waves whose worst request is over phase 15's gate
(``TTFT_RATIO_MAX`` x the cold wave's p99) and lists the requests over it
with their segments, switches and any garbage collection that overlapped
them.

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
import resource
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEGMENTS = ('submit->enqueue', 'enqueue->admit', 'admit->emit',
            'emit->client')


def switches():
    """(voluntary, involuntary) context switches of the calling thread
    (getrusage holds the GIL: a read of /proc would release it and let a
    waiting thread in)."""
    ru = resource.getrusage(resource.RUSAGE_THREAD)
    return ru.ru_nvcsw, ru.ru_nivcsw


class CopyTimer:
    """Wraps the engine's copy-on-write page copy: its wall ms and the
    caller's switches inside it, summed since the last ``take()``."""

    def __init__(self, pkv):
        self.pkv, self.orig = pkv, pkv.copy_page
        self.ms, self.sw = 0.0, [0, 0]
        pkv.copy_page = self

    def __call__(self, *a):
        s0, t0 = switches(), time.perf_counter()
        try:
            return self.orig(*a)
        finally:
            self.ms += (time.perf_counter() - t0) * 1e3
            self.sw = [x + b - a for x, a, b in zip(self.sw, s0, switches())]

    def take(self):
        out, self.ms, self.sw = (self.ms, self.sw), 0.0, [0, 0]
        return out

    def restore(self):
        self.pkv.copy_page = self.orig


def warm_wave(eng, reqs, new, reqtrace, copies):
    """chip_smoke.wave with each request's timeline split. -> rows."""
    rows = []
    for p, seed in reqs:
        copies.take()
        sw0 = switches()
        c0 = time.thread_time()
        t0 = time.perf_counter()
        fut = eng.submit(p, max_new_tokens=new, seed=seed)
        rec = reqtrace.recorder()._active.get(fut.request_id)
        it = fut.stream(timeout=600)
        next(it)
        t1 = time.perf_counter()
        c1 = time.thread_time()
        sw1 = switches()
        copy_ms, copy_sw = copies.take()
        list(it)
        ev = {e['ev']: e['t_ms'] for e in rec.timeline}
        at = (rec._mono0 - t0) * 1e3          # the record's origin
        marks = [0.0, at + ev['enqueue'], at + ev['admit'],
                 at + ev['first_emit'], (t1 - t0) * 1e3]
        rows.append({'ttft_ms': marks[-1], 't0': t0, 't1': t1,
                     'segments_ms': np.diff(marks).tolist(),
                     'cpu_ms': (c1 - c0) * 1e3,
                     'switches': [b - a for a, b in zip(sw0, sw1)],
                     'copy_ms': copy_ms, 'copy_switches': copy_sw,
                     'threads': threading.active_count()})
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


def probe_pool(cs, gpt, GenerationEngine, reqtrace, cfg, params, shared,
               waves, collections, copies):
    """Phase 15's waves over one pool. -> (result dict, requests over)."""
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
        for _ in range(waves):
            before = len(rows)
            rows += warm_wave(on, shared, cs.PFX_NEW, reqtrace, copies)
            assert len(rows) - before == len(shared)
        full_hits = on.stats()['prefix_full_hits']
        names = sorted(t.name for t in threading.enumerate())
    finally:
        on.shutdown()
        off.shutdown()
    if cold != want:
        raise AssertionError('cache-on cold streams differ from cache-off')
    ttft = [r['ttft_ms'] for r in rows]
    seg = np.median([r['segments_ms'] for r in rows], axis=0)
    sw = np.asarray([r['switches'] for r in rows])
    res = {'waves': waves, 'requests': len(rows), 'full_hits': full_hits,
           'cold_ttft_ms_p99': cs.p99(cold_ttft), 'limit_ms': limit,
           'warm_ttft_ms_p50': float(np.median(ttft)),
           'warm_ttft_ms_p99': float(np.percentile(ttft, 99)),
           'warm_ttft_ms_max': max(ttft),
           'segments_ms_p50': dict(zip(SEGMENTS, seg.tolist())),
           'cpu_ms_p50': float(np.median([r['cpu_ms'] for r in rows])),
           'requests_switched': {'voluntary': int((sw[:, 0] > 0).sum()),
                                 'involuntary': int((sw[:, 1] > 0).sum())},
           'threads': max(r['threads'] for r in rows),
           'thread_names': names,
           'copy_ms_p50': float(np.median([r['copy_ms'] for r in rows])),
           'waves_over': windows_over(ttft, limit)}
    over = [{'ttft_ms': r['ttft_ms'],
             'segments_ms': dict(zip(SEGMENTS, r['segments_ms'])),
             'cpu_ms': r['cpu_ms'], 'switches': r['switches'],
             'copy_ms': r['copy_ms'], 'copy_switches': r['copy_switches'],
             'gc': [g for s, e, g in collections
                    if s < r['t1'] and e > r['t0']]}
            for r in rows if r['ttft_ms'] > limit]
    return res, over


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--waves', type=int, default=25)
    ap.add_argument('--pools', default='bf16')
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
    from paddle_tpu_torch.serving import generation

    card = cs.card_line()
    print(f'card {card!r}; engine from {os.path.dirname(gpt.__file__)}',
          flush=True)
    pools = args.pools.split(',')
    _build.build(('paged_decode',))        # kernels 6 and 7
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
    res = {'card': card}
    copies = CopyTimer(generation._pkv)
    try:
        for pool in pools:
            c = cs.bench_config(gpt, kv_cache_int8=pool == 'int8')
            r, over = probe_pool(cs, gpt, GenerationEngine, reqtrace, c,
                                 params, shared, args.waves, collections,
                                 copies)
            res[pool] = dict(r, requests_over=over)
            print(f'{pool} pool: warm TTFT over {r["requests"]} requests: p50 '
                  f'{r["warm_ttft_ms_p50"]:.3f} p99 {r["warm_ttft_ms_p99"]:.3f}'
                  f' max {r["warm_ttft_ms_max"]:.3f} ms; gate '
                  f'{r["limit_ms"]:.3f} ms (cold p99 '
                  f'{r["cold_ttft_ms_p99"]:.3f}); waves over '
                  f'{r["waves_over"]}/{args.waves}; client cpu p50 '
                  f'{r["cpu_ms_p50"]:.3f} ms, copy p50 {r["copy_ms_p50"]:.3f}'
                  f' ms; requests switched {r["requests_switched"]} '
                  f'(threads {r["thread_names"]}); '
                  f'segments p50 ' + ', '.join(
                      f'{k} {v:.3f}' for k, v in r['segments_ms_p50'].items())
                  + f' [{card}]', flush=True)
            for o in over:
                print(f'  over: {o["ttft_ms"]:.3f} ms = ' + ', '.join(
                    f'{k} {v:.3f}' for k, v in o['segments_ms'].items())
                    + f'; cpu {o["cpu_ms"]:.3f} ms, switches (vol, invol) '
                    f'{o["switches"]}; copy {o["copy_ms"]:.3f} ms, switches '
                    f'{o["copy_switches"]}; gc {o["gc"]}', flush=True)
    finally:
        gc.callbacks.remove(on_gc)
        copies.restore()
    hand = handoff(args.handoff_s)
    limit = min(res[p]['limit_ms'] for p in pools)
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
    print(json.dumps({k: ({kk: vv for kk, vv in v.items()
                           if kk != 'requests_over'}
                          if isinstance(v, dict) else v)
                      for k, v in res.items()}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
