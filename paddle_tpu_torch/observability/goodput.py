"""Always-on training goodput/badput ledger (port of
``paddle_tpu/observability/goodput.py``).

Where does training wall-clock actually go? ``devtime.py`` answers for a
bounded capture; this module answers continuously for every ``fit()``
run, from signals the step path already emits — no profiler, no new
device work, a handful of float ops per step (well inside the <5%
observability budget).

Badput causes:

- ``compile``     — a step during which the port built or loaded a
                    kernel library (``ops/_build.py``) or captured a CUDA
                    graph (``models/decode_cache.py``): the reference's
                    retrace. The eager hapi step traces nothing, so this
                    is what 'compile' can mean here. The whole step
                    duration is booked, the standard goodput convention.
- ``checkpoint``  — time inside ``ckpt.save`` / ``ckpt.manager_save``
                    (framework_io books its span duration here).
- ``data_stall``  — host blocked in the batch iterator beyond the stall
                    floor (``PADDLE_TPU_GOODPUT_DATA_FLOOR_MS``, default
                    5 ms: normal prefetched next() costs less; a stall is
                    the loader failing to hide behind compute).
- ``preemption``  — restore-from-checkpoint time (``ckpt.restore``) and
                    fleet failover recovery.
- ``requeue``     — backoff sleeps inside ``fault.retry`` (the process is
                    alive but deliberately waiting to try again).

Exposed as ``goodput.ratio`` (goodput seconds ÷ elapsed run seconds),
``goodput.badput_ms{cause}`` counters, ``goodput.steps``, and the
``/debug/goodput`` endpoint (``snapshot()``). Badput noted while no run
is active still lands on the counters but does not move the ratio — a
checkpoint written outside ``fit()`` is not stealing training time.

Disabled mode (``PADDLE_TPU_OBS=0``): every entry point is a no-op.
"""
import os
import threading
import time

from .registry import cfg, registry as _registry

CAUSES = ('compile', 'checkpoint', 'data_stall', 'preemption', 'requeue')

ENV_DATA_FLOOR = 'PADDLE_TPU_GOODPUT_DATA_FLOOR_MS'


def _data_floor_s():
    try:
        return float(os.environ.get(ENV_DATA_FLOOR, '5')) / 1e3
    except ValueError:
        return 0.005


class GoodputLedger:
    """Process-wide training-time ledger. One instance (``ledger()``);
    every method is thread-safe and cheap enough for per-step use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._run_start = None       # perf_counter at run_start, or None
        self._prior_elapsed = 0.0    # completed runs' wall time
        self._badput_run = {c: 0.0 for c in CAUSES}   # since first run
        self._badput_total = {c: 0.0 for c in CAUSES}  # lifetime
        self._steps = 0
        self._runs = 0

    # ---- run window ------------------------------------------------------
    def run_start(self):
        """Open a training-run window; elapsed time starts counting."""
        if not cfg.enabled:
            return
        with self._lock:
            if self._run_start is None:
                self._run_start = time.perf_counter()
                self._runs += 1

    def run_end(self):
        """Close the run window; the ratio freezes at its final value."""
        if not cfg.enabled:
            return
        with self._lock:
            if self._run_start is not None:
                self._prior_elapsed += time.perf_counter() - self._run_start
                self._run_start = None
        self._update_gauges()

    # ---- signals ---------------------------------------------------------
    def note_step(self, seconds=None):
        """One training step completed (``seconds`` currently informational;
        elapsed comes from the run wall clock)."""
        if not cfg.enabled:
            return
        with self._lock:
            self._steps += 1
            publish = self._steps % 16 == 0   # gauge refresh off hot path
        _registry().counter('goodput.steps',
                            help='fit() steps seen by the goodput '
                                 'ledger').inc()
        if publish:
            self._update_gauges()

    def note_badput(self, cause, seconds):
        """Book ``seconds`` of wall time against ``cause``. Counted toward
        the ratio only while a run window is open."""
        if not cfg.enabled or seconds is None or seconds <= 0:
            return
        if cause not in CAUSES:
            cause = 'requeue'
        with self._lock:
            self._badput_total[cause] += seconds
            if self._run_start is not None:
                self._badput_run[cause] += seconds
        _registry().counter(
            'goodput.badput_ms', {'cause': cause},
            help='badput wall time per cause (ms)').inc(
                round(1e3 * seconds, 3))
        self._update_gauges()

    def note_data_wait(self, seconds):
        """Batch-iterator wait; only the portion of a wait that exceeds
        the stall floor is badput (prefetch-hidden loads are goodput)."""
        if seconds is None:
            return
        floor = _data_floor_s()
        if seconds > floor:
            self.note_badput('data_stall', seconds - floor)

    def badput(self, cause):
        """``with ledger.badput('checkpoint'):`` — measure and book."""
        return _BadputTimer(self, cause)

    def data_iter(self, it):
        """Wrap a batch iterable so every blocking ``next()`` is measured
        into ``data_stall`` (above the floor). Always-on equivalent of
        StepTimer's data phase, feeding the ledger instead."""
        if not cfg.enabled:
            return it

        def gen():
            src = iter(it)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(src)
                except StopIteration:
                    return
                self.note_data_wait(time.perf_counter() - t0)
                yield batch
        return gen()

    # ---- views -----------------------------------------------------------
    def _elapsed_locked(self):
        el = self._prior_elapsed
        if self._run_start is not None:
            el += time.perf_counter() - self._run_start
        return el

    def ratio(self):
        """goodput seconds / elapsed run seconds (1.0 before any run)."""
        with self._lock:
            el = self._elapsed_locked()
            bad = sum(self._badput_run.values())
        if el <= 0:
            return 1.0
        return max(0.0, min(1.0, (el - bad) / el))

    def snapshot(self):
        """JSON-able ledger state — the ``/debug/goodput`` body."""
        with self._lock:
            el = self._elapsed_locked()
            bad_run = dict(self._badput_run)
            bad_total = dict(self._badput_total)
            steps = self._steps
            runs = self._runs
            active = self._run_start is not None
        bad = sum(bad_run.values())
        ratio = max(0.0, min(1.0, (el - bad) / el)) if el > 0 else 1.0
        return {'enabled': cfg.enabled, 'run_active': active, 'runs': runs,
                'steps': steps, 'elapsed_s': round(el, 6),
                'goodput_s': round(max(el - bad, 0.0), 6),
                'ratio': round(ratio, 6),
                'badput_s': {c: round(v, 6) for c, v in bad_run.items()},
                'badput_lifetime_s': {c: round(v, 6)
                                      for c, v in bad_total.items()},
                'data_stall_floor_ms': round(1e3 * _data_floor_s(), 3)}

    def _update_gauges(self):
        if not cfg.enabled:
            return
        reg = _registry()
        reg.gauge('goodput.ratio',
                  help='goodput / elapsed wall time of the training '
                       'run').set(round(self.ratio(), 6))
        with self._lock:
            reg.gauge('goodput.elapsed_s').set(
                round(self._elapsed_locked(), 3))

    def reset(self):
        with self._lock:
            self._run_start = None
            self._prior_elapsed = 0.0
            self._badput_run = {c: 0.0 for c in CAUSES}
            self._badput_total = {c: 0.0 for c in CAUSES}
            self._steps = 0
            self._runs = 0


class _BadputTimer:
    __slots__ = ('_ledger', '_cause', '_t0')

    def __init__(self, ledger, cause):
        self._ledger = ledger
        self._cause = cause
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._ledger.note_badput(self._cause,
                                 time.perf_counter() - self._t0)
        return False


_ledger = GoodputLedger()


def ledger():
    """The process-wide ledger (one training process, one ledger)."""
    return _ledger


def note_badput(cause, seconds):
    _ledger.note_badput(cause, seconds)


def snapshot():
    return _ledger.snapshot()


def reset_goodput():
    _ledger.reset()
