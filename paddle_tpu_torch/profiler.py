"""Profiler (port of ``paddle_tpu/profiler.py``; reference:
python/paddle/fluid/profiler.py + the new paddle.profiler).

On ``torch.profiler``: ``Profiler`` / ``start_profiler`` /
``stop_profiler`` record host and CUDA activity and write Kineto's Chrome
trace into their log directory (the reference writes XProf protobufs);
``RecordEvent`` is an observability span, itself a
``torch.profiler.record_function`` range. ``StepTimer`` is the reference's
per-step host timing breakdown, as it is.
"""
import contextlib
import itertools
import os
import time

from . import observability as _obs


class ProfilerTarget:
    CPU = 'cpu'
    GPU = 'gpu'
    TPU = 'tpu'


class RecordEvent:
    """User-facing profiling region. Forwards to an observability span
    (itself a ``torch.profiler.record_function`` range, degrading to
    host-only timing without one).

    Misuse-hardened: ``begin()`` while already active is a no-op (no leaked
    second annotation), ``end()`` without a matching ``begin()`` is a
    no-op instead of an AttributeError."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._span = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def begin(self):
        if self._span is not None:      # already active: do not re-enter
            return
        from .observability import trace as _trace
        span = _trace.Span(self.name)
        try:
            span.__enter__()
        except Exception:               # host-only fallback of last resort
            span = _trace.NULL_SPAN
        self._span = span

    def end(self):
        span = self._span
        if span is None:                # end() without begin(): no-op
            return
        self._span = None
        try:
            span.__exit__(None, None, None)
        except Exception:
            pass


def _activities():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start_trace():
    import torch
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    return prof


def _stop_trace(prof, log_dir):
    """End a capture and write its Chrome trace under ``log_dir``."""
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f'profile_{os.getpid()}_'
                                 f'{int(time.time() * 1e3)}.pt.trace.json')
    prof.export_chrome_trace(path)
    return path


class Profiler:
    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, log_dir='./profiler_log'):
        self.log_dir = log_dir
        self.timer_only = timer_only
        self._started = False
        self._step_times = []
        self._last = None
        self._prof = None
        self.trace_path = None

    def start(self):
        if not self.timer_only:
            try:
                self._prof = _start_trace()
            except Exception:
                self.timer_only = True
        self._started = True
        self._last = time.perf_counter()

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last is not None:
            self._step_times.append(now - self._last)
        self._last = now

    def stop(self):
        if self._started and not self.timer_only and self._prof is not None:
            try:
                self.trace_path = _stop_trace(self._prof, self.log_dir)
            except Exception:
                pass
            self._prof = None
        self._started = False

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit='ms'):
        if not self._step_times:
            return 'no steps recorded'
        import numpy as np
        ts = np.asarray(self._step_times) * 1000
        return (f'steps={len(ts)} mean={ts.mean():.2f}ms p50='
                f'{np.percentile(ts, 50):.2f}ms p99={np.percentile(ts, 99):.2f}ms')

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


@contextlib.contextmanager
def profiler(state='All', sorted_key=None, profile_path='/tmp/profile'):
    p = Profiler(timer_only=False, log_dir=profile_path)
    p.start()
    try:
        yield p
    finally:
        p.stop()


_global_trace = None


def start_profiler(state='All', tracer_option='Default'):
    global _global_trace
    if _global_trace is None:
        _global_trace = _start_trace()


def stop_profiler(sorted_key=None, profile_path='/tmp/profile'):
    global _global_trace
    prof, _global_trace = _global_trace, None
    if prof is None:
        return None
    try:
        return _stop_trace(prof, profile_path)
    except Exception:
        return None


class ProfilerOptions:
    """Reference: python/paddle/utils/profiler.py ProfilerOptions — a dict
    of knobs; only ``profile_path`` is read (by ``get_profiler``)."""

    DEFAULT = {'state': 'All', 'sorted_key': 'default',
               'tracer_level': 'Default', 'batch_range': [0, 10],
               'output_thread_detail': False, 'profile_path': 'none',
               'timeline_path': 'none', 'op_summary_path': 'none'}

    def __init__(self, options=None):
        self._options = dict(self.DEFAULT)
        if options:
            self._options.update(options)

    def with_state(self, state):
        new = ProfilerOptions(self._options)
        new._options['state'] = state
        return new

    def __getitem__(self, name):
        return self._options[name]


def percentile(samples, q):
    """Nearest-rank percentile — delegates to the one canonical
    implementation in :mod:`paddle_tpu_torch.observability.registry`. Returns
    ``None`` for empty input, the lone element for a single sample, and
    clamps q into [0, 100]."""
    return _obs.percentile(samples, q)


class StepTimer:
    """Per-step host-side timing breakdown for the async train executor.

    Phases: ``data`` (host fetch/collate + H2D wait), ``dispatch`` (python
    overhead to enqueue the compiled step — what the async executor
    minimizes), ``readback`` (blocking D2H loss resolution at logging
    points). Attach with ``model._step_timer = StepTimer()`` before fit();
    read ``summary()`` after.

    Since the observability PR this is a *view* over registry histograms:
    each instance owns ``train.{phase}_ms{timer=tN}`` series (values in
    milliseconds) plus a ``train.timer_steps`` counter, so the same numbers
    ``summary()`` reports are visible in ``observability.snapshot()``.
    When observability is disabled the timer keeps working on private,
    unregistered metric objects."""

    PHASES = ('data', 'dispatch', 'readback')
    _seq = itertools.count()

    def __init__(self):
        self.labels = {'timer': f't{next(StepTimer._seq)}'}
        self._hists = {}
        self._steps = None
        self.reset()

    def _histogram(self, phase):
        h = self._hists.get(phase)
        if h is None:
            name = f'train.{phase}_ms'
            if _obs.enabled():
                h = _obs.registry().histogram(name, self.labels)
            else:
                h = _obs.Histogram(name, self.labels)
            self._hists[phase] = h
        return h

    def reset(self):
        self._hists.clear()
        if _obs.enabled():
            self._steps = _obs.registry().counter(
                'train.timer_steps', self.labels)
        else:
            self._steps = _obs.Counter('train.timer_steps', self.labels)
        self._steps.reset()
        for p in self.PHASES:
            self._histogram(p).reset()
        self._pending = {p: 0.0 for p in self.PHASES}
        self._t_start = time.perf_counter()

    @property
    def steps(self):
        return int(self._steps.value)

    def add(self, phase, seconds):
        self._pending[phase] = self._pending.get(phase, 0.0) + seconds

    @contextlib.contextmanager
    def span(self, phase):
        """Books elapsed time to ``phase`` ONLY when the body completes.
        A raising step would otherwise record the partial duration up to
        the raise — a misleadingly small sample polluting the p50/p99."""
        t0 = time.perf_counter()
        yield
        self.add(phase, time.perf_counter() - t0)

    def timed_iter(self, phase, iterable):
        """Wrap an iterator so the time blocked in next() books to phase.
        A raising ``next()`` (other than StopIteration) books nothing."""
        it = iter(iterable)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.add(phase, time.perf_counter() - t0)
            yield item

    def abort_step(self):
        """Discard the partially-accumulated step (the step fn raised):
        pending phase durations are dropped instead of observed."""
        self._pending = {p: 0.0 for p in self._pending}

    def step_done(self):
        for p, v in self._pending.items():
            self._histogram(p).observe(1e3 * v)
        self._pending = {p: 0.0 for p in self._pending}
        self._steps.inc()

    def summary(self):
        wall = time.perf_counter() - self._t_start
        steps = self.steps
        out = {'steps': steps,
               'wall_s': wall,
               'steps_per_sec': steps / wall if wall > 0 else 0.0}
        for p, h in self._hists.items():
            c = h.count
            if not c:
                continue
            out[p + '_ms_mean'] = h.sum / c
            out[p + '_ms_p50'] = h.percentile(50)
            out[p + '_ms_p99'] = h.percentile(99)
        return out


_profiler_singleton = None


def get_profiler(options=None):
    """Process-wide Profiler singleton (reference utils/profiler.py)."""
    global _profiler_singleton
    if _profiler_singleton is None:
        opts = options if isinstance(options, ProfilerOptions) \
            else ProfilerOptions(options)
        _profiler_singleton = Profiler(
            log_dir=opts['profile_path'] if opts['profile_path'] != 'none'
            else './profiler_log')
    return _profiler_singleton
