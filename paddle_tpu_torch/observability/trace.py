"""Structured span tracer with Chrome-trace/Perfetto JSON export (port of
``paddle_tpu/observability/trace.py``).

``span("train.step", step=n)`` is a context manager that records wall and
monotonic timing for the enclosed region and, while a ``torch.profiler``
capture runs, forwards the region to ``torch.profiler.record_function``,
so spans show up as ranges in the capture (``/debug/profile``), next to
the card's kernels; the reference forwards to
``jax.profiler.TraceAnnotation``.

Completed spans land in a bounded process-wide ring buffer as Chrome
trace-event dicts (``ph: 'X'`` complete events; ``event()`` emits
``ph: 'i'`` instants). ``dump_trace(path)`` writes a file that loads
directly in ``chrome://tracing`` / Perfetto. Nesting needs no explicit
parent tracking — complete events on the same tid nest by ts/dur.

When observability is disabled, ``span()`` returns one shared no-op
singleton: no allocation, no timestamps, no buffer writes.
"""
import collections
import json
import os
import threading
import time

from .registry import cfg

TRACE_CAP = int(os.environ.get('PADDLE_TPU_OBS_TRACE_CAP', '100000'))

_lock = threading.Lock()
_events = collections.deque(maxlen=TRACE_CAP)
_dropped = 0            # events evicted by a full ring (or a cap shrink)


def set_trace_cap(n):
    """Re-bound the span ring at runtime (tests, the ``/debug/trace``
    endpoint). The env knob only sets the import-time default; this swaps
    the ring for one of the new capacity, keeping the newest events.
    Returns the new cap."""
    global TRACE_CAP, _events, _dropped
    n = max(1, int(n))
    with _lock:
        TRACE_CAP = n
        _dropped += max(0, len(_events) - n)
        _events = collections.deque(_events, maxlen=n)
    return n


def trace_cap():
    return TRACE_CAP


def trace_dropped():
    """Lifetime count of events the bounded ring has evicted — surfaced
    as the ``obs.trace_dropped_total`` registry gauge so ring overflow is
    itself observable (and SLO-rule-able)."""
    with _lock:
        return _dropped


def _append_locked(rec):
    # caller holds _lock; eviction by a full deque is the silent-drop
    # path the self-metrics satellite makes visible
    global _dropped
    if len(_events) == _events.maxlen:
        _dropped += 1
    _events.append(rec)
_tid_names = {}          # tid -> thread name at record time (for ph:'M')
_origin_mono = time.perf_counter()
_origin_wall = time.time()

_profiler_mod = None
_profiler_checked = False


def _torch_profiler():
    """torch.profiler if importable, else None (cached). The
    ``record_function`` attribute is looked up per use so stubs (and
    tests) that remove or break it degrade the span to host-only
    timing."""
    global _profiler_mod, _profiler_checked
    if not _profiler_checked:
        try:
            from torch import profiler as _p
            _profiler_mod = _p
        except Exception:
            _profiler_mod = None
        _profiler_checked = True
    return _profiler_mod


_autograd_profiler = None


def _capturing():
    """True while a torch.profiler session runs (torch's process-wide
    flag): only then does a span open a ``record_function`` range, which
    costs a dispatched operator a span otherwise (the reference's
    TraceAnnotation is as cheap without a trace)."""
    global _autograd_profiler
    if _autograd_profiler is None:
        import torch.autograd.profiler as ap
        _autograd_profiler = ap
    flag = getattr(_autograd_profiler, '_is_profiler_enabled', None)
    if flag is not None:
        return flag
    import torch       # a torch without the flag: the calling thread's state
    return bool(torch._C._autograd._profiler_enabled())


def _now_us():
    return (time.perf_counter() - _origin_mono) * 1e6


class Span:
    """One timed region. Use via ``observability.span(name, **attrs)``."""

    __slots__ = ('name', 'attrs', 'duration', 'wall_start', '_ts', '_ann')

    def __init__(self, name, attrs=None):
        self.name = name
        self.attrs = attrs or None
        self.duration = 0.0          # monotonic seconds, set on exit
        self.wall_start = 0.0
        self._ts = 0.0
        self._ann = None

    def __enter__(self):
        mod = _torch_profiler()
        if mod is not None and _capturing():
            try:
                ann = mod.record_function(self.name)
                ann.__enter__()
                self._ann = ann
            except Exception:
                self._ann = None
        self.wall_start = time.time()
        self._ts = _now_us()
        return self

    def event(self, name, **attrs):
        """Instant event stamped inside this span's thread/timeline."""
        record_event(name, **attrs)

    def __exit__(self, etype, evalue, tb):
        end = _now_us()
        self.duration = (end - self._ts) / 1e6
        if self._ann is not None:
            try:
                self._ann.__exit__(None, None, None)
            except Exception:
                pass
            self._ann = None
        args = dict(self.attrs) if self.attrs else {}
        if etype is not None:
            args['error'] = f'{etype.__name__}: {evalue}'[:200]
        tid = threading.get_ident()
        rec = {'name': self.name, 'ph': 'X', 'cat': self.name.split('.')[0],
               'ts': round(self._ts, 3), 'dur': round(end - self._ts, 3),
               'pid': os.getpid(), 'tid': tid}
        if args:
            rec['args'] = args
        with _lock:
            _append_locked(rec)
            _tid_names[tid] = threading.current_thread().name
        return False


class _NullSpan:
    __slots__ = ()
    duration = 0.0
    wall_start = 0.0
    name = ''
    attrs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def event(self, name, **attrs):
        pass


NULL_SPAN = _NullSpan()


def span(name, **attrs):
    """``with span('serve.batch', bucket=8):`` — returns the no-op singleton
    when observability is disabled."""
    if not cfg.enabled:
        return NULL_SPAN
    return Span(name, attrs)


def record_event(name, **attrs):
    """Standalone instant event (``ph: 'i'``) — fault injections, retries,
    circuit transitions."""
    if not cfg.enabled:
        return
    tid = threading.get_ident()
    rec = {'name': name, 'ph': 'i', 'cat': name.split('.')[0], 's': 't',
           'ts': round(_now_us(), 3), 'pid': os.getpid(), 'tid': tid}
    if attrs:
        rec['args'] = attrs
    with _lock:
        _append_locked(rec)
        _tid_names[tid] = threading.current_thread().name


def now_us():
    """Current trace-clock timestamp (µs since the monotonic origin) —
    the same clock every event's ``ts`` is stamped in."""
    return _now_us()


def trace_events(since_us=None):
    """Copy of the completed-event ring (Chrome trace-event dicts).
    ``since_us`` keeps only events whose ``ts`` is at or after that
    trace-clock timestamp (the ``/debug/trace?ms=N`` capture window)."""
    with _lock:
        events = list(_events)
    if since_us is not None:
        events = [e for e in events if e.get('ts', 0.0) >= since_us]
    return events


def reset_trace():
    global _dropped
    with _lock:
        _events.clear()
        _tid_names.clear()
        _dropped = 0


def _wall_anchor():
    """Fresh wall↔monotonic mapping, taken NOW. The import-time pair
    drifts in long runs (NTP slew, clock steps, VM suspend), so dumped
    wall timestamps derived from it go stale; re-deriving the origin from
    a current reading of both clocks keeps ``wall_origin + ts/1e6`` true
    to real time at dump time. Both clocks (and the measured drift) land
    in the metadata so consumers can pick either."""
    mono_now = time.perf_counter()
    wall_now = time.time()
    wall_origin = wall_now - (mono_now - _origin_mono)
    return {'wall_origin': wall_origin,
            'wall_origin_at_import': _origin_wall,
            'wall_at_dump': wall_now,
            'mono_us_at_dump': round((mono_now - _origin_mono) * 1e6, 3),
            'wall_drift_s': round(wall_origin - _origin_wall, 6),
            'clock': 'perf_counter_us_since_origin'}


def build_trace_doc(events=None):
    """Chrome-trace document for ``events`` (default: the whole ring),
    with process/thread-name metadata (``ph:'M'``) and the re-anchored
    wall-clock mapping in ``otherData``."""
    with _lock:
        if events is None:
            events = list(_events)
        tid_names = dict(_tid_names)
    pid = os.getpid()
    meta = [{'name': 'process_name', 'ph': 'M', 'pid': pid,
             'args': {'name': 'paddle_tpu_torch'}}]
    seen_tids = {e['tid'] for e in events if 'tid' in e}
    for tid, tname in sorted(tid_names.items()):
        if tid in seen_tids:
            meta.append({'name': 'thread_name', 'ph': 'M', 'pid': pid,
                         'tid': tid, 'args': {'name': tname}})
    return {'traceEvents': meta + events,
            'displayTimeUnit': 'ms',
            'otherData': _wall_anchor()}


def dump_trace(path):
    """Write the span ring as Chrome-trace JSON (loads in chrome://tracing
    and Perfetto). Returns the event count written. Metadata (``ph:'M'``)
    events name the process and every thread that recorded a span, so
    Perfetto lanes read "Thread-dispatch" instead of a bare TID."""
    doc = build_trace_doc()
    n = sum(1 for e in doc['traceEvents'] if e.get('ph') != 'M')
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, 'w') as f:
        json.dump(doc, f, default=str)
    return n
