"""Structured span tracer (port of the recording half of
``paddle_tpu/observability/trace.py``).

``span("gen.decode_step", slots=n)`` is a context manager that records
the enclosed region as a Chrome trace-event dict (``ph: 'X'``) in a
bounded process-wide ring; ``record_event()`` adds instants (``ph:
'i'``); ``dump_trace`` writes the ring as a Chrome-trace file. Profiler
annotations wait for the telemetry plane (ROADMAP Queue 1 step F). When observability is disabled,
``span()`` returns one shared no-op singleton.
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
_origin = time.perf_counter()


def _now_us():
    return (time.perf_counter() - _origin) * 1e6


class Span:
    """One timed region. Use via ``observability.span(name, **attrs)``."""

    __slots__ = ('name', 'attrs', 'duration', '_ts')

    def __init__(self, name, attrs=None):
        self.name = name
        self.attrs = attrs or None
        self.duration = 0.0          # seconds, set on exit
        self._ts = 0.0

    def __enter__(self):
        self._ts = _now_us()
        return self

    def __exit__(self, etype, evalue, tb):
        end = _now_us()
        self.duration = (end - self._ts) / 1e6
        args = dict(self.attrs) if self.attrs else {}
        if etype is not None:
            args['error'] = f'{etype.__name__}: {evalue}'[:200]
        rec = {'name': self.name, 'ph': 'X', 'cat': self.name.split('.')[0],
               'ts': round(self._ts, 3), 'dur': round(end - self._ts, 3),
               'pid': os.getpid(), 'tid': threading.get_ident()}
        if args:
            rec['args'] = args
        with _lock:
            _events.append(rec)
        return False


class _NullSpan:
    __slots__ = ()
    duration = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def span(name, **attrs):
    """``with span('gen.prefill', slot=0):`` — the no-op singleton when
    observability is disabled."""
    if not cfg.enabled:
        return NULL_SPAN
    return Span(name, attrs)


def record_event(name, **attrs):
    """Standalone instant event (``ph: 'i'``) — fault injections, circuit
    transitions."""
    if not cfg.enabled:
        return
    rec = {'name': name, 'ph': 'i', 'cat': name.split('.')[0], 's': 't',
           'ts': round(_now_us(), 3), 'pid': os.getpid(),
           'tid': threading.get_ident()}
    if attrs:
        rec['args'] = attrs
    with _lock:
        _events.append(rec)


def trace_events():
    """Copy of the event ring (Chrome trace-event dicts)."""
    with _lock:
        return list(_events)


def dump_trace(path):
    """Write the span ring as Chrome-trace JSON (chrome://tracing,
    Perfetto). Returns the event count written."""
    events = trace_events()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, 'w') as f:
        json.dump({'traceEvents': events, 'displayTimeUnit': 'ms'}, f,
                  default=str)
    return len(events)
