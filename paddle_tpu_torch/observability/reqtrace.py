"""Request-scoped tracing: per-request timelines + a bounded flight recorder.

Port of ``paddle_tpu/observability/reqtrace.py`` (framework-free).
``start_request(kind, engine=...)`` mints a request ID at ``submit()``
time and returns a :class:`RequestRecord` that rides the request across
the submit -> scheduler thread boundary; the engine ``note()``s lifecycle
events into it (enqueue, admit, prefill, decode windows, eviction, first
emission, retire) and ``finish(outcome)`` moves it into a bounded ring of
the last N completed requests, where slow and failed requests are kept
in preference to healthy ones when the ring evicts.

Disabled mode (``PADDLE_TPU_OBS=0``): ``start_request`` returns one shared
``NULL_RECORD`` whose methods are no-ops.

Env knobs: ``PADDLE_TPU_OBS_REQ_CAP`` (ring capacity, default 256),
``PADDLE_TPU_OBS_SLOW_MS`` (slow-request retention threshold, default
1000 ms).
"""
import itertools
import os
import threading
import time

from .registry import cfg, counter, gauge

ENV_REQ_CAP = 'PADDLE_TPU_OBS_REQ_CAP'
ENV_SLOW_MS = 'PADDLE_TPU_OBS_SLOW_MS'


def _env_num(name, default, cast):
    try:
        return cast(os.environ.get(name, default))
    except (TypeError, ValueError):
        return cast(default)


class RequestRecord:
    """One request's timeline; its lock lets whichever thread drives the
    request append events."""

    __slots__ = ('rid', 'kind', 'engine', 'attrs', 'wall_start', 'timeline',
                 'outcome', 'error', 'duration_ms', '_mono0', '_lock',
                 '_parts_left', '_recorder')

    def __init__(self, rid, kind, engine='', attrs=None, recorder=None):
        self.rid = rid
        self.kind = kind
        self.engine = engine
        self.attrs = dict(attrs) if attrs else {}
        self.wall_start = time.time()
        self._mono0 = time.perf_counter()
        self.timeline = []
        self.outcome = None          # None while in flight
        self.error = None            # error class name on failure
        self.duration_ms = None
        self._lock = threading.Lock()
        self._parts_left = 1
        self._recorder = recorder

    def _ms(self):
        return round((time.perf_counter() - self._mono0) * 1e3, 3)

    def note(self, ev, **attrs):
        """Append one timeline event at the current ms offset."""
        entry = {'ev': ev, 't_ms': self._ms()}
        if attrs:
            entry.update(attrs)
        with self._lock:
            if self.outcome is None:
                self.timeline.append(entry)
        return self

    def note_decode(self, pos):
        """Record participation in one decode step, coalescing consecutive
        steps into a single window entry."""
        now_ms = self._ms()
        with self._lock:
            if self.outcome is not None:
                return self
            last = self.timeline[-1] if self.timeline else None
            if last is not None and last['ev'] == 'decode':
                last['steps'] += 1
                last['t_last_ms'] = now_ms
                last['last_pos'] = int(pos)
            else:
                self.timeline.append({'ev': 'decode', 't_ms': now_ms,
                                      't_last_ms': now_ms, 'steps': 1,
                                      'last_pos': int(pos)})
        return self

    def expect_parts(self, n):
        """A split request retires once per chunk; the record finishes on
        the last chunk (``part_retired`` returning True)."""
        with self._lock:
            self._parts_left = max(1, int(n))
        return self

    def part_retired(self):
        with self._lock:
            self._parts_left -= 1
            return self._parts_left <= 0

    def finish(self, outcome, error=None):
        """Seal the record (idempotent — the first outcome wins) and hand
        it to the flight recorder's retention ring."""
        with self._lock:
            if self.outcome is not None:
                return self
            self.outcome = str(outcome)
            if error is not None:
                self.error = type(error).__name__ \
                    if isinstance(error, BaseException) else str(error)
            self.duration_ms = self._ms()
        if self._recorder is not None:
            self._recorder._complete(self)
        return self

    def to_dict(self):
        with self._lock:
            return {'id': self.rid, 'kind': self.kind, 'engine': self.engine,
                    'wall_start': self.wall_start,
                    'outcome': self.outcome, 'error': self.error,
                    'duration_ms': self.duration_ms,
                    'attrs': dict(self.attrs),
                    'timeline': [dict(e) for e in self.timeline]}


class _NullRecord:
    """Shared no-op record for disabled mode."""

    __slots__ = ()
    rid = ''
    outcome = None

    def note(self, ev, **attrs):
        return self

    def note_decode(self, pos):
        return self

    def expect_parts(self, n):
        return self

    def part_retired(self):
        return False

    def finish(self, outcome, error=None):
        return self

    def to_dict(self):
        return {}


NULL_RECORD = _NullRecord()


class FlightRecorder:
    """Bounded ring of the last N *completed* requests plus the in-flight
    set. When the ring is full the oldest *healthy* (ok, fast, never
    evicted) record goes first."""

    def __init__(self, capacity=None, slow_ms=None):
        self.capacity = int(capacity if capacity is not None
                            else _env_num(ENV_REQ_CAP, 256, int))
        self.slow_ms = float(slow_ms if slow_ms is not None
                             else _env_num(ENV_SLOW_MS, 1000.0, float))
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._active = {}            # rid -> RequestRecord
        self._done = []              # completion order, oldest first

    def start(self, kind, engine='', **attrs):
        rid = f'{kind}-{os.getpid():x}-{next(self._ids):06d}'
        rec = RequestRecord(rid, kind, engine, attrs, recorder=self)
        with self._lock:
            self._active[rid] = rec
            n_active = len(self._active)
        counter('request.started', {'kind': kind}).inc()
        gauge('request.active').set(n_active)
        return rec

    def _notable(self, rec):
        if rec.outcome != 'ok':
            return True
        if rec.duration_ms is not None and rec.duration_ms >= self.slow_ms:
            return True
        return any(e.get('ev') == 'evict' for e in rec.timeline)

    def _complete(self, rec):
        with self._lock:
            self._active.pop(rec.rid, None)
            self._done.append(rec)
            while len(self._done) > self.capacity:
                victim = next((i for i, r in enumerate(self._done)
                               if not self._notable(r)), 0)
                self._done.pop(victim)
            n_active = len(self._active)
        counter('request.completed',
                {'kind': rec.kind, 'outcome': rec.outcome or '?'}).inc()
        gauge('request.active').set(n_active)

    def requests(self, outcome=None):
        """Newest-first record dicts: in flight and completed, or only
        ``outcome`` ('ok', 'error', 'expired', ..., 'active')."""
        with self._lock:
            done = list(reversed(self._done))
            active = list(self._active.values())
        if outcome == 'active':
            recs = active
        elif outcome:
            recs = [r for r in done if r.outcome == outcome]
        else:
            recs = active + done
        return [r.to_dict() for r in recs]


class _NullRecorder:
    """Shared no-op recorder for disabled mode."""

    __slots__ = ()

    def requests(self, outcome=None):
        return []


NULL_RECORDER = _NullRecorder()

_recorder = FlightRecorder()


def recorder():
    """The process-wide flight recorder (``NULL_RECORDER`` when disabled)."""
    if not cfg.enabled:
        return NULL_RECORDER
    return _recorder


def start_request(kind, engine='', **attrs):
    """Mint a request ID and start its timeline (``NULL_RECORD`` when
    observability is disabled)."""
    if not cfg.enabled:
        return NULL_RECORD
    return _recorder.start(kind, engine, **attrs)
