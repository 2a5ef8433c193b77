"""Request-scoped tracing: per-request timelines + a bounded flight recorder
(port of ``paddle_tpu/observability/reqtrace.py``).

Aggregate histograms (``serve.*`` / ``gen.*``) answer "how is the fleet
doing"; they cannot answer "what happened to THIS request". The engines'
iteration-level scheduling makes that worse — one user sequence rides many
decode steps, may be evicted and readmitted, and its TTFT depends on queue
position — none of which is recoverable from percentiles. This module is
the missing per-request layer:

- ``start_request(kind, engine=...)`` mints a request ID at ``submit()``
  time and returns a :class:`RequestRecord` that rides the request across
  the submit→dispatch/scheduler thread boundary;
- the engines ``note()`` lifecycle events into it (enqueue, admit,
  bucket/slot assignment, prefill, decode-step windows, eviction/requeue,
  first stream emission, retire) with millisecond offsets from enqueue;
- ``finish(outcome)`` moves the record into a bounded **flight recorder**
  ring of the last N completed requests, where slow and failed requests
  are retained preferentially over healthy ones when the ring evicts —
  the requests you debug are exactly the ones a plain FIFO would have
  already dropped.

Request IDs also appear as args on the engines' Chrome-trace spans
(``serve.batch`` / ``gen.prefill`` / ``gen.decode_step``), so one request
can be followed through the Perfetto view, and ``/debug/requests`` on the
telemetry server (``server.py``) exposes the ring over HTTP.

Disabled mode (``PADDLE_TPU_OBS=0``): ``start_request`` returns one shared
``NULL_RECORD`` whose methods are no-ops — no IDs, no timelines, no ring.

Env knobs: ``PADDLE_TPU_OBS_REQ_CAP`` (ring capacity, default 256),
``PADDLE_TPU_OBS_SLOW_MS`` (slow-request retention threshold, default
1000 ms).
"""
import collections
import itertools
import os
import threading
import time

from .registry import cfg, counter, gauge

ENV_REQ_CAP = 'PADDLE_TPU_OBS_REQ_CAP'
ENV_SLOW_MS = 'PADDLE_TPU_OBS_SLOW_MS'

_OK_OUTCOMES = ('ok',)


def _env_num(name, default, cast):
    try:
        return cast(os.environ.get(name, default))
    except (TypeError, ValueError):
        return cast(default)


class RequestRecord:
    """One request's timeline. Created by ``FlightRecorder.start``; engines
    append events from whichever thread is driving the request at the time
    (its lock makes that safe), then ``finish(outcome)`` seals it."""

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

    # ---- engine-side API -------------------------------------------------
    def note(self, ev, **attrs):
        """Append one timeline event at the current ms offset."""
        entry = {'ev': ev,
                 't_ms': round((time.perf_counter() - self._mono0) * 1e3, 3)}
        if attrs:
            entry.update(attrs)
        with self._lock:
            if self.outcome is None:
                self.timeline.append(entry)
        return self

    def note_decode(self, pos):
        """Record participation in one decode step, coalescing consecutive
        steps into a single window entry — a 2k-token sequence must not
        grow a 2k-entry timeline."""
        now_ms = round((time.perf_counter() - self._mono0) * 1e3, 3)
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
            self.duration_ms = round(
                (time.perf_counter() - self._mono0) * 1e3, 3)
        if self._recorder is not None:
            self._recorder._complete(self)
        return self

    # ---- serialization ---------------------------------------------------
    def to_dict(self):
        with self._lock:
            return {'id': self.rid, 'kind': self.kind, 'engine': self.engine,
                    'wall_start': self.wall_start,
                    'outcome': self.outcome, 'error': self.error,
                    'duration_ms': self.duration_ms,
                    'attrs': dict(self.attrs),
                    'timeline': [dict(e) for e in self.timeline]}


class _NullRecord:
    """Shared no-op record for disabled mode: no ID, no timeline, no ring."""

    __slots__ = ()
    rid = ''
    kind = ''
    engine = ''
    outcome = None
    error = None
    duration_ms = None
    timeline = ()
    attrs = {}

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
    set. Eviction is outcome-aware: when the ring is full the oldest
    *healthy* (ok + fast) record goes first, so slow/failed requests — the
    ones worth debugging — survive longer than their arrival order."""

    def __init__(self, capacity=None, slow_ms=None):
        self.capacity = int(capacity if capacity is not None
                            else _env_num(ENV_REQ_CAP, 256, int))
        self.slow_ms = float(slow_ms if slow_ms is not None
                             else _env_num(ENV_SLOW_MS, 1000.0, float))
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._active = {}            # rid -> RequestRecord
        self._done = []              # completion order, oldest first
        # records evicted from the ring stay findable BY ID for one more
        # generation: the cross-replica stitcher must be able to recover
        # every part of a split or failed-over request even after fresh
        # traffic has cycled the main ring (bounded — never a leak)
        self._evicted = collections.deque(maxlen=self.capacity)

    # ---- lifecycle -------------------------------------------------------
    def start(self, kind, engine='', **attrs):
        rid = f'{kind}-{os.getpid():x}-{next(self._ids):06d}'
        rec = RequestRecord(rid, kind, engine, attrs, recorder=self)
        with self._lock:
            self._active[rid] = rec
            n_active = len(self._active)
        lbl = {'kind': kind}
        if 'tenant' in attrs:
            # per-tenant request accounting: a ModelHost threads the tenant
            # through here so /metrics can attribute load per tenant
            lbl['tenant'] = str(attrs['tenant'])
        counter('request.started', lbl).inc()
        gauge('request.active').set(n_active)
        return rec

    def _notable(self, rec):
        """Retained preferentially: failed, slow, evicted, or failed-over /
        hedged requests (a request that survived a replica death is exactly
        the one worth a post-mortem even though its outcome reads ok)."""
        if rec.outcome not in _OK_OUTCOMES:
            return True
        if rec.duration_ms is not None and rec.duration_ms >= self.slow_ms:
            return True
        return any(e.get('ev') in ('evict', 'failover', 'hedge')
                   for e in rec.timeline)

    def _complete(self, rec):
        with self._lock:
            self._active.pop(rec.rid, None)
            self._done.append(rec)
            while len(self._done) > self.capacity:
                victim = next((i for i, r in enumerate(self._done)
                               if not self._notable(r)), 0)
                self._evicted.append(self._done.pop(victim))
            n_active = len(self._active)
        lbl = {'kind': rec.kind, 'outcome': rec.outcome or '?'}
        if 'tenant' in rec.attrs:
            lbl['tenant'] = str(rec.attrs['tenant'])
        counter('request.completed', lbl).inc()
        gauge('request.active').set(n_active)

    # ---- queries ---------------------------------------------------------
    def lookup(self, rid):
        """The record dict for ``rid`` (in flight, completed, or evicted
        from the ring but still in the archive), or None."""
        with self._lock:
            rec = self._active.get(rid)
            if rec is None:
                rec = next((r for r in self._done if r.rid == rid), None)
            if rec is None:
                rec = next((r for r in self._evicted if r.rid == rid), None)
        return rec.to_dict() if rec is not None else None

    def requests(self, outcome=None, rid=None, limit=None, tenant=None):
        """Newest-first list of record dicts. ``outcome`` filters completed
        records ('ok', 'error', 'expired', 'rejected', or 'active' for the
        in-flight set); ``rid`` returns EVERY record carrying that ID —
        searching the in-flight set, the completed ring, AND the evicted
        archive — so the cross-replica stitcher (``fleetobs.stitch``) and
        ``/debug/requests?id=`` find all parts of a split or failed-over
        request; ``tenant`` filters on the ``tenant`` attr a ModelHost
        stamps onto every request it routes (per-tenant blast-radius
        triage)."""
        if rid:
            with self._lock:
                found = []
                rec = self._active.get(rid)
                if rec is not None:
                    found.append(rec)
                found.extend(r for r in self._done if r.rid == rid)
                found.extend(r for r in self._evicted if r.rid == rid)
            return [r.to_dict() for r in found]
        with self._lock:
            done = list(reversed(self._done))
            active = list(self._active.values())
        if outcome == 'active':
            recs = active
        elif outcome:
            recs = [r for r in done if r.outcome == outcome]
        else:
            recs = active + done
        if tenant:
            recs = [r for r in recs if r.attrs.get('tenant') == tenant]
        if limit is not None:
            recs = recs[:max(0, int(limit))]
        return [r.to_dict() for r in recs]

    def set_capacity(self, n):
        with self._lock:
            self.capacity = max(1, int(n))
            self._evicted = collections.deque(self._evicted,
                                              maxlen=self.capacity)
            while len(self._done) > self.capacity:
                victim = next((i for i, r in enumerate(self._done)
                               if not self._notable(r)), 0)
                self._evicted.append(self._done.pop(victim))
        return self.capacity

    def __len__(self):
        with self._lock:
            return len(self._done)

    def reset(self):
        with self._lock:
            self._active.clear()
            self._done.clear()
            self._evicted.clear()


class _NullRecorder:
    """Shared no-op recorder for disabled mode."""

    __slots__ = ()
    capacity = 0
    slow_ms = 0.0

    def start(self, kind, engine='', **attrs):
        return NULL_RECORD

    def lookup(self, rid):
        return None

    def requests(self, outcome=None, rid=None, limit=None, tenant=None):
        return []

    def set_capacity(self, n):
        return 0

    def __len__(self):
        return 0

    def reset(self):
        pass


NULL_RECORDER = _NullRecorder()

_recorder = FlightRecorder()


def recorder():
    """The process-wide flight recorder (``NULL_RECORDER`` when disabled)."""
    if not cfg.enabled:
        return NULL_RECORDER
    return _recorder


def start_request(kind, engine='', **attrs):
    """Mint a request ID and start its timeline (``NULL_RECORD`` when
    observability is disabled — zero allocation on the hot path)."""
    if not cfg.enabled:
        return NULL_RECORD
    return _recorder.start(kind, engine, **attrs)


def reset_requests():
    _recorder.reset()
