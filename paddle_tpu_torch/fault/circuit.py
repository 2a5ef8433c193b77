"""Circuit breaker: stop hammering a dependency that is down.

Port of ``paddle_tpu/fault/circuit.py`` (framework-free; copied so the
port imports nothing of the JAX package).

closed --(failure_threshold consecutive failures)--> open
open   --(recovery_timeout elapsed)-->               half_open
half_open --success--> closed   |   --failure--> open (timer restarts)

Half-open admits at most ONE probe *in flight* at a time: when the
recovery timeout elapses, exactly one caller is elected to test the
dependency and every other caller keeps getting CircuitOpenError until
that probe resolves. ``half_open_max_calls`` bounds how many *sequential*
trial calls one half-open period may spend before the verdict.

Every state change increments ``fault.breaker_transition{from,to}`` (per
breaker label). The clock is injectable so transitions are deterministic
in tests.
"""
import itertools
import threading
import time

from .. import observability as _obs
from .errors import CircuitOpenError

CLOSED = 'closed'
OPEN = 'open'
HALF_OPEN = 'half_open'

# numeric encoding for the fault.circuit_state gauge
_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    _seq = itertools.count()

    def __init__(self, failure_threshold=5, recovery_timeout=30.0,
                 half_open_max_calls=1, clock=None):
        self.failure_threshold = max(1, failure_threshold)
        self.recovery_timeout = recovery_timeout
        self.half_open_max_calls = max(1, half_open_max_calls)
        self._clock = clock or time.monotonic
        self._lock = threading.RLock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = None
        self._trial_calls = 0
        self._probe_inflight = False
        self.labels = {'breaker': f'b{next(CircuitBreaker._seq)}'}
        self._publish_state()

    def _publish_state(self):
        """Mirror the current state into the fault.circuit_state gauge
        (0 closed / 1 open / 2 half_open)."""
        _obs.gauge('fault.circuit_state',
                   self.labels).set(_STATE_CODE[self._state])

    def _transition(self, new_state):
        old = self._state
        self._state = new_state
        if new_state != old:
            self._publish_state()
            _obs.record_event('fault.circuit_transition',
                              frm=old, to=new_state, **self.labels)
            _obs.counter('fault.breaker_transition',
                         {'from': old, 'to': new_state,
                          **self.labels}).inc()
            if new_state == OPEN:
                _obs.counter('fault.circuit_opened').inc()

    # ---- state ----------------------------------------------------------
    @property
    def state(self):
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self):
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.recovery_timeout:
            self._transition(HALF_OPEN)
            self._trial_calls = 0
            self._probe_inflight = False

    def _open(self):
        self._opened_at = self._clock()
        self._failures = 0
        self._probe_inflight = False
        self._transition(OPEN)

    def reset(self):
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._trial_calls = 0
            self._probe_inflight = False
            self._transition(CLOSED)

    # ---- accounting -----------------------------------------------------
    def allow(self):
        """Reserve permission for one call. In half-open, exactly one probe
        may be in flight at a time, and at most ``half_open_max_calls``
        sequential trials run per half-open period. A granted half-open
        permit MUST be resolved with record_success() or record_failure()
        — ``call()`` does this automatically."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN:
                if self._probe_inflight:
                    return False
                if self._trial_calls < self.half_open_max_calls:
                    self._trial_calls += 1
                    self._probe_inflight = True
                    return True
                return False
            return False

    def record_success(self):
        with self._lock:
            self._probe_inflight = False
            self._failures = 0
            if self._state in (HALF_OPEN, OPEN):
                self.reset()

    def record_failure(self):
        with self._lock:
            self._probe_inflight = False
            self._maybe_half_open()
            if self._state == HALF_OPEN:
                self._open()
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._open()

    # ---- call wrapper ---------------------------------------------------
    def call(self, fn, *args, **kwargs):
        if not self.allow():
            with self._lock:
                remaining = self.recovery_timeout - \
                    (self._clock() - self._opened_at) \
                    if self._opened_at is not None else self.recovery_timeout
            raise CircuitOpenError(max(0.0, remaining))
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result
