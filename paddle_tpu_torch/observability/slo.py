"""Declarative SLO rules over registry series, with debounce + callbacks
(port of ``paddle_tpu/observability/slo.py``, host code as it is).

The machine-readable breach signal the ROADMAP's autoscale-on-queue-wait
design plugs into: a ``Rule`` names a registry series (e.g.
``serve.queue_wait_ms{engine=e0}``), a statistic, a comparison, and a
threshold; a ``Watcher`` evaluates its rules (manually via ``evaluate()``
or on a background thread via ``start()``), tracking an ok → firing →
resolved state machine per rule:

- firing increments ``slo.breaches{rule}``, sets ``slo.firing{rule}`` = 1,
  emits an ``slo.fire`` trace event, and invokes ``on_fire(rule, value)``;
- resolving sets the gauge back to 0, emits ``slo.resolve``, and invokes
  ``on_resolve(rule, value)``. Callback errors are counted
  (``slo.callback_errors{rule}``), never propagated into the poll loop.

Histogram statistics (``p50``/``p90``/``p99``/``mean``) are computed over
the *delta window* — only samples observed since the rule's previous
evaluation — so a breached rule resolves as soon as fresh traffic is
healthy instead of waiting for the 4096-sample window to cycle out.
``rate`` differentiates a counter against wall time. An evaluation with
no new data leaves the rule's state unchanged.

Disabled mode: ``watcher()`` returns ``NULL_WATCHER`` whose methods are
no-ops — no thread, no registry families.
"""
import threading
import time
import weakref

from .registry import cfg, fmt_key, percentile, registry as _registry
from .trace import record_event

# Every live Watcher registers here (weakly — no lifetime coupling) so the
# telemetry server's /debug/slo can enumerate rule states process-wide.
_watchers = weakref.WeakSet()

_CMPS = {
    '>': lambda v, t: v > t,
    '>=': lambda v, t: v >= t,
    '<': lambda v, t: v < t,
    '<=': lambda v, t: v <= t,
}
_STATS = ('value', 'rate', 'mean', 'p50', 'p90', 'p99')


class Rule:
    """One threshold rule. ``debounce`` is the number of *consecutive*
    breaching evaluations required before the rule fires (1 = immediate);
    a single healthy evaluation resolves it."""

    def __init__(self, name, series, threshold, labels=None, stat='value',
                 cmp='>', debounce=1, on_fire=None, on_resolve=None):
        if stat not in _STATS:
            raise ValueError(f'stat {stat!r} not in {_STATS}')
        if cmp not in _CMPS:
            raise ValueError(f'cmp {cmp!r} not in {tuple(_CMPS)}')
        self.name = name
        self.series = series
        self.labels = dict(labels or {})
        self.stat = stat
        self.cmp = cmp
        self.threshold = float(threshold)
        self.debounce = max(1, int(debounce))
        self.on_fire = on_fire
        self.on_resolve = on_resolve
        # evaluation state
        self.state = 'ok'            # 'ok' | 'firing'
        self.last_value = None
        self._breach_streak = 0
        self._hist_count = 0         # histogram delta-window cursor
        self._rate_prev = None       # (value, t) for stat='rate'

    def _sample(self, now):
        """-> (has_data, value) for this evaluation."""
        m = _registry().find(self.series, self.labels)
        if m is None:
            return False, None
        if self.stat == 'value':
            return True, float(m.value if hasattr(m, 'value') else m.count)
        if self.stat == 'rate':
            cur = float(m.value if hasattr(m, 'value') else m.count)
            prev = self._rate_prev
            self._rate_prev = (cur, now)
            if prev is None or now <= prev[1]:
                return False, None
            return True, (cur - prev[0]) / (now - prev[1])
        # histogram stats over the delta window
        if not hasattr(m, 'since'):
            return False, None
        self._hist_count, samples = m.since(self._hist_count)
        if not samples:
            return False, None
        if self.stat == 'mean':
            return True, sum(samples) / len(samples)
        return True, percentile(samples, int(self.stat[1:]))

    def describe(self):
        lbl = fmt_key(self.series, self.labels)
        return (f'{self.name}: {self.stat}({lbl}) {self.cmp} '
                f'{self.threshold}')


class Watcher:
    """Evaluates a set of :class:`Rule` objects. Use ``evaluate()`` from
    your own loop, or ``start()`` for a daemon poll thread."""

    def __init__(self, interval=1.0):
        self.interval = float(interval)
        self._rules = []
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()
        _watchers.add(self)

    def rule(self, name, series, threshold, **kwargs):
        """Create, register, and return a :class:`Rule`."""
        r = Rule(name, series, threshold, **kwargs)
        return self.add_rule(r)

    def add_rule(self, r):
        with self._lock:
            if any(x.name == r.name for x in self._rules):
                raise ValueError(f'duplicate rule name {r.name!r}')
            self._rules.append(r)
        return r

    def remove_rule(self, name):
        """Deregister a rule by name (a fleet autoscaler retires a
        replica's queue-wait rule when the replica is decommissioned).
        Clears the rule's ``slo.firing`` gauge if it was firing; returns
        the removed Rule or None."""
        with self._lock:
            r = next((x for x in self._rules if x.name == name), None)
            if r is not None:
                self._rules.remove(r)
        if r is not None and r.state == 'firing':
            _registry().gauge('slo.firing', {'rule': r.name}).set(0)
        return r

    @property
    def rules(self):
        with self._lock:
            return list(self._rules)

    def states(self):
        with self._lock:
            return {r.name: r.state for r in self._rules}

    def _callback(self, fn, r, value):
        if fn is None:
            return
        try:
            fn(r, value)
        except Exception:
            _registry().counter('slo.callback_errors', {'rule': r.name}).inc()

    def evaluate(self, now=None):
        """Evaluate every rule once. Returns the list of transitions made:
        ``[(rule_name, 'fire'|'resolve', value), ...]``."""
        if not cfg.enabled:
            return []
        now = time.monotonic() if now is None else now
        transitions = []
        reg = _registry()
        for r in self.rules:
            has_data, value = r._sample(now)
            if not has_data:
                continue
            r.last_value = value
            breached = _CMPS[r.cmp](value, r.threshold)
            if breached:
                r._breach_streak += 1
                if r.state == 'ok' and r._breach_streak >= r.debounce:
                    r.state = 'firing'
                    reg.counter('slo.breaches', {'rule': r.name}).inc()
                    reg.gauge('slo.firing', {'rule': r.name}).set(1)
                    record_event('slo.fire', rule=r.name, value=value,
                                 threshold=r.threshold)
                    self._callback(r.on_fire, r, value)
                    transitions.append((r.name, 'fire', value))
            else:
                r._breach_streak = 0
                if r.state == 'firing':
                    r.state = 'ok'
                    reg.gauge('slo.firing', {'rule': r.name}).set(0)
                    record_event('slo.resolve', rule=r.name, value=value,
                                 threshold=r.threshold)
                    self._callback(r.on_resolve, r, value)
                    transitions.append((r.name, 'resolve', value))
        return transitions

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.evaluate()
            except Exception:
                _registry().counter('slo.eval_errors').inc()

    def start(self):
        """Start the daemon poll thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name='slo-watcher', daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class _NullWatcher:
    """Shared no-op watcher for disabled mode: accepts the full API, never
    creates threads, rules, or registry families."""

    __slots__ = ()
    interval = 0.0
    rules = ()

    def rule(self, name, series, threshold, **kwargs):
        return None

    def add_rule(self, r):
        return r

    def remove_rule(self, name):
        return None

    def states(self):
        return {}

    def evaluate(self, now=None):
        return []

    def start(self):
        return self

    def stop(self, timeout=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_WATCHER = _NullWatcher()


def rule_states():
    """Every rule of every live Watcher as a JSON-able list (the
    ``/debug/slo`` payload): name, ok/firing state, last value, and the
    rule's full description. Empty when disabled or no watchers exist."""
    if not cfg.enabled:
        return []
    out = []
    for w in list(_watchers):
        polling = w._thread is not None and w._thread.is_alive()
        for r in w.rules:
            out.append({'rule': r.name, 'state': r.state,
                        'series': fmt_key(r.series, r.labels),
                        'stat': r.stat, 'cmp': r.cmp,
                        'threshold': r.threshold,
                        'last_value': r.last_value,
                        'debounce': r.debounce,
                        'polling': polling,
                        'describe': r.describe()})
    return sorted(out, key=lambda d: d['rule'])


def watcher(interval=1.0):
    """Factory honoring disabled mode — the supported entry point."""
    if not cfg.enabled:
        return NULL_WATCHER
    return Watcher(interval)
