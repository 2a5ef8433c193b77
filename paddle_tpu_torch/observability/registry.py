"""Process-wide metrics registry: Counter / Gauge / Histogram (port of
``paddle_tpu/observability/registry.py``; framework-free, the same
exposition byte for byte).

One namespace for every telemetry source in the framework (``train.*``,
``serve.*``, ``fault.*``, ``ckpt.*``, ``data.*``). Metric families are
created on first use and keyed by (name, labels); the same (name, labels)
pair always returns the same child, so independent call sites accumulate
into one series — the TPP (arxiv 2104.05755) discipline of uniform
primitive-level instrumentation.

Thread-safety: the registry lock guards family/child creation only; each
child carries its own lock for updates, so hot-path increments never
serialize against unrelated metrics.

Disabled mode (``PADDLE_TPU_OBS=0``): the module-level helpers return one
shared no-op singleton — no allocation, no registration, near-zero cost.
Holders that must keep working regardless (StepTimer, ServingStats)
construct private unregistered ``Counter``/``Histogram`` instances instead.
"""
import collections
import json
import os
import threading
import time

DEFAULT_WINDOW = 4096
_QUANTILES = (50, 90, 99)


class _Config:
    __slots__ = ('enabled',)


cfg = _Config()
cfg.enabled = os.environ.get('PADDLE_TPU_OBS', '1').lower() not in (
    '0', 'false', 'off')


def enabled():
    return cfg.enabled


def set_enabled(flag):
    """Runtime toggle (tests, embedding apps). The env knob
    ``PADDLE_TPU_OBS=0`` sets the initial value at import."""
    cfg.enabled = bool(flag)


def percentile(samples, q):
    """Nearest-rank percentile of an (unsorted) sample sequence.

    The ONE percentile implementation in the framework — StepTimer, the
    serving stats, and the registry histograms all report latency through
    it. Returns ``None`` for an empty sequence (callers decide how to
    render "no data"); a single sample is every percentile of itself; q is
    clamped into [0, 100] instead of wrapping around via negative indexing.
    """
    n = len(samples)
    if n == 0:
        return None
    s = sorted(samples)
    if q <= 0:
        return s[0]
    if q >= 100:
        return s[-1]
    return s[min(n - 1, int(n * q / 100.0))]


def fmt_key(name, labels=None):
    """Canonical snapshot key: ``name`` or ``name{k=v,...}`` (sorted)."""
    if not labels:
        return name
    inner = ','.join(f'{k}={labels[k]}' for k in sorted(labels))
    return f'{name}{{{inner}}}'


class Counter:
    """Monotonic counter. ``inc`` only; ``reset`` exists for view-holders
    (StepTimer/ServingStats) that own their series' lifetime."""

    __slots__ = ('name', 'labels', '_lock', '_value')

    def __init__(self, name='', labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0

    @property
    def key(self):
        return fmt_key(self.name, self.labels)


class Gauge:
    """Point-in-time value (queue depth, circuit state, last loss)."""

    __slots__ = ('name', 'labels', '_lock', '_value')

    def __init__(self, name='', labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0

    @property
    def key(self):
        return fmt_key(self.name, self.labels)


class Histogram:
    """Windowed sample histogram with nearest-rank percentiles.

    ``count``/``sum``/``min``/``max`` cover the full lifetime; percentiles
    come from a bounded window (last ``window`` observations) so a
    long-lived process never grows telemetry without bound — the same
    policy the serving stats use.
    """

    __slots__ = ('name', 'labels', 'window', '_lock', '_samples', '_count',
                 '_sum', '_min', '_max')

    def __init__(self, name='', labels=None, window=DEFAULT_WINDOW):
        self.name = name
        self.labels = dict(labels or {})
        self.window = window
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._samples = collections.deque(maxlen=self.window)
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._samples.append(v)
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def percentile(self, q):
        with self._lock:
            return percentile(self._samples, q)

    def since(self, count):
        """Samples observed after lifetime-count ``count`` (capped at the
        window). Returns ``(current_count, new_samples)`` — the delta-window
        primitive the SLO watcher evaluates percentiles over, so a breached
        rule can resolve as soon as fresh traffic is healthy instead of
        waiting for the full window to cycle."""
        with self._lock:
            new = self._count - count
            if new <= 0:
                return self._count, []
            s = list(self._samples)
            take = min(new, len(s))
            return self._count, s[len(s) - take:]

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    @property
    def mean(self):
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def stats(self):
        with self._lock:
            out = {'count': self._count,
                   'sum': round(self._sum, 6),
                   'mean': round(self._sum / self._count, 6)
                   if self._count else 0.0,
                   'min': self._min, 'max': self._max}
            for q in _QUANTILES:
                out[f'p{q}'] = percentile(self._samples, q)
        return out

    @property
    def key(self):
        return fmt_key(self.name, self.labels)


class _NullMetric:
    """Shared no-op standing in for every metric type when observability is
    disabled — the zero-allocation fast path (one process-wide instance)."""

    __slots__ = ()
    value = 0
    count = 0
    sum = 0.0
    mean = 0.0
    name = ''
    labels = {}
    key = ''

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def reset(self):
        pass

    def percentile(self, q):
        return None

    def since(self, count):
        return 0, []

    def stats(self):
        return {'count': 0, 'sum': 0.0, 'mean': 0.0, 'min': None,
                'max': None, 'p50': None, 'p90': None, 'p99': None}


NULL_METRIC = _NullMetric()

_TYPES = {'counter': Counter, 'gauge': Gauge, 'histogram': Histogram}


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.RLock()
        self._families = {}     # name -> [type_name, {label_key: child}]
        self._help = {}         # name -> help text (family-level)

    def _child(self, type_name, name, labels, help=None, **kwargs):
        lk = tuple(sorted((labels or {}).items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (type_name, {})
                self._families[name] = fam
                # help is registered at family creation; the default is
                # the metric name so strict scrapers always see a # HELP
                self._help[name] = str(help) if help else name
            elif fam[0] != type_name:
                raise ValueError(
                    f'metric {name!r} already registered as {fam[0]}, '
                    f'requested as {type_name}')
            elif help:
                # a later call site that DOES know the semantics upgrades
                # a default (name-only) help; explicit text never churns
                if self._help.get(name) in (None, name):
                    self._help[name] = str(help)
            child = fam[1].get(lk)
            if child is None:
                child = _TYPES[type_name](name, labels, **kwargs)
                fam[1][lk] = child
            return child

    def counter(self, name, labels=None, help=None):
        return self._child('counter', name, labels, help=help)

    def gauge(self, name, labels=None, help=None):
        return self._child('gauge', name, labels, help=help)

    def histogram(self, name, labels=None, window=DEFAULT_WINDOW,
                  help=None):
        return self._child('histogram', name, labels, help=help,
                           window=window)

    def help_text(self, name):
        """The registered family help (None for unknown families)."""
        with self._lock:
            return self._help.get(name)

    def find(self, name, labels=None):
        """Read-only lookup: the existing child for (name, labels) or
        ``None`` — never creates a family. The SLO watcher polls through
        this so a rule over a series that hasn't reported yet does not
        materialize an empty family in the snapshot."""
        lk = tuple(sorted((labels or {}).items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam[1].get(lk)

    def reset(self):
        with self._lock:
            self._families.clear()
            self._help.clear()

    def _items(self):
        with self._lock:
            return [(name, t, list(children.values()),
                     self._help.get(name, name))
                    for name, (t, children) in sorted(self._families.items())]

    # the registry's own health gauges never count toward cardinality, so
    # back-to-back exports report the same figure (byte-identical renders)
    _SELF_FAMILIES = ('obs.series_total', 'obs.trace_dropped_total')

    def series_total(self):
        """Number of registered series (children across all families,
        excluding the registry's own health gauges) — the
        label-cardinality figure behind ``obs.series_total``."""
        with self._lock:
            return sum(len(children)
                       for name, (_, children) in self._families.items()
                       if name not in self._SELF_FAMILIES)

    def refresh_self_metrics(self):
        """Refresh the registry's own health gauges: ``obs.series_total``
        (cardinality-explosion detector) and ``obs.trace_dropped_total``
        (span-ring overflow). Called on every export (snapshot /
        exposition) so SLO rules and scrapers always see current values;
        safe to call directly. The trace import is deferred — trace.py
        imports this module at load time."""
        if not cfg.enabled:
            return
        n = self.series_total()
        if n == 0:
            # an empty registry must stay empty through an export — don't
            # let observing the registry materialize its first series
            return
        from .trace import trace_dropped
        self.gauge('obs.series_total',
                   help='registered metric series (children across all '
                        'families)').set(n)
        self.gauge('obs.trace_dropped_total',
                   help='span-ring events evicted by the bounded trace '
                        'buffer').set(trace_dropped())

    def snapshot(self):
        """JSON-serializable view of every registered series."""
        self.refresh_self_metrics()
        out = {'ts': time.time(),
               'counters': {}, 'gauges': {}, 'histograms': {}}
        for name, t, children, _ in self._items():
            section = out[t + 's']
            for c in children:
                section[c.key] = c.stats() if t == 'histogram' else c.value
        return out

    def to_prometheus(self):
        """Prometheus text exposition format (histograms as summaries),
        with ``# HELP`` alongside every ``# TYPE`` so the exposition
        survives strict scrapers when federated."""
        self.refresh_self_metrics()
        lines = []
        for name, t, children, help_text in self._items():
            pname = _prom_name(name)
            lines.append(f'# HELP {pname} {_prom_help(help_text)}')
            lines.append(f'# TYPE {pname} '
                         f'{"summary" if t == "histogram" else t}')
            for c in children:
                lbl = _prom_labels(c.labels)
                if t == 'histogram':
                    st = c.stats()
                    for q in _QUANTILES:
                        v = st[f'p{q}']
                        if v is None:
                            continue
                        ql = _prom_labels(dict(c.labels,
                                               quantile=str(q / 100.0)))
                        lines.append(f'{pname}{ql} {v}')
                    lines.append(f'{pname}_sum{lbl} {st["sum"]}')
                    lines.append(f'{pname}_count{lbl} {st["count"]}')
                else:
                    lines.append(f'{pname}{lbl} {c.value}')
        return '\n'.join(lines) + ('\n' if lines else '')


def _prom_name(name):
    return ''.join(ch if (ch.isalnum() or ch in '_:') else '_'
                   for ch in name)


def _prom_help(text):
    # exposition-format HELP escaping: backslash and newline only
    return str(text).replace('\\', '\\\\').replace('\n', '\\n')


def _prom_labels(labels):
    if not labels:
        return ''
    parts = []
    for k, v in sorted(labels.items()):
        val = (str(v).replace('\\', '\\\\').replace('"', '\\"')
               .replace('\n', '\\n'))
        parts.append(f'{_prom_name(str(k))}="{val}"')
    return '{' + ','.join(parts) + '}'


_default = MetricsRegistry()


def registry():
    """The process-wide default registry."""
    return _default


def counter(name, labels=None, help=None):
    if not cfg.enabled:
        return NULL_METRIC
    return _default.counter(name, labels, help=help)


def gauge(name, labels=None, help=None):
    if not cfg.enabled:
        return NULL_METRIC
    return _default.gauge(name, labels, help=help)


def histogram(name, labels=None, window=DEFAULT_WINDOW, help=None):
    if not cfg.enabled:
        return NULL_METRIC
    return _default.histogram(name, labels, window=window, help=help)


def find(name, labels=None):
    if not cfg.enabled:
        return None
    return _default.find(name, labels)


def snapshot():
    return _default.snapshot()


def to_prometheus():
    return _default.to_prometheus()


def dump_snapshot(path):
    snap = _default.snapshot()
    with open(path, 'w') as f:
        json.dump(snap, f, indent=1, sort_keys=True, default=str)
    return snap
