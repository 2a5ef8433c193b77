"""Process-wide metrics registry: Counter / Gauge / Histogram.

Port of the part of ``paddle_tpu/observability/registry.py`` the serving
and training paths use: the series, and their JSON snapshot and
Prometheus text for hapi's ``MetricsExporter`` (the telemetry HTTP plane
that serves them waits for ROADMAP Queue 1 step F). Metric families are created on first use and keyed by
(name, labels); the same (name, labels) pair always returns the same
child, so independent call sites accumulate into one series.

Disabled mode (``PADDLE_TPU_OBS=0``): the module-level helpers return one
shared no-op singleton. Holders that must keep working regardless (the
engine's own stats) construct private unregistered instances instead.
"""
import collections
import os
import threading
import time

DEFAULT_WINDOW = 4096


class _Config:
    __slots__ = ('enabled',)


cfg = _Config()
cfg.enabled = os.environ.get('PADDLE_TPU_OBS', '1').lower() not in (
    '0', 'false', 'off')


def enabled():
    return cfg.enabled


def percentile(samples, q):
    """Nearest-rank percentile of an (unsorted) sample sequence; ``None``
    for an empty one, q clamped into [0, 100]."""
    n = len(samples)
    if n == 0:
        return None
    s = sorted(samples)
    if q <= 0:
        return s[0]
    if q >= 100:
        return s[-1]
    return s[min(n - 1, int(n * q / 100.0))]


class Counter:
    """Monotonic counter."""

    __slots__ = ('name', 'labels', '_lock', '_value')

    def __init__(self, name='', labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def reset(self):
        with self._lock:
            self._value = 0

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (occupancy, circuit state)."""

    __slots__ = ('name', 'labels', '_lock', '_value')

    def __init__(self, name='', labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v):
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Windowed sample histogram with nearest-rank percentiles.
    ``count``/``sum`` cover the full lifetime; percentiles come from the
    last ``window`` observations."""

    __slots__ = ('name', 'labels', 'window', '_lock', '_samples', '_count',
                 '_sum')

    def __init__(self, name='', labels=None, window=DEFAULT_WINDOW):
        self.name = name
        self.labels = dict(labels or {})
        self.window = window
        self._lock = threading.Lock()
        self._samples = collections.deque(maxlen=window)
        self._count = 0
        self._sum = 0.0

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._samples.append(v)
            self._count += 1
            self._sum += v

    def percentile(self, q):
        with self._lock:
            return percentile(self._samples, q)

    def reset(self):
        with self._lock:
            self._samples.clear()
            self._count = 0
            self._sum = 0.0

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


class _NullMetric:
    """Shared no-op standing in for every metric type when observability is
    disabled."""

    __slots__ = ()
    value = 0
    count = 0
    sum = 0.0
    mean = 0.0

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def reset(self):
        pass

    def percentile(self, q):
        return None


NULL_METRIC = _NullMetric()

_TYPES = {'counter': Counter, 'gauge': Gauge, 'histogram': Histogram}


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.RLock()
        self._families = {}     # name -> (type_name, {label_key: child})

    def _child(self, type_name, name, labels, **kwargs):
        lk = tuple(sorted((labels or {}).items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (type_name, {})
                self._families[name] = fam
            elif fam[0] != type_name:
                raise ValueError(
                    f'metric {name!r} already registered as {fam[0]}, '
                    f'requested as {type_name}')
            child = fam[1].get(lk)
            if child is None:
                child = _TYPES[type_name](name, labels, **kwargs)
                fam[1][lk] = child
            return child

    def counter(self, name, labels=None):
        return self._child('counter', name, labels)

    def gauge(self, name, labels=None):
        return self._child('gauge', name, labels)

    def histogram(self, name, labels=None, window=DEFAULT_WINDOW):
        return self._child('histogram', name, labels, window=window)

    def _items(self):
        """[(name, type, [child, ...])] in name order."""
        with self._lock:
            return [(n, t, list(ch.values()))
                    for n, (t, ch) in sorted(self._families.items())]

    def snapshot(self):
        """JSON-serializable view of every registered series, keyed by
        name and labels."""
        out = {'ts': time.time(),
               'counters': {}, 'gauges': {}, 'histograms': {}}
        for name, t, children in self._items():
            for c in children:
                key = name + _prom_labels(c.labels)
                out[t + 's'][key] = (
                    {'count': c.count, 'sum': c.sum,
                     'p50': c.percentile(50), 'p99': c.percentile(99)}
                    if t == 'histogram' else c.value)
        return out

    def to_prometheus(self):
        """Prometheus text exposition format (histograms as summaries)."""
        lines = []
        for name, t, children in self._items():
            pname = _prom_name(name)
            lines.append(f'# TYPE {pname} '
                         f'{"summary" if t == "histogram" else t}')
            for c in children:
                lbl = _prom_labels(c.labels)
                if t == 'histogram':
                    for q in (50, 90, 99):
                        v = c.percentile(q)
                        if v is not None:
                            ql = _prom_labels(dict(c.labels,
                                                   quantile=str(q / 100.0)))
                            lines.append(f'{pname}{ql} {v}')
                    lines.append(f'{pname}_sum{lbl} {c.sum}')
                    lines.append(f'{pname}_count{lbl} {c.count}')
                else:
                    lines.append(f'{pname}{lbl} {c.value}')
        return '\n'.join(lines) + ('\n' if lines else '')

    def find(self, name, labels=None):
        """The existing child for (name, labels) or ``None`` — never
        creates a family."""
        lk = tuple(sorted((labels or {}).items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam[1].get(lk)


def _prom_name(name):
    return ''.join(ch if (ch.isalnum() or ch in '_:') else '_'
                   for ch in name)


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


def counter(name, labels=None):
    if not cfg.enabled:
        return NULL_METRIC
    return _default.counter(name, labels)


def gauge(name, labels=None):
    if not cfg.enabled:
        return NULL_METRIC
    return _default.gauge(name, labels)


def histogram(name, labels=None):
    if not cfg.enabled:
        return NULL_METRIC
    return _default.histogram(name, labels)


def find(name, labels=None):
    if not cfg.enabled:
        return None
    return _default.find(name, labels)


def snapshot():
    return _default.snapshot()


def to_prometheus():
    return _default.to_prometheus()
