"""Process-wide metrics registry: Counter / Gauge / Histogram.

Port of the part of ``paddle_tpu/observability/registry.py`` the serving
path uses (the Prometheus/JSON export waits for the telemetry HTTP plane,
ROADMAP Queue 1). Metric families are created on first use and keyed by
(name, labels); the same (name, labels) pair always returns the same
child, so independent call sites accumulate into one series.

Disabled mode (``PADDLE_TPU_OBS=0``): the module-level helpers return one
shared no-op singleton. Holders that must keep working regardless (the
engine's own stats) construct private unregistered instances instead.
"""
import collections
import os
import threading

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

    def find(self, name, labels=None):
        """The existing child for (name, labels) or ``None`` — never
        creates a family."""
        lk = tuple(sorted((labels or {}).items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam[1].get(lk)


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


def find(name, labels=None):
    if not cfg.enabled:
        return None
    return _default.find(name, labels)
