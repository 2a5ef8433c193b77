"""Serving telemetry as a view over the observability registry. Port of
``paddle_tpu/serving/metrics.py``.

Queue wait, execution time, end-to-end latency, batch occupancy / pad
waste and admission outcomes live in the process-wide registry under
``serve.*{engine=eN}``; ``snapshot()`` is the ``engine.stats()`` schema.
Percentiles come from the registry's nearest-rank implementation over
bounded windows. When observability is disabled the stats keep full
product behavior on private, unregistered metric objects.
"""
import itertools
import time

from .. import observability as _obs

WINDOW = 4096

# latency-ish histograms store MILLISECONDS (registry-wide convention)
_HISTOGRAMS = {
    'queue_wait': 'serve.queue_wait_ms',
    'latency': 'serve.latency_ms',
    'exec': 'serve.exec_ms',
    'batch_size': 'serve.batch_size',
}
_COUNTERS = {
    'submitted': 'serve.requests_submitted',
    'completed': 'serve.requests_completed',
    'rejected': 'serve.requests_rejected',
    'expired': 'serve.requests_expired',
    'failed': 'serve.requests_failed',
    'split': 'serve.requests_split',
    'batches': 'serve.batches',
    'rows': 'serve.rows',
    'bucket_rows': 'serve.padded_rows',
}


class ServingStats:
    """Thread-safe accumulator; ``snapshot()`` is the ``engine.stats()``
    payload (schema documented in the README Serving section). Each child
    metric carries its own lock, so hot-path notes never serialize
    against unrelated series."""

    _seq = itertools.count()

    def __init__(self, clock=None):
        self._clock = clock or time.monotonic
        self.labels = {'engine': f'e{next(ServingStats._seq)}'}
        self._c = {}
        self._h = {}
        self.reset()

    def _make_children(self):
        if _obs.enabled():
            reg = _obs.registry()
            self._c = {k: reg.counter(name, self.labels)
                       for k, name in _COUNTERS.items()}
            self._h = {k: reg.histogram(name, self.labels, window=WINDOW)
                       for k, name in _HISTOGRAMS.items()}
        else:
            self._c = {k: _obs.Counter(name, self.labels)
                       for k, name in _COUNTERS.items()}
            self._h = {k: _obs.Histogram(name, self.labels, window=WINDOW)
                       for k, name in _HISTOGRAMS.items()}

    def reset(self):
        self._start_t = self._clock()
        self._make_children()
        for m in self._c.values():
            m.reset()
        for m in self._h.values():
            m.reset()

    # ---- recording (engine-internal) ------------------------------------
    def note_submitted(self, n=1):
        self._c['submitted'].inc(n)

    def note_split(self):
        self._c['split'].inc()

    def note_rejected(self):
        self._c['rejected'].inc()

    def note_expired(self):
        self._c['expired'].inc()

    def note_queue_wait(self, seconds):
        self._h['queue_wait'].observe(1e3 * seconds)

    def note_completed(self, latency_s):
        self._c['completed'].inc()
        self._h['latency'].observe(1e3 * latency_s)

    def note_failed(self, n=1):
        self._c['failed'].inc(n)

    def note_batch(self, rows, bucket, exec_s):
        self._c['batches'].inc()
        self._c['rows'].inc(rows)
        self._c['bucket_rows'].inc(bucket)
        self._h['exec'].observe(1e3 * exec_s)
        self._h['batch_size'].observe(rows)

    # ---- reading ---------------------------------------------------------
    def _pct_ms(self, key, q):
        v = self._h[key].percentile(q)
        return round(v, 3) if v is not None else 0.0

    def snapshot(self):
        elapsed = max(self._clock() - self._start_t, 1e-9)
        rows = self._c['rows'].value
        bucket_rows = self._c['bucket_rows'].value
        completed = self._c['completed'].value
        occ = rows / bucket_rows if bucket_rows else 0.0
        bs = self._h['batch_size']
        return {
            'submitted': self._c['submitted'].value,
            'completed': completed,
            'rejected': self._c['rejected'].value,
            'expired': self._c['expired'].value,
            'failed': self._c['failed'].value,
            'split_requests': self._c['split'].value,
            'batches': self._c['batches'].value,
            'rows': rows,
            'padded_rows': bucket_rows,
            'batch_occupancy': round(occ, 4),
            'pad_waste_pct': round(100.0 * (1.0 - occ), 2)
            if bucket_rows else 0.0,
            'avg_batch_size': round(bs.mean, 2) if bs.count else 0.0,
            'queue_wait_ms_p50': self._pct_ms('queue_wait', 50),
            'queue_wait_ms_p99': self._pct_ms('queue_wait', 99),
            'latency_ms_p50': self._pct_ms('latency', 50),
            'latency_ms_p99': self._pct_ms('latency', 99),
            'exec_ms_p50': self._pct_ms('exec', 50),
            'exec_ms_p99': self._pct_ms('exec', 99),
            'requests_per_sec': round(completed / elapsed, 2),
            'uptime_s': round(elapsed, 3),
        }
