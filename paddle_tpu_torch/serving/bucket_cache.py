"""Bucketed capture cache. Port of ``paddle_tpu/serving/bucket_cache.py``.

One captured function (a CUDA graph on the card, ``models.decode_cache.
CapturedFn``) per ``(bucket_size, input_signature, precision)``: a small
set of shape-stable functions reused across the whole request stream. The
builder is supplied by the engine; the cache only owns keying and
lifetime. Since every cached function runs at exactly one padded shape,
``len(cache)`` IS the capture count the serve benchmark asserts on.

Locking is per key: the global lock guards only the dict bookkeeping, and
a builder runs outside it holding a per-key event, so a slow capture for
one bucket never blocks hits (or concurrent captures) for other buckets.
Concurrent requests for the *same* missing key coalesce onto one build;
if the builder raises, waiters wake and retry the build themselves.

``put()`` seeds a function built elsewhere (warmup prebuild): it counts
in ``prebuilt`` / ``serve.prebuilt``, not in ``misses``.
"""
import threading

from .. import observability as _obs


class BucketCompileCache:
    def __init__(self, builder):
        self._builder = builder
        self._fns = {}
        self._lock = threading.Lock()
        self._building = {}  # key -> Event set when the build finishes
        self.misses = 0
        self.prebuilt = 0

    def get(self, bucket, sig, precision):
        key = (bucket, sig, precision)
        while True:
            with self._lock:
                fn = self._fns.get(key)
                if fn is not None:
                    return fn
                event = self._building.get(key)
                if event is None:
                    event = self._building[key] = threading.Event()
                    is_builder = True
                else:
                    is_builder = False
            if not is_builder:
                event.wait()
                continue
            try:
                with _obs.span('serve.compile', bucket=bucket,
                               precision=str(precision)) as sp:
                    fn = self._builder(bucket, sig, precision)
            except BaseException:
                with self._lock:
                    self._building.pop(key, None)
                event.set()
                raise
            with self._lock:
                self._fns[key] = fn
                self.misses += 1
                self._building.pop(key, None)
            event.set()
            _obs.counter('serve.compiles', {'bucket': str(bucket)}).inc()
            _obs.histogram('serve.compile_ms').observe(1e3 * sp.duration)
            return fn

    def peek(self, bucket, sig, precision):
        """The cached executable for a key, or None — never builds."""
        with self._lock:
            return self._fns.get((bucket, sig, precision))

    def put(self, bucket, sig, precision, fn):
        """Seed a prebuilt executable; first write wins. Returns True when
        the entry was installed."""
        key = (bucket, sig, precision)
        with self._lock:
            if key in self._fns:
                return False
            self._fns[key] = fn
            self.prebuilt += 1
        _obs.counter('serve.prebuilt', {'bucket': str(bucket)}).inc()
        return True

    def __len__(self):
        with self._lock:
            return len(self._fns)

    def keys(self):
        with self._lock:
            return list(self._fns)

    def clear(self):
        with self._lock:
            self._fns.clear()
