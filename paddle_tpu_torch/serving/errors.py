"""Typed serving errors (port of ``paddle_tpu/serving/errors.py``).

``DeadlineExceededError`` subclasses ``fault.RetryError`` so callers that
already classify RetryError-family timeouts handle an expired serving
request with the same code path.
"""
from ..fault.errors import RetryError


class QueueFullError(RuntimeError):
    """Admission control rejected a request: the engine's bounded queue is
    at capacity. Explicit backpressure — the caller decides whether to shed,
    retry with backoff, or block; the engine never buffers unboundedly.

    ``retry_after_ms`` (optional) is a shedder's estimate of when capacity
    will exist again."""

    def __init__(self, capacity, depth, retry_after_ms=None):
        msg = (f'serving queue full ({depth}/{capacity} pending); '
               f'request rejected by admission control')
        if retry_after_ms is not None:
            msg += f'; retry after ~{retry_after_ms:.0f}ms'
        super().__init__(msg)
        self.capacity = capacity
        self.depth = depth
        self.retry_after_ms = retry_after_ms


class DeadlineExceededError(RetryError):
    """A request's deadline expired while it waited in the queue; it was
    dropped without touching the device."""

    def __init__(self, waited_ms, deadline_ms):
        RuntimeError.__init__(
            self, f'request deadline {deadline_ms:.1f}ms exceeded after '
            f'{waited_ms:.1f}ms in queue')
        self.attempts = 0
        self.waited_ms = waited_ms
        self.deadline_ms = deadline_ms


class EngineClosedError(RuntimeError):
    """submit() after shutdown(): the scheduler thread is gone."""


class HBMAdmissionError(RuntimeError):
    """A ModelHost refused to admit a model: its device-memory footprint
    plus live usage does not fit under the host watermark, and no cold
    model was left to evict."""

    def __init__(self, model, needed_bytes, free_bytes, watermark_bytes):
        super().__init__(
            f'model {model!r} needs {needed_bytes} HBM bytes but only '
            f'{free_bytes} fit under the {watermark_bytes}-byte watermark '
            f'(no evictable cold models remain)')
        self.model = model
        self.needed_bytes = int(needed_bytes)
        self.free_bytes = int(free_bytes)
        self.watermark_bytes = int(watermark_bytes)
