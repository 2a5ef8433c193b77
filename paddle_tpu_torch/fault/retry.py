"""Bounded retry with exponential backoff + jitter and a total deadline
(port of ``paddle_tpu/fault/retry.py``).

Every time source is injectable (clock/sleep/rng) so backoff schedules are
exactly reproducible under a fake clock in tests — no real sleeping, no
wall-clock flakiness. The goodput ledger's requeue badput waits for ROADMAP
step F.
"""
import random as _random
import time

from .. import observability as _obs
from .errors import RetryError


def retry(fn, *, retries=3, deadline=None, backoff=0.1, factor=2.0,
          max_backoff=30.0, jitter=0.0, exceptions=(Exception,),
          clock=None, sleep=None, rng=None, on_retry=None):
    """Call ``fn()`` up to ``retries`` times total.

    - ``backoff * factor**(attempt-1)`` capped at ``max_backoff`` between
      attempts; ``jitter`` stretches each delay by up to ``jitter`` fraction
      (uniform) to decorrelate a fleet retrying in lockstep.
    - ``deadline`` bounds total elapsed time (measured by ``clock``): if the
      next sleep would cross it, give up immediately.
    - only ``exceptions`` are retried; anything else propagates.
    - ``on_retry(attempt, exc, delay)`` observes each scheduled retry.

    Raises RetryError (last error chained as __cause__) when it gives up.
    """
    clock = clock or time.monotonic
    sleep = sleep or time.sleep
    _obs.counter('fault.retry_calls').inc()
    start = clock()
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions as e:
            attempt += 1
            if attempt >= retries:
                _obs.counter('fault.retry_exhausted').inc()
                raise RetryError(
                    f'gave up after {attempt} attempt(s): {e!r}',
                    attempts=attempt) from e
            delay = min(backoff * (factor ** (attempt - 1)), max_backoff)
            if jitter:
                r = rng.random() if rng is not None else _random.random()
                delay *= 1.0 + jitter * r
            if deadline is not None and (clock() - start) + delay > deadline:
                _obs.counter('fault.retry_exhausted').inc()
                raise RetryError(
                    f'deadline {deadline}s exceeded after {attempt} '
                    f'attempt(s): {e!r}', attempts=attempt) from e
            _obs.counter('fault.retries').inc()
            _obs.record_event('fault.retry', attempt=attempt,
                              delay_s=round(delay, 4),
                              error=type(e).__name__)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
