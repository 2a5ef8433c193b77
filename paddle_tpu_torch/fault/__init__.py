"""paddle_tpu_torch.fault — framework-level fault tolerance primitives
(port of ``paddle_tpu/fault``).

- retry():          bounded retries with backoff/jitter/deadline
- CircuitBreaker:   stop hammering a dependency that is down
- inject():         env-controlled fault points for chaos tests
- typed errors:     CheckpointCorruptError, UnsafePayloadError, RetryError,
                    CircuitOpenError, InjectedFault

Used by framework_io (atomic verified checkpoints), utils.checkpoint
(save retries), io.DataLoader (transient __getitem__ retries + native-pool
degrade) and the serving engine (its breaker).
"""
from .errors import (CheckpointCorruptError, CircuitOpenError,  # noqa: F401
                     InjectedFault, RetryError, UnsafePayloadError)
from .retry import retry  # noqa: F401
from .circuit import CLOSED, HALF_OPEN, OPEN, CircuitBreaker  # noqa: F401
from .inject import (active_points, configure, fired_count,  # noqa: F401
                     inject, reload)

__all__ = [
    'retry', 'RetryError',
    'CircuitBreaker', 'CircuitOpenError', 'CLOSED', 'OPEN', 'HALF_OPEN',
    'inject', 'configure', 'reload', 'active_points', 'fired_count',
    'InjectedFault', 'CheckpointCorruptError', 'UnsafePayloadError',
]
