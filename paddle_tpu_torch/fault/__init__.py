"""paddle_tpu_torch.fault — the fault-tolerance primitives the serving path
uses (port of the matching part of ``paddle_tpu/fault``).

- CircuitBreaker:   stop hammering a dependency that is down
- inject():         env-controlled fault points for chaos tests
- typed errors:     CircuitOpenError, InjectedFault, RetryError
"""
from .errors import CircuitOpenError, InjectedFault, RetryError  # noqa: F401
from .circuit import CLOSED, HALF_OPEN, OPEN, CircuitBreaker  # noqa: F401
from .inject import configure, inject, reload  # noqa: F401

__all__ = [
    'CircuitBreaker', 'CircuitOpenError', 'CLOSED', 'OPEN', 'HALF_OPEN',
    'inject', 'configure', 'reload',
    'InjectedFault', 'RetryError',
]
