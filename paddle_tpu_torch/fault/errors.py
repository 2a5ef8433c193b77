"""Typed fault-tolerance errors (the port's copy of the subset of
``paddle_tpu/fault/errors.py`` the serving path raises)."""


class RetryError(RuntimeError):
    """A bounded wait gave up: attempts exhausted or deadline exceeded.
    The last underlying exception, if any, is chained as __cause__."""

    def __init__(self, message, attempts):
        super().__init__(message)
        self.attempts = attempts

    @property
    def last_exception(self):
        return self.__cause__


class CircuitOpenError(RuntimeError):
    """A CircuitBreaker is open: calls are refused without attempting the
    underlying operation until the recovery timeout elapses."""

    def __init__(self, retry_after):
        super().__init__(f'circuit open; retry in {retry_after:.3f}s')
        self.retry_after = retry_after


class InjectedFault(RuntimeError):
    """Raised by fault.inject() at an armed fault point (action=raise)."""

    def __init__(self, point):
        super().__init__(f'injected fault at {point!r}')
        self.point = point
