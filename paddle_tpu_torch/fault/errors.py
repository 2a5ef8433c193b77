"""Typed fault-tolerance errors shared across the port (port of
``paddle_tpu/fault/errors.py``)."""
import pickle


class CheckpointCorruptError(IOError):
    """A checkpoint failed integrity verification (truncated payload,
    CRC/size mismatch against its manifest, or undecodable pickle stream).
    Raised by framework_io.load instead of silently returning garbage."""

    def __init__(self, path, reason):
        super().__init__(f'corrupt checkpoint {path!r}: {reason}')
        self.path = path
        self.reason = reason


class UnsafePayloadError(pickle.UnpicklingError):
    """The pickle stream referenced a global outside the numpy/builtins
    allowlist — loading it could execute arbitrary code, so it is refused.
    Subclasses UnpicklingError so generic pickle handling still applies."""


class RetryError(RuntimeError):
    """retry() or a bounded wait gave up: attempts exhausted or deadline
    exceeded. The last underlying exception, if any, is chained as
    __cause__."""

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
