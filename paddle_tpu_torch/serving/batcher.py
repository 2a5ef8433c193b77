"""Dynamic batcher bookkeeping: the request objects and the per-signature
pending queues the dispatch thread drains. Port of
``paddle_tpu/serving/batcher.py``.

Pure data-structure logic — no device calls, no threads of its own — so
bucket/flush decisions are unit-testable without an engine. The engine owns
the lock; every method here must be called with it held.
"""
import threading
import numpy as np

from ..observability.reqtrace import NULL_RECORD as _NULL_REC
from .bucketing import input_signature


class Request:
    """One admitted unit of work: ``n`` rows sharing a per-example
    signature. Oversized submissions are split into several Requests whose
    futures are joined by ``SplitJoin``."""

    __slots__ = ('arrays', 'n', 'sig', 'future', 'enqueue_t', 'deadline_t',
                 'rec')

    def __init__(self, arrays, sig, future, enqueue_t, deadline_t, rec=None):
        self.arrays = arrays
        self.n = arrays[0].shape[0]
        self.sig = sig
        self.future = future
        self.enqueue_t = enqueue_t
        self.deadline_t = deadline_t
        # request-scoped trace record (observability.reqtrace); a shared
        # no-op singleton when the layer is disabled
        self.rec = rec if rec is not None else _NULL_REC


class SplitJoin:
    """Joins the chunk results of a split request back into one future.
    Chunk outputs are concatenated along axis 0 in submission order; the
    first chunk failure fails the whole request."""

    def __init__(self, parent_future, n_parts):
        self.future = parent_future
        self._parts = [None] * n_parts
        self._remaining = n_parts
        self._lock = threading.Lock()
        self._failed = False

    def part(self, idx):
        return _PartFuture(self, idx)

    def _done(self, idx, outs):
        with self._lock:
            if self._failed:
                return
            self._parts[idx] = outs
            self._remaining -= 1
            if self._remaining:
                return
        joined = [np.concatenate([p[i] for p in self._parts], axis=0)
                  for i in range(len(self._parts[0]))]
        self.future.set_result(joined[0] if len(joined) == 1 else joined)

    def _failed_part(self, exc):
        with self._lock:
            if self._failed:
                return
            self._failed = True
        self.future.set_exception(exc)


class _PartFuture:
    """Future-shaped adapter a chunk Request completes into."""

    __slots__ = ('_join', '_idx')

    def __init__(self, join, idx):
        self._join = join
        self._idx = idx

    def set_result(self, outs):
        self._join._done(self._idx,
                         outs if isinstance(outs, list) else [outs])

    def set_exception(self, exc):
        self._join._failed_part(exc)


class PendingQueues:
    """FIFO queues of admitted Requests, one per input signature (only
    same-signature requests can share a padded bucket)."""

    def __init__(self):
        self._by_sig = {}
        self.depth = 0          # pending Requests across all signatures

    def push(self, req):
        self._by_sig.setdefault(req.sig, []).append(req)
        self.depth += 1

    def rows(self, sig):
        return sum(r.n for r in self._by_sig.get(sig, ()))

    def take_ready(self, now, max_batch, max_delay_s, force=False):
        """Pop one flushable group: a signature whose pending rows fill a
        max_batch bucket, whose oldest request aged past max_delay, or any
        group when ``force`` (drain). Takes head-of-line requests greedily
        while they fit ``max_batch`` rows; never splits here (submit-time
        splitting guarantees every Request fits a bucket). Returns
        ``(sig, [requests])`` or None."""
        for sig, q in self._by_sig.items():
            if not q:
                continue
            total = sum(r.n for r in q)
            aged = (now - q[0].enqueue_t) >= max_delay_s
            if not (force or aged or total >= max_batch):
                continue
            taken, rows = [], 0
            while q and rows + q[0].n <= max_batch:
                r = q.pop(0)
                taken.append(r)
                rows += r.n
            if not q:
                del self._by_sig[sig]
            self.depth -= len(taken)
            return sig, taken
        return None

    def time_until_ready(self, now, max_delay_s):
        """Seconds until the oldest pending request forces a flush; None
        when nothing is pending (wait indefinitely for a submit)."""
        oldest = None
        for q in self._by_sig.values():
            if q and (oldest is None or q[0].enqueue_t < oldest):
                oldest = q[0].enqueue_t
        if oldest is None:
            return None
        return max(0.0, max_delay_s - (now - oldest))

    def drain_all(self):
        """Pop every pending request (shutdown without drain=True fails
        them; drain=True executes them)."""
        out = []
        for q in self._by_sig.values():
            out.extend(q)
        self._by_sig.clear()
        self.depth = 0
        return out


def _host_array(x):
    """A request input as a host ndarray (a port Tensor or a torch tensor
    copied off its device, bfloat16 as float32)."""
    import torch
    from ..core.tensor import Tensor, wrap
    if isinstance(x, torch.Tensor):
        x = wrap(x)
    return x.numpy() if isinstance(x, Tensor) else np.asarray(x)


def normalize_request(inputs):
    """Validate and host-stage one submission: every input must share the
    leading row count. Returns (list of np arrays, n_rows, signature)."""
    if not inputs:
        raise ValueError('submit() needs at least one input tensor')
    arrays = []
    for x in inputs:
        a = _host_array(x)
        if a.ndim == 0:
            raise ValueError('serving inputs must have a leading batch '
                             'dimension (got a scalar)')
        arrays.append(a)
    n = arrays[0].shape[0]
    for a in arrays[1:]:
        if a.shape[0] != n:
            raise ValueError(
                f'all inputs of one request must share the batch dimension '
                f'(got {n} vs {a.shape[0]})')
    if n < 1:
        raise ValueError('empty request (0 rows)')
    return arrays, n, input_signature(arrays)
