"""Bucket policy: pad ragged request batches into a small fixed set of
captured shapes. Port of ``paddle_tpu/serving/bucketing.py``.

A captured CUDA graph, like an XLA executable, runs at one shape, so
uneven traffic is quantized onto a ladder of power-of-two batch sizes:
``ceil(log2(max_batch)) + 1`` graphs cover every request size, and
steady-state traffic never captures again.
"""
import numpy as np


def bucket_sizes(max_batch):
    """The bucket ladder: powers of two up to ``max_batch`` (which is
    appended as the terminal bucket when it is not itself a power of two)."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError(f'max_batch must be >= 1, got {max_batch}')
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def bucket_for(n, max_batch=None):
    """Smallest bucket holding ``n`` rows. With ``max_batch=None`` the
    ladder is unbounded (pure next power of two) — the inference.Predictor
    dynamic-batch path uses this; the engine always passes its max."""
    n = int(n)
    if n < 1:
        raise ValueError(f'need at least one row, got {n}')
    if max_batch is not None:
        if n > max_batch:
            raise ValueError(f'{n} rows exceed max_batch={max_batch}; '
                             f'split the request first')
        for b in bucket_sizes(max_batch):
            if b >= n:
                return b
    b = 1
    while b < n:
        b *= 2
    return b


def pad_rows(arr, bucket):
    """Pad ``arr`` along axis 0 up to ``bucket`` rows by repeating the last
    real row (edge padding keeps the filler in-distribution — an all-zeros
    row can push normalization layers into degenerate branches). The real
    rows are bit-identical to the input; callers slice ``out[:n]``."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    if n == bucket:
        return arr
    if n > bucket:
        raise ValueError(f'{n} rows do not fit bucket {bucket}')
    pad = [(0, bucket - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, mode='edge')


def input_signature(arrays):
    """Per-example signature of a request: (shape-without-batch-dim, dtype)
    per input tensor. Requests with equal signatures are batchable."""
    sig = []
    for a in arrays:
        shape = tuple(a.shape[1:])
        sig.append((shape, str(a.dtype)))
    return tuple(sig)
