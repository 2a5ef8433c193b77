"""Bounded LRU memoization of the decode path's captured functions, and the
captured function itself.

Port of ``paddle_tpu/models/decode_cache.py``. The reference memoizes its
jitted decode functions and on-device generate loops keyed on (config,
sampling knobs); ``DecodeFnCache`` is its bounded LRU, copied as it is:
evictions drop the reference (here the CUDA graph and its memory pool go
with it), and a weak registry lets ``clear_decode_caches`` wipe every live
cache in one call.

The PyTorch counterpart of a jitted executable is a captured CUDA graph.
``CapturedFn`` holds one: a function of static input buffers, run a few
times eagerly on a side stream (first-call allocations, library init, the
split-K decode's ticket buffer of that stream), then captured once with
``torch.cuda.graph`` into a memory pool of its own. ``replay(**inputs)``
copies the inputs into the buffers and replays the graph: one launch for
the whole function, with no host work per kernel. A graph bakes in every
address it touches, so whatever the function reads or writes besides its
buffers (parameters, a KV cache or pool) must stay where it is while the
graph lives; owners zero such state in place rather than reallocate it.

The kernel wrappers count their launches in Python, which a replay does not
run. So the capture records each counter's delta (the launches the graph
holds), puts the counters back (a capture launches nothing), and every
replay adds the delta: the counters still count the launches the device
ran.

On the CPU a ``CapturedFn`` runs its function eagerly from the same
buffers: a CPU tensor has no graphs, and that is the device asked for, not
a fallback. A failed capture or replay raises; nothing falls back to the
eager path on the card.
"""
import gc
import os
import threading
import weakref
from collections import OrderedDict

import torch

_REGISTRY = weakref.WeakSet()
_REGISTRY_LOCK = threading.Lock()


def _default_maxsize():
    try:
        v = int(os.environ.get('PADDLE_TPU_DECODE_CACHE_SIZE', 8))
    except ValueError:
        return 8
    return v if v > 0 else 8


class DecodeFnCache:
    """Thread-safe bounded LRU: ``get(key, builder)`` returns the cached
    value, building (and possibly evicting the least-recently-used entry)
    on miss. Instances register themselves weakly for
    ``clear_decode_caches``; per-model instances are collected normally."""

    def __init__(self, maxsize=None, name=None):
        self.maxsize = int(maxsize) if maxsize else _default_maxsize()
        if self.maxsize < 1:
            raise ValueError('maxsize must be >= 1')
        self.name = name or 'decode_cache'
        self._data = OrderedDict()
        self._lock = threading.RLock()
        with _REGISTRY_LOCK:
            _REGISTRY.add(self)

    def get(self, key, builder):
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                return self._data[key]
            value = builder()
            self._data[key] = value
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
            return value

    def clear(self):
        with self._lock:
            self._data.clear()

    def __len__(self):
        with self._lock:
            return len(self._data)

    def __contains__(self, key):
        with self._lock:
            return key in self._data


def clear_decode_caches():
    """Drop every live decode-fn/generate-loop cache (module-level and
    per-model instances: GPT's models and loops, and MoE's
    ``moe_gpt._decode_fns_cache`` / ``_GEN_LOOPS`` with the graphs, caches
    and cast weights they hold). Tests use this to force recaptures;
    serving code can use it to release graphs after a config rollover."""
    with _REGISTRY_LOCK:
        caches = list(_REGISTRY)
    for c in caches:
        c.clear()


# ---------------------------------------------------------------------------
# captured functions
# ---------------------------------------------------------------------------

WARMUP_RUNS = 2          # eager runs on the side stream before the capture
_COUNTERS = ('launches', 'split_launches', 'tc_launches')
_capture_streams = {}


def kernel_wrappers():
    """Every kernel wrapper of the port that counts its launches."""
    from ..ops import flash_attention as fa
    from ..ops import paged_attention as pa
    return (fa.flash_decode, fa.flash_decode_int8, fa.flash_fwd,
            fa.flash_bwd_dq, fa.flash_bwd_dkv, pa.paged_flash_decode,
            pa.paged_flash_decode_int8)


def _counter_values():
    return {(k, a): getattr(k, a) for k in kernel_wrappers()
            for a in _COUNTERS if hasattr(k, a)}


def _capture_stream(dev):
    """One side stream a device for every warm-up and capture, so the
    per-stream buffers the kernels keep (the split-K tickets) are made once
    and outside any graph."""
    s = _capture_streams.get(dev)
    if s is None:
        s = _capture_streams[dev] = torch.cuda.Stream(dev)
    return s


def tensor_key(tree):
    """A hashable key of where every tensor of a nested dict lives: (path,
    address, shape, stride, dtype) per tensor. A graph that read these
    tensors may be replayed for another tree only when the keys agree."""
    out = []

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + (k,))
        elif isinstance(x, torch.Tensor):
            out.append((path, x.data_ptr(), tuple(x.shape), x.stride(),
                        x.dtype))
        elif x is not None:
            raise TypeError(f'tensor_key: {path} is a {type(x).__name__}')

    walk(tree, ())
    return tuple(out)


class CapturedFn:
    """``fn(**buffers)`` as one CUDA graph over static input buffers.

    ``buffers``: name -> tensor, taken as they are (two captured functions
    may share one, as generate()'s prefill and step share their state).
    ``fn`` reads its inputs from them and may write them in place; what it
    returns (tensors, or a tuple of them) is the same storage on every
    replay, valid until the next one. With ``capture=False`` the function
    runs eagerly from the same buffers (on the CPU that is the only way).

    On the card the constructor runs ``fn`` ``WARMUP_RUNS`` times on a side
    stream and captures it once; it raises when the capture fails."""

    def __init__(self, fn, buffers, device, capture=True):
        self.fn = fn
        self.buffers = dict(buffers)
        self.device = torch.device(device)
        self.graph = None
        self.delta = {}
        self.out = None
        self._staging = {}
        self._copied = None      # event: the staged copies have run
        self._pending = False    # a recorded event not yet waited on
        if self.device.type == 'cuda' and capture:
            self._capture()

    @property
    def captured(self):
        return self.graph is not None

    def _capture(self):
        dev = self.device
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self.fn(**self.buffers)
        before = _counter_values()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection while capturing: a collection in the
        # middle would free unreachable graphs (an engine dropped in a
        # reference cycle), and destroying a graph invalidates the capture
        gc_was = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the engine captures on its scheduler thread
            # while other threads may use the card
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(),
                                  stream=side,
                                  capture_error_mode='thread_local'):
                out = self.fn(**self.buffers)
        finally:
            if gc_was:
                gc.enable()
            after = _counter_values()
            for (k, a), n in before.items():
                setattr(k, a, n)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.delta = {key: after[key] - n for key, n in before.items()
                      if after[key] != n}
        self.graph, self.out = graph, out

    def _stage(self, name, value):
        """Copy one input into its buffer: a tensor on the buffer's device
        directly, anything else (numpy, a host tensor) through a pinned
        staging buffer without blocking."""
        buf = self.buffers[name]
        if isinstance(value, torch.Tensor) and value.device == buf.device:
            buf.copy_(value.reshape(buf.shape))
            return
        host = torch.as_tensor(value).reshape(buf.shape)
        if buf.device.type != 'cuda':
            buf.copy_(host)
            return
        stage = self._staging.get(name)
        if stage is None:
            stage = self._staging[name] = torch.empty(
                buf.shape, dtype=buf.dtype, pin_memory=True)
        if self._pending:
            # the last replay's copies out of the staging buffers are done
            self._copied.synchronize()
            self._pending = False
        stage.copy_(host)
        buf.copy_(stage, non_blocking=True)
        if self._copied is None:
            self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(buf.device))

    def replay(self, **inputs):
        """Copy ``inputs`` (name -> array or tensor; unnamed buffers keep
        what they hold) into the buffers and run the function once: the
        graph, or ``fn`` eagerly. -> what ``fn`` returned."""
        for name, value in inputs.items():
            self._stage(name, value)
        self._pending = self._copied is not None
        if self.graph is None:
            return self.fn(**self.buffers)
        self.graph.replay()
        for (k, a), n in self.delta.items():
            setattr(k, a, getattr(k, a) + n)
        return self.out
