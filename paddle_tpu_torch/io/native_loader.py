"""ctypes bridge to the C++ worker-pool dataloader (port of
``paddle_tpu/io/native_loader.py``).

The pool is the JAX package's ``native/dataloader.cpp``, used as it is: a
plain C ABI, compiled at first use with the host C++ compiler
(``native/Makefile``'s flags) into ``paddle_tpu_torch/_build/`` under a
name that carries the source's hash, so an edited source is rebuilt and a
library built elsewhere is never loaded. Python builds a producer callback
(collate into a flat byte buffer); C++ threads run it concurrently and
keep an ordered ring of ready batches. For pure-C++ producers
(``pt_lm_window_producer``) the whole pipeline runs without the GIL.
"""
import ctypes
import hashlib
import os
import pickle
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..core.nest import map_nested
from ..core.tensor import Tensor

SOURCE = Path(__file__).resolve().parents[2] / 'native' / 'dataloader.cpp'
BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
CXX_FLAGS = ('-O3', '-fPIC', '-std=c++17', '-pthread', '-shared')

_lib = None
_lib_lock = threading.Lock()

_PRODUCE_FN = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_int64, ctypes.c_void_p)


def lib_path():
    """Where the pool's library is built: the source's and the flags'
    hash in its name."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(' '.join(CXX_FLAGS).encode())
    return BUILD_DIR / f'libpaddle_tpu_native-{h.hexdigest()[:12]}.so'


def _build(out):
    cxx = os.environ.get('CXX') or shutil.which('g++') or shutil.which('c++')
    if not cxx:
        raise RuntimeError('no C++ compiler (g++) to build the native '
                           'DataLoader pool')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, '-o', tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'building the native DataLoader pool failed '
                           f'({" ".join(cmd)}):\n{proc.stderr}')
    os.replace(tmp, out)          # atomic: a concurrent loader sees all or none


def get_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        out = lib_path()
        if not out.exists():
            # build-once-under-lock: concurrent callers wait for the library
            _build(out)
        lib = ctypes.CDLL(str(out))
        lib.pt_pool_create.restype = ctypes.c_void_p
        lib.pt_pool_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int64, _PRODUCE_FN,
                                       ctypes.c_void_p]
        lib.pt_pool_submit.restype = None
        lib.pt_pool_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.pt_pool_next.restype = ctypes.c_int64
        lib.pt_pool_next.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_uint8)]
        lib.pt_pool_destroy.restype = None
        lib.pt_pool_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class WorkerPool:
    """Generic pool: producer(index) -> bytes (pickled batch)."""

    def __init__(self, produce_py, n_workers=2, ring_cap=4,
                 batch_bytes=32 << 20):
        lib = get_lib()
        self.batch_bytes = batch_bytes
        self.error = None         # the last producer failure, for the caller

        def produce(index, dest, capacity, ctx):
            # runs on a C++ worker thread: nothing may raise into C
            try:
                payload = produce_py(index)
                n = len(payload)
                if n > capacity:
                    raise ValueError(f'batch {index} is {n} bytes, over the '
                                     f'pool\'s {capacity}')
                ctypes.memmove(dest, payload, n)
                return n
            except Exception as e:
                self.error = e
                return -1

        self._cb = _PRODUCE_FN(produce)          # keep alive
        self._pool = lib.pt_pool_create(n_workers, ring_cap, batch_bytes,
                                        self._cb, None)
        self._buf = (ctypes.c_uint8 * batch_bytes)()
        self._lib = lib
        self._closed = False

    def submit(self, index):
        self._lib.pt_pool_submit(self._pool, index)

    def next(self):
        n = self._lib.pt_pool_next(self._pool, self._buf)
        if n < 0:
            return None
        return bytes(self._buf[:n])

    def close(self):
        if not self._closed:
            self._lib.pt_pool_destroy(self._pool)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeWorkerIterator:
    """DataLoader iterator backed by the C++ pool: collation runs on worker
    threads, on the host (the default collate's numpy form: worker threads
    never touch the device); Python unpickles ready batches in order and,
    unless ``host``, wraps their arrays as Tensors on the current place.
    The batch order is drawn when the iterator is built."""

    def __init__(self, loader, host=False):
        self.loader = loader
        self.host = host
        if loader.batch_sampler is None:
            raise RuntimeError('native loader needs a batch_sampler dataset')
        self.batches = list(loader.batch_sampler)
        dataset = loader.dataset
        collate = loader._collate(True)
        batches = self.batches

        def produce(i):
            items = [dataset[j] for j in batches[i]]
            return pickle.dumps(_to_numpy(collate(items)), protocol=4)

        workers = max(loader.num_workers, 1)
        self.pool = WorkerPool(produce, n_workers=workers,
                               ring_cap=loader.prefetch_factor * workers)
        self.n = len(self.batches)
        self.submitted = 0
        self.consumed = 0
        prefill = min(2 * workers, self.n)
        for _ in range(prefill):
            self.pool.submit(self.submitted)
            self.submitted += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self.consumed >= self.n:
            self.close()
            raise StopIteration
        if self.submitted < self.n:
            self.pool.submit(self.submitted)
            self.submitted += 1
        payload = self.pool.next()
        self.consumed += 1
        if not payload:
            self.close()
            raise RuntimeError(f'native worker failed on batch '
                               f'{self.consumed - 1}') from self.pool.error
        out = pickle.loads(payload)      # bytes our own workers wrote
        return out if self.host else _from_numpy(out)

    def close(self):
        self.pool.close()


def _to_numpy(obj):
    return map_nested(lambda x: x.numpy() if isinstance(x, Tensor) else x,
                      obj)


def _from_numpy(obj):
    return map_nested(
        lambda x: Tensor(x) if isinstance(x, np.ndarray) else x, obj)


class LMTokenLoader:
    """Pure-C++ LM batcher: windows over a flat int32 token stream (no GIL)."""

    def __init__(self, tokens, batch_size, seq_len, stride=None, n_workers=2,
                 ring_cap=4):
        lib = get_lib()
        self.tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        self.batch_size = batch_size
        self.seq_len = seq_len
        stride = stride or seq_len

        class LmCtx(ctypes.Structure):
            _fields_ = [('stream', ctypes.c_void_p),
                        ('n_tokens', ctypes.c_int64),
                        ('seq_len', ctypes.c_int64),
                        ('stride', ctypes.c_int64),
                        ('batch', ctypes.c_int64)]

        self._ctx = LmCtx(self.tokens.ctypes.data, len(self.tokens),
                          seq_len, stride, batch_size)
        producer = ctypes.cast(lib.pt_lm_window_producer, _PRODUCE_FN)
        nbytes = batch_size * seq_len * 4
        self._pool = lib.pt_pool_create(n_workers, ring_cap, nbytes, producer,
                                        ctypes.byref(self._ctx))
        self._buf = (ctypes.c_uint8 * nbytes)()
        self._lib = lib
        self._nbytes = nbytes
        self._next_submit = 0
        self._closed = False
        for _ in range(ring_cap):
            self._lib.pt_pool_submit(self._pool, self._next_submit)
            self._next_submit += 1

    def next_batch(self):
        self._lib.pt_pool_submit(self._pool, self._next_submit)
        self._next_submit += 1
        n = self._lib.pt_pool_next(self._pool, self._buf)
        if n != self._nbytes:
            raise RuntimeError(f'LMTokenLoader: a window of {n} bytes, '
                               f'want {self._nbytes}')
        return np.frombuffer(bytes(self._buf[:n]), np.int32).reshape(
            self.batch_size, self.seq_len)

    def close(self):
        if not self._closed:
            self._lib.pt_pool_destroy(self._pool)
            self._closed = True
