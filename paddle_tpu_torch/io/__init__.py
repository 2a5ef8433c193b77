"""Datasets, samplers, DataLoader (port of ``paddle_tpu/io/__init__.py``).

The worker pool is the C++ one in ``native/dataloader.cpp``
(``io/native_loader.py`` builds it with the host compiler at first use);
iteration degrades to synchronous, with one warning, when it cannot run.
The samplers draw from numpy's global RNG as the reference's do, so the
same ``np.random.seed`` gives the same batch order in both packages.
Batches are Tensors on the current place; ``prefetch_to_device`` collates
on a producer thread into pinned host memory and copies each batch to the
card ahead of the step that takes it.
"""
import itertools
import math
import numbers
import time

import numpy as np
import torch

from .. import observability as _obs
from ..core import dtype as dtypes
from ..core.nest import map_nested
from ..core.tensor import Tensor, wrap
from ..fault import retry
from ..fault.inject import inject


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError('IterableDataset has no __getitem__')

    def __len__(self):
        raise RuntimeError('IterableDataset has no __len__')


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError(f'random_split: lengths sum to {total}, the '
                         f'dataset has {len(dataset)} rows')
    perm = np.random.permutation(total)
    out = []
    off = 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num = num_samples

    @property
    def num_samples(self):
        return self._num if self._num is not None else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, 'float64')
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    """(world size, rank) of the torch.distributed group, (1, 0) without
    one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _data_world():
    """(replicas, rank) of the data axes (dp x sharding: the partitioner's
    ``data_axes``) of the installed process topology: the ranks of one mp
    group read the same samples, as the reference's one process a host
    does. Without a topology, the world's."""
    from ..distributed import topology
    topo = topology._current
    if topo is None:
        return _world()
    from ..parallel.partitioner import Partitioner
    mesh = topo.mesh
    if mesh.coords is None:
        return _world()
    grp = mesh.group(Partitioner(mesh=mesh).data_axes())
    return (1, 0) if grp is None else (grp.nranks, grp.index)


class DistributedBatchSampler(BatchSampler):
    """Shards the dataset across the data-parallel ranks (the installed
    topology's data axes, else the world)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        world, own = _data_world()
        self.nranks = world if num_replicas is None else num_replicas
        self.local_rank = own if rank is None else rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[:(self.total_size - len(indices))]
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


def _is_number(sample):
    # python ints/floats AND numeric numpy scalars (np.float32(i) is not a
    # python float; np.str_/np.bytes_ must fall through untouched)
    return (isinstance(sample, numbers.Number)
            or isinstance(sample, (np.number, np.bool_)))


def default_collate_fn(batch):
    """Stack samples into batched Tensors on the current place (Tensor
    samples stack where they lie)."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return wrap(torch.stack([s._value for s in batch]))
    if isinstance(sample, np.ndarray):
        return Tensor(np.stack(batch))
    if _is_number(sample):
        return Tensor(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _host_collate_fn(batch):
    """default_collate_fn without the Tensor wrap: stacks to plain numpy.
    Built for worker and producer threads, which must not touch the
    device."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return np.stack([s.numpy() for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if _is_number(sample):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return tuple(_host_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: _host_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _pinned(b, pin):
    """A host batch's ndarrays as torch tensors of the port's dtypes (64-bit
    canonicalized), in page-locked memory when ``pin``; anything else as
    it is."""
    def leaf(x):
        if not (isinstance(x, np.ndarray) and x.dtype.kind in 'biufc'):
            return x
        t = torch.from_numpy(np.ascontiguousarray(x))
        want = dtypes.canonical(t.dtype)
        if want != t.dtype:
            t = t.to(want)
        return t.pin_memory() if pin else t
    return map_nested(leaf, b)


def _on_device(b, device):
    """A pinned host batch as Tensors on ``device``; each copy is queued on
    the current stream without waiting for it (the step that reads the
    batch runs after it on the same stream)."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return wrap(x.to(device, non_blocking=True))
        if isinstance(x, Tensor) and x._value.device != device:
            return wrap(x._value.to(device, non_blocking=True))
        return x
    return map_nested(leaf, b)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2, use_shared_memory=True,
                 timeout=0, worker_init_fn=None, persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if not self._iterable_mode:
            if batch_sampler is not None:
                self.batch_sampler = batch_sampler
            else:
                self.batch_sampler = BatchSampler(
                    dataset, shuffle=shuffle, batch_size=batch_size,
                    drop_last=drop_last)
        else:
            self.batch_sampler = None

    def __len__(self):
        if self._iterable_mode:
            raise TypeError('length of IterableDataset DataLoader unknown')
        return len(self.batch_sampler)

    def _fetch(self, i):
        """dataset[i] with up to 3 attempts — transient errors (flaky remote
        storage, a racy augmentation) retry with a short backoff instead of
        killing the epoch."""
        return retry(lambda: self.dataset[i], retries=3, backoff=0.05,
                     jitter=0.5)

    def _collate(self, host):
        """The collate function: the host one (numpy, no device) in place of
        the default when ``host``."""
        if host and self.collate_fn is default_collate_fn:
            return _host_collate_fn
        return self.collate_fn

    def _iter_sync(self, host=False, index_batches=None):
        batches = _obs.counter('data.batches')
        collate = self._collate(host)
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                inject('dataloader.step')
                batches.inc()
                yield collate(batch)
        else:
            for idxs in (self.batch_sampler if index_batches is None
                         else index_batches):
                inject('dataloader.step')
                batches.inc()
                yield collate([self._fetch(i) for i in idxs])

    def _warn_native(self, exc, what):
        if not getattr(self, '_native_warned', False):
            self._native_warned = True
            import warnings
            warnings.warn(
                f'native DataLoader worker pool {what} ({exc!r}); degrading '
                f'to synchronous iteration', RuntimeWarning, stacklevel=2)

    def _native_iter(self, host=False):
        """The native iterator over this epoch's batches, built now (so the
        batch order is drawn on the calling thread), or None with a warning
        when the pool cannot start."""
        try:
            from .native_loader import NativeWorkerIterator
            return NativeWorkerIterator(self, host=host)
        except Exception as e:
            self._warn_native(e, 'unavailable')
            return None

    def _iter_native_fallback(self, it, host=False):
        """Native C++ worker pool with graceful degrade: if the pool could
        not start or dies mid-epoch, finish the epoch synchronously from the
        first undelivered batch — one warning, no data loss."""
        if it is None:
            yield from self._iter_sync(host)
            return
        batches = _obs.counter('data.batches')
        pooled = _obs.counter('data.native_batches')
        delivered = 0
        try:
            while True:
                try:
                    batch = next(it)
                except StopIteration:
                    return
                except Exception as e:
                    self._warn_native(e, 'failed mid-epoch')
                    it.close()
                    yield from self._iter_sync(host, it.batches[delivered:])
                    return
                delivered += 1
                inject('dataloader.step')
                batches.inc()
                pooled.inc()
                yield batch
        finally:
            it.close()

    def _iter(self, host=False):
        if self.num_workers > 0 and not self._iterable_mode:
            return self._iter_native_fallback(self._native_iter(host), host)
        if self._iterable_mode:
            return self._iter_sync(host)
        # the batch order is drawn here, on the calling thread
        return self._iter_sync(host, list(self.batch_sampler))

    def __iter__(self):
        return self._iter()

    def prefetch_to_device(self, n=2):
        """Double-buffered device prefetch: a background thread fetches and
        collates batch N+1 on the host into page-locked memory while the
        consumer computes on batch N; the consumer queues each batch's copy
        to the device ``n`` batches ahead (``non_blocking``, on its current
        stream, so the step that reads a batch runs after its copy). Yields
        the same Tensor batches plain iteration would, in the same order.

        The batch index order is drawn on the CALLING thread — the samplers
        consume ``np.random`` state, which must stay on the main thread for
        AutoResume's deterministic per-epoch shuffle to replay. Closing the
        generator early stops the producer."""
        import collections
        import queue
        import threading

        from ..device import current_device

        depth = max(1, int(n))
        device = current_device()
        pin = device.type == 'cuda'
        host_iter = self._iter(host=True)
        stop = threading.Event()
        q = queue.Queue(maxsize=depth)
        _END, _ERR = object(), object()
        collate_ms = _obs.histogram('data.collate_ms')

        def _put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def _produce():
            try:
                while not stop.is_set():
                    t0 = time.perf_counter()
                    try:
                        b = _pinned(next(host_iter), pin)
                    except StopIteration:
                        break
                    collate_ms.observe(1e3 * (time.perf_counter() - t0))
                    if not _put((None, b)):
                        return
                _put((_END, None))
            except BaseException as e:   # relayed and re-raised by consumer
                _put((_ERR, e))
            finally:
                host_iter.close()

        def _gen():
            thread = threading.Thread(target=_produce, daemon=True,
                                      name='prefetch_to_device')
            thread.start()
            pending = collections.deque()
            done = False
            prefetched = _obs.counter('data.prefetch_batches')
            try:
                while True:
                    # keep up to ``depth`` batches already queued to the
                    # device so the next step's inputs are resident
                    while not done and len(pending) < depth:
                        tag, payload = q.get()
                        if tag is _END:
                            done = True
                        elif tag is _ERR:
                            raise payload
                        else:
                            pending.append(_on_device(payload, device))
                            prefetched.inc()
                    if not pending:
                        return
                    yield pending.popleft()
            finally:
                stop.set()
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
                thread.join(timeout=5.0)

        return _gen()


def get_worker_info():
    return None
