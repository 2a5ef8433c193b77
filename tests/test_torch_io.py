"""paddle_tpu_torch.io against the JAX package's paddle_tpu.io, on the
CPU: every case of ``tests/test_io.py`` on the port; the same batches
(values exactly, dtypes under the int32 convention) as the reference's
for sequence and shuffled loaders under one ``np.random.seed``, sync and
on the native pool, and for iterable datasets; the same
DistributedBatchSampler shards, random_split and LMTokenLoader windows;
``prefetch_to_device``'s order, error relay and early close; the native
pool's warned degrade; ``paddle.batch`` and ``paddle.reader``."""
import threading
import warnings

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.io import native_loader


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


def _square(P):
    class Square(P.io.Dataset):
        def __getitem__(self, i):
            return np.asarray([i * i], 'float32'), np.asarray([i], 'int64')

        def __len__(self):
            return 10
    return Square()


def _stream(P, n=7):
    class Stream(P.io.IterableDataset):
        def __iter__(self):
            for i in range(n):
                yield np.asarray([i], 'float32'), np.int64(i)
    return Stream()


def _dicts(P):
    class Dicts(P.io.Dataset):
        def __getitem__(self, i):
            return {'x': np.full((2,), i, 'float32'), 'n': i, 'f': 0.5 * i}

        def __len__(self):
            return 9
    return Dicts()


def _host(b):
    """A batch as a tree of (dtype name, numpy values)."""
    if isinstance(b, (ref.Tensor, port.Tensor)):
        return (str(b.dtype).replace('torch.', '').replace(
            'paddle_tpu.', ''), np.asarray(b.numpy()))
    if isinstance(b, (list, tuple)):
        return [_host(x) for x in b]
    if isinstance(b, dict):
        return {k: _host(v) for k, v in b.items()}
    return b


def _equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        (gd, gv), (wd, wv) = got, want
        assert gd == wd
        assert gv.dtype == wv.dtype and gv.shape == wv.shape
        np.testing.assert_array_equal(gv, wv)


def _epochs(P, make, seed=3, epochs=2, **kw):
    """Two epochs of a loader under one np.random.seed, as host trees."""
    np.random.seed(seed)
    loader = P.io.DataLoader(make(P), **kw)
    return [[_host(b) for b in loader] for _ in range(epochs)]


@pytest.mark.parametrize('make', [_square, _dicts])
@pytest.mark.parametrize('shuffle', [False, True])
@pytest.mark.parametrize('workers', [0, 2])
def test_batches_equal_the_references(make, shuffle, workers):
    kw = dict(batch_size=4, shuffle=shuffle, num_workers=workers)
    got = _epochs(port, make, **kw)
    _equal(got, _epochs(ref, make, **kw))
    rows = [np.concatenate([(b['n'] if isinstance(b, dict) else b[1])[1]
                            .reshape(-1) for b in epoch]).tolist()
            for epoch in got]
    assert sorted(rows[0]) == list(range(len(rows[0])))
    # a shuffled loader draws a new order each epoch
    assert (rows[0] != rows[1]) == shuffle


@pytest.mark.parametrize('drop_last', [False, True])
def test_iterable_batches_equal_the_references(drop_last):
    kw = dict(batch_size=3, drop_last=drop_last)
    got = _epochs(port, _stream, **kw)
    _equal(got, _epochs(ref, _stream, **kw))
    assert [b[0][1].shape[0] for b in got[0]] == (
        [3, 3] if drop_last else [3, 3, 1])


def test_samplers_and_splits_equal_the_references():
    for P in (ref, port):
        np.random.seed(5)
        ds = _square(P)
        out = [list(P.io.RandomSampler(ds)),
               list(P.io.RandomSampler(ds, replacement=True,
                                       num_samples=6)),
               list(P.io.WeightedRandomSampler([0.1, 0.5, 0.4], 8)),
               list(P.io.BatchSampler(ds, shuffle=True, batch_size=3)),
               [s.indices for s in P.io.random_split(ds, [7, 3])]]
        for shuffle in (False, True):
            for rank in (0, 1, 2):
                s = P.io.DistributedBatchSampler(
                    ds, batch_size=2, num_replicas=3, rank=rank,
                    shuffle=shuffle)
                s.set_epoch(4)
                out.append((list(s), len(s)))
        if P is ref:
            want = out
    assert out == want


def test_lm_token_loader_windows_equal_the_references():
    from paddle_tpu.io.native_loader import LMTokenLoader as RefLM
    toks = np.arange(5000, dtype=np.int32) * 3
    got, want = [], []
    for cls, out in ((native_loader.LMTokenLoader, got), (RefLM, want)):
        loader = cls(toks, batch_size=2, seq_len=8, stride=5, n_workers=2,
                     ring_cap=2)
        out.extend(loader.next_batch().copy() for _ in range(4))
        loader.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0][0] == toks[:8]).all()


def test_the_pool_is_built_from_the_source_under_its_hash():
    path = native_loader.lib_path()
    assert path.parent.name == '_build' and path.suffix == '.so'
    assert native_loader.get_lib() is native_loader.get_lib()
    assert path.exists()


# ---- tests/test_io.py on the port -------------------------------------------
def test_tensor_dataset_and_loader():
    X = port.to_tensor(np.arange(12).reshape(6, 2).astype('float32'))
    Y = port.to_tensor(np.arange(6).astype('int64'))
    ds = port.io.TensorDataset([X, Y])
    assert len(ds) == 6
    batches = list(port.io.DataLoader(ds, batch_size=4))
    assert len(batches) == 2
    assert batches[0][0].shape == [4, 2] and batches[1][0].shape == [2, 2]
    assert batches[0][1].dtype == port.int32
    assert len(list(port.io.DataLoader(ds, batch_size=4,
                                       drop_last=True))) == 1


def test_map_dataset_order_and_shuffle():
    b = list(port.io.DataLoader(_square(port), batch_size=5, shuffle=False))
    assert b[0][1].numpy().reshape(-1).tolist() == [0, 1, 2, 3, 4]
    np.random.seed(0)
    vals = list(port.io.DataLoader(_square(port), batch_size=10,
                                   shuffle=True))[0][1]
    assert sorted(vals.numpy().reshape(-1).tolist()) == list(range(10))


def test_samplers():
    ds = _square(port)
    assert list(port.io.SequenceSampler(ds)) == list(range(10))
    assert sorted(port.io.RandomSampler(ds)) == list(range(10))
    assert set(port.io.WeightedRandomSampler([0.0, 1.0, 0.0], 20)) == {1}
    bs = port.io.BatchSampler(ds, batch_size=3, drop_last=True)
    assert len(bs) == 3 and all(len(b) == 3 for b in bs)


def test_distributed_batch_sampler():
    ds = _square(port)
    i0 = [i for b in port.io.DistributedBatchSampler(
        ds, batch_size=2, num_replicas=2, rank=0) for i in b]
    i1 = [i for b in port.io.DistributedBatchSampler(
        ds, batch_size=2, num_replicas=2, rank=1) for i in b]
    assert len(i0) == len(i1) == 5 and not set(i0) & set(i1)
    # without a process group: one replica, rank 0
    s = port.io.DistributedBatchSampler(ds, batch_size=4)
    assert (s.nranks, s.local_rank) == (1, 0)


def test_subset_split_chain_compose():
    ds = _square(port)
    sub = port.io.Subset(ds, [1, 3])
    assert len(sub) == 2 and float(sub[1][0][0]) == 9.0
    a, b = port.io.random_split(ds, [7, 3])
    assert len(a) == 7 and len(b) == 3
    with pytest.raises(ValueError):
        port.io.random_split(ds, [7, 2])
    ch = port.io.ChainDataset([_stream(port), _stream(port)])
    assert sum(1 for _ in ch) == 14
    comp = port.io.ComposeDataset([ds, _square(port)])
    assert len(comp) == 10 and len(comp[2]) == 4


def _pooled():
    """Batches the native pool has delivered so far."""
    return port.observability.counter('data.native_batches').value


def test_native_worker_loader():
    before = _pooled()
    batches = list(port.io.DataLoader(_square(port), batch_size=4,
                                      num_workers=2))
    assert len(batches) == 3 and _pooled() - before == 3
    got = sorted(i for b in batches for i in b[1].numpy().reshape(-1))
    assert got == list(range(10))
    assert port.io.get_worker_info() is None


def test_collate_numpy_scalars_stack():
    class IDS(port.io.IterableDataset):
        def __iter__(self):
            for i in range(20):
                yield np.float32(i)

    for workers in (0, 2):
        total = 0.0
        for b in port.io.DataLoader(IDS(), batch_size=4,
                                    num_workers=workers):
            assert isinstance(b, port.Tensor)
            total += float(b.numpy().sum())
        assert total == float(sum(range(20)))


def test_a_custom_collate_runs_on_the_pool():
    def collate(items):
        return port.to_tensor(np.stack([x for x, _ in items]).sum(0))

    got = [b.numpy().tolist() for b in port.io.DataLoader(
        _square(port), batch_size=5, collate_fn=collate, num_workers=2)]
    assert got == [[30.0], [255.0]]


# ---- the native pool's degrade ----------------------------------------------
def test_an_unavailable_pool_degrades_to_sync_with_one_warning(monkeypatch):
    def no_pool(loader, host=False):
        raise OSError('no compiler')

    monkeypatch.setattr(native_loader, 'NativeWorkerIterator', no_pool)
    loader = port.io.DataLoader(_square(port), batch_size=4, num_workers=2)
    before = _pooled()
    with pytest.warns(RuntimeWarning, match='degrading'):
        batches = list(loader)
    assert _pooled() == before                 # none came from a pool
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert len(list(loader)) == 3          # warned once
    assert [b[1].numpy().reshape(-1).tolist() for b in batches] == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


def test_a_failing_worker_finishes_the_epoch_synchronously():
    class Flaky(port.io.Dataset):
        """Item 5 fails the first time it is read (on a pool worker)."""

        def __init__(self):
            self.failed = False
            self.lock = threading.Lock()

        def __getitem__(self, i):
            with self.lock:
                fail, self.failed = (i == 5 and not self.failed,
                                     self.failed or i == 5)
            if fail:
                raise IOError('flaky storage')
            return np.asarray([i], 'float32')

        def __len__(self):
            return 10

    loader = port.io.DataLoader(Flaky(), batch_size=2, num_workers=2)
    before = _pooled()
    with pytest.warns(RuntimeWarning, match='mid-epoch'):
        got = [b.numpy().reshape(-1).tolist() for b in loader]
    assert sum(got, []) == [float(i) for i in range(10)]
    assert _pooled() - before <= 2             # the rest came synchronously


def test_many_pool_workers_keep_the_order_under_contention():
    """More workers than cores and a short switch interval: every batch
    arrives once, in the sampler's order."""
    import os
    import sys

    class Slow(port.io.Dataset):
        def __getitem__(self, i):
            return np.full((3,), i, 'float32')

        def __len__(self):
            return 301

    workers = 2 * (os.cpu_count() or 2) + 1
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        np.random.seed(2)
        loader = port.io.DataLoader(Slow(), batch_size=4, shuffle=True,
                                    num_workers=workers)
        order = [int(v) for b in loader for v in b.numpy()[:, 0]]
    finally:
        sys.setswitchinterval(prev)
    np.random.seed(2)
    assert order == np.random.permutation(301).tolist()


# ---- prefetch_to_device -----------------------------------------------------
@pytest.mark.parametrize('workers', [0, 2])
def test_prefetch_to_device_matches_plain_iteration(workers):
    def loader():
        return port.io.DataLoader(_square(port), batch_size=3, shuffle=True,
                                  num_workers=workers)
    np.random.seed(7)
    plain = [_host(b) for b in loader()]
    np.random.seed(7)
    fetched = list(loader().prefetch_to_device(2))
    assert all(isinstance(t, port.Tensor) for b in fetched for t in b)
    _equal([_host(b) for b in fetched], plain)


def test_prefetch_draws_the_order_on_the_calling_thread():
    loader = port.io.DataLoader(_square(port), batch_size=10, shuffle=True)
    np.random.seed(11)
    it = loader.prefetch_to_device(2)
    state = np.random.get_state()[1].copy()
    order = next(it)[1].numpy().reshape(-1).tolist()
    it.close()
    np.random.seed(11)
    assert order == np.random.permutation(10).tolist()
    assert (np.random.get_state()[1] == state).all()


def test_prefetch_relays_producer_errors():
    class Bad(port.io.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i >= 4:
                raise ValueError('boom')
            return np.zeros(3, np.float32)

    it = port.io.DataLoader(Bad(), batch_size=2).prefetch_to_device(2)
    with pytest.raises(Exception, match='boom'):
        list(it)


def test_prefetch_early_close_stops_the_producer():
    before = {t.ident for t in threading.enumerate()}
    it = port.io.DataLoader(_square(port), batch_size=1).prefetch_to_device(2)
    next(it)
    it.close()                                 # must not hang or leak
    left = [t for t in threading.enumerate()
            if t.name == 'prefetch_to_device' and t.ident not in before]
    assert left == []


# ---- paddle.batch and paddle.reader ------------------------------------------
def test_batch_and_reader_combinators_equal_the_references():
    from paddle_tpu import reader as ref_reader
    from paddle_tpu_torch import reader as port_reader

    def source():
        return iter(range(10))

    def run(P, R):
        out = [list(P.batch(source, 3)()), list(P.batch(source, 3, True)()),
               list(R.chain(source, source)()),
               list(R.compose(source, source)()),
               list(R.firstn(source, 4)()),
               list(R.map_readers(lambda a, b: a * b, source, source)()),
               list(R.buffered(source, 2)()), list(R.cache(source)()),
               sorted(R.xmap_readers(lambda x: x + 1, source, 2, 4)())]
        import random
        random.seed(0)
        out.append(list(R.shuffle(source, 4)()))
        return out

    assert run(port, port_reader) == run(ref, ref_reader)
