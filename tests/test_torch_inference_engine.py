"""The batch-serving stack of paddle_tpu_torch (serving.bucketing, the
bucket cache, the batcher, ServingStats, InferenceEngine) against the JAX
package's, on the CPU, on the same numpy requests and weights.

The behaviour ``tests/test_serving.py`` asserts of the reference is held
here of both packages side by side: the bucket ladder, edge padding and
oversized splits, one capture per bucket, deadlines, the full queue, the
circuit breaker, ``shutdown(drain=)``, ``stats()``; each request's outputs
equal the direct forward in both packages and agree across them. Also
``int8_wo`` (which quantizes none of ``ErnieModel``'s raw parameters, as
the reference), ERNIE served through the engine, hapi's
``serving_engine()`` and ``predict(engine=True)``, and the deferred
arguments.
"""
import math
import threading
import time

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.serving import InferenceEngine as RefEngine
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch import fault
from paddle_tpu_torch import serving
from paddle_tpu_torch.fault import CircuitOpenError, InjectedFault, RetryError
from paddle_tpu_torch.serving import (DeadlineExceededError,
                                      EngineClosedError, InferenceEngine,
                                      QueueFullError, bucket_for,
                                      bucket_sizes, input_signature,
                                      pad_rows)

TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


def _mlp(P):
    net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                          P.nn.Linear(16, 4))
    net.eval()
    return net


def _pair(make=_mlp, seed=0):
    """The same network in both packages: the reference's weights (from
    ref.seed) copied into the port's."""
    ref.seed(seed)
    rnet = make(ref)
    pnet = make(port)
    pnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in rnet.state_dict().items()})
    return rnet, pnet


def _fwd(P, net, *xs):
    out = net(*[P.to_tensor(np.asarray(x)) for x in xs])
    if isinstance(out, (list, tuple)):
        return [np.asarray(o.numpy()) for o in out]
    return np.asarray(out.numpy())


def _x(n, d=8, seed=0):
    return np.random.RandomState(seed).rand(n, d).astype('float32')


# ---------------------------------------------------------------------------
# bucket policy, batcher, metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mb', [1, 2, 6, 8, 16, 64])
def test_bucket_ladder_equals_the_reference(mb):
    from paddle_tpu.serving import bucket_sizes as rsizes
    from paddle_tpu.serving import bucket_for as rfor
    assert bucket_sizes(mb) == rsizes(mb)
    assert len(bucket_sizes(mb)) == int(math.ceil(math.log2(mb))) + 1 \
        or mb == 6
    for n in range(1, mb + 1):
        assert bucket_for(n, mb) == rfor(n, mb)
    for n in (1, 3, 9, 100):
        assert bucket_for(n) == rfor(n)
    with pytest.raises(ValueError):
        bucket_for(mb + 1, mb)
    with pytest.raises(ValueError):
        bucket_for(0, mb)


def test_pad_rows_and_signature_equal_the_reference():
    from paddle_tpu.serving import input_signature as rsig
    from paddle_tpu.serving import pad_rows as rpad
    x = np.random.RandomState(1).rand(5, 3, 2).astype('float32')
    np.testing.assert_array_equal(pad_rows(x, 8), rpad(x, 8))
    np.testing.assert_array_equal(pad_rows(x, 8)[5:], np.repeat(x[4:], 3, 0))
    assert pad_rows(x, 5).shape[0] == 5
    with pytest.raises(ValueError):
        pad_rows(x, 4)
    a, b, c = ([np.zeros((3, 8), 'float32')], [np.zeros((7, 8), 'float32')],
               [np.zeros((3, 9), 'float32')])
    assert input_signature(a) == input_signature(b) == rsig(a)
    assert input_signature(a) != input_signature(c)


def test_pending_queues_take_groups_as_the_reference():
    from paddle_tpu.serving.batcher import PendingQueues as RQ
    from paddle_tpu.serving.batcher import Request as RReq
    from paddle_tpu_torch.serving.batcher import PendingQueues, Request
    got = []
    for Q, R in ((RQ, RReq), (PendingQueues, Request)):
        q = Q()
        for i, n in enumerate((3, 2, 4, 1)):
            q.push(R([np.zeros((n, 2))], 's', None, float(i), None))
        q.push(R([np.zeros((2, 3))], 't', None, 10.0, None))
        out = [q.take_ready(1.0, 8, 5.0), q.take_ready(20.0, 8, 5.0),
               q.take_ready(20.0, 8, 5.0, force=True),
               q.take_ready(20.0, 8, 5.0, force=True)]
        got.append([(g[0], [r.n for r in g[1]]) if g else None
                    for g in out] + [q.depth])
    assert got[0] == got[1]


def test_normalize_request_accepts_tensors_and_validates():
    from paddle_tpu_torch.serving.batcher import normalize_request
    import torch
    arrays, n, sig = normalize_request(
        [torch.ones(3, 2, dtype=torch.bfloat16), port.to_tensor(_x(3))])
    assert n == 3 and arrays[0].dtype == np.float32
    assert sig == (((2,), 'float32'), ((8,), 'float32'))
    for bad in ([], [np.float32(1.0)], [np.zeros((2, 8)), np.zeros((3, 8))],
                [np.zeros((0, 8))]):
        with pytest.raises(ValueError):
            normalize_request(bad)


def test_serving_stats_snapshot_keys_equal_the_reference():
    from paddle_tpu.serving.metrics import ServingStats as RStats
    snaps = []
    for S in (RStats, serving.ServingStats):
        t = [0.0]
        st = S(clock=lambda: t[0])
        st.note_submitted(3)
        st.note_queue_wait(0.002)
        st.note_batch(rows=3, bucket=4, exec_s=0.001)
        st.note_completed(0.004)
        t[0] = 2.0
        snaps.append(st.snapshot())
    assert snaps[0].keys() == snaps[1].keys()
    assert {k: v for k, v in snaps[0].items() if k != 'uptime_s'} == \
        {k: v for k, v in snaps[1].items() if k != 'uptime_s'}
    st = serving.ServingStats()
    st.note_submitted()
    st.reset()
    assert st.snapshot()['submitted'] == 0


# ---------------------------------------------------------------------------
# the engine: outputs, captures, stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('sizes', [(1, 3, 5, 8, 17), (2, 2, 7)])
def test_engine_outputs_match_direct_forward_in_both_packages(sizes):
    rnet, pnet = _pair()
    xs = [_x(n, seed=i) for i, n in enumerate(sizes)]
    outs = {}
    for P, E, net in ((ref, RefEngine, rnet), (port, InferenceEngine, pnet)):
        with E(net, max_batch_size=8, max_delay_ms=1.0) as eng:
            outs[P] = [f.result(timeout=60)
                       for f in [eng.submit(x) for x in xs]]
            st = eng.stats()
        assert st['split_requests'] == sum(n > 8 for n in sizes)
        for x, out in zip(xs, outs[P]):
            assert out.shape == (x.shape[0], 4)
            np.testing.assert_allclose(out, _fwd(P, net, x), atol=TOL)
    for a, b in zip(outs[ref], outs[port]):
        np.testing.assert_allclose(b, a, atol=TOL)


def test_engine_one_capture_per_bucket_and_none_in_steady_state():
    _, net = _pair()
    with InferenceEngine(net, max_batch_size=16, max_delay_ms=0.5) as eng:
        for n in (1, 2, 4, 8, 16):
            eng.submit(_x(n)).result(timeout=60)
        st = eng.stats()
        assert st['compiles'] == st['traces'] == len(bucket_sizes(16)) == 5
        rs = np.random.RandomState(3)
        for f in [eng.submit(_x(int(rs.randint(1, 17)))) for _ in range(30)]:
            f.result(timeout=60)
        st = eng.stats()
        assert st['compiles'] == st['traces'] == 5
        assert st['cache_misses'] == 5 and st['prebuilt'] == 0


def test_engine_multi_input_and_stats_schema_equal_the_reference():
    def two_in(P):
        class TwoIn(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = P.nn.Linear(8, 4)

            def forward(self, a, b):
                return self.fc(a) + self.fc(b)
        net = TwoIn()
        net.eval()
        return net
    rnet, pnet = _pair(two_in)
    a, b = _x(3, seed=1), _x(3, seed=2)
    stats = {}
    for P, E, net in ((ref, RefEngine, rnet), (port, InferenceEngine, pnet)):
        with E(net, max_batch_size=8, max_delay_ms=1.0) as eng:
            out = eng.submit(a, b).result(timeout=60)
            stats[P] = eng.stats()
        np.testing.assert_allclose(out, _fwd(P, net, a, b), atol=TOL)
    assert stats[port].keys() == stats[ref].keys()
    assert stats[port]['circuit_state'] == 'closed'
    assert stats[port]['mesh'] is None


def test_engine_env_knobs(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_SERVE_MAX_BATCH', '8')
    monkeypatch.setenv('PADDLE_TPU_SERVE_MAX_DELAY_MS', '7.5')
    eng = InferenceEngine(_mlp(port), autostart=False)
    assert eng.max_batch_size == 8
    assert eng.max_delay_s == pytest.approx(0.0075)
    eng.shutdown()


# ---------------------------------------------------------------------------
# admission control, deadlines, shutdown, the breaker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('E', [RefEngine, InferenceEngine],
                         ids=['reference', 'port'])
def test_backpressure_queue_full_rejects(E):
    net = _mlp(ref if E is RefEngine else port)
    eng = E(net, max_batch_size=8, queue_capacity=2, autostart=False)
    x = _x(2)
    f1, f2 = eng.submit(x), eng.submit(x)
    with pytest.raises(QueueFullError if E is InferenceEngine
                       else ref.serving.QueueFullError) as ei:
        eng.submit(x)
    assert ei.value.capacity == 2
    assert eng.stats()['rejected'] == 1
    eng.start()
    eng.shutdown(drain=True)
    assert f1.result(timeout=60).shape == f2.result(timeout=60).shape \
        == (2, 4)


def test_deadline_expiry_is_retryerror_family_not_a_hang():
    eng = InferenceEngine(_mlp(port), max_batch_size=8, max_delay_ms=1.0,
                          autostart=False)
    x = _x(2)
    with pytest.raises(DeadlineExceededError) as ei:
        eng.submit(x, deadline_ms=0.0)
    assert isinstance(ei.value, RetryError)
    assert eng.stats()['expired'] == 1
    fut = eng.submit(x, deadline_ms=5.0)
    time.sleep(0.02)
    eng.start()
    with pytest.raises(DeadlineExceededError):
        fut.result(timeout=60)
    assert eng.stats()['expired'] == 2
    eng.shutdown()


def test_default_deadline_applies_to_every_request():
    eng = InferenceEngine(_mlp(port), max_batch_size=8,
                          default_deadline_ms=0.0, autostart=False)
    with pytest.raises(DeadlineExceededError):
        eng.submit(_x(1))
    eng.shutdown(drain=False)


@pytest.mark.parametrize('drain', [False, True])
def test_shutdown_drain_or_fail_fast(drain):
    net = _mlp(port)
    eng = InferenceEngine(net, max_batch_size=8, autostart=False)
    x = _x(3)
    fut = eng.submit(x)
    eng.shutdown(drain=drain)
    if drain:       # no dispatch thread: the admitted work runs inline
        np.testing.assert_allclose(fut.result(timeout=60),
                                   _fwd(port, net, x), atol=TOL)
    else:
        with pytest.raises(EngineClosedError):
            fut.result(timeout=60)
    with pytest.raises(EngineClosedError):
        eng.submit(x)


def test_injected_dispatch_faults_open_the_circuit_then_recover():
    fake = [1000.0]
    breaker = fault.CircuitBreaker(failure_threshold=2, recovery_timeout=30.0,
                                   clock=lambda: fake[0])
    eng = InferenceEngine(_mlp(port), max_batch_size=4, max_delay_ms=0.5,
                          breaker=breaker)
    x = _x(1)
    try:
        fault.configure('serving.dispatch:1.0')
        for _ in range(2):
            with pytest.raises(InjectedFault):
                eng.submit(x).result(timeout=60)
        assert breaker.state == fault.OPEN
        with pytest.raises(CircuitOpenError):
            eng.submit(x).result(timeout=60)
        assert eng.stats()['circuit_state'] == 'open'
        fault.configure(None)
        fake[0] += 31.0
        assert eng.submit(x).result(timeout=60).shape == (1, 4)
        assert breaker.state == fault.CLOSED
        assert eng.stats()['failed'] >= 2
    finally:
        fault.reload()
        eng.shutdown()


def test_readiness_probe_warm_and_closed():
    from paddle_tpu_torch import observability as obs
    eng = InferenceEngine(_mlp(port), max_batch_size=4, autostart=False)
    name = eng._probe_name
    assert obs.readiness()['checks'][name]['ready'] is False   # not warm
    eng.warmup('all_buckets', input_spec=[((8,), 'float32')])
    assert obs.readiness()['checks'][name]['ready'] is True
    eng.shutdown()
    assert name not in obs.readiness()['checks']


# ---------------------------------------------------------------------------
# precisions
# ---------------------------------------------------------------------------

def test_int8_wo_close_to_float32_and_within_the_ladder():
    _, net = _pair()
    xs = [_x(n, seed=n) for n in (1, 3, 6)]
    with InferenceEngine(net, max_batch_size=8) as f32, \
            InferenceEngine(net, max_batch_size=8,
                            precision='int8_wo') as wo:
        for x in xs:
            a = f32.submit(x).result(timeout=60)
            b = wo.submit(x).result(timeout=60)
            assert np.abs(a - b).max() < 0.05 * (np.abs(a).max() + 1e-3)
        assert sorted(wo._wo_dtypes) == ['0.weight', '2.weight']
        assert wo.stats()['compiles'] <= len(bucket_sizes(8))


def test_bf16_engine_lowers_inputs_and_returns_float32():
    _, net = _pair()
    with InferenceEngine(net, max_batch_size=4,
                         precision='bfloat16') as eng:
        out = eng.submit(_x(3)).result(timeout=60)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, _fwd(port, net, _x(3)), atol=5e-2)
    with pytest.raises(ValueError):
        InferenceEngine(net, precision='int4')


def test_deferred_arguments_name_their_step():
    net = _mlp(port)
    with pytest.raises(NotImplementedError, match='step F'):
        InferenceEngine(net, telemetry_port=0)
    with pytest.raises(NotImplementedError, match='step K'):
        InferenceEngine(net, mp=2)
    with pytest.raises(NotImplementedError, match='step K'):
        InferenceEngine(net, mesh=object())
    for name, step in (('FleetRouter', 'F'), ('ModelHost', 'F'),
                       ('MeshReplica', 'K')):
        with pytest.raises(NotImplementedError, match=f'step {step}'):
            getattr(serving, name)()


# ---------------------------------------------------------------------------
# ERNIE through the engine
# ---------------------------------------------------------------------------

ERNIE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=32, dtype='float32')


def _ernie_requests(sizes, s=32, vocab=128, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for n in sizes:
        ids = rs.randint(5, vocab, (n, s)).astype(np.int64)
        lens = rs.randint(8, s + 1, n)
        mask = (np.arange(s)[None] < lens[:, None]).astype(np.int64)
        out.append((np.where(mask > 0, ids, 0), np.zeros_like(ids), mask))
    return out


@pytest.fixture(scope='module')
def ernie_pair():
    from paddle_tpu.models.ernie import ErnieConfig as RCfg
    from paddle_tpu.models.ernie import ErnieModel as RModel
    from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieModel
    ref.seed(0)
    rnet = RModel(RCfg(**ERNIE))
    prev = port_device._current
    port.set_device('cpu')
    pnet = ErnieModel(ErnieConfig(**ERNIE))
    pnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in rnet.state_dict().items()})
    port_device._current = prev
    rnet.eval()
    pnet.eval()
    return rnet, pnet


def test_ernie_served_equals_its_forward_in_both_packages(ernie_pair):
    rnet, pnet = ernie_pair
    reqs = _ernie_requests((1, 3, 5, 2))
    outs = {}
    for P, E, net in ((ref, RefEngine, rnet), (port, InferenceEngine, pnet)):
        with E(net, max_batch_size=8, max_delay_ms=1.0) as eng:
            eng.warmup('all_buckets', input_spec=[((32,), 'int64')] * 3)
            before = eng.stats()['traces']
            outs[P] = [f.result(timeout=120)
                       for f in [eng.submit(*r) for r in reqs]]
            assert eng.stats()['traces'] == before == 4
        for r, out in zip(reqs, outs[P]):
            want = _fwd(P, net, *r)
            for o, w in zip(out, want):
                np.testing.assert_allclose(o, w, atol=TOL)
    for a, b in zip(outs[ref], outs[port]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, atol=1e-4)


def test_int8_wo_quantizes_none_of_ernies_parameters(ernie_pair):
    """ErnieModel's parameters are raw (no Linear / Conv2D / Embedding
    sublayer), so int8_wo leaves every one at full precision, as the
    reference's _wo_param_axes does."""
    from paddle_tpu.serving.engine import _wo_param_axes as rwo
    from paddle_tpu_torch.serving.engine import _wo_param_axes
    rnet, pnet = ernie_pair
    assert _wo_param_axes(pnet) == rwo(rnet) == {}
    req = _ernie_requests((3,), seed=4)[0]
    with InferenceEngine(pnet, max_batch_size=4) as f32, \
            InferenceEngine(pnet, max_batch_size=4,
                            precision='int8_wo') as wo:
        assert wo._wo_dtypes == {}
        for a, b in zip(f32.submit(*req).result(timeout=60),
                        wo.submit(*req).result(timeout=60)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# hapi
# ---------------------------------------------------------------------------

def test_model_predict_through_the_engine_equals_predict():
    _, net = _pair()
    model = port.Model(net)
    model.prepare(None, None)
    xs = _x(10, seed=5)
    batches = [(xs[0:4],), (xs[4:8],), (xs[8:10],)]
    direct = model.predict(batches, stack_outputs=True)
    out = model.predict(batches, stack_outputs=True, engine=True)
    np.testing.assert_allclose(out[0], direct[0], atol=TOL)
    np.testing.assert_allclose(out[0], _fwd(port, net, xs), atol=TOL)
    st = model._engine.stats()
    assert st['completed'] == 3 and st['batches'] >= 1
    model._engine.shutdown()


def test_model_predict_engine_bounded_inflight():
    _, net = _pair()
    model = port.Model(net)
    model.prepare(None, None)
    eng = InferenceEngine(model, max_batch_size=8, max_delay_ms=0.5,
                          queue_capacity=4)
    xs = _x(40, seed=6)
    batches = [(xs[i:i + 2],) for i in range(0, 40, 2)]
    out = model.predict(batches, stack_outputs=True, engine=eng)
    np.testing.assert_allclose(out[0], _fwd(port, net, xs), atol=TOL)
    eng.shutdown()


def test_serving_engine_rebuilds_on_new_kwargs():
    model = port.Model(_mlp(port))
    model.prepare(None, None)
    e1 = model.serving_engine(max_batch_size=4)
    assert e1.max_batch_size == 4
    assert model.serving_engine() is e1
    assert model.serving_engine(max_batch_size=4) is e1
    e2 = model.serving_engine(max_batch_size=8)
    assert e2 is not e1 and e2.max_batch_size == 8
    e2.shutdown()


def test_engine_does_not_freeze_training_mode():
    net = port.nn.Sequential(port.nn.Linear(8, 16), port.nn.Dropout(0.5),
                             port.nn.Linear(16, 4))
    drop = net[1]
    model = port.Model(net)
    opt = port.optimizer.Adam(learning_rate=1e-2, parameters=net.parameters())
    model.prepare(opt, port.nn.CrossEntropyLoss())
    xs = _x(4)
    ys = np.random.RandomState(0).randint(0, 4, size=(4,)).astype('int64')
    model.train_batch([xs], [ys])
    assert drop.training is True
    eng = model.serving_engine(max_batch_size=8, max_delay_ms=1.0)
    assert drop.training is False
    model.train_batch([xs], [ys])
    assert drop.training is True
    eng.shutdown()


def test_engine_from_a_trained_model_serves_its_weights():
    net = port.nn.Sequential(port.nn.Linear(8, 16), port.nn.ReLU(),
                             port.nn.Linear(16, 4))
    model = port.Model(net)
    opt = port.optimizer.Adam(learning_rate=1e-2, parameters=net.parameters())
    model.prepare(opt, port.nn.CrossEntropyLoss())
    xs = _x(8)
    ys = np.random.RandomState(1).randint(0, 4, size=(8,)).astype('int64')
    for _ in range(3):
        model.train_batch([xs], [ys])
    eng = InferenceEngine(model, max_batch_size=8, max_delay_ms=1.0)
    out = eng.submit(xs).result(timeout=60)
    net.eval()
    np.testing.assert_allclose(out, _fwd(port, net, xs), atol=TOL)
    eng.shutdown()


def test_concurrent_submitters_all_complete():
    _, net = _pair()
    xs = [_x(int(n), seed=i) for i, n in
          enumerate(np.random.RandomState(2).randint(1, 9, 24))]
    results = [None] * len(xs)
    with InferenceEngine(net, max_batch_size=8, max_delay_ms=1.0) as eng:
        def work(i):
            results[i] = eng.submit(xs[i]).result(timeout=60)
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert eng.stats()['completed'] == len(xs)
    for x, out in zip(xs, results):
        np.testing.assert_allclose(out, _fwd(port, net, x), atol=TOL)

