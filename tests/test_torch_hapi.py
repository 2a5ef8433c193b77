"""hapi's Model, its callbacks and paddle.metric of paddle_tpu_torch against
the JAX package's, on the CPU, on the same numpy data and weights.

``fit`` of an MLP (SGD: losses and parameters after each epoch within
1e-5; Adam) and of a 2-layer transformer encoder with a key-padding mask
(AdamW over LinearWarmup with ClipGradByGlobalNorm), shuffled under one
``np.random.seed``. The Adam family is held through
``torch_nn_cases.mlm_agreement`` within 1e-4: each side's parameters less
what float64 Adam makes of its own gradients (near Adam's eps the update
amplifies a gradient's last bits by lr / eps); the reference's gradients
are read out of its compiled step with ``jax.debug.callback``. Also
gradient merge, ``evaluate`` with every metric, ``predict`` with
``bucket_pad``, checkpoints across the packages, AutoResume (bit
identical), the LR callbacks, the deferrals, ``summary`` and ``flops``.
"""
import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
import torch_nn_cases as C
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.hapi.callbacks import AutoResume

SGD_TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


def _data(n=32, d=8, classes=3, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, d).astype('float32'),
            rs.randint(0, classes, (n, 1)).astype('int64'))


def _dataset(P, xs, ys):
    return P.io.TensorDataset([P.to_tensor(xs), P.to_tensor(ys)])


def _mlp(P, classes=3, head=None, dropout=None):
    nn = P.nn
    layers = [nn.Linear(8, 16), nn.ReLU()]
    if dropout:
        layers.append(nn.Dropout(dropout))
    layers.append(nn.Linear(16, classes))
    if head:
        layers.append(head(nn))
    return nn.Sequential(*layers)


def _np_state(net):
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def _pair(make, seed=0):
    """The same network in both packages: the reference's weights (from
    ref.seed) copied into the port's."""
    ref.seed(seed)
    rnet = make(ref)
    pnet = make(port)
    pnet.set_state_dict(_np_state(rnet))
    return rnet, pnet


def _optimizer(P, name, net):
    if name == 'sgd':
        return P.optimizer.SGD(0.1, parameters=net.parameters())
    if name == 'momentum':
        return P.optimizer.Momentum(0.05, 0.9, parameters=net.parameters())
    return P.optimizer.Adam(0.01, parameters=net.parameters())


def _record_reference(opt):
    """(gradients by name, lr) of each update the reference's compiled
    step makes, read out with jax.debug.callback."""
    calls, inner = [], opt.functional_apply

    def apply(params, grads, opt_state, lr=None):
        def store(g, lr_):
            calls.append(({k: np.asarray(v, np.float32)
                           for k, v in g.items()}, float(lr_)))
        jax.debug.callback(store, grads, lr)
        return inner(params, grads, opt_state, lr)
    opt.functional_apply = apply
    return calls


class _EpochStates:
    """Each epoch's state dict and the step losses, from callbacks."""

    def __init__(self, P):
        outer = self
        self.states, self.losses = [], []

        class CB(P.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                outer.losses.append(float(np.asarray(logs['loss'])))

            def on_epoch_end(self, epoch, logs=None):
                outer.states.append(_np_state(self.model.network))
        self.cb = CB()


def _mlp_fit(P, net, opt_name, record):
    model = P.Model(net)
    opt = _optimizer(P, opt_name, net)
    calls = record(opt)
    model.prepare(opt, P.nn.CrossEntropyLoss(),
                  metrics=P.metric.Accuracy())
    xs, ys = _data()
    rec = _EpochStates(P)
    np.random.seed(1)
    model.fit(_dataset(P, xs, ys), epochs=2, batch_size=8, log_freq=1,
              verbose=0, callbacks=[rec.cb])
    return rec, calls


@pytest.fixture(scope='module')
def mlp_runs():
    out = {}
    for name in ('sgd', 'adam'):
        rnet, pnet = _pair(_mlp)
        start = _np_state(pnet)
        out[name] = (start,
                     _mlp_fit(ref, rnet, name, _record_reference),
                     _mlp_fit(port, pnet, name, C.record_applies))
    return out


def test_sgd_fit_matches_the_reference_each_epoch(mlp_runs):
    _, (want, _), (got, _) = mlp_runs['sgd']
    assert len(got.losses) == len(want.losses) == 8
    np.testing.assert_allclose(got.losses, want.losses, atol=SGD_TOL,
                               rtol=SGD_TOL)
    assert len(got.states) == len(want.states) == 2
    for g, w in zip(got.states, want.states):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=SGD_TOL, rtol=0,
                                       err_msg=k)


def test_adam_fit_matches_the_reference_through_adams_gaps(mlp_runs):
    start, (want, wcalls), (got, gcalls) = mlp_runs['adam']
    assert len(gcalls) == len(wcalls) == 8

    def form(rec, calls):
        return (rec.losses, [g for g, _ in calls], [lr for _, lr in calls],
                rec.states[-1])
    res = C.mlm_agreement(form(got, gcalls), form(want, wcalls), start,
                          coeff=0.0, clip_norm=None)
    assert res['ok'], res
    # the first epoch's parameters too, from its four updates
    mid = C.mlm_agreement(
        (got.losses[:4], [g for g, _ in gcalls[:4]], [0.01] * 4,
         got.states[0]),
        (want.losses[:4], [g for g, _ in wcalls[:4]], [0.01] * 4,
         want.states[0]), start, coeff=0.0, clip_norm=None)
    assert mid['ok'], mid


@pytest.fixture(scope='module')
def encoder_runs():
    """The masked-LM program of torch_nn_cases at 2 layers, narrow, as a
    hapi Model: AdamW over LinearWarmup(PolynomialDecay) with weight decay
    0.01 and ClipGradByGlobalNorm(1.0), a key-padding mask, 2 shuffled
    epochs of 3 batches."""
    dims = dict(vocab=64, hidden=32, layers=2, heads=2, ffn=64,
                max_seq_len=16, dropout=0.0)
    arrays = C.mlm_batch(dims['vocab'], 12, 16, 8, 16, seed=2)[:4]
    ref.seed(0)
    rnet = C.ernie_mlm(ref, **dims)
    pnet = C.ernie_mlm(port, **dims)
    start = C.state_of(rnet)
    pnet.set_state_dict(start)
    runs = []
    for P, net, record in ((port, pnet, C.record_applies),
                           (ref, rnet, _record_reference)):
        opt, _ = C.mlm_optimizer(P, net, peak=1e-2, warmup=2, decay_steps=10)
        calls = record(opt)
        model = P.Model(net)
        model.prepare(opt, C.mlm_loss(P, dims['vocab']))
        loader = P.io.DataLoader(C.mlm_rows(P, arrays), batch_size=4,
                                 shuffle=True)
        np.random.seed(5)
        runs.append(C.fit_record(P, model, loader, 2, calls))
    return start, runs


def test_encoder_fit_matches_the_reference(encoder_runs):
    start, (got, want) = encoder_runs
    assert len(got[0]) == len(want[0]) == 6
    # the schedule steps at each epoch end: warm-up lrs 0 then 5e-3
    assert got[2] == pytest.approx([0.0] * 3 + [5e-3] * 3)
    res = C.mlm_agreement(got, want, start)
    assert res['ok'], res


def _sgd_fit(P, init, xs, ys, **kw):
    """SGD fit of the MLP from ``init`` -> the state after."""
    net = _mlp(P)
    net.set_state_dict(init)
    model = P.Model(net)
    model.prepare(_optimizer(P, 'sgd', net), P.nn.CrossEntropyLoss())
    model.fit(_dataset(P, xs, ys), verbose=0, shuffle=False, **kw)
    assert model._grad_acc is None
    if P is port:
        assert model._accum_count == 0
    return _np_state(net)


def test_gradient_merge_matches_the_large_batch_and_the_reference():
    xs, ys = _data(16, seed=3)
    ref.seed(0)
    init = _np_state(_mlp(ref))
    merge = dict(epochs=1, batch_size=2, accumulate_grad_batches=4)
    got = _sgd_fit(port, init, xs, ys, **merge)
    want = _sgd_fit(ref, init, xs, ys, **merge)
    large = _sgd_fit(port, init, xs, ys, epochs=1, batch_size=8)
    for k in init:
        np.testing.assert_allclose(got[k], want[k], atol=SGD_TOL, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], large[k], atol=SGD_TOL, rtol=0,
                                   err_msg=k)


def test_a_partial_merge_cycle_flushes_at_epoch_end():
    """10 batches of 1 with accumulate 4: the 2 micro steps left each epoch
    are applied at its end, as the reference's."""
    xs, ys = _data(10, seed=4)
    ref.seed(0)
    init = _np_state(_mlp(ref))
    kw = dict(epochs=2, batch_size=1, accumulate_grad_batches=4)
    got, want = _sgd_fit(port, init, xs, ys, **kw), _sgd_fit(ref, init, xs,
                                                             ys, **kw)
    for k in init:
        np.testing.assert_allclose(got[k], want[k], atol=SGD_TOL, rtol=0,
                                   err_msg=k)


def _softmax(nn):
    return nn.Softmax()


def _sigmoid(nn):
    return nn.Sigmoid()


@pytest.mark.parametrize('kind', ['softmax', 'sigmoid'])
def test_evaluate_metrics_equal_the_references(kind):
    xs, _ = _data(20, seed=6)
    ys = (xs[:, :1] > 0.5).astype('int64')
    if kind == 'softmax':
        make = lambda P: _mlp(P, 2, _softmax)          # noqa: E731
        metrics = lambda P: [P.metric.Accuracy(topk=(1, 2)),  # noqa: E731
                             P.metric.Auc()]
        loss = lambda P: P.nn.NLLLoss()                 # noqa: E731
    else:
        make = lambda P: _mlp(P, 1, _sigmoid)          # noqa: E731
        metrics = lambda P: [P.metric.Precision(),     # noqa: E731
                             P.metric.Recall()]
        loss = lambda P: P.nn.BCELoss()                 # noqa: E731
        ys = ys.astype('float32')
    rnet, pnet = _pair(make)
    logs = []
    for P, net in ((ref, rnet), (port, pnet)):
        model = P.Model(net, inputs=['x'], labels=['y'])
        model.prepare(None, None, metrics=metrics(P))
        logs.append(model.evaluate(_dataset(P, xs, ys), batch_size=6,
                                   verbose=0))
    assert logs[1] == logs[0]
    assert len(logs[0]) == (3 if kind == 'softmax' else 2)


def test_metrics_equal_the_references():
    rs = np.random.RandomState(7)
    pred = rs.rand(40, 5).astype('float32')
    label = rs.randint(0, 5, (40, 1)).astype('int64')
    prob = rs.rand(40).astype('float32')
    binary = rs.randint(0, 2, 40).astype('int64')
    out = []
    for P in (ref, port):
        m = P.metric
        acc = m.Accuracy(topk=(1, 3))
        res = [acc.update(acc.compute(P.to_tensor(pred), P.to_tensor(label))),
               acc.accumulate(), acc.name()]
        for cls in (m.Precision, m.Recall, m.Auc):
            inst = cls()
            inst.update(P.to_tensor(prob), P.to_tensor(binary))
            inst.update(prob[:10], binary[:10])
            res += [inst.accumulate(), inst.name()]
        res.append(float(m.accuracy(P.to_tensor(pred), P.to_tensor(label),
                                    k=2).numpy()))
        out.append(res)
    assert out[1] == out[0]


def test_predict_pads_a_ragged_tail():
    xs, _ = _data(10, seed=8)
    rnet, pnet = _pair(_mlp)
    got = port.Model(pnet, inputs=['x']).predict(
        _dataset(port, xs, xs[:, :1]), batch_size=4, stack_outputs=True)
    want = ref.Model(rnet, inputs=['x']).predict(
        _dataset(ref, xs, xs[:, :1]), batch_size=4, stack_outputs=True)
    assert len(got) == 1 and got[0].shape == (10, 3)
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    direct = pnet(port.to_tensor(xs)).numpy()
    np.testing.assert_allclose(got[0], direct, atol=1e-6)
    per_batch = port.Model(pnet, inputs=['x']).predict(
        _dataset(port, xs, xs[:, :1]), batch_size=4, bucket_pad=False)
    assert [o.shape[0] for o in per_batch[0]] == [4, 4, 2]


def _checkpoint_model(P, net):
    model = P.Model(net)
    model.prepare(_optimizer(P, 'momentum', net), P.nn.CrossEntropyLoss())
    return model


@pytest.mark.parametrize('writer', ['reference', 'port'])
def test_a_checkpoint_continues_in_the_other_package(tmp_path, writer):
    """Train one epoch, save; load in the other package and in a fresh
    model of the writer's, train one more epoch each: equal within
    SGD's tolerance (the momentum state carried in .pdopt)."""
    w, r = (ref, port) if writer == 'reference' else (port, ref)
    xs, ys = _data(seed=9)
    w.seed(0)
    net = _mlp(w)
    init = _np_state(net)
    model = _checkpoint_model(w, net)
    model.fit(_dataset(w, xs, ys), epochs=1, batch_size=8, verbose=0,
              shuffle=False)
    path = str(tmp_path / 'ck')
    model.save(path)
    raw = ref.load(path + '.pdopt') if r is ref else port.load(
        path + '.pdopt')
    assert sorted(raw['opt_state']) == sorted(init)
    assert sorted(raw['opt_state']['0.weight']) == ['velocity']
    after = []
    for P in (w, r):
        P.seed(1)
        fresh = _mlp(P)
        m = _checkpoint_model(P, fresh)
        m.load(path)
        m.fit(_dataset(P, xs, ys), epochs=1, batch_size=8, verbose=0,
              shuffle=False)
        after.append(_np_state(fresh))
    for k in init:
        np.testing.assert_allclose(after[1][k], after[0][k], atol=SGD_TOL,
                                   rtol=0, err_msg=k)


def _resume_model(P=port):
    net = _mlp(P, dropout=0.2)
    model = P.Model(net)
    model.prepare(P.optimizer.Adam(parameters=net.parameters(),
                                   learning_rate=1e-2),
                  P.nn.CrossEntropyLoss())
    return model


def _resume_loader(P=port):
    xs, ys = _data(seed=0)
    ys = ys[:, 0]

    class DS(P.io.Dataset):
        def __len__(self):
            return len(xs)

        def __getitem__(self, i):
            return xs[i], ys[i]
    return P.io.DataLoader(DS(), batch_size=8, shuffle=True)


def _seeds():
    """paddle.seed and numpy's (AutoResume draws its shuffle seed base
    from numpy at train begin)."""
    port.seed(0)
    np.random.seed(0)


def test_auto_resume_continues_bit_identically(tmp_path):
    """One epoch with per-epoch checkpoints, then a resumed run to three
    epochs: the weights are bit-identical to an uninterrupted run (the
    dropout stream and the shuffle are restored too)."""
    ckdir = str(tmp_path / 'ck')
    _seeds()
    _resume_model().fit(_resume_loader(), epochs=1, verbose=0,
                        callbacks=[AutoResume(ckdir)])
    _seeds()
    resumed = _resume_model()
    cb = AutoResume(ckdir)
    resumed.fit(_resume_loader(), epochs=3, verbose=0, callbacks=[cb])
    assert cb.resume_info == {'epoch': 0, 'step': None, 'global_step': 4}
    _seeds()
    straight = _resume_model()
    straight.fit(_resume_loader(), epochs=3, verbose=0,
                 callbacks=[AutoResume(str(tmp_path / 'other'))])
    got, want = _np_state(resumed.network), _np_state(straight.network)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_mid_epoch_resume_under_a_capped_step(tmp_path, monkeypatch):
    ckdir = str(tmp_path / 'ck')
    _seeds()
    _resume_model().fit(_resume_loader(), epochs=2, verbose=0,
                        callbacks=[AutoResume(ckdir, every_n_steps=2,
                                              max_to_keep=10)])
    monkeypatch.setenv('PADDLE_RESUME_STEP', '6')
    _seeds()
    resumed = _resume_model()
    cb = AutoResume(ckdir, every_n_steps=2, max_to_keep=10)
    resumed.fit(_resume_loader(), epochs=3, verbose=0, callbacks=[cb])
    assert cb.resume_info == {'epoch': 1, 'step': 1, 'global_step': 6}
    monkeypatch.delenv('PADDLE_RESUME_STEP')
    _seeds()
    straight = _resume_model()
    straight.fit(_resume_loader(), epochs=3, verbose=0,
                 callbacks=[AutoResume(str(tmp_path / 'o'), every_n_steps=2)])
    got, want = _np_state(resumed.network), _np_state(straight.network)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fit_resume_kwarg_and_a_reference_checkpoint(tmp_path):
    """``fit(resume=dir)`` installs AutoResume; a checkpoint the
    reference's AutoResume wrote restores its params and Adam state in
    the port (its threefry key cannot seed torch: skipped, warned)."""
    ckdir = str(tmp_path / 'ref')
    ref.seed(0)
    rmodel = _resume_model(ref)
    rmodel.fit(_resume_loader(ref), epochs=1, verbose=0, resume=ckdir)
    assert os.path.exists(os.path.join(ckdir, 'ckpt-4.pdckpt'))
    port.seed(0)
    pmodel = _resume_model()
    with pytest.warns(UserWarning, match='generator state'):
        pmodel.fit(_resume_loader(), epochs=1, verbose=0, resume=ckdir)
    got, want = _np_state(pmodel.network), _np_state(rmodel.network)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    st = pmodel._opt_state['0.weight']
    np.testing.assert_array_equal(
        st['moment1'].numpy(),
        np.asarray(rmodel._opt_state['0.weight']['moment1']))


def _callback_run(P, callbacks, epochs=5):
    P.seed(0)
    net = _mlp(P)
    model = P.Model(net)
    sched = P.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    opt = P.optimizer.SGD(sched if callbacks == 'sched' else 0.1,
                          parameters=net.parameters())
    model.prepare(opt, P.nn.CrossEntropyLoss())
    epochs_run = []

    class Count(P.callbacks.Callback):
        def on_epoch_end(self, epoch, logs=None):
            epochs_run.append(epoch)

    cbs = {'early': lambda: [P.callbacks.EarlyStopping(
               'loss', patience=1, min_delta=10.0)],
           'plateau': lambda: [P.callbacks.ReduceLROnPlateau(
               'loss', factor=0.5, patience=0, min_delta=10.0)],
           'sched': lambda: [P.callbacks.LRScheduler(by_step=True)]}
    xs, ys = _data(16, seed=10)
    model.fit(_dataset(P, xs, ys), epochs=epochs, batch_size=8, verbose=0,
              shuffle=False, callbacks=cbs[callbacks]() + [Count()])
    return epochs_run, float(opt.get_lr())


@pytest.mark.parametrize('callbacks', ['early', 'plateau', 'sched'])
def test_lr_and_stopping_callbacks_match_the_reference(callbacks):
    got, want = _callback_run(port, callbacks), _callback_run(ref, callbacks)
    assert got[0] == want[0] and got[1] == pytest.approx(want[1], rel=1e-6)
    if callbacks == 'early':
        assert got[0] == [0, 1, 2]
    elif callbacks == 'plateau':
        assert got[1] == pytest.approx(0.1 * 0.5 ** 4)


def test_checkpoint_logger_and_exporters(tmp_path, capsys):
    xs, ys = _data(16, seed=11)
    port.seed(0)
    net = _mlp(port)
    model = port.Model(net)
    model.prepare(_optimizer(port, 'adam', net), port.nn.CrossEntropyLoss())
    steps = obs.counter('train.steps').value
    model.fit(_dataset(port, xs, ys), epochs=2, batch_size=8, verbose=1,
              log_freq=1, save_dir=str(tmp_path / 'save'),
              callbacks=[port.callbacks.VisualDL(str(tmp_path / 'vdl')),
                         port.hapi.callbacks.MetricsExporter(
                             str(tmp_path / 'obs'))])
    assert obs.counter('train.steps').value == steps + 4
    assert obs.histogram('train.data_wait_ms').count >= 4
    names = sorted(os.listdir(tmp_path / 'save'))
    assert {'0.pdparams', '0.pdopt', '1.pdparams', 'final.pdparams',
            'final.pdopt'} <= set(names)
    out = capsys.readouterr().out
    assert 'Epoch 1 done: loss:' in out and 'Epoch 0 step 1:' in out
    lines = open(tmp_path / 'vdl' / 'metrics.jsonl').read().splitlines()
    assert [json.loads(x)['epoch'] for x in lines] == [0, 1]
    snap = json.load(open(tmp_path / 'obs' / 'snapshot.json'))
    assert snap['counters']['train.steps'] >= 4
    assert 'train_step_ms_count' in open(tmp_path / 'obs' /
                                         'metrics.prom').read()
    trace = json.load(open(tmp_path / 'obs' / 'trace.json'))
    assert any(e['name'] == 'train.fit' for e in trace['traceEvents'])
    # the final checkpoint loads in the reference
    rnet = _mlp(ref)
    ref.Model(rnet).load(str(tmp_path / 'save' / 'final'))
    for k, v in _np_state(rnet).items():
        np.testing.assert_array_equal(v, _np_state(net)[k])


def test_the_sync_executor_reads_every_loss(monkeypatch):
    xs, ys = _data(16, seed=12)
    states = []
    for sync in ('0', '1'):
        monkeypatch.setenv('PADDLE_TPU_SYNC_EXECUTOR', sync)
        _seeds()
        net = _mlp(port)
        model = port.Model(net)
        model.prepare(_optimizer(port, 'sgd', net), port.nn.CrossEntropyLoss())
        loss = model.train_batch([port.to_tensor(xs)], [port.to_tensor(ys)])
        assert isinstance(loss[0], float) == (sync == '1')
        model.fit(_dataset(port, xs, ys), epochs=1, batch_size=8, verbose=0)
        states.append(_np_state(net))
    for k in states[0]:
        np.testing.assert_array_equal(states[0][k], states[1][k])


def test_every_deferral_names_its_step():
    """Sparsity waits for step M; step K4a's ``prepare(strategy=)`` is
    ported: a ``DistributedStrategy`` prepares (one process: a topology of
    one rank), and an object that is not one is refused as the
    reference refuses it (it has no ``to_partition_rules``). Step F's
    ``fit(telemetry_port=)`` is ported: the run serves the telemetry plane
    (``model.telemetry``)."""
    import urllib.request
    net = _mlp(port)
    model = port.Model(net)
    calls = [('M', lambda: port.sparsity.prune_model(net)),
             ('M', lambda: port.sparsity.decorate(None))]
    for step, call in calls:
        with pytest.raises(NotImplementedError, match=f'step {step}'):
            call()
    for P, m in ((ref, ref.Model(_mlp(ref))), (port, model)):
        with pytest.raises(AttributeError, match='to_partition_rules'):
            m.prepare(strategy=object())
    model.prepare(_optimizer(port, 'sgd', net), port.nn.CrossEntropyLoss(),
                  strategy=port.distributed.fleet.DistributedStrategy())
    assert model._partitioner.data_axes() == ('dp',)
    xs, ys = _data(8, seed=5)
    model.prepare(_optimizer(port, 'sgd', net), port.nn.CrossEntropyLoss())
    model.fit(_dataset(port, xs, ys), epochs=1, batch_size=8, verbose=0,
              telemetry_port=0)
    try:
        assert model.telemetry in obs.servers()
        with urllib.request.urlopen(model.telemetry.url + '/debug/goodput',
                                    timeout=30) as r:
            assert json.loads(r.read())['runs'] >= 1
    finally:
        model.telemetry.stop()


def test_summary_and_flops_equal_the_references():
    outs = []
    for P in (ref, port):
        P.seed(0)
        net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                              P.nn.Linear(16, 4))
        net[2].weight.trainable = False
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = P.summary(net)
        outs.append((res, buf.getvalue(), P.flops(net, [1, 8]),
                     P.Model(net).summary()))
    assert outs[1][:3] == outs[0][:3]
    assert outs[1][0]['total_params'] == 8 * 16 + 16 + 16 * 4 + 4


def test_a_frozen_parameter_stays_where_the_reference_trains_it():
    """A Parameter with trainable=False (stop_gradient) gets no gradient
    and no update in the port's fit, as in Paddle; the reference's
    compiled step differentiates every parameter and moves it (ROADMAP
    known differences)."""
    xs, ys = _data(8, seed=13)
    moved = {}
    for P in (ref, port):
        P.seed(0)
        net = _mlp(P)
        net[0].weight.stop_gradient = True
        before = np.asarray(net[0].weight.numpy()).copy()
        model = P.Model(net)
        model.prepare(_optimizer(P, 'sgd', net), P.nn.CrossEntropyLoss())
        model.fit(_dataset(P, xs, ys), batch_size=4, verbose=0)
        moved[P] = float(np.abs(np.asarray(net[0].weight.numpy())
                                - before).max())
        assert np.abs(np.asarray(net[2].weight.numpy())).max() > 0
    assert moved[port] == 0.0 and moved[ref] > 0.0
