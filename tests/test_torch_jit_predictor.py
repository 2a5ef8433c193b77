"""paddle_tpu_torch's jit.save / jit.load, inference.Predictor and warmup
against the JAX package's, on the CPU.

jit.save's program is a ``torch.export`` program (``.pt2``), tried in the
reference's shape modes (one dynamic dim each, one shared, concrete) with
``meta['export_error']`` on failure; it runs layer-free in the Predictor
and as a trainable TranslatedLayer. The two packages read each other's
``.pdparams`` / ``.pdmodel`` and find no program of their own in the
other's save. The Predictor's attach_layer path, its dynamic batch
buckets, and warmup: a manifest saved by either package loads in the
other, capture-then-prebuild leaves live traffic with zero captures, and
hapi's train/eval entries count as untargeted. Also the bucket cache's
per-key locking, convert_to_mixed_precision, static's deferred names and
the persistent-cache names.
"""
import json
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch import inference, jit, static, warmup
from paddle_tpu_torch.serving import InferenceEngine, bucket_sizes
from paddle_tpu_torch.serving.bucket_cache import BucketCompileCache
from paddle_tpu_torch.static import InputSpec

TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


@pytest.fixture(autouse=True)
def _clean_capture():
    yield
    warmup.capture_stop()
    ref.warmup.capture_stop()


def _mlp(P):
    net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                          P.nn.Linear(16, 4))
    net.eval()
    return net


def _pair(make=_mlp, seed=0):
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


def _meta(path):
    with open(path + '.pdmodel') as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# jit.save / jit.load: the .pt2 program in each shape mode
# ---------------------------------------------------------------------------

def _two_in(P):
    class TwoIn(P.nn.Layer):
        """Two inputs used apart: their batch dims may differ."""
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(8, 4)

        def forward(self, a, b):
            return self.fc(a), self.fc(b) * 2.0
    net = TwoIn()
    net.eval()
    return net


def _added(P):
    class Added(P.nn.Layer):
        """Two inputs added together: their batch dims must be equal."""
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(8, 4)

        def forward(self, a, b):
            return self.fc(a + b)
    net = Added()
    net.eval()
    return net


def _pinned(P):
    class Pinned(P.nn.Layer):
        """Reads the batch size as a Python int: no dynamic program."""
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(8, 4)

        def forward(self, x):
            n = int(x.shape[0])
            return self.fc(x).reshape([n * 4]).reshape([n, 4])
    net = Pinned()
    net.eval()
    return net


@pytest.mark.parametrize('make,n_in,poly', [
    (_two_in, 2, True), (_added, 2, True), (_pinned, 1, False)],
    ids=['per_dim', 'shared', 'concrete'])
def test_jit_save_round_trip_in_each_shape_mode(tmp_path, make, n_in, poly):
    _, net = _pair(make)
    path = str(tmp_path / 'm')
    jit.save(net, path, input_spec=[InputSpec([-1, 8], 'float32')] * n_in)
    meta = _meta(path)
    assert meta['exported'] is True and meta['poly_batch'] is poly
    assert meta['program'] == 'torch.export' and 'export_error' not in meta
    assert meta['input_spec'] == [{'shape': [-1, 8], 'dtype': 'float32'}] \
        * n_in
    assert os.path.exists(path + '.pt2')
    assert not os.path.exists(path + '.pdexec')
    assert not os.path.exists(path + '.stablehlo')
    pred = inference.create_predictor(inference.Config(path + '.pdmodel'))
    for n in ((1, 5) if poly else (2,)):
        xs = [_x(n, seed=i) for i in range(n_in)]
        got = pred.run(xs)
        want = _fwd(port, net, *xs)
        want = want if isinstance(want, list) else [want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=TOL)
    if not poly:
        with pytest.raises(ValueError, match='fixed input shape'):
            pred.run([_x(3)])
    tl = jit.load(path)
    assert type(tl).__name__ == 'TranslatedLayer'
    xs = [_x(2, seed=i) for i in range(n_in)]
    out = tl(*[port.to_tensor(x) for x in xs])
    out = out if isinstance(out, (list, tuple)) else [out]
    want = _fwd(port, net, *xs)
    for g, w in zip(out, want if isinstance(want, list) else [want]):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL)


def test_export_failure_records_the_cause_and_drops_a_stale_program(
        tmp_path):
    class DataDependent(port.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = port.nn.Linear(8, 4)

        def forward(self, x):
            if float(x.sum()) > 0:          # reads a value: no program
                return self.fc(x)
            return self.fc(x) * 0
    path = str(tmp_path / 'm')
    jit.save(_mlp(port), path, input_spec=[InputSpec([-1, 8])])
    assert os.path.exists(path + '.pt2')
    net = DataDependent()
    jit.save(net, path, input_spec=[InputSpec([-1, 8])])
    meta = _meta(path)
    assert meta['exported'] is False and meta['export_error']
    assert not os.path.exists(path + '.pt2')
    raw = jit.load(path)
    assert set(raw) == {'params', 'buffers'}
    pred = inference.create_predictor(inference.Config(path + '.pdmodel'))
    with pytest.raises(RuntimeError, match='attach_layer'):
        pred.run([_x(2)])
    pred.attach_layer(DataDependent())
    np.testing.assert_allclose(pred.run([_x(2)])[0], _fwd(port, net, _x(2)),
                               atol=TOL)


def test_jit_save_without_a_spec_and_of_a_function(tmp_path):
    _, net = _pair()
    path = str(tmp_path / 'nospec')
    jit.save(net, path)
    assert 'exported' not in _meta(path)
    assert not os.path.exists(path + '.pt2')
    assert set(jit.load(path)['params']) == {'0.weight', '0.bias',
                                              '2.weight', '2.bias'}

    def double_relu(x):
        return port.nn.functional.relu(x) * 2.0
    fpath = str(tmp_path / 'fn')
    jit.save(double_relu, fpath, input_spec=[InputSpec([-1, 3])])
    meta = _meta(fpath)
    assert meta['function'] is True and meta['exported'] is True
    pred = inference.create_predictor(inference.Config(fpath + '.pdmodel'))
    x = np.array([[-1.0, 0.5, 2.0]], 'float32')
    np.testing.assert_allclose(pred.run([x])[0], [[0.0, 1.0, 4.0]])
    with pytest.raises(ValueError, match='input_spec'):
        jit.save(double_relu, fpath)


def test_translated_layer_fine_tunes_as_the_layer(tmp_path):
    """One SGD step through the loaded program's backward equals the same
    step on the Layer it was saved from."""
    _, net = _pair()
    path = str(tmp_path / 'm')
    jit.save(net, path, input_spec=[InputSpec([-1, 8])])
    tl = jit.load(path)
    assert _meta(path)['vjp_exported'] is True
    assert list(tl.state_dict()) == list(net.state_dict())
    x = port.to_tensor(_x(4))
    states = []
    for layer in (tl, net):
        layer.train()
        opt = port.optimizer.SGD(0.1, parameters=layer.parameters())
        loss = (layer(x) ** 2).mean()
        loss.backward()
        opt.step()
        states.append({k: v.numpy() for k, v in
                       layer.state_dict().items()})
    for k in states[1]:
        np.testing.assert_allclose(states[0][k], states[1][k], atol=1e-6)
    assert any(np.abs(states[0][k] - v.numpy()).max() > 0 for k, v in
               _pair()[1].state_dict().items())


def test_ernie_program_serves_layer_free(tmp_path):
    """ERNIE's three inputs need equal batch dims (token + type
    embeddings): the shared-dim program, its attention one operator."""
    from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieModel
    port.seed(0)
    # head dim 64: one kernel takes it, so the attention is the operator
    cfg = ErnieConfig(vocab_size=64, hidden_size=128, num_layers=2,
                      num_heads=2, max_seq_len=16, dtype='float32')
    net = ErnieModel(cfg)
    path = str(tmp_path / 'ernie')
    jit.save(net, path, input_spec=[InputSpec([-1, 16], 'int64')] * 3)
    meta = _meta(path)
    assert meta['poly_batch'] is True
    assert [s['dtype'] for s in meta['input_spec']] == ['int32'] * 3
    ep = torch.export.load(path + '.pt2')
    ops = [str(n.target) for n in ep.graph.nodes
           if n.op == 'call_function']
    assert ops.count('paddle_tpu_torch.flash_attention.default') == 2
    pred = inference.create_predictor(inference.Config(path + '.pdmodel'))
    rs = np.random.RandomState(0)
    for n in (1, 3):
        ids = rs.randint(5, 64, (n, 16)).astype(np.int64)
        mask = (np.arange(16)[None] < rs.randint(4, 17, (n, 1))).astype(
            np.int64)
        req = [ids, np.zeros_like(ids), mask]
        for g, w in zip(pred.run(req), _fwd(port, net, *req)):
            np.testing.assert_allclose(g, w, atol=1e-5)


# ---------------------------------------------------------------------------
# the two packages read each other's saves
# ---------------------------------------------------------------------------

def test_a_reference_save_loads_into_the_port(tmp_path):
    rnet, pnet = _pair()
    path = str(tmp_path / 'ref')
    ref.jit.save(rnet, path, input_spec=[ref.static.InputSpec([-1, 8],
                                                              'float32')])
    assert os.path.exists(path + '.pdexec')
    raw = jit.load(path)                      # no program of the port's
    assert set(raw) == {'params', 'buffers'}
    pred = inference.create_predictor(inference.Config(path + '.pdmodel'))
    with pytest.raises(RuntimeError, match='attach_layer'):
        pred.run([_x(2)])
    pred.attach_layer(_mlp(port))
    x = _x(3, seed=4)
    np.testing.assert_allclose(pred.run([x])[0], _fwd(ref, rnet, x),
                               atol=TOL)


def test_a_port_save_loads_into_the_reference(tmp_path):
    rnet, pnet = _pair(seed=3)
    path = str(tmp_path / 'port')
    jit.save(pnet, path, input_spec=[InputSpec([-1, 8], 'float32')])
    raw = ref.jit.load(path)                  # no .pdexec: the raw dict
    assert set(raw) == {'params', 'buffers'}
    from paddle_tpu.inference import Config, create_predictor
    pred = create_predictor(Config(path + '.pdmodel'))
    with pytest.raises(RuntimeError, match='attach_layer'):
        pred.run([_x(2)])
    pred.attach_layer(_mlp(ref))
    x = _x(3, seed=5)
    np.testing.assert_allclose(pred.run([x])[0], _fwd(port, pnet, x),
                               atol=TOL)


def test_a_reference_jit_save_of_resnet18_serves_in_the_port(tmp_path):
    ref.seed(0)
    rnet = ref.vision.models.resnet18(num_classes=10)
    rnet.eval()
    path = str(tmp_path / 'resnet18')
    ref.jit.save(rnet, path)
    pred = inference.create_predictor(inference.Config(path + '.pdmodel'))
    pred.attach_layer(port.vision.models.resnet18(num_classes=10))
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype('float32')
    # the reference's forward traced once (eagerly it compiles each op)
    import jax
    from paddle_tpu.nn.layer_base import (buffer_arrays, functional_call,
                                          param_arrays)
    want = np.asarray(jax.jit(lambda p, b, xx: functional_call(
        rnet, p, b, xx)[0])(param_arrays(rnet), buffer_arrays(rnet), x))
    got = pred.run([x])[0]
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the Predictor's attach_layer path
# ---------------------------------------------------------------------------

def _saved_predictor(tmp_path, dynamic, net):
    path = str(tmp_path / 'm')
    jit.save(net, path, input_spec=[InputSpec([-1, 8], 'float32')])
    cfg = inference.Config(path + '.pdmodel')
    if dynamic:
        cfg.switch_batch_dim_dynamic()
    pred = inference.create_predictor(cfg)
    pred.attach_layer(_mlp(port))
    return pred


@pytest.mark.parametrize('dynamic,captures', [(True, 5), (False, 9)])
def test_predictor_buckets_or_captures_per_shape(tmp_path, dynamic,
                                                 captures):
    _, net = _pair()
    pred = _saved_predictor(tmp_path, dynamic, net)
    for n in (1, 2, 3, 5, 7, 8, 9, 13, 16):
        x = _x(n, seed=n)
        out = pred.run([x])[0]
        assert out.shape == (n, 4)
        np.testing.assert_allclose(out, _fwd(port, net, x), atol=TOL)
    assert pred._trace_count == captures


def test_predictor_handles_and_aux_outputs(tmp_path):
    class WithAux(port.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = port.nn.Linear(8, 4)

        def forward(self, x):
            return self.fc(x), port.to_tensor(np.eye(8, dtype='float32'))
    net = WithAux()
    net.eval()
    path = str(tmp_path / 'aux')
    jit.save(net, path, input_spec=[InputSpec([-1, 8], 'float32')])
    cfg = inference.Config(path + '.pdmodel')
    cfg.switch_batch_dim_dynamic()
    pred = inference.create_predictor(cfg)
    pred.attach_layer(net)
    assert pred.get_input_names() == ['x0']
    pred.get_input_handle('x0').copy_from_cpu(_x(3))
    out, aux = pred.run()
    assert out.shape == (3, 4) and aux.shape == (8, 8)
    np.testing.assert_array_equal(aux, np.eye(8, dtype='float32'))
    assert pred.get_output_names() == ['out0', 'out1']
    np.testing.assert_array_equal(
        pred.get_output_handle('out0').copy_to_cpu(), out)


def test_predictor_precision_and_mixed_precision_conversion(tmp_path):
    _, net = _pair()
    path = str(tmp_path / 'm')
    jit.save(net, path, input_spec=[InputSpec([-1, 8], 'float32')])
    dst = inference.convert_to_mixed_precision(
        path + '.pdmodel', save_model_path=str(tmp_path / 'bf16'),
        mixed_precision='bf16')
    meta = _meta(dst)
    assert meta['precision'] == 'bfloat16' and meta['exported'] is False
    pred = inference.create_predictor(inference.Config(dst + '.pdmodel'))
    assert pred._params['0.weight'].dtype == torch.bfloat16
    pred.attach_layer(_mlp(port))
    out = pred.run([_x(3)])[0]
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, _fwd(port, net, _x(3)), atol=5e-2)
    cfg = inference.Config(path + '.pdmodel')
    cfg.set_precision(inference.PrecisionType.Bfloat16)
    layer_free = inference.create_predictor(cfg)
    with pytest.warns(UserWarning, match='precision is ignored'):
        layer_free.run([_x(2)])
    with pytest.raises(ValueError):
        cfg.enable_tpu()
    assert inference.get_num_bytes_of_data_type(
        inference.DataType.INT64) == 8
    assert 'paddle_tpu_torch' in inference.get_version()
    pool = inference.PredictorPool(inference.Config(path + '.pdmodel'), 2)
    assert pool.retrieve(1)._exec is pool.retrive(0)._exec


# ---------------------------------------------------------------------------
# warmup
# ---------------------------------------------------------------------------

def test_manifests_load_across_the_packages(tmp_path):
    sig = (((8,), 'float32'),)
    for W, R in ((warmup, ref.warmup), (ref.warmup, warmup)):
        man = W.Manifest()
        man.add(W.serving_bucket_entry(4, sig, 'float32', max_batch=8))
        man.add(W.predictor_entry((((3, 8), 'float32'),)))
        man.add(W.train_step_entry([((4, 8), 'float32')],
                                   [((4, 1), 'int64')]))
        man.add(W.generation_entry('gen_prefill', slots=2, page_size=16,
                                   num_pages=9, prefill_width=32,
                                   table_width=4))
        man.add(W.serving_bucket_entry(4, sig, 'float32', max_batch=8))
        assert len(man) == 4
        path = str(tmp_path / f'{W.__name__}.json')
        man.save(path)
        back = R.Manifest.load(path)
        assert list(back) == list(man) and back.counts() == man.counts()
    with open(tmp_path / 'bad.json', 'w') as f:
        f.write('[]')
    with pytest.raises(ValueError):
        warmup.Manifest.load(str(tmp_path / 'bad.json'))


def test_capture_is_process_global_and_reentrant():
    assert not warmup.capturing()
    m1 = warmup.capture_start()
    assert warmup.capture_start() is m1 and warmup.capturing()
    warmup.record({'kind': 'eval_step', 'inputs': [], 'labels': []})
    assert warmup.capture_stop() is m1 and len(m1) == 1
    warmup.record({'kind': 'eval_step'})      # inactive: a no-op
    assert len(m1) == 1


def test_engine_capture_then_prebuild_zero_live_captures():
    _, net = _pair()
    x3, x7 = _x(3), _x(7, seed=1)
    with warmup.capture() as man:
        with InferenceEngine(net, max_batch_size=8, max_delay_ms=0.2) as eng:
            want3 = eng.submit(x3).result(timeout=60)
            eng.submit(x7).result(timeout=60)
    assert man.counts() == {'serving_bucket': 2}
    eng2 = InferenceEngine(net, max_batch_size=8, max_delay_ms=0.2,
                           warmup=man)
    assert eng2._cache.prebuilt == 2 and eng2._cache.misses == 0
    traces = eng2._trace_count
    with eng2:
        out3 = eng2.submit(x3).result(timeout=60)
        eng2.submit(x7).result(timeout=60)
    assert eng2._cache.misses == 0 and eng2._trace_count == traces
    np.testing.assert_allclose(out3, want3, rtol=1e-6)


def test_a_reference_manifest_warms_the_port_engine():
    rnet, pnet = _pair()
    with ref.warmup.capture() as man:
        with ref.serving.InferenceEngine(rnet, max_batch_size=8,
                                         max_delay_ms=0.2) as eng:
            eng.submit(_x(3)).result(timeout=60)
    eng2 = InferenceEngine(pnet, max_batch_size=8,
                           warmup=warmup.Manifest(list(man)))
    assert eng2._cache.prebuilt == 1
    with eng2:
        eng2.submit(_x(3)).result(timeout=60)
    assert eng2._cache.misses == 0


@pytest.mark.parametrize('spec', ['pairs', 'hapi'])
def test_engine_warmup_all_buckets(spec):
    _, net = _pair()
    if spec == 'pairs':
        eng = InferenceEngine(net, max_batch_size=8, warmup='all_buckets',
                              input_spec=[((8,), 'float32')])
    else:
        model = port.Model(net, inputs=[InputSpec([None, 8], 'float32')])
        eng = InferenceEngine(model, max_batch_size=8, warmup='all_buckets')
    assert len(eng._cache) == len(bucket_sizes(8)) == eng._cache.prebuilt
    with eng:
        for n in (1, 3, 8):
            eng.submit(_x(n)).result(timeout=60)
    assert eng._cache.misses == 0
    with pytest.raises(ValueError, match='input signature'):
        InferenceEngine(_mlp(port), max_batch_size=4, warmup='all_buckets')


def test_stale_and_oversized_entries_are_skipped():
    man = warmup.Manifest()
    man.add(warmup.serving_bucket_entry(2, (((9,), 'float32'),), 'float32'))
    man.add(warmup.serving_bucket_entry(2, (((8,), 'float32'),), 'float32'))
    man.add(warmup.serving_bucket_entry(64, (((8,), 'float32'),),
                                        'float32'))
    eng = InferenceEngine(_mlp(port), max_batch_size=4, max_delay_ms=0.2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        report = eng.warmup(man)
    assert report['skipped'] == 2 and report['prebuilt'] == 1
    assert any('stale' in str(w.message) for w in caught)
    with pytest.raises(Exception):
        warmup.prebuild(man, engine=InferenceEngine(_mlp(port),
                                                    max_batch_size=4),
                        strict=True)
    again = warmup.prebuild(man, engine=eng)
    assert again['already_cached'] == 1
    eng.shutdown()


def test_prebuild_report_and_hapi_entries_untargeted():
    """The port's hapi steps are eager: a manifest's train/eval entries
    have nothing to build and count as untargeted, through prebuild,
    prepare(warmup=), fit(warmup=) and prebuild_warmup."""
    man = warmup.Manifest()
    man.add(warmup.serving_bucket_entry(2, (((8,), 'float32'),), 'float32'))
    man.add(warmup.train_step_entry([((4, 8), 'float32')],
                                    [((4, 1), 'int64')]))
    man.add(warmup.train_step_entry([((4, 8), 'float32')],
                                    [((4, 1), 'int64')], accumulate=True))
    man.add(warmup.eval_step_entry([((4, 8), 'float32')],
                                   [((4, 1), 'int64')]))
    net = _mlp(port)
    model = port.Model(net)
    opt = port.optimizer.Adam(parameters=net.parameters())
    model.prepare(opt, port.nn.CrossEntropyLoss(), warmup=man)
    report = model.prebuild_warmup(man)
    assert set(report) == {'entries', 'prebuilt', 'already_cached',
                           'skipped', 'untargeted', 'skips', 'total_ms'}
    assert report['entries'] == 4 and report['untargeted'] == 4
    assert report['prebuilt'] == 0
    eng = InferenceEngine(net, max_batch_size=4)
    both = warmup.prebuild(man, engine=eng, model=model)
    assert both['prebuilt'] == 1 and both['untargeted'] == 3
    eng.shutdown()
    x = _x(8)
    y = np.arange(8).reshape(8, 1).astype('int64') % 4
    ds = port.io.TensorDataset([port.to_tensor(x), port.to_tensor(y)])
    model.fit(ds, batch_size=4, epochs=1, verbose=0, warmup=man)


def test_predictor_capture_then_prebuild(tmp_path):
    _, net = _pair()
    path = str(tmp_path / 'm' / 'model')
    jit.save(net, path, input_spec=[InputSpec([None, 8], 'float32')])

    def make_pred():
        pred = inference.create_predictor(inference.Config(path +
                                                           '.pdmodel'))
        pred.attach_layer(_mlp(port))
        return pred
    src = make_pred()
    x = _x(4)
    with warmup.capture() as man:
        want = src.run([x])
    assert man.counts() == {'predictor': 1}
    pred = make_pred()
    assert pred.warmup(man)['prebuilt'] == 1
    traces = pred._trace_count
    np.testing.assert_allclose(pred.run([x])[0], want[0], rtol=1e-6)
    assert pred._trace_count == traces
    assert pred.warmup(man)['already_cached'] == 1
    layer_free = inference.create_predictor(inference.Config(path +
                                                             '.pdmodel'))
    with pytest.raises(RuntimeError, match='attach'):
        layer_free.warmup(man)


def test_generation_engine_records_and_prebuilds_its_functions():
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import GenerationEngine
    cfg = gpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                        num_heads=2, max_seq_len=32, dtype='float32')
    params = gpt.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    with warmup.capture() as man:
        eng = GenerationEngine(params, cfg, device='cpu', num_slots=2,
                               page_size=16)
        eng.submit(np.arange(5), max_new_tokens=2).result(timeout=60)
        eng.shutdown()
    assert man.counts() == {'gen_prefill': 1, 'gen_decode': 1}
    eng2 = GenerationEngine(params, cfg, device='cpu', num_slots=2,
                            page_size=16)
    report = warmup.prebuild(man, generation=eng2)
    assert report['prebuilt'] == 2 and eng2._trace_count == 2
    assert warmup.prebuild(man, generation=eng2)['already_cached'] == 2
    eng3 = GenerationEngine(params, cfg, device='cpu', num_slots=3,
                            page_size=16)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        assert warmup.prebuild(man, generation=eng3)['skipped'] == 2
    for e in (eng2, eng3):
        e.shutdown()


def test_persistent_cache_names_raise_citing_their_step():
    for name in ('enable_persistent_cache', 'disable_persistent_cache',
                 'ensure_persistent_cache', 'persistent_cache_dir',
                 'cache_stats', 'cache_key_component'):
        with pytest.raises(NotImplementedError,
                           match=r'step E \(persistent cache\)'):
            getattr(warmup, name)()
    assert warmup.ENV_CACHE_DIR == ref.warmup.ENV_CACHE_DIR


# ---------------------------------------------------------------------------
# the bucket cache's per-key locking
# ---------------------------------------------------------------------------

def test_bucket_cache_foreign_build_does_not_block_hits():
    release_a, started_a = threading.Event(), threading.Event()

    def builder(bucket, sig, precision):
        if bucket == 1:
            started_a.set()
            assert release_a.wait(timeout=10)
        return lambda *a: bucket
    cache = BucketCompileCache(builder)
    sig = (((8,), 'float32'),)
    cache.get(2, sig, 'float32')
    results = {}
    t_a = threading.Thread(
        target=lambda: results.setdefault('a', cache.get(1, sig, 'float32')))
    t_a.start()
    assert started_a.wait(timeout=10)
    t0 = time.monotonic()
    results['b'] = cache.get(2, sig, 'float32')
    hit = time.monotonic() - t0
    release_a.set()
    t_a.join(timeout=10)
    assert results['b'](None) == 2 and results['a'](None) == 1
    assert hit < 1.0 and cache.misses == 2 and len(cache) == 2


def test_bucket_cache_coalesces_retries_and_seeds():
    builds, gate = [], threading.Event()

    def builder(bucket, sig, precision):
        builds.append(bucket)
        gate.wait(timeout=10)
        return lambda *a: bucket
    cache = BucketCompileCache(builder)
    sig = (((8,), 'float32'),)
    out = []
    threads = [threading.Thread(
        target=lambda: out.append(cache.get(4, sig, 'float32')))
        for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    gate.set()
    for t in threads:
        t.join(timeout=10)
    assert builds == [4] and len(out) == 4 and cache.misses == 1
    calls = []

    def flaky(bucket, sig, precision):
        calls.append(bucket)
        if len(calls) == 1:
            raise RuntimeError('first build dies')
        return lambda *a: 'ok'
    cache = BucketCompileCache(flaky)
    with pytest.raises(RuntimeError):
        cache.get(1, sig, 'float32')
    assert cache.get(1, sig, 'float32')(None) == 'ok' and cache.misses == 1
    cache = BucketCompileCache(lambda *a: (lambda *x: 'built'))
    assert cache.put(2, sig, 'float32', lambda *x: 'seeded') is True
    assert cache.put(2, sig, 'float32', lambda *x: 'loser') is False
    assert cache.get(2, sig, 'float32')(None) == 'seeded'
    assert cache.misses == 0 and cache.prebuilt == 1


# ---------------------------------------------------------------------------
# static and jit's deferred names
# ---------------------------------------------------------------------------

def test_input_spec_as_the_reference():
    for P in (ref, port):
        s = P.static.InputSpec([None, 8], 'int64', name='ids')
        assert s.shape == (None, 8) and s.name == 'ids'
        assert s.batch(4).shape == (4, None, 8)
        assert s.unbatch().shape == (8,)
        assert P.static.InputSpec.from_numpy(np.zeros((2, 3), 'float32')) \
            .shape == (2, 3)
    assert static.InputSpec([1], 'int64').dtype == torch.int32
    assert static.InputSpec([1]).dtype == torch.float32


@pytest.mark.parametrize('name', ['Executor', 'Program', 'data',
                                  'default_main_program', 'save_inference_model',
                                  'nn.fc', 'nn.cond'])
def test_static_graph_names_raise_citing_step_l(name):
    obj = static
    for part in name.split('.'):
        obj = getattr(obj, part)
    with pytest.raises(NotImplementedError, match='step L'):
        obj()


@pytest.mark.parametrize('name', ['to_static', 'not_to_static',
                                  'ProgramTranslator', 'TracedLayer'])
def test_jit_dy2static_names_raise_citing_step_l(name):
    with pytest.raises(NotImplementedError, match='step L'):
        getattr(jit, name)(lambda x: x)
