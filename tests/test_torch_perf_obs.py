"""perf (counted FLOPs and bytes, MFU, memory sweeps), slo and the
profiler's StepTimer in paddle_tpu_torch against the JAX package's, on the
CPU.

The behaviour ``tests/test_perf_obs.py`` asserts of the reference, held
here of both packages where both can run the same thing: the peaks table
and its environment overrides (the card's rows, no TPU row), a small
GPT's train step counted within 20% of 6·N·tokens and of the reference's
cost analysis, the ``note_step`` MFU join, the ``hbm_bytes`` kinds as the
port measures them, ``sweep_hbm``'s leak streak, the SLO rules' transitions
and callbacks on the same observations, the serving buckets' and the
Predictor's counts, hapi's perf series (and a fit with telemetry leaving
the same parameters as one without), and StepTimer on a raising step.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as ref
import paddle_tpu.observability as robs
import paddle_tpu_torch as port
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import perf, slo
from paddle_tpu_torch.profiler import StepTimer

BOTH = (robs, obs)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    prev = port_device._current
    port.set_device('cpu')
    for o in BOTH:
        o.set_enabled(True)
        o.reset()
    monkeypatch.delenv(perf.ENV_PEAK_FLOPS, raising=False)
    monkeypatch.delenv(perf.ENV_PEAK_BW, raising=False)
    yield
    for o in BOTH:
        o.shutdown_telemetry()
        o.set_enabled(True)
        o.reset()
    port_device._current = prev


def _gauges():
    return obs.snapshot()['gauges']


# ---------------------------------------------------------------------------
# peaks
# ---------------------------------------------------------------------------

def test_peaks_table_has_the_cards_rows_and_the_env_overrides(monkeypatch):
    kind = 'nvidia h100 80gb hbm3'
    assert perf.peaks(kind) == (989e12, 3.35e12, 'table')
    assert perf.peaks(kind, precision='fp8')[0] == 1979e12
    assert perf.peaks(kind, precision='int8_wo')[0] == 1979e12
    assert perf.peaks(kind, precision='bfloat16')[0] == 989e12
    assert perf.peaks('cpu') == robs.perf.peaks('cpu') == \
        (1e12, 100e9, 'table')
    assert perf.peaks('some other card')[2] == 'default'
    assert not any(k.startswith('v') for k, _ in perf.PEAKS)  # no TPU row
    assert perf._device_kind() == 'cpu'
    monkeypatch.setenv(perf.ENV_PEAK_FLOPS, '2e12')
    monkeypatch.setenv(perf.ENV_PEAK_BW, '5e11')
    assert perf.peaks(kind) == (2e12, 5e11, 'env')
    monkeypatch.setenv(perf.ENV_PEAK_FLOPS_FP8, '7e12')
    assert perf.peaks(kind, precision='float8')[0] == 7e12


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def test_hbm_kinds_and_bytes_as_the_port_measures_them():
    x, w = torch.ones(8, 16), torch.ones(16, 4)
    rec = perf.analyze('mm', lambda a, b: torch.relu(a @ b), (x, w))
    # argument: what existed before the run; output: what it returned;
    # temp: what its ops wrote besides (the product before relu)
    assert rec['hbm'] == {'argument': (128 + 64) * 4, 'output': 32 * 4,
                          'temp': 32 * 4, 'code': 0}
    assert rec['flops'] == 2 * 8 * 16 * 4
    assert rec['bytes_accessed'] == (128 + 64 + 32) * 4 + 2 * 32 * 4
    g = _gauges()
    assert g['perf.flops{fn=mm}'] == 1024
    assert g['perf.hbm_bytes{fn=mm,kind=argument}'] == 768
    assert g['perf.compute_bound{fn=mm}'] == 0.0          # memory-bound
    assert perf.analyzed('mm')['module'] == 'mm'
    # an error of the function propagates; counting never raises
    with pytest.raises(ZeroDivisionError):
        perf.analyze('bad', lambda: 1 / 0)
    assert perf.analyzed('bad') is None


def test_gpt_train_step_counted_within_20pct_of_analytic_and_reference(
        monkeypatch):
    cfg = jgpt.GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                         num_heads=4, max_seq_len=64, remat=False,
                         use_flash=False, scan_unroll=2, dtype='float32')
    jp = jgpt.init_params(cfg, jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, jp)  # the step donates jp
    n_params = sum(int(x.size) for x in jax.tree_util.tree_leaves(jp))
    B, S = 2, cfg.max_seq_len
    toks = np.random.RandomState(1).randint(0, 256, (B, S)).astype(np.int32)
    jopt = ref.optimizer.AdamW(learning_rate=2e-4, weight_decay=0.01)
    jstep = jgpt.make_train_step(cfg, jopt)
    jargs = (jp, jopt.functional_init(jp), jax.random.PRNGKey(2),
             jnp.asarray(2e-4), jnp.asarray(toks), jnp.asarray(toks))
    jstep(*jargs)[0].block_until_ready()
    want = robs.perf.analyze('gpt.train_step', jstep, jargs)['flops']
    tcfg = tgpt.GPTConfig(**dataclasses.asdict(cfg))
    tp = tgpt.params_from_numpy(host, tcfg, 'cpu')
    opt = topt.AdamW(learning_rate=2e-4, weight_decay=0.01)
    tstep = tgpt.make_train_step(tcfg, opt)
    state = opt.functional_init(tp)
    tt = torch.from_numpy(toks)
    with perf.measure('gpt.train_step') as m:
        m.set_outputs(tstep(tp, state, 7, 2e-4, tt, tt))
    got = m.record['flops']
    analytic = 6.0 * n_params * B * S
    assert 0.8 <= got / analytic <= 1.25, (got, analytic)
    assert 0.8 <= got / want <= 1.25, (got, want)
    # the MFU join against the same peak
    monkeypatch.setenv(perf.ENV_PEAK_FLOPS, '1e12')
    perf.note_step('gpt.train_step', 0.05)
    mfu = _gauges()['perf.mfu{fn=gpt.train_step}']
    assert mfu == pytest.approx(got / 0.05 / 1e12, abs=1e-6)  # rounded
    assert 0.8 <= mfu / (analytic / 0.05 / 1e12) <= 1.25


def test_flash_attention_counted_by_its_registered_formulas():
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v = (torch.randn(2, 32, 4, 16, requires_grad=True)
               for _ in range(3))
    with perf.measure('attn') as m:
        out = fa.flash_attention(q, k, v, causal=True)
        out.sum().backward()
        m.set_outputs(out)
    # the dense counts, halved when causal: forward 2 products, backward 5
    assert m.record['flops'] == 7 * 2 * 2 * 4 * 32 * 32 * 16 // 2
    assert fa.attention_flops((2, 32, 4, 16), (2, 32), False) == \
        4 * 2 * 4 * 32 * 32 * 16


def test_note_step_join_equals_the_reference(monkeypatch):
    for o in BOTH:
        monkeypatch.setenv(o.perf.ENV_PEAK_FLOPS, '1e9')
    perf._publish('f', 4e6, 1e6, {}, None, None)
    robs.perf._records['f'] = dict(perf.analyzed('f'))
    got = [o.perf.note_step('f', 0.002) for o in BOTH]
    assert got[0] == got[1] == pytest.approx(2.0)
    assert perf.note_step('unknown', 1.0) is None
    assert perf.report()['executables'][0]['step_ms_p50'] == 2.0


# ---------------------------------------------------------------------------
# device memory
# ---------------------------------------------------------------------------

class _FakeJaxDevice:
    platform, id = 'fake', 0

    def __init__(self, seq):
        self._seq = iter(seq)

    def memory_stats(self):
        return {'bytes_in_use': next(self._seq)}


@pytest.mark.parametrize('seq', [[1, 2, 3, 4, 5, 6, 7, 8, 9],
                                 [5, 5, 5, 5, 5, 5],
                                 [1, 2, 3, 2, 3, 4, 5, 9]])
def test_sweep_hbm_leak_streak_as_the_reference(monkeypatch, seq):
    jdev = _FakeJaxDevice(seq)
    vals = iter(seq)
    monkeypatch.setattr(perf, '_used_bytes', lambda d: next(vals))
    for _ in seq:
        robs.perf.sweep_hbm(devices=[jdev], streak=3)
        out = perf.sweep_hbm(devices=['cpu'], streak=3)
    leaks = [getattr(o.find('perf.hbm_leak_suspect', {'device': d}),
                     'value', 0)
             for o, d in ((robs, 'fake:0'), (obs, 'cpu:0'))]
    assert leaks[0] == leaks[1]
    assert out == {'cpu:0': seq[-1]}
    assert _gauges()['perf.hbm_used_bytes{device=cpu:0}'] == seq[-1]


def test_sweep_hbm_reads_the_host_and_the_cards_allocator():
    used = perf.sweep_hbm()
    assert list(used) == ['cpu:0'] and used['cpu:0'] > 0
    assert 'allocated_bytes.all.current' in perf._used_bytes.__code__\
        .co_consts


# ---------------------------------------------------------------------------
# SLO rules
# ---------------------------------------------------------------------------

def _slo_run(o):
    fired, resolved = [], []
    w = o.slo.Watcher(interval=60.0)
    w.rule('depth', 'q.depth', 4, debounce=2,
           on_fire=lambda r, v: fired.append((r.name, v)),
           on_resolve=lambda r, v: resolved.append((r.name, v)))
    w.rule('lat', 'q.lat_ms', 10.0, stat='p99')
    w.rule('rate', 'q.done', 5.0, stat='rate', cmp='<')
    w.rule('boom', 'q.depth', 0, on_fire=lambda r, v: 1 / 0)
    g, h, c = o.gauge('q.depth'), o.histogram('q.lat_ms'), o.counter('q.done')
    out = []
    for t, (depth, lats, done) in enumerate(
            [(1, [1, 2], 10), (5, [20, 30], 20), (6, [25], 21),
             (6, [], 40), (2, [1, 1, 1], 60), (2, [50], 61)]):
        g.set(depth)
        for v in lats:
            h.observe(v)
        c.inc(done - c.value)
        out.append(w.evaluate(now=float(t)))
    errors = o.find('slo.callback_errors', {'rule': 'boom'}).value
    states = sorted((r['rule'], r['state'], r['last_value'])
                    for r in o.slo.rule_states())
    w.stop()
    return out, fired, resolved, errors, states


def test_slo_rules_transition_and_call_back_as_the_reference():
    got, want = _slo_run(obs), _slo_run(robs)
    assert got == want
    transitions = got[0]
    assert ('depth', 'fire', 6.0) in transitions[2]       # debounced
    assert ('lat', 'resolve', 1) in transitions[4]        # delta window
    assert got[1] == [('depth', 6.0)] and got[2] == [('depth', 2.0)]
    assert got[3] == 1


def test_slo_validation_and_missing_series_as_the_reference():
    for o in BOTH:
        w = o.slo.Watcher()
        with pytest.raises(ValueError):
            w.rule('x', 's', 1, stat='p42')
        w.rule('x', 'absent.series', 1)
        with pytest.raises(ValueError, match='duplicate'):
            w.rule('x', 's', 1)
        assert w.evaluate(now=1.0) == []
        assert o.find('absent.series') is None


# ---------------------------------------------------------------------------
# the wiring: serving buckets, the Predictor, hapi
# ---------------------------------------------------------------------------

def _mlp(P, out=4):
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                           P.nn.Linear(16, out))


def test_serving_buckets_counted_at_warmup_and_joined_in_steady_state(
        monkeypatch):
    # the bucket-4 forward is 1,536 FLOPs: at the CPU row's nominal 1e12
    # FLOP/s the gauge (rounded to 6 places) reads 0 for any batch slower
    # than ~3 ms, which a loaded host gives. A nominal peak of 1e9 keeps
    # the join visible up to ~50 minutes a batch.
    monkeypatch.setenv(perf.ENV_PEAK_FLOPS, '1e9')
    ref.seed(0)
    rnet = _mlp(ref)
    net = _mlp(port)
    net.set_state_dict({k: np.asarray(v.numpy())
                        for k, v in rnet.state_dict().items()})
    x = np.ones((4, 8), np.float32)
    for P, n in ((ref, rnet), (port, net)):
        with P.serving.InferenceEngine(n, max_batch_size=4) as eng:
            eng.warmup('all_buckets', input_spec=[((8,), 'float32')])
            for _ in range(3):
                eng.submit(x).result(timeout=60)
    for b in (1, 2, 4):
        got = perf.analyzed(f'serving.bucket{b}')['flops']
        assert got == 2 * b * (8 * 16 + 16 * 4)
        want = robs.perf.analyzed(f'serving.bucket{b}')['flops']
        assert 0.8 <= got / want <= 1.25, (b, got, want)
    g = _gauges()
    assert 0 < g['perf.mfu{fn=serving.bucket4}']
    assert obs.find('perf.step_ms', {'fn': 'serving.bucket4'}).count == 3


def test_predictor_feed_counted_once(tmp_path):
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.static import InputSpec
    net = _mlp(port)
    jit.save(net, str(tmp_path / 'm'),
             input_spec=[InputSpec([-1, 8], 'float32')])
    pred = inference.create_predictor(
        inference.Config(str(tmp_path / 'm.pdmodel')))
    pred.attach_layer(net)
    for _ in range(2):
        pred.run([np.ones((3, 8), np.float32)])
    assert perf.analyzed('predictor.3x8')['flops'] == \
        2 * 3 * (8 * 16 + 16 * 4)


class _Toy(port.io.Dataset):
    def __len__(self):
        return 32

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return (rng.randn(8).astype('float32'),
                np.array([i % 2], dtype='int64'))


def _toy_model(seed=0, loss=None):
    port.seed(seed)
    net = _mlp(port, out=2)
    m = port.Model(net)
    m.prepare(optimizer=port.optimizer.SGD(learning_rate=0.1,
                                           parameters=net.parameters()),
              loss=loss or port.nn.CrossEntropyLoss())
    return m, net


def _params(net):
    return {k: v.numpy().copy() for k, v in net.state_dict().items()}


def test_hapi_publishes_perf_series_and_telemetry_changes_no_parameter(
        monkeypatch):
    # a nominal peak at this toy's scale: perf.mfu is rounded to 1e-6
    monkeypatch.setenv(perf.ENV_PEAK_FLOPS, '1e6')
    obs.set_enabled(False)
    m0, net0 = _toy_model()
    m0.fit(_Toy(), epochs=1, batch_size=8, verbose=0, shuffle=False)
    obs.set_enabled(True)
    m1, net1 = _toy_model()
    m1._step_timer = StepTimer()
    m1.fit(_Toy(), epochs=1, batch_size=8, verbose=0, shuffle=False,
           telemetry_port=0, log_freq=2)
    for k, v in _params(net0).items():
        np.testing.assert_array_equal(_params(net1)[k], v)
    rec = perf.analyzed('hapi.train_step')
    # forward 2·8·(8·16 + 16·2), the backward's weight and input
    # gradients (none for the batch itself)
    assert rec['flops'] == 2560 + 512 + 512 + 2048
    g = _gauges()
    assert g['perf.mfu{fn=hapi.train_step}'] > 0
    assert obs.find('perf.step_ms', {'fn': 'hapi.train_step'}).count == 4
    assert 'perf.hbm_used_bytes{device=cpu:0}' in g
    assert obs.goodput.snapshot()['steps'] == 4
    s = m1._step_timer.summary()
    assert s['steps'] == 4 and s['dispatch_ms_p50'] > 0
    m1.evaluate(_Toy(), batch_size=8, verbose=0)
    assert perf.analyzed('hapi.eval_step')['flops'] == 2560
    m2, _ = _toy_model()
    m2.fit(_Toy(), epochs=1, batch_size=8, verbose=0,
           accumulate_grad_batches=2)
    assert perf.analyzed('hapi.accum_step')['flops'] == 5632
    assert perf.analyzed('hapi.apply_accum') is not None


def test_steptimer_books_nothing_for_a_raising_step():
    t = StepTimer()
    with pytest.raises(RuntimeError):
        with t.span('dispatch'):
            raise RuntimeError('boom')
    t.step_done()
    assert t.summary()['dispatch_ms_mean'] == 0.0
    state = {'n': 0}

    def loss(out, label):
        state['n'] += 1
        if state['n'] == 3:
            raise RuntimeError('step 3 fails')
        return port.nn.functional.cross_entropy(out, label)

    m, _ = _toy_model(loss=loss)
    m._step_timer = StepTimer()
    with pytest.raises(RuntimeError, match='step 3'):
        m.fit(_Toy(), epochs=1, batch_size=8, verbose=0)
    s = m._step_timer.summary()
    assert s['steps'] == 2
    assert obs.find('train.dispatch_ms', m._step_timer.labels).count == 2


def test_disabled_mode_perf_and_slo_are_null():
    obs.set_enabled(False)
    assert perf.analyze('x', lambda: 1) is None
    assert perf.note_step('x', 1.0) is None
    assert perf.sweep_hbm() is None and perf.report() is None
    assert slo.watcher() is slo.NULL_WATCHER
    assert slo.rule_states() == []
    assert obs.snapshot()['gauges'] == {}


def test_profiler_surface_on_torch_profiler(tmp_path):
    from paddle_tpu_torch import profiler
    assert port.profiler is profiler
    p = profiler.Profiler(log_dir=str(tmp_path / 'a'))
    with p:
        for _ in range(3):
            with profiler.RecordEvent('user.region'):
                torch.ones(8).sum()
            p.step()
    names = {e['name'] for e in json.load(open(p.trace_path))['traceEvents']}
    assert 'user.region' in names
    assert p.summary().startswith('steps=3 ')
    profiler.start_profiler()
    path = profiler.stop_profiler(profile_path=str(tmp_path / 'b'))
    assert os.path.isfile(path) and profiler.stop_profiler() is None
    ev = profiler.RecordEvent('x')
    ev.end()                            # end() without begin(): a no-op
    opts = profiler.ProfilerOptions({'profile_path': str(tmp_path)})
    assert opts['batch_range'] == [0, 10]
    assert opts.with_state('CPU')['state'] == 'CPU'
    assert profiler.percentile([3, 1, 2], 50) == \
        robs.percentile([3, 1, 2], 50) == 2
