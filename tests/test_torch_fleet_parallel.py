"""fleet's data- and tensor-parallel Layer path on the port against the
reference: DataParallel, distributed_model / distributed_optimizer (ZeRO
1-3, lars), meta_parallel's layers, make_sharded_train_step, LocalSGD,
SyncBatchNorm across ranks, hapi ``prepare(strategy=)``, fleet.metrics,
state dicts across layouts, the mp=2 InferenceEngine over a meta_parallel
Layer, and DistributedBatchSampler's data axes.

One spawn of 2 gloo ranks (tests/torch_parallel_cases.py ``fleet_cases``)
runs every multi-rank case; the parent runs the reference on the global
batch in its own process (the reference's one controller computes the
global function) and holds each rank to it: losses and parameters after 2
steps to 1e-5 (f32), logits greedy-equal. The program is
tests/torch_nn_cases.py's ERNIE-width MLM cut to 2 layers, hidden 64, 4
heads, vocabulary 128, [4, 32]; its mp form ``ernie_mlm_mp``. The batch
masks the same number of positions in every row: each rank averages its
own block's loss, as Paddle's DataParallel does, and the mean of equal
blocks' means is the batch's (with unequal counts the two differ, ROADMAP
Known differences)."""
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu.parallel import localsgd as rlsgd

import paddle_tpu_torch as port
import paddle_tpu_torch.distributed as tdist

sys.path.insert(0, os.path.dirname(__file__))
import torch_nn_cases as N  # noqa: E402
import torch_parallel_cases as C  # noqa: E402

TOL = 1e-5
VOCAB = C.FLEET['vocab']
HEADS = C.FLEET['heads']
L = C.FLEET['layers']


@pytest.fixture(autouse=True)
def _cpu():
    prev = port.device._current
    port.set_device('cpu')
    yield
    port.device._current = prev


def _ref_state():
    ref.seed(0)
    net = N.ernie_mlm(ref, **C.FLEET)
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def _inputs():
    rs = np.random.RandomState(22)
    toks, types, mask, labels, _ = N.mlm_batch(
        VOCAB, *C.FLEET_BATCH, 16, 32, seed=22, per_row=3)
    layers = {
        'x16': rs.randn(2, 3, 16).astype('float32'),
        'x8': rs.randn(2, 3, 8).astype('float32'),
        'cot8': rs.randn(2, 3, 8).astype('float32'),
        'cot16': rs.randn(2, 3, 16).astype('float32'),
        'ids': np.array([[0, 5, 15, 16], [31, 20, 3, 17]], 'int32'),
        'cot_emb': rs.randn(2, 4, 8).astype('float32'),
        'col': {'weight': rs.randn(16, 8).astype('float32'),
                'bias': rs.randn(8).astype('float32')},
        'row': {'weight': rs.randn(8, 16).astype('float32'),
                'bias': rs.randn(16).astype('float32')},
        'vocab': {'weight': rs.randn(32, 8).astype('float32')}}
    bn_x = rs.randn(8, 6, 4, 4).astype('float32') * 2 + 1
    # a near-constant channel of large mean: E[x^2] - mean^2 cancels
    bn_x[:, 0] = 3.0 + 1e-3 * rs.randn(8, 4, 4).astype('float32')
    return {
        'mlm_state': _ref_state(),
        'batch': (toks, types, mask, labels),
        'mlp': {'w1': rs.randn(16, 32).astype('float32') * 0.3,
                'b1': rs.randn(32).astype('float32') * 0.1,
                'w2': rs.randn(32, 4).astype('float32') * 0.3},
        'mlp_xy': (rs.randn(8, 16).astype('float32'),
                   rs.randn(8, 4).astype('float32')),
        'lsgd_w': rs.rand(4).astype('float32'),
        'lsgd_x': np.concatenate([rs.rand(4, 4) * (i + 1) for i in range(2)]
                                 ).astype('float32'),
        'bn_x': bn_x, 'bn_cot': rs.randn(8, 6, 4, 4).astype('float32'),
        'bn_w': rs.rand(6).astype('float32') + 0.5,
        'bn_b': rs.randn(6).astype('float32'),
        'layers': layers}


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """-> (inputs, [rank 0's results, rank 1's], the output directory)."""
    out = str(tmp_path_factory.mktemp('fleet_parallel'))
    inp = _inputs()
    with open(os.path.join(out, 'inputs.pkl'), 'wb') as f:
        pickle.dump(inp, f)
    tdist.spawn(C.fleet_cases, (out,), nprocs=2, backend='gloo')
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f'fleet.rank{r}.pkl'), 'rb') as f:
            ranks.append(pickle.load(f))
    return inp, ranks, out


_REF = {}


def _ref_mlm(inp):
    """The reference program's 2 AdamW steps on the global batch -> (losses,
    the state after): its ``make_sharded_train_step``'s step body (a
    ``functional_call`` forward, ``jax.value_and_grad``, the optimizer's
    ``functional_apply``) jitted on one device, the global function. (The
    reference's ``make_sharded_train_step`` itself raises NameError as it
    makes its step object: its class body reads ``place_batch`` from the
    function's scope.)"""
    if 'mlm' in _REF:
        return _REF['mlm']
    from paddle_tpu.core.tensor import Tensor as RT, no_grad_ctx
    from paddle_tpu.nn.layer_base import functional_call as rcall
    ref.seed(0)
    net = N.ernie_mlm(ref, **C.FLEET)
    net.set_state_dict(inp['mlm_state'])
    net.train()
    opt = ref.optimizer.AdamW(
        parameters=net.parameters(),
        grad_clip=ref.nn.ClipGradByGlobalNorm(C.FLEET_CLIP), **C.FLEET_OPT)
    loss_fn = N.mlm_loss(ref, VOCAB)
    params = {n: p._value for n, p in net.named_parameters()}
    bufs = {n: b._value for n, b in net.named_buffers()}
    state = opt.functional_init(params)
    toks, types, mask, labels = (jnp.asarray(a) for a in inp['batch'])

    @jax.jit
    def step(params, state):
        def compute(p):
            out, _ = rcall(net, p, bufs, toks, types, mask)
            with no_grad_ctx():
                loss = loss_fn(RT(out), RT(labels))
            return loss._value
        loss, grads = jax.value_and_grad(compute)(params)
        params, state = opt.functional_apply(
            params, grads, state, C.FLEET_OPT['learning_rate'])
        return loss, params, state
    losses = []
    for _ in range(C.FLEET_STEPS):
        loss, params, state = step(params, state)
        losses.append(float(loss))
    _REF['mlm'] = (losses, {k: np.asarray(v) for k, v in params.items()})
    return _REF['mlm']


def _gap(got, want):
    """The largest gap over the largest value (at least 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(
        1.0, float(np.abs(want).max()))


def _hold_state(got, want):
    assert sorted(got) == sorted(want)
    worst = max(_gap(got[k], want[k]) for k in want)
    assert worst <= TOL, worst


def _hold_losses(got, want):
    for a, b in zip(got, want):
        assert abs(a - b) <= TOL * abs(b), (got, want)


def _expected_dp_calls(form, rank_res):
    """Collectives a step of each form: one all-reduce a gradient bucket
    (``DataParallel``'s 25 MB default holds the whole program); ZeRO-2
    adds the clip's sum of the blocks' squares and one all-gather of the
    blocks."""
    from paddle_tpu_torch.distributed.parallel import buckets
    sizes = rank_res['n_param_bytes']
    fake = [torch.empty(n // 4) for n in sizes]
    n = len(buckets(fake, C.BUCKET_MB if form == 'buckets' else 25))
    return n + 2 if form == 'zero2' else n


@pytest.mark.parametrize('form', C.DP_FORMS)
def test_dp_forms_average_once(run, form):
    """DataParallel, distributed_model alone, distributed_optimizer alone,
    both, a bucketed DataParallel and ZeRO-2: each rank's parameters after
    2 steps are the reference's global-batch run's, the mean of the
    ranks' losses its loss, and each step ran the expected collectives
    (the gradients averaged exactly once)."""
    inp, ranks, _ = run
    want_losses, want_state = _ref_mlm(inp)
    res = [r['dp'][form] for r in ranks]
    _hold_losses([(a + b) / 2 for a, b in zip(res[0]['losses'],
                                               res[1]['losses'])],
                 want_losses)
    for r in res:
        _hold_state(r['state'], want_state)
        assert r['calls'] == [_expected_dp_calls(form, r)] * C.FLEET_STEPS
    if form == 'buckets':
        assert res[0]['calls'][0] > 1


def test_mp2_eager_loop(run):
    """ernie_mlm_mp at mp2 from the full state, distributed_model +
    distributed_optimizer: the reference's losses and (gathered, mapped
    back) parameters; each rank holds half of every split weight; the
    collectives a step: g of each Row (2 a layer), the embedding's g, the
    head's gather, f's backward of each Column (2 a layer and the head's)
    and the clip's sum of the blocks' squares."""
    inp, ranks, _ = run
    want_losses, want_state = _ref_mlm(inp)
    for r in ranks:
        res = r['mp_eager']
        _hold_losses(res['losses'], want_losses)
        _hold_state(N.mlm_state_from_mp(res['state'], HEADS), want_state)
        assert res['calls'] == [4 * L + 4] * C.FLEET_STEPS
        h = C.FLEET['hidden']
        assert res['local_shapes']['layers.0.qkv.weight'] == (h, 3 * h // 2)
        assert res['local_shapes']['layers.0.fc2.weight'] == (
            C.FLEET['ffn'] // 2, h)
        assert res['local_shapes']['word.weight'] == (VOCAB // 2, h)


def test_mp2_state_round_trip_through_reference(run):
    """The port's mp2 state, saved whole with paddle.save after training,
    loads into the reference's ernie_mlm_mp and gives the reference's
    logits of its own trained parameters."""
    inp, _, out = run
    _, want_state = _ref_mlm(inp)
    saved = ref.load(os.path.join(out, 'mp2.pdparams'))
    ref.seed(0)
    got_net = N.ernie_mlm_mp(ref, **C.FLEET)
    got_net.set_state_dict({k: np.asarray(v) for k, v in saved.items()})
    want_net = N.ernie_mlm(ref, **C.FLEET)
    want_net.set_state_dict(want_state)
    x = [ref.to_tensor(a) for a in inp['batch'][:3]]
    got, want = got_net(*x).numpy(), want_net(*x).numpy()
    assert _gap(got, want) <= TOL
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize('layout', ['dp2', 'mp2'])
def test_sharded_train_step(run, layout):
    inp, ranks, _ = run
    want_losses, want_state = _ref_mlm(inp)
    for r in ranks:
        res = r['sharded'][layout]
        _hold_losses(res['losses'], want_losses)
        state = (N.mlm_state_from_mp(res['state'], HEADS)
                 if layout == 'mp2' else res['state'])
        _hold_state(state, want_state)


@pytest.mark.parametrize('layout', C.HAPI_LAYOUTS)
def test_hapi_fit_with_strategy(run, layout):
    """Model.prepare(strategy=) then fit over the global batch twice: each
    step's logged loss and the parameters after are the reference's;
    evaluate's loss is the global batch's. Over a DistributedBatchSampler
    the loader's batches are the ranks' blocks already and are not split
    again: the same losses, parameters and evaluate loss."""
    inp, ranks, _ = run
    want_losses, want_state = _ref_mlm(inp)
    for r in ranks:
        res = r['hapi'][layout]
        _hold_losses(res['losses'], want_losses)
        state = (N.mlm_state_from_mp(res['state'], HEADS)
                 if layout == 'mp2' else res['state'])
        _hold_state(state, want_state)
    assert ranks[0]['hapi'][layout]['eval'] == ranks[1]['hapi'][layout][
        'eval']
    if layout == 'dp2_sampler':
        got = ranks[0]['hapi'][layout]['eval']['loss']
        want = ranks[0]['hapi']['dp2']['eval']['loss']
        assert abs(got - want) <= TOL * abs(want), (got, want)


def _mlp_loss_jax(params, x, y):
    h = jax.nn.relu(x @ params['w1'] + params['b1'])
    return jnp.mean(jnp.square(h @ params['w2'] - y))


def _ref_functional(opt, inp, lr):
    params = {k: jnp.asarray(v) for k, v in inp['mlp'].items()}
    state = opt.functional_init(params)
    x, y = (jnp.asarray(a) for a in inp['mlp_xy'])
    for _ in range(C.FLEET_STEPS):
        g = jax.grad(_mlp_loss_jax)(params, x, y)
        params, state = opt.functional_apply(params, g, state,
                                             jnp.asarray(lr, jnp.float32))
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize('stage', [1, 2, 3])
def test_zero_functional_apply(run, stage):
    """ZeRO 1-3 through distributed_optimizer's functional_apply (each
    rank's block of the batch; stage 3 with the parameters as blocks)
    against the reference's AdamW on the global gradient, with a
    global-norm clip that acts."""
    inp, ranks, _ = run
    want = _ref_functional(ref.optimizer.AdamW(
        learning_rate=C.MLP_LR, weight_decay=0.01, epsilon=1e-6,
        grad_clip=ref.nn.ClipGradByGlobalNorm(C.MLP_CLIP)), inp, C.MLP_LR)
    for r in ranks:
        _hold_state(r['zero'][stage], want)


def test_lars_wrap(run):
    inp, ranks, _ = run
    want = _ref_functional(ref.optimizer.LarsMomentum(
        learning_rate=0.1, momentum=0.9), inp, 0.1)
    for r in ranks:
        assert r['lars']['inner'] == 'LarsMomentum'
        _hold_state(r['lars']['params'], want)


def _quad_jax(params, x):
    return jnp.mean(jnp.square(x @ params['w'] - 1.0))


def _ref_localsgd(inp, k, steps):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ('dp',))
    opt = ref.optimizer.SGD(learning_rate=C.LSGD_LR)
    params = {'w': jnp.asarray(inp['lsgd_w'])}
    step = rlsgd.make_localsgd_train_step(_quad_jax, opt, mesh, k_steps=k)
    p = rlsgd.replicate_for_localsgd(params, mesh)
    s = rlsgd.replicate_for_localsgd(opt.functional_init(params), mesh)
    ws = []
    for i in range(steps):
        _, p, s = step(p, s, jnp.asarray(inp['lsgd_x']), i, C.LSGD_LR)
        ws.append(np.asarray(jax.device_get(p['w'])))
    return ws


def test_localsgd_k1_matches_sync_dp(run):
    """k = 1 with SGD: averaging the parameters after each local step is
    stepping with the averaged gradient (synchronous dp)."""
    inp, ranks, _ = run
    x, w = inp['lsgd_x'].astype(np.float64), inp['lsgd_w'].astype(
        np.float64)
    grads = [2 * x[i * 4:(i + 1) * 4].T @ (x[i * 4:(i + 1) * 4] @ w - 1) / 4
             for i in range(2)]
    sync = w - C.LSGD_LR * np.mean(grads, axis=0)
    ref_w = _ref_localsgd(inp, 1, 1)[-1]
    for r in ranks:
        got = r['localsgd'][1]
        assert _gap(got['w'][-1], sync) <= TOL
        assert _gap(got['collapsed'], ref_w.mean(0)) <= TOL


def test_localsgd_k4_rank_is_reference_replica(run):
    """k = 4: rank r's parameters after each step are the reference's
    replica r (apart for 3 steps, averaged at the 4th)."""
    inp, ranks, _ = run
    ref_ws = _ref_localsgd(inp, 4, 4)
    for r, res in enumerate(ranks):
        for got, want in zip(res['localsgd'][4]['w'], ref_ws):
            assert _gap(got, want[r]) <= TOL
    assert not np.allclose(ranks[0]['localsgd'][4]['w'][0],
                           ranks[1]['localsgd'][4]['w'][0])
    np.testing.assert_array_equal(ranks[0]['localsgd'][4]['w'][3],
                                  ranks[1]['localsgd'][4]['w'][3])


def test_syncbatchnorm_across_ranks(run):
    """SyncBatchNorm over dp2: each rank's output and input gradient are
    the reference's merge over the whole batch (its BatchNorm on all 8
    rows, where the merged moments are the batch's), the weight and bias
    gradients summed over the ranks its, and the running statistics its.
    Channel 0 is near-constant at mean 3: the merge's E[x^2] - mean^2
    cancels to one f32 rounding of E[x^2] (~9.5e-7), which both sides
    clamp at 0; its running variance is held to 4 such roundings and its
    output to be finite, the other channels to 1e-5."""
    inp, ranks, _ = run
    bn = ref.nn.BatchNorm2D(6)
    bn.set_state_dict({'weight': inp['bn_w'], 'bias': inp['bn_b']})
    x = ref.to_tensor(inp['bn_x'], stop_gradient=False)
    out = bn(x)
    (out * ref.to_tensor(inp['bn_cot'])).sum().backward()
    want_out = out.numpy()
    want_xg = x.grad.numpy()
    for r, rk in enumerate(ranks):
        res = rk['syncbn']
        rows = slice(4 * r, 4 * r + 4)
        assert np.isfinite(res['out']).all()
        assert _gap(res['out'][:, 1:], want_out[rows, 1:]) <= TOL
        assert _gap(res['x_grad'][:, 1:], want_xg[rows, 1:]) <= TOL
        assert _gap(res['mean'], bn._mean.numpy()) <= TOL
        assert _gap(res['var'][1:], bn._variance.numpy()[1:]) <= TOL
        ulp = np.spacing(np.float32(9.0))
        assert abs(res['var'][0] - bn._variance.numpy()[0]) <= 4 * ulp
    for key, p in (('w_grad', bn.weight), ('b_grad', bn.bias)):
        got = ranks[0]['syncbn'][key] + ranks[1]['syncbn'][key]
        assert _gap(got[1:], p.grad.numpy()[1:]) <= TOL


def _ref_layer(name, L):
    kind = name.split('_')[0]
    fl = ref.distributed.fleet
    ref.seed(0)
    layer = {'col': lambda: fl.ColumnParallelLinear(16, 8),
             'row': lambda: fl.RowParallelLinear(8, 16),
             'vocab': lambda: fl.VocabParallelEmbedding(32, 8)}[kind]()
    layer.set_state_dict(L[kind])
    x = {'col': L['x16'], 'row': L['x8'], 'vocab': L['ids']}[kind]
    cot = {'col': L['cot8'], 'row': L['cot16'], 'vocab': L['cot_emb']}[kind]
    xt = ref.to_tensor(x, stop_gradient=(kind == 'vocab'))
    y = layer(xt)
    (y * ref.to_tensor(cot)).sum().backward()
    return (y.numpy(), None if kind == 'vocab' else xt.grad.numpy(),
            {n: p.grad.numpy() for n, p in layer.named_parameters()})


@pytest.mark.parametrize('name', ['col_gather', 'col_split', 'row_full',
                                  'row_parallel', 'vocab'])
def test_meta_parallel_layers_mp2(run, name):
    """Each layer at mp2 from the reference layer's full weights: the
    output (a Column without ``gather_output``: the rank's columns; a Row
    with ``input_is_parallel``: fed the rank's columns), the input's
    gradient (its block for a parallel input) and the gathered parameter
    gradients are the reference's; the embedding's ids fall on both sides
    of the split; each rank holds half of the split weight and
    ``state_dict`` gives it whole."""
    inp, ranks, _ = run
    want_y, want_xg, want_g = _ref_layer(name, inp['layers'])
    for r, rk in enumerate(ranks):
        res = rk['layers'][name]
        y = want_y
        if name == 'col_split':
            y = want_y[..., 4 * r:4 * r + 4]
        assert _gap(res['out'], y) <= TOL
        if want_xg is not None:
            xg = (want_xg[..., 4 * r:4 * r + 4] if name == 'row_parallel'
                  else want_xg)
            assert _gap(res['x_grad'], xg) <= TOL
        for n, g in want_g.items():
            assert _gap(res['grads'][n], g) <= TOL, n
        w_full = inp['layers'][name.split('_')[0]]['weight'].shape
        assert np.prod(res['shapes']['weight']) * 2 == np.prod(w_full)
        assert res['state']['weight'].shape == w_full


def test_fleet_metrics(run):
    """Each statistic reduced over both ranks in float64 (a count past
    2^24 stays exact); auc over the summed histograms is the reference's
    auc of them."""
    _, ranks, _ = run
    for rk in ranks:
        m = rk['metrics']
        np.testing.assert_array_equal(m['sum'], [3.0, 2.0 ** 31 + 1])
        np.testing.assert_array_equal(m['max'], [1, 0])
        np.testing.assert_array_equal(m['min'], [0, -1])
        pos = np.array([1, 2, 3, 4], 'float64') * 3
        neg = np.array([4, 3, 2, 1], 'float64') * 2 + 1
        assert m['auc'] == pytest.approx(
            ref.distributed.fleet.metrics.auc(pos, neg), rel=1e-12)
        assert m['mae'] == pytest.approx(4.0 / 7.0)
        assert m['mse'] == pytest.approx(6.0 / 8.0)
        assert m['rmse'] == pytest.approx(np.sqrt(4.0 / 8.0))
        assert m['acc'] == pytest.approx(7.0 / 20.0)


def test_distributed_batch_sampler_reads_by_data_axes(run):
    """Under mp2 the two ranks are one data rank and list the same
    indices (the reference's one process a host); under dp2 they split
    the dataset."""
    _, ranks, _ = run
    a, b = (rk['sampler'] for rk in ranks)
    assert a['mp2'] == b['mp2'] == [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]]
    assert a['dp2'] == [[0, 2], [4, 6], [8]]
    assert b['dp2'] == [[1, 3], [5, 7], [9]]


def test_recompute_replays_dropout():
    """fleet.utils.recompute of a Layer with dropout (and of a callable)
    gives the gradients of the plain run: the backward's second forward
    draws the first's masks."""
    from paddle_tpu_torch.distributed.fleet.utils import recompute
    nn = port.nn
    port.seed(3)
    net = nn.Sequential(nn.Linear(8, 16), nn.Dropout(0.5), nn.GELU(),
                        nn.Linear(16, 8))
    x = port.to_tensor(np.random.RandomState(1).randn(4, 8)
                       .astype('float32'), stop_gradient=False)
    grads = []
    for use in (False, True):
        port.seed(7)
        net.clear_gradients() if hasattr(net, 'clear_gradients') else None
        for p in net.parameters():
            p.clear_grad()
        x.clear_grad()
        y = recompute(net, x) if use else net(x)
        # a draw between the forward and the backward must not leak in
        port.nn.functional.dropout(port.to_tensor(np.ones(8, 'float32')),
                                   0.5)
        (y * y).sum().backward()
        grads.append([x.grad.numpy()] + [p.grad.numpy()
                                         for p in net.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)

    def fn(t):
        return port.nn.functional.dropout(t * 2.0, 0.5)
    outs = []
    for use in (False, True):
        port.seed(9)
        x.clear_grad()
        y = recompute(fn, x) if use else fn(x)
        y.sum().backward()
        outs.append((y.numpy(), x.grad.numpy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_ernie_mlm_mp_is_ernie_mlm_at_mp1():
    """ernie_mlm_mp at mp = 1 is ernie_mlm's function weight for weight,
    on both packages (the reference's meta_parallel layers keep the full
    logical weight)."""
    state = _ref_state()
    batch = N.mlm_batch(VOCAB, *C.FLEET_BATCH, 16, 32, seed=3)[:3]
    for P in (ref, port):
        P.seed(0)
        a = N.ernie_mlm(P, **C.FLEET)
        a.set_state_dict(state)
        b = N.ernie_mlm_mp(P, **C.FLEET)
        b.set_state_dict(N.mlm_mp_state(state, HEADS))
        x = [P.to_tensor(v) for v in batch]
        assert _gap(b(*x).numpy(), a(*x).numpy()) <= TOL


def test_inference_engine_mp2_over_meta_parallel_layer():
    """InferenceEngine(mesh=) of 2 shards over ernie_mlm_mp: each shard
    runs its Column / Row / Vocab blocks, the partials summed by
    MeshContext.psum; its logits are the reference's
    ``sharded_inference_engine`` at mp = 2 on the same weights and
    inputs, greedy-equal, and the port's mp = 1 engine's."""
    from paddle_tpu.serving import sharded_inference_engine as ref_inf
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.parallel import mesh_engine
    state = N.mlm_mp_state(_ref_state(), HEADS)
    toks, types, mask, _, _ = N.mlm_batch(VOCAB, *C.FLEET_BATCH, 16, 32,
                                          seed=5)
    ref.seed(0)
    rnet = N.ernie_mlm_mp(ref, **C.FLEET)
    rnet.set_state_dict(state)
    rnet.eval()
    eng = ref_inf(rnet, mp=2, devices=jax.devices()[:2], max_batch_size=4)
    try:
        want = np.asarray(eng.submit(toks, types, mask).result(timeout=120))
    finally:
        eng.shutdown()
    port.seed(0)
    net = N.ernie_mlm_mp(port, **C.FLEET)
    net.set_state_dict(state)
    net.eval()
    outs = []
    for mesh in (mesh_engine.MeshContext.build(2, devices=['cpu'] * 2), None):
        eng = serving.InferenceEngine(net, max_batch_size=4, mesh=mesh)
        try:
            outs.append(np.asarray(eng.submit(toks, types, mask).result(
                timeout=120)))
            if mesh is not None:
                assert eng.stats()['mesh']['fallbacks'] == []
        finally:
            eng.shutdown()
    got, mp1 = outs
    assert _gap(got, want) <= TOL
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert _gap(got, mp1) <= TOL


K4B = {
    'paddle_tpu_torch.distributed': (
        'launch', 'gloo_init_parallel_env', 'gloo_barrier', 'gloo_release',
        'shard_tensor', 'shard_op', 'set_shard_mask', 'set_offload_device',
        'set_pipeline_stage', 'split', 'ProcessMesh', 'CountFilterEntry',
        'ProbabilityEntry', 'BoxPSDataset', 'InMemoryDataset',
        'QueueDataset'),
    'paddle_tpu_torch.distributed.fleet': (
        'DatasetBase', 'BoxPSDataset', 'InMemoryDataset', 'QueueDataset',
        'FileInstantDataset', 'MultiSlotDataGenerator',
        'MultiSlotStringDataGenerator')}


@pytest.mark.parametrize('module', sorted(K4B))
def test_k4b_names_raise(module):
    """Every name left for step K4b raises citing it."""
    import importlib
    mod = importlib.import_module(module)
    for name in K4B[module]:
        with pytest.raises(NotImplementedError,
                           match='ROADMAP Queue 1 step K4b'):
            getattr(mod, name)()
