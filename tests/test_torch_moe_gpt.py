"""The port's MoE GPT (paddle_tpu_torch/parallel/moe.py and models/
moe_gpt.py) against the JAX package's, on the CPU at 2 layers in float32:
the reference's own parameters (converted through numpy by
``gpt.params_from_numpy``), the same numpy-seeded tokens, and for the
flash path the reference's Pallas kernels in interpret mode.

Tolerances: the routing (combine, dispatch, aux) exact up to f32 rounding
of the softmax, 1e-6; the MoE FFN 1e-5 (gather form against the einsum
twin and the reference); the int8 expert banks bit-equal and their
products 1e-5; logits and aux 1e-4; loss and gradients 1e-4 relative
(each gradient's largest error over its largest value), as the GPT train
tests; greedy token streams equal. The int8 KV cache is held to the
reference's own rule (``tests/test_weight_only_int8.py``: at least 70% of
tokens on the float cache's trajectory)."""
import dataclasses
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.models import moe_gpt as jmoe
from paddle_tpu.ops import weight_only as jwo
from paddle_tpu.parallel import moe as jpm
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import decode_cache as tdc
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import moe_gpt as tmoe
from paddle_tpu_torch.ops import weight_only as two
from paddle_tpu_torch.parallel import moe as tpm

fa = importlib.import_module('paddle_tpu.ops.flash_attention')

V = 128
_CFGS = {
    # the plain attention path (use_flash False on both sides)
    'mha': dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4,
                n_experts=4, max_seq_len=48, dtype='float32', remat=False,
                use_flash=False, xent_chunk=0),
    'gqa': dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, n_experts=4, max_seq_len=48,
                dtype='float32', remat=False, use_flash=False, xent_chunk=0),
    # the flash path: head dim 64 and S 128, which the reference's kernels
    # take in interpret mode; xent_chunk 64 divides the vocab (blockwise)
    'flash': dict(vocab_size=V, hidden_size=128, num_layers=2, num_heads=2,
                  n_experts=4, ffn_mult=2, max_seq_len=128, dtype='float32',
                  xent_chunk=64),
}


@pytest.fixture
def interpret():
    fa.set_interpret(True)
    try:
        yield
    finally:
        fa.set_interpret(False)


def _model(name, scale=1.0, **over):
    """(reference config, reference params as numpy, port config, port
    params). ``scale`` multiplies the block matrices: at init stds a
    2-layer model with a tied head mostly repeats its last token, larger
    weights make every stream depend on its context."""
    cfg = jmoe.MoEConfig(**dict(_CFGS[name], **over))
    jp = jax.tree_util.tree_map(
        np.asarray, jmoe.init_params(cfg, jax.random.PRNGKey(0)))
    for k in ('qkv_w', 'proj_w', 'gate_w', 'w_in', 'w_out'):
        jp['blocks'][k] = jp['blocks'][k] * np.float32(scale)
    tcfg = tmoe.MoEConfig(**dataclasses.asdict(cfg))
    return cfg, jp, tcfg, tgpt.params_from_numpy(jp, tcfg, 'cpu')


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tokens(b, s, seed):
    return np.random.RandomState(seed).randint(0, V, (b, s)).astype(np.int32)


def _seed_of(key):
    return int(jax.random.bits(key, (1,), jnp.uint32)[0])


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# parallel/moe.py: routing and the expert FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('t,e,cf', [(96, 4, 1.25), (96, 4, 8.0),
                                    (50, 8, 0.75)])
def test_top2_gating_matches_reference(t, e, cf):
    rng = np.random.RandomState(t + e)
    logits = (2 * rng.randn(t, e)).astype(np.float32)
    # ties: duplicated rows and a row with equal logits (first maximum)
    logits[5] = logits[4]
    logits[7] = 0.5
    cap = tpm.capacity_of(cf, t, e)
    assert cap == int(cf * t / e + 1)
    jc, jd, ja = jpm.top2_gating(jnp.asarray(logits), cap)
    tc, td, ta = tpm.top2_gating(torch.from_numpy(logits), cap)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert abs(ta.item() - float(ja)) <= 1e-6
    dropped = (np.asarray(jd).sum((1, 2)) < 2).sum()
    assert (dropped > 0) == (cf < 2), dropped


@pytest.mark.parametrize('cf', [1.25, 8.0])
def test_moe_ffn_gather_form_matches_einsum_and_reference(cf):
    rng = np.random.RandomState(3)
    b, s, h, f, e = 2, 24, 32, 64, 4
    x = rng.randn(b, s, h).astype(np.float32)
    gw = (0.5 * rng.randn(h, e)).astype(np.float32)
    wi = (0.2 * rng.randn(e, h, f)).astype(np.float32)
    wo = (0.2 * rng.randn(e, f, h)).astype(np.float32)
    w = rng.randn(b, s, h).astype(np.float32)

    def ref(*a):
        y, aux = jpm.moe_ffn(*a, capacity_factor=cf)
        return (y * w).sum() + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1, 2, 3), has_aux=True))(
            *map(jnp.asarray, (x, gw, wi, wo)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, gw, wi, wo)]
    ty, taux = tpm.moe_ffn(*ts, capacity_factor=cf)
    es = [torch.from_numpy(a).requires_grad_() for a in (x, gw, wi, wo)]
    ey, eaux = tpm.moe_ffn_einsum(*es, capacity_factor=cf)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ty.detach().numpy(), ey.detach().numpy(),
                               rtol=0, atol=1e-5)
    assert abs(taux.item() - float(jaux)) <= 1e-6
    # gradients: through the combine weights, the aux loss's density
    # proxy and the gather, as the einsum form's and the reference's
    tw = torch.from_numpy(w)
    tg = torch.autograd.grad((ty * tw).sum() + taux, ts)
    eg = torch.autograd.grad((ey * tw).sum() + eaux, es)
    for a, c, r in zip(tg, eg, jg):
        assert _rel(a.numpy(), c.numpy()) <= 1e-5
        assert _rel(a.numpy(), r) <= 1e-5


def test_moe_ffn_drops_tokens_at_capacity_like_the_reference():
    # every token prefers expert 0: its first choices overflow capacity,
    # the rest keep only their second choice, the last ones keep nothing
    t, e = 32, 4
    logits = np.tile(np.array([[3.0, 2.0, 1.0, 0.0]], np.float32), (t, 1))
    cap = tpm.capacity_of(1.25, t, e)
    idx1, idx2, w1, w2, _ = tpm.top2_route(torch.from_numpy(logits), cap)
    sink = e * cap
    assert (idx1[:cap] == torch.arange(cap)).all()
    assert (idx1[cap:] == sink).all()
    assert (idx2[:cap] == cap + torch.arange(cap)).all()
    assert (idx2[cap:] == sink).all() and (w2[cap:] == 0).all()
    jc, _, _ = jpm.top2_gating(jnp.asarray(logits), cap)
    tc, _, _ = tpm.top2_gating(torch.from_numpy(logits), cap)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)


def test_int8_expert_banks_bit_equal_and_products_match():
    cfg, jp, tcfg, tp = _model('mha')
    want = jmoe.quantize_decode_params(_j(jp))
    got = tmoe.quantize_decode_params(tp)
    for k in ('qkv_w', 'proj_w', 'w_in', 'w_out'):
        np.testing.assert_array_equal(got['blocks'][k]['int8'].numpy(),
                                      np.asarray(want['blocks'][k]['int8']))
        np.testing.assert_allclose(got['blocks'][k]['scale'].numpy(),
                                   np.asarray(want['blocks'][k]['scale']),
                                   rtol=1e-7, atol=0)
    assert tuple(got['blocks']['w_in']['scale'].shape) == (
        cfg.num_layers, cfg.n_experts, cfg.ffn_size)
    np.testing.assert_array_equal(got['wte']['int8'].numpy(),
                                  np.asarray(want['wte']['int8']))
    # untouched: the router, biases, norms, wpe
    assert got['blocks']['gate_w'] is tp['blocks']['gate_w']
    a = np.random.RandomState(0).randn(cfg.n_experts, 5,
                                       cfg.hidden_size).astype(np.float32)
    bank = {p: got['blocks']['w_in'][p][0] for p in ('int8', 'scale')}
    jbank = {p: want['blocks']['w_in'][p][0] for p in ('int8', 'scale')}
    out = two.wo_bmm(torch.from_numpy(a), bank, torch.float32)
    ref = jpm._expert_mm('ech,ehf->ecf', jnp.asarray(a), jbank, jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert jwo.is_weight_only(jbank)


# ---------------------------------------------------------------------------
# models/moe_gpt.py: parameters, forward, loss, train step
# ---------------------------------------------------------------------------

def test_params_layout_and_init_stds_match_reference():
    cfg, jp, tcfg, tp = _model('gqa')
    for k, v in jp['blocks'].items():
        assert torch.equal(tp['blocks'][k], torch.from_numpy(np.array(v)))
    assert set(tp['blocks']) == set(jp['blocks'])
    assert not {'fc_w', 'fc_b', 'out_w', 'out_b'} & set(tp['blocks'])
    mine = tmoe.init_params(tcfg, torch.Generator().manual_seed(0), 'cpu')
    for k, v in jp['blocks'].items():
        assert tuple(mine['blocks'][k].shape) == v.shape, k
    for k, std in (('qkv_w', 0.02), ('w_in', 0.02), ('w_out', 0.02),
                   ('gate_w', 0.01)):
        assert abs(mine['blocks'][k].std().item() - std) < 0.15 * std, k
    bad = dataclasses.replace(tcfg, n_experts=2)
    with pytest.raises(ValueError, match='gate_w'):
        tgpt.params_from_numpy(jp, bad, 'cpu')
    with pytest.raises(ValueError, match='num_kv_heads'):
        tmoe.MoEConfig(num_heads=4, num_kv_heads=3)


@pytest.mark.parametrize('name', ['mha', 'gqa'])
def test_forward_logits_and_aux_match_reference(name):
    cfg, jp, tcfg, tp = _model(name, scale=4.0)
    toks = _tokens(2, 40, 1)
    jl, ja = jax.jit(lambda p, t: jmoe.forward(p, t, cfg))(
        _j(jp), jnp.asarray(toks))
    tl, ta = tmoe.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert abs(ta.item() - float(ja)) <= 1e-4 * abs(float(ja))
    assert ta.dtype == torch.float32


def _port_value_and_grad(tp, tcfg, toks, tgts, seed):
    leaves = tgpt._leaves(tp)
    live = [p.detach().clone().requires_grad_() for p in leaves]
    loss = tmoe.loss_fn(tgpt._rebuild(tp, live), torch.from_numpy(toks),
                        torch.from_numpy(tgts), tcfg, seed)
    return loss.item(), tgpt._rebuild(tp, torch.autograd.grad(loss, live))


def _assert_grads(got, want, tol, path=''):
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_grads(got[k], w, tol, f'{path}{k}.')
        else:
            assert _rel(got[k].numpy(), w) <= tol, f'{path}{k}'


@pytest.mark.parametrize('name,over', [
    ('flash', dict(remat=True)),
    ('flash', dict(remat=False, dropout=0.1)),
    ('flash', dict(remat=True, dropout=0.1, num_kv_heads=1)),
    ('gqa', dict(remat=True)),              # log_softmax over full logits
])
def test_loss_and_grads_match_jax(interpret, name, over):
    cfg, jp, tcfg, tp = _model(name, **over)
    s = cfg.max_seq_len
    toks, tgts = _tokens(2, s, 2), _tokens(2, s, 3)
    key = jax.random.PRNGKey(7)
    jl, jg = jax.value_and_grad(jmoe.loss_fn)(
        _j(jp), jnp.asarray(toks), jnp.asarray(tgts), cfg, key)
    tl, tg = _port_value_and_grad(tp, tcfg, toks, tgts, _seed_of(key))
    assert abs(tl - float(jl)) <= 1e-4 * abs(float(jl))
    _assert_grads(tg, jg, 1e-4)


def test_remat_reruns_the_block_and_keeps_the_grads(monkeypatch):
    """remat recomputes each whole block (kernel 1 included) in the
    backward and gives the same gradients."""
    from paddle_tpu_torch.ops import flash_attention as tfa
    calls = []
    fwd = tfa.flash_fwd_reference

    def count(*a, **k):
        calls.append(1)
        return fwd(*a, **k)

    monkeypatch.setattr(tfa, 'flash_fwd_reference', count)
    toks, tgts = _tokens(2, 64, 4), _tokens(2, 64, 5)
    grads, seen = {}, {}
    for remat in (False, True):
        _, _, tcfg, tp = _model('flash', remat=remat, max_seq_len=64)
        calls.clear()
        _, grads[remat] = _port_value_and_grad(tp, tcfg, toks, tgts, None)
        seen[remat] = len(calls)
    assert seen == {False: 2, True: 4}
    for a, b in zip(tgpt._leaves(grads[True]), tgpt._leaves(grads[False])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_three_adamw_steps_match_reference(interpret):
    cfg, jp, tcfg, tp = _model('flash', dropout=0.1)
    toks, tgts = _tokens(2, cfg.max_seq_len, 6), _tokens(2, cfg.max_seq_len,
                                                         7)
    jopt = paddle.optimizer.AdamW(learning_rate=2e-3, weight_decay=0.01)
    topt_ = topt.AdamW(learning_rate=2e-3, weight_decay=0.01)
    jparams = _j(jp)
    jstate = jopt.functional_init(jparams)
    tstate = topt_.functional_init(tp)
    jstep = jmoe.make_train_step(cfg, jopt)
    tstep = tmoe.make_train_step(tcfg, topt_)
    jcurve, tcurve = [], []
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        jl, jparams, jstate = jstep(jparams, jstate, key, jnp.float32(2e-3),
                                    jnp.asarray(toks), jnp.asarray(tgts))
        tl, tp, tstate = tstep(tp, tstate, _seed_of(key), 2e-3,
                               torch.from_numpy(toks), torch.from_numpy(tgts))
        jcurve.append(float(jl))
        tcurve.append(tl.item())
    np.testing.assert_allclose(tcurve, jcurve, rtol=1e-4)
    assert tcurve[-1] < tcurve[0]


def test_unported_options_raise_naming_the_roadmap():
    """The mesh options (step K2, ported): mp > 1 needs a mesh of that
    degree (here the one-process world's, mp = 1); sp > 1 raises the
    reference's own refusal, with fp8 too; pp > 1, which the reference's
    step ignores, builds the step. A config value outside the reference's
    set still raises."""
    _, _, tcfg, _ = _model('mha')
    opt = topt.AdamW()
    with pytest.raises(ValueError, match='mp=1'):
        tmoe.make_train_step(dataclasses.replace(tcfg, mp=2), opt)
    for over in (dict(sp=2), dict(sp=2, matmul_precision='fp8')):
        with pytest.raises(NotImplementedError,
                           match='unbound axis name: sp'):
            tmoe.make_train_step(dataclasses.replace(tcfg, **over), opt)
    assert callable(tmoe.make_train_step(dataclasses.replace(tcfg, pp=2),
                                         opt))
    with pytest.raises(ValueError, match='matmul_precision'):
        tmoe.MoEConfig(matmul_precision='int4')


# ---------------------------------------------------------------------------
# the dense KV cache and generate()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['mha', 'gqa'])
def test_cached_forward_matches_full_and_reference(name):
    # capacity 8: a 1-wide step routes as the full forward only when the
    # full forward drops nothing
    cfg, jp, tcfg, tp = _model(name, scale=4.0, capacity_factor=8.0)
    toks = _tokens(2, 9, 8)
    full, _ = tmoe.forward(tp, torch.from_numpy(toks), tcfg)
    cache = tmoe.init_kv_cache(tcfg, 2, 'cpu')
    jcache = jmoe.init_kv_cache(cfg, 2)
    jfwd = jax.jit(lambda p, t, c, pos: jmoe.forward_with_cache(p, t, c, pos,
                                                                cfg))
    pre, cache = tmoe.forward_with_cache(tp, torch.from_numpy(toks[:, :5]),
                                         cache, 0, tcfg)
    jpre, jcache = jfwd(_j(jp), jnp.asarray(toks[:, :5]), jcache,
                        jnp.int32(0))
    np.testing.assert_allclose(pre.numpy(), full[:, :5].numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), rtol=1e-4,
                               atol=1e-4)
    for t in range(5, 9):
        lg, cache = tmoe.forward_with_cache(
            tp, torch.from_numpy(toks[:, t:t + 1]), cache, t, tcfg)
        jlg, jcache = jfwd(_j(jp), jnp.asarray(toks[:, t:t + 1]), jcache,
                           jnp.int32(t))
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize('name,cf', [('mha', 1.25), ('gqa', 8.0)])
def test_greedy_generate_equals_reference(name, cf):
    cfg, jp, tcfg, tp = _model(name, scale=4.0, capacity_factor=cf)
    prompt = _tokens(3, 7, 9)
    want = np.asarray(jmoe.generate(_j(jp), cfg, jnp.asarray(prompt), 12))
    got = tmoe.generate(tp, tcfg, torch.from_numpy(prompt), 12)
    assert got.dtype == torch.int32 and got.shape == (3, 19)
    np.testing.assert_array_equal(got.numpy(), want)
    # a second call replays the memoized prefill and loop
    again = tmoe.generate(tp, tcfg, torch.from_numpy(prompt), 12)
    assert torch.equal(again, got)
    with pytest.warns(UserWarning, match='window'):
        out = tmoe.generate(tp, tcfg, torch.from_numpy(prompt),
                            cfg.max_seq_len)
    assert out.shape[1] == cfg.max_seq_len + 1
    with pytest.raises(ValueError, match='max_seq_len'):
        tmoe.generate(tp, tcfg, torch.from_numpy(_tokens(1, 48, 1)), 2)


def test_int8_cache_generate_holds_the_reference_rule():
    kw = dict(scale=4.0, capacity_factor=4.0)
    cfg, jp, tcfg, tp = _model('mha', **kw)
    qcfg, _, tqcfg, _ = _model('mha', kv_cache_int8=True, **kw)
    prompt = _tokens(2, 5, 10)
    fp = tmoe.generate(tp, tcfg, torch.from_numpy(prompt), 10).numpy()
    q8 = tmoe.generate(tp, tqcfg, torch.from_numpy(prompt), 10).numpy()
    jq8 = np.asarray(jmoe.generate(_j(jp), qcfg, jnp.asarray(prompt), 10))
    assert q8.shape == fp.shape == jq8.shape
    assert (q8 == fp).mean() >= 0.7
    assert (q8 == jq8).mean() >= 0.7
    cache = tmoe.init_kv_cache(tqcfg, 2, 'cpu')
    assert cache['k']['int8'].dtype == torch.int8


def test_generate_over_int8_weights_equals_reference():
    cfg, jp, tcfg, tp = _model('gqa', scale=4.0)
    prompt = _tokens(2, 6, 11)
    want = np.asarray(jmoe.generate(jmoe.quantize_decode_params(_j(jp)), cfg,
                                    jnp.asarray(prompt), 10))
    got = tmoe.generate(tmoe.quantize_decode_params(tp), tcfg,
                        torch.from_numpy(prompt), 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_is_a_function_of_the_seed():
    _, _, tcfg, tp = _model('mha', scale=4.0)
    prompt = torch.from_numpy(_tokens(2, 5, 12))
    a = tmoe.generate(tp, tcfg, prompt, 8, temperature=1.0, top_k=20, seed=3)
    b = tmoe.generate(tp, tcfg, prompt, 8, temperature=1.0, top_k=20, seed=3)
    c = tmoe.generate(tp, tcfg, prompt, 8, temperature=1.0, top_k=20, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_clear_decode_caches_clears_the_moe_caches():
    _, _, tcfg, tp = _model('mha')
    tmoe.generate(tp, tcfg, torch.from_numpy(_tokens(1, 4, 13)), 3)
    assert len(tmoe._decode_fns_cache) >= 1 and len(tmoe._GEN_LOOPS) >= 1
    tdc.clear_decode_caches()
    assert len(tmoe._decode_fns_cache) == 0 and len(tmoe._GEN_LOOPS) == 0
