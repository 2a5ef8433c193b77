"""The port's weight-only int8 serving path (paddle_tpu_torch/ops/
weight_only.py, ``models.gpt.quantize_decode_params``,
``GPTForCausalLM.enable_int8_decode``, ``GenerationEngine(precision=
'int8_wo')``) against the JAX package's, on the CPU at a small size, in
float32: the same numpy-seeded weights through both. The int8 banks are
bit-equal and their scales within 1e-7; the int8 products within 1e-5;
the quantized forward, dense cached forward and paged forward logits
within 1e-4 (the two sum in different orders); greedy streams equal token
for token (float and int8 KV caches and pools, and past the window)."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops import weight_only as jwo
from paddle_tpu.serving import GenerationEngine as JEngine
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import weight_only as two
from paddle_tpu_torch.serving import GenerationEngine

_MATS = ('qkv_w', 'proj_w', 'fc_w', 'out_w')
_CFGS = {
    'mha': dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
                max_seq_len=48),
    'gqa': dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, max_seq_len=48),
    'int8kv': dict(vocab_size=128, hidden_size=64, num_layers=2,
                   num_heads=2, max_seq_len=48, kv_cache_int8=True),
    'window12': dict(vocab_size=97, hidden_size=64, num_layers=2,
                     num_heads=1, max_seq_len=12),
}


def _models(name):
    """(reference model, port model, reference params as numpy, reference
    config, port config): the reference's parameters with the block
    matrices x10 (at init stds a 2-layer model with a tied head mostly
    repeats its last token), loaded into both packages' models."""
    cfg = jgpt.GPTConfig(dtype='float32', remat=False, use_flash=False,
                         **_CFGS[name])
    jp = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(cfg, jax.random.PRNGKey(0)))
    for k in _MATS:
        jp['blocks'][k] = jp['blocks'][k] * np.float32(10)
    jm = jgpt.GPTForCausalLM(cfg)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(jp)):
        jm._parameters[f'p{i}'].set_value(jnp.asarray(leaf))
    tcfg = tgpt.GPTConfig(**dataclasses.asdict(cfg))
    tm = tgpt.GPTForCausalLM(tcfg, tgpt.params_from_numpy(jp, tcfg, 'cpu'),
                             device='cpu')
    return jm, tm, jp, cfg, tcfg


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _weights(seed, shape, scale=0.1):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# ops/weight_only.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape,axis', [((64, 48), 0), ((11, 8), 1),
                                        ((3, 32, 40), 1), ((2, 5, 7), 2)])
def test_quantize_weight_banks_bit_equal(shape, axis):
    w = _weights(1, shape)
    w[0] = 0.0                       # an all-zero channel: the 1e-8 floor
    want = jwo.quantize_weight(jnp.asarray(w), reduce_axis=axis)
    got = two.quantize_weight(torch.from_numpy(w), reduce_axis=axis)
    assert got['int8'].dtype == torch.int8
    np.testing.assert_array_equal(_np(got['int8']), _np(want['int8']))
    assert got['scale'].dtype == torch.float32
    np.testing.assert_allclose(_np(got['scale']), _np(want['scale']),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        _np(two.dequantize_weight(got, axis)),
        _np(jwo.dequantize_weight(want, axis)), rtol=0, atol=1e-7)


@pytest.mark.parametrize('shape,axis', [((16, 24), 0), ((4, 6, 10), (1, 2))])
def test_quantize_param_keeps_the_reduced_axes(shape, axis):
    w = _weights(2, shape)
    want = jwo.quantize_param(jnp.asarray(w), axis)
    got = two.quantize_param(torch.from_numpy(w), axis)
    np.testing.assert_array_equal(_np(got['int8']), _np(want['int8']))
    assert tuple(got['scale'].shape) == want['scale'].shape
    np.testing.assert_allclose(_np(got['scale']), _np(want['scale']),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        _np(two.dequantize_param(got, torch.float32)),
        _np(jwo.dequantize_param(want, jnp.float32)), rtol=0, atol=1e-7)


def test_weight_only_products_match_reference():
    y = _weights(3, (5, 32), 1.0)
    w = _weights(4, (32, 16))
    wte = _weights(5, (11, 32))
    idx = np.array([[0, 3], [10, 7]], np.int32)
    jq = jwo.quantize_weight(jnp.asarray(w), 0)
    tq = two.quantize_weight(torch.from_numpy(w), 0)
    jt = jwo.quantize_weight(jnp.asarray(wte), 1)
    tt = two.quantize_weight(torch.from_numpy(wte), 1)
    ty, jy = torch.from_numpy(y), jnp.asarray(y)
    f32 = (torch.float32, jnp.float32)
    for got, want in (
            (two.wo_matmul(ty, tq, f32[0]), jwo.wo_matmul(jy, jq, f32[1])),
            (two.wo_matmul(ty, torch.from_numpy(w), f32[0]),
             jwo.wo_matmul(jy, jnp.asarray(w), f32[1])),
            (two.wo_take(tt, torch.from_numpy(idx).long()),
             jwo.wo_take(jt, jnp.asarray(idx))),
            (two.wo_lm_head(ty, tt, f32[0]), jwo.wo_lm_head(jy, jt, f32[1])),
            (two.wo_lm_head(ty, torch.from_numpy(wte), f32[0]),
             jwo.wo_lm_head(jy, jnp.asarray(wte), f32[1]))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# models/gpt.py over the quantized tree
# ---------------------------------------------------------------------------

def _quantized(name):
    _, _, jp, cfg, tcfg = _models(name)
    jq = jgpt.quantize_decode_params(jax.tree_util.tree_map(jnp.asarray, jp))
    tq = tgpt.quantize_decode_params(tgpt.params_from_numpy(jp, tcfg, 'cpu'))
    return jq, tq, cfg, tcfg


@pytest.mark.parametrize('name', ['mha', 'gqa'])
def test_quantize_decode_params_bit_equal(name):
    jq, tq, _, _ = _quantized(name)
    pairs = [(tq['wte'], jq['wte'])] + [(tq['blocks'][k], jq['blocks'][k])
                                        for k in _MATS]
    for got, want in pairs:
        assert two.is_weight_only(got)
        np.testing.assert_array_equal(_np(got['int8']), _np(want['int8']))
        np.testing.assert_allclose(_np(got['scale']), _np(want['scale']),
                                   rtol=0, atol=1e-7)
    # biases, norms and wpe are the source tensors, unquantized
    for k in ('qkv_b', 'ln1_g'):
        np.testing.assert_array_equal(_np(tq['blocks'][k]),
                                      _np(jq['blocks'][k]))
    np.testing.assert_array_equal(_np(tq['wpe']), _np(jq['wpe']))


def test_quantized_bytes_under_a_third_of_the_f32_matrices():
    jq, tq, _, _ = _quantized('mha')
    _, _, jp, _, tcfg = _models('mha')
    tp = tgpt.params_from_numpy(jp, tcfg, 'cpu')

    def nbytes(x):
        if isinstance(x, dict):
            return sum(nbytes(v) for v in x.values())
        return x.numel() * x.element_size()
    orig = sum(nbytes(tp['blocks'][k]) for k in _MATS) + nbytes(tp['wte'])
    quant = sum(nbytes(tq['blocks'][k]) for k in _MATS) + nbytes(tq['wte'])
    assert quant < 0.3 * orig


@pytest.mark.parametrize('name', ['mha', 'gqa'])
def test_quantized_forward_logits_match_reference(name):
    jq, tq, cfg, tcfg = _quantized(name)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                            (2, 20)).astype(np.int32)
    want = np.asarray(jgpt.forward(jq, jnp.asarray(toks), cfg))
    got = tgpt.forward(tq, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    # the serving copy passes the banks through uncast
    sp = tgpt.serving_params(tq, tcfg)
    assert all(sp['blocks'][k] is tq['blocks'][k] for k in _MATS)


@pytest.mark.parametrize('name', ['mha', 'int8kv'])
def test_quantized_dense_cache_prefill_and_steps_match_reference(name):
    jq, tq, cfg, tcfg = _quantized(name)
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size,
                                            (2, 12)).astype(np.int32)
    jcache = jgpt.init_kv_cache(cfg, 2)
    tcache = tgpt.init_kv_cache(tcfg, 2, 'cpu')
    jl, jcache = jgpt.forward_with_cache(jq, jnp.asarray(toks[:, :8]), jcache,
                                         jnp.int32(0), cfg)
    tl, tcache = tgpt.forward_with_cache(
        tq, torch.from_numpy(toks[:, :8]), tcache,
        torch.zeros(1, dtype=torch.int32), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for t in range(8, 12):
        jl, jcache = jgpt.forward_with_cache(
            jq, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t), cfg)
        tl, tcache = tgpt.forward_with_cache(
            tq, torch.from_numpy(toks[:, t:t + 1]), tcache,
            torch.tensor([t], dtype=torch.int32), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize('name', ['gqa', 'int8kv'])
def test_quantized_paged_prefill_and_decode_match_reference(name):
    jq, tq, cfg, tcfg = _quantized(name)
    ps, b, w = 8, 2, 12
    lens = [6, 10]
    rng = np.random.RandomState(3)
    toks = np.zeros((b, w), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(0, cfg.vocab_size, n)
    table = np.zeros((b, cfg.max_seq_len // ps), np.int32)
    table[0, :3] = [5, 2, 9]
    table[1, :3] = [1, 11, 4]
    valid = np.array(lens, np.int32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jpool = jgpt.init_paged_kv_cache(cfg, 13, ps)
    tpool = tgpt.init_paged_kv_cache(tcfg, 13, ps, 'cpu')
    jl, jc = jgpt.forward_with_cache(
        jq, jnp.asarray(toks), dict(jpool, page_table=jt,
                                    valid=jnp.asarray(valid)),
        jnp.zeros((b,), jnp.int32), cfg, last_only=True)
    tl, tc = tgpt.forward_with_cache(
        tq, torch.from_numpy(toks), dict(tpool, page_table=tt,
                                         valid=torch.from_numpy(valid)),
        torch.zeros(b, dtype=torch.int32), tcfg, last_only=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    tok = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    jcache = {'k': jc['k'], 'v': jc['v'], 'page_table': jt}
    tcache = {'k': tc['k'], 'v': tc['v'], 'page_table': tt}
    pos = valid.copy()
    for _ in range(3):
        jl, jcache = jgpt.forward_with_cache(
            jq, jnp.asarray(tok[:, None]), jcache, jnp.asarray(pos), cfg)
        tl, tcache = tgpt.forward_with_cache(
            tq, torch.from_numpy(tok[:, None]), tcache,
            torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        tok = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
        pos += 1


def test_generate_loop_over_quantized_params_matches_reference():
    jq, tq, cfg, tcfg = _quantized('mha')
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size,
                                            (2, 6)).astype(np.int32)
    jprefill, _ = jgpt.make_decode_fns(cfg)
    jl, jcache = jprefill(jq, jnp.asarray(toks), jgpt.init_kv_cache(cfg, 2))
    tok0 = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    want, _ = jgpt.make_generate_loop(cfg)(
        jq, jnp.asarray(tok0), jnp.int32(6), jcache, jax.random.PRNGKey(0), 8)
    tprefill, _ = tgpt.make_decode_fns(tcfg)
    tl, tcache = tprefill(tq, torch.from_numpy(toks),
                          tgpt.init_kv_cache(tcfg, 2, 'cpu'))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    got, _ = tgpt.make_generate_loop(tcfg)(
        tq, torch.from_numpy(tok0), torch.tensor([6], dtype=torch.int32),
        tcache, None, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# GPTForCausalLM.enable_int8_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name,t0,new', [
    ('mha', 5, 12),              # float cache
    ('int8kv', 6, 10),           # int8 cache
    ('window12', 8, 20),         # crosses the window into the sliding path
])
def test_enable_int8_decode_greedy_equals_reference(name, t0, new):
    jm, tm, _, cfg, _ = _models(name)
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size,
                                              (2, t0)).astype(np.int32)
    fp = tm.generate(torch.from_numpy(prompt), max_new_tokens=new,
                     temperature=0)
    jm.enable_int8_decode()
    assert tm.enable_int8_decode() is tm
    want = np.asarray(jm.generate(jnp.asarray(prompt), max_new_tokens=new,
                                  temperature=0)._value)
    got = tm.generate(torch.from_numpy(prompt), max_new_tokens=new,
                      temperature=0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got[0, t0:].tolist())) > 1
    # the snapshot is cached; forward() stays on the float weights
    snap = tm._decode_params()
    assert snap is tm._decode_params()
    assert two.is_weight_only(snap['wte'])
    assert not two.is_weight_only(tm.param_dict()['wte'])
    # disabling restores the float stream
    tm.enable_int8_decode(False)
    again = tm.generate(torch.from_numpy(prompt), max_new_tokens=new,
                        temperature=0)
    assert torch.equal(again, fp)


def test_enable_int8_decode_snapshots_the_current_weights():
    """The snapshot is taken at the next generate() and frozen there: a
    weight changed in place is not seen until ``enable_int8_decode()`` is
    called again, and then it is (a new snapshot, new tokens, as the
    reference's)."""
    jm, tm, jp, cfg, _ = _models('mha')
    prompt = np.random.RandomState(6).randint(0, cfg.vocab_size,
                                              (2, 5)).astype(np.int32)
    tm.enable_int8_decode()
    first = tm.generate(torch.from_numpy(prompt), max_new_tokens=8,
                        temperature=0)
    snap = tm._decode_params()
    with torch.no_grad():
        tm.blocks.fc_w.mul_(-1.0)
        tm.lnf_b.add_(0.5)
    frozen = tm.generate(torch.from_numpy(prompt), max_new_tokens=8,
                         temperature=0)
    assert torch.equal(frozen, first)
    assert tm._decode_params() is snap
    tm.enable_int8_decode()
    fresh = tm.generate(torch.from_numpy(prompt), max_new_tokens=8,
                        temperature=0)
    assert tm._decode_params() is not snap
    # the reference over the same changed weights
    leaves = jax.tree_util.tree_leaves(jp)
    jtree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jp), leaves)
    jtree['blocks']['fc_w'] = -jtree['blocks']['fc_w']
    jtree['lnf_b'] = jtree['lnf_b'] + np.float32(0.5)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(jtree)):
        jm._parameters[f'p{i}'].set_value(jnp.asarray(leaf))
    jm.enable_int8_decode()
    want = np.asarray(jm.generate(jnp.asarray(prompt), max_new_tokens=8,
                                  temperature=0)._value)
    np.testing.assert_array_equal(fresh.numpy(), want)
    assert not torch.equal(fresh, first)


# ---------------------------------------------------------------------------
# GenerationEngine(precision='int8_wo')
# ---------------------------------------------------------------------------

def _serve(engine, prompts, n_new):
    with engine as eng:
        futs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        return [f.result(timeout=120) for f in futs], eng.stats()


_ENGINE_KW = dict(num_slots=2, page_size=8, prefill_width=16)


@pytest.mark.parametrize('name,num_pages', [('gqa', None), ('gqa', 6),
                                            ('int8kv', None)])
def test_int8_wo_engine_greedy_streams_equal_reference(name, num_pages):
    _, _, jp, cfg, tcfg = _models(name)
    prompts = [np.random.RandomState(20 + i).randint(
        0, cfg.vocab_size, n).astype(np.int32)
        for i, n in enumerate([9, 9, 3, 14])]
    kw = dict(_ENGINE_KW, num_pages=num_pages, precision='int8_wo')
    want, _ = _serve(JEngine(jp, cfg, **kw), prompts, 12)
    got, st = _serve(GenerationEngine(tgpt.params_from_numpy(jp, tcfg, 'cpu'),
                                      tcfg, device='cpu', **kw), prompts, 12)
    assert got == want
    assert st['precision'] == 'int8_wo' and st['traces'] == 2
    assert st['completed'] == len(prompts)
    assert st['free_pages'] == st['num_pages'] - 1


def test_int8_wo_engine_holds_banks_and_takes_a_snapshot_model():
    _, tm, jp, cfg, tcfg = _models('mha')
    eng = GenerationEngine(tm, precision='int8_wo', autostart=False,
                           **_ENGINE_KW)
    try:
        sp = eng._params
        assert two.is_weight_only(sp['wte'])
        assert all(two.is_weight_only(sp['blocks'][k]) for k in _MATS)
        assert not two.is_weight_only(tm.param_dict()['wte'])
    finally:
        eng.shutdown()
    # a model already snapshot by enable_int8_decode serves that snapshot
    tm.enable_int8_decode()
    snap = tm._decode_params()
    for precision in (None, 'int8_wo'):
        eng = GenerationEngine(tm, precision=precision, autostart=False,
                               **_ENGINE_KW)
        try:
            # the same tensors (the engine rebuilds the dicts around them)
            assert eng._params['wte']['int8'] is snap['wte']['int8']
            assert (eng._params['blocks']['fc_w']['scale']
                    is snap['blocks']['fc_w']['scale'])
        finally:
            eng.shutdown()
