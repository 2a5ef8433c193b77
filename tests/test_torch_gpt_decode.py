"""The port's dense KV-cache decode, ``generate()`` and plain forward
(paddle_tpu_torch/models/gpt.py) against the JAX package's, on the CPU at
a small size, in float32: the reference's own parameters (converted
through numpy), forward logits and the cached prefill + steps within 1e-4
(the two sum in different orders, and the port's attention is the
kernels' block-wise twins where the reference takes its einsum path), and
greedy ``generate`` equal token for token: a plain prompt, a prompt that
fills the window exactly, one that crosses it into the sliding-window
recompute, GQA, and the int8 KV cache. The reference runs once on its
plain paths and once with its Pallas kernels in interpret mode. Sampled
decoding cannot match ``jax.random``; it is held to its own contract: the
same seed gives the same tokens."""
import dataclasses
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import flash_attention as tfa

fa = importlib.import_module('paddle_tpu.ops.flash_attention')

_CFGS = {
    'mha': dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
                max_seq_len=256),
    'gqa': dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=4,
                num_kv_heads=2, max_seq_len=256),
    'window12': dict(vocab_size=97, hidden_size=64, num_layers=2,
                     num_heads=1, max_seq_len=12),
    'int8kv': dict(vocab_size=128, hidden_size=128, num_layers=2,
                   num_heads=2, max_seq_len=256, kv_cache_int8=True),
}


def _models(name, use_flash=True):
    """(reference model, port model, reference params, port config): the
    reference's parameters, block matrices x10 (at init stds a 2-layer
    model with a tied head mostly repeats its last token; larger weights
    make every stream depend on attention over its context)."""
    cfg = jgpt.GPTConfig(dtype='float32', remat=False, use_flash=use_flash,
                         **_CFGS[name])
    jp = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(cfg, jax.random.PRNGKey(0)))
    for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
        jp['blocks'][k] = jp['blocks'][k] * np.float32(10)
    jm = jgpt.GPTForCausalLM(cfg)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(jp)):
        jm._parameters[f'p{i}'].set_value(jnp.asarray(leaf))
    tcfg = tgpt.GPTConfig(**dataclasses.asdict(cfg))
    tm = tgpt.GPTForCausalLM(tcfg, tgpt.params_from_numpy(jp, tcfg, 'cpu'),
                             device='cpu')
    return jm, tm, jp, tcfg


@pytest.fixture(params=[False, True], ids=['plain', 'interpret'])
def interpret(request):
    """The reference on its plain paths, then on its Pallas kernels."""
    fa.set_interpret(request.param)
    try:
        yield request.param
    finally:
        fa.set_interpret(False)


def _prompt(b, t, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize('use_flash', [True, False])
@pytest.mark.parametrize('name', ['mha', 'gqa'])
def test_forward_logits_match(interpret, name, use_flash):
    jm, tm, jp, tcfg = _models(name, use_flash)
    toks = _prompt(2, 130, tcfg.vocab_size, 1)
    want = np.asarray(jgpt.forward(jax.tree_util.tree_map(jnp.asarray, jp),
                                   jnp.asarray(toks), jm.config))
    before = tfa.flash_fwd.launches
    got = tm(torch.from_numpy(toks))
    assert tfa.flash_fwd.launches == before      # the CPU runs the twin
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('name,prefill_pos', [
    ('mha', 'int'), ('mha', 'tensor'), ('gqa', 'int'), ('gqa', 'tensor'),
    ('int8kv', 'tensor')])
def test_cached_prefill_and_steps_match(interpret, name, prefill_pos):
    """A dense prefill at position 0 (a Python int: kernel 1 over the
    fresh rows; a tensor: the decode kernel over the cache), then four
    single-token steps, each against the reference's forward_with_cache.
    An int8 cache at a Python int 0 is left out: there the reference's
    route hangs on its TPU gate (kernel 1 over the unquantized rows when
    S >= 128 on its platform, the int8 path over the quantized cache
    otherwise), so the two differ by the quantization error."""
    jm, tm, jp, tcfg = _models(name)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    params = tm.param_dict()
    toks = _prompt(2, 12, tcfg.vocab_size, 2)
    jcache = jgpt.init_kv_cache(jm.config, 2)
    tcache = tgpt.init_kv_cache(tcfg, 2, 'cpu')
    jpos0 = 0 if prefill_pos == 'int' else jnp.int32(0)
    tpos0 = 0 if prefill_pos == 'int' else torch.zeros(1, dtype=torch.int32)
    jl, jcache = jgpt.forward_with_cache(jparams, jnp.asarray(toks[:, :8]),
                                         jcache, jpos0, jm.config)
    tl, tcache = tgpt.forward_with_cache(params, torch.from_numpy(toks[:, :8]),
                                         tcache, tpos0, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for t in range(8, 12):
        jl, jcache = jgpt.forward_with_cache(
            jparams, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t),
            jm.config)
        tl, tcache = tgpt.forward_with_cache(
            params, torch.from_numpy(toks[:, t:t + 1]), tcache,
            torch.tensor([t], dtype=torch.int32), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    if tcfg.kv_cache_int8:
        np.testing.assert_array_equal(tcache['k']['int8'].numpy(),
                                      np.asarray(jcache['k']['int8']))
    else:
        np.testing.assert_allclose(tcache['k'].numpy(),
                                   np.asarray(jcache['k']), atol=1e-4)


@pytest.mark.parametrize('name,t0,new', [
    ('mha', 5, 12),              # a plain prompt
    ('window12', 4, 8),          # T0 + new == max_seq_len: fills the window
    ('window12', 8, 20),         # crosses it into the sliding recompute
    ('gqa', 7, 10),
    ('int8kv', 6, 10),
])
def test_greedy_generate_equals_reference(interpret, name, t0, new):
    jm, tm, _, tcfg = _models(name)
    prompt = _prompt(2, t0, tcfg.vocab_size, 3)
    want = np.asarray(jm.generate(jnp.asarray(prompt), max_new_tokens=new,
                                  temperature=0)._value)
    got = tm.generate(torch.from_numpy(prompt), max_new_tokens=new,
                      temperature=0)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, t0 + new)
    np.testing.assert_array_equal(got.numpy(), want)
    # the streams depend on their context (not one repeated token)
    assert len(set(got[0, t0:].tolist())) > 1


def test_sampled_generate_is_a_function_of_the_seed():
    _, tm, _, tcfg = _models('window12')
    prompt = torch.from_numpy(_prompt(2, 5, tcfg.vocab_size, 4))
    kw = dict(max_new_tokens=14, temperature=0.9, top_k=20, top_p=0.95)
    a = tm.generate(prompt, seed=7, **kw)
    assert torch.equal(a, tm.generate(prompt, seed=7, **kw))
    assert not torch.equal(a, tm.generate(prompt, seed=8, **kw))
    assert ((a >= 0) & (a < tcfg.vocab_size)).all()
    # row b draws with seed + b: row 1 of seed 7 is row 0 of seed 8
    one = tm.generate(prompt[1:], seed=8, **kw)
    assert torch.equal(a[1:], one)


def test_decode_fns_route_the_prefill_to_the_decode_twin(monkeypatch):
    """``make_decode_fns`` passes a device tensor 0, so the prefill goes to
    the decode path and never to kernel 1, as in the reference."""
    _, tm, _, tcfg = _models('mha')
    calls = {'fwd': 0, 'decode': 0}
    real_fwd, real_dec = tgpt.flash_attention, tgpt.decode_attention

    def fwd(*a, **k):
        calls['fwd'] += 1
        return real_fwd(*a, **k)

    def dec(*a, **k):
        calls['decode'] += 1
        return real_dec(*a, **k)

    monkeypatch.setattr(tgpt, 'flash_attention', fwd)
    monkeypatch.setattr(tgpt, 'decode_attention', dec)
    prefill, step = tgpt.make_decode_fns(tcfg)
    cache = tgpt.init_kv_cache(tcfg, 1, 'cpu')
    params = tm.param_dict()
    lg, cache = prefill(params, torch.from_numpy(_prompt(1, 6, 128, 5)),
                        cache)
    lg, cache = step(params, lg.argmax(-1).int(),
                     torch.tensor([6], dtype=torch.int32), cache)
    assert calls == {'fwd': 0, 'decode': 2 * tcfg.num_layers}
    assert tuple(lg.shape) == (1, tcfg.vocab_size)
