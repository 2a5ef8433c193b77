"""paddle_tpu_torch.models.ernie against the JAX package's ERNIE, on the
CPU, on the same numpy inputs and weights (the reference's ``init_params``
tree converted with ``params_from_numpy``).

``encode`` with and without a key-padding mask, on the kernels' route
(``use_flash``: the twins here) and the plain one; ``pretrain_loss`` and
its gradients with remat on and off and with attention dropout from the
u32 the reference draws from its key (``jax.random.bits``), at 1e-4;
``ErnieModel``'s parameter names ``p0`` .. ``p24`` and outputs, its
``state_dict()`` and a ``.pdparams`` written by the reference loaded into
the port. The reference's programs are jitted, one per case.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.models.ernie as rern
import paddle_tpu_torch as port
import paddle_tpu_torch.models.ernie as pern
from paddle_tpu_torch import device as port_device

SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=64, dtype='float32')
TOL = 1e-4
B, S = 2, 48


@pytest.fixture(autouse=True, scope='module')
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


def _cfgs(**over):
    rc = rern.ErnieConfig(**dict(SMALL, **over))
    return rc, pern.ErnieConfig(**dataclasses.asdict(rc))


@pytest.fixture(scope='module')
def weights():
    rc, _ = _cfgs()
    tree = rern.init_params(rc, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0, vocab=128):
    rs = np.random.RandomState(seed)
    lens = np.array([S, S - 17])
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    ids = np.where(mask > 0, rs.randint(5, vocab, (B, S)), 0).astype(np.int32)
    types = (np.arange(S)[None] >= lens[:, None] // 2).astype(np.int32)
    pick = (rs.rand(B, S) < 0.3) & (mask > 0)
    mlm = np.where(pick, ids, -100).astype(np.int32)
    nsp = np.array([0, 1], np.int32)
    return ids, types, mask, mlm, nsp


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


@pytest.mark.parametrize('masked', [True, False], ids=['mask', 'nomask'])
@pytest.mark.parametrize('use_flash', [True, False], ids=['flash', 'plain'])
def test_encode_matches_the_reference(weights, masked, use_flash):
    rc, pc = _cfgs(use_flash=use_flash)
    ids, types, mask, _, _ = _batch()
    am = mask if masked else None
    want = jax.jit(lambda p, i, t, m: rern.encode(p, i, t, m, rc))(
        weights, ids, types, am)
    got = pern.encode(pern.params_from_numpy(weights, 'cpu'), _t(ids),
                      _t(types), None if am is None else _t(am), pc)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, 64)
    _close(got.numpy(), want)


def test_bf16_encode_near_the_reference(weights):
    """bf16 compute over f32 parameters: the reference's dtype steps
    (LayerNorm's statistics in bf16, the f32 gain promoting, the cast
    back) agree within bf16 rounding through two layers."""
    rc, pc = _cfgs(dtype='bfloat16')
    ids, types, mask, _, _ = _batch(1)
    want = jax.jit(lambda p: rern.encode(p, ids, types, mask, rc))(weights)
    got = pern.encode(pern.params_from_numpy(weights, 'cpu'), _t(ids),
                      _t(types), _t(mask), pc)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.float().numpy() - want).max() < 0.1
    assert np.abs(got.float().numpy() - want).mean() < 5e-3


@pytest.mark.parametrize('remat,dropout', [(True, 0.0), (False, 0.0),
                                           (True, 0.1)],
                         ids=['remat', 'no_remat', 'remat_dropout'])
def test_pretrain_loss_and_gradients_match_the_reference(weights, remat,
                                                         dropout):
    rc, pc = _cfgs(remat=remat, dropout=dropout)
    ids, types, mask, mlm, nsp = _batch(2)
    key = jax.random.PRNGKey(7) if dropout else None

    def loss_fn(p):
        return rern.pretrain_loss(p, ids, types, mask, mlm, nsp, rc,
                                  dropout_key=key)
    want, want_g = jax.jit(jax.value_and_grad(loss_fn))(weights)
    seed = (int(jax.random.bits(key, (1,), jnp.uint32)[0]) if dropout
            else None)
    params = pern.params_from_numpy(weights, 'cpu')
    leaves = [t.requires_grad_() for t in pern.leaves(params)]
    loss = pern.pretrain_loss(pern.from_leaves(leaves), _t(ids), _t(types),
                              _t(mask), _t(mlm), _t(nsp), pc,
                              dropout_seed=seed)
    grads = torch.autograd.grad(loss, leaves)
    _close(float(loss.detach()), float(want))
    flat = jax.tree_util.tree_leaves(want_g)
    assert len(flat) == len(grads) == 25
    for g, w in zip(grads, flat):
        _close(g.numpy(), w)
    if dropout:     # the dropout changes the loss: the seed is used
        rc0, pc0 = _cfgs(remat=remat)
        off = pern.pretrain_loss(params, _t(ids), _t(types), _t(mask),
                                 _t(mlm), _t(nsp), pc0)
        assert abs(float(off.detach()) - float(loss.detach())) > 1e-4


def test_leaves_follow_the_references_flatten_order(weights):
    rc, _ = _cfgs()
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(weights)[0]]
    want = ([f"['blocks']['{k}']" for k in pern.BLOCK_KEYS]
            + [f"['{k}']" for k in pern.TOP_KEYS])
    assert names == want
    params = pern.params_from_numpy(weights, 'cpu')
    for got, w in zip(pern.leaves(params),
                      jax.tree_util.tree_leaves(weights)):
        np.testing.assert_array_equal(got.numpy(), w)
    back = pern.from_leaves(pern.leaves(params))
    assert back.keys() == params.keys()


def test_ernie_base_has_the_references_parameter_count():
    rc = rern.ErnieConfig()
    shapes = jax.eval_shape(lambda: rern.init_params(rc,
                                                     jax.random.PRNGKey(0)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        shapes))
    assert pern.num_params(pern.ErnieConfig()) == want == 110_075_906


def test_init_params_has_the_references_shapes_and_stds():
    rc, pc = _cfgs()
    want = jax.tree_util.tree_map(lambda a: a.shape, jax.eval_shape(
        lambda: rern.init_params(rc, jax.random.PRNGKey(0))))
    got = pern.init_params(pc, torch.Generator().manual_seed(0), 'cpu')
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == want
    assert float(got['wte'].std()) == pytest.approx(0.02, rel=0.1)
    assert float(got['blocks']['ln1_g'].min()) == 1.0
    assert float(got['blocks']['qkv_b'].abs().max()) == 0.0


@pytest.fixture(scope='module')
def model_pair():
    rc, pc = _cfgs()
    ref.seed(0)
    rnet = rern.ErnieModel(rc)
    pnet = pern.ErnieModel(pc)
    return rnet, pnet


def test_ernie_model_names_shapes_and_state_dict(model_pair):
    rnet, pnet = model_pair
    rsd, psd = rnet.state_dict(), pnet.state_dict()
    assert list(psd) == list(rsd) == [f'p{i}' for i in range(25)]
    for k in rsd:
        assert list(psd[k].shape) == list(rsd[k].shape)
    missing, unexpected = pnet.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in rsd.items()})
    assert missing == [] and unexpected == []


@pytest.mark.parametrize('masked', [True, False], ids=['mask', 'nomask'])
def test_ernie_model_outputs_match_the_reference(model_pair, masked):
    rnet, pnet = model_pair
    pnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in rnet.state_dict().items()})
    ids, types, mask, _, _ = _batch(3)
    am = mask if masked else None
    want = rnet(ref.to_tensor(ids), ref.to_tensor(types),
                None if am is None else ref.to_tensor(am))
    got = pnet(port.to_tensor(ids), port.to_tensor(types),
               None if am is None else port.to_tensor(am))
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == list(w.shape)
        _close(g.numpy(), w.numpy())


def test_a_reference_pdparams_loads_into_the_port(model_pair, tmp_path):
    rnet, _ = model_pair
    path = str(tmp_path / 'ernie.pdparams')
    ref.save(rnet.state_dict(), path)
    _, pc = _cfgs()
    port.seed(5)
    fresh = pern.ErnieModel(pc)
    fresh.set_state_dict(port.load(path))
    ids, types, mask, _, _ = _batch(4)
    want = rnet(ref.to_tensor(ids), ref.to_tensor(types),
                ref.to_tensor(mask))
    got = fresh(port.to_tensor(ids), port.to_tensor(types),
                port.to_tensor(mask))
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy())


def test_ernie_model_trains_through_autograd(model_pair):
    """The Layer's parameters get gradients (kernels 2 and 3's twin on the
    CPU) and remat changes none of them."""
    _, pnet = model_pair
    ids, types, mask, _, _ = _batch(5)
    grads = []
    for remat in (True, False):
        pnet.config = dataclasses.replace(pnet.config, remat=remat)
        pnet.train()
        for p in pnet.parameters():
            p.clear_gradient()
        h, pooled = pnet(port.to_tensor(ids), port.to_tensor(types),
                         port.to_tensor(mask))
        ((h * h).mean() + pooled.sum()).backward()
        # the MLM and NSP heads are not on the forward: no gradient
        grads.append([None if p.grad is None else p.grad.numpy().copy()
                      for p in pnet.parameters()])
    pnet.config = dataclasses.replace(pnet.config, remat=True)
    assert [a is None for a in grads[0]] == [b is None for b in grads[1]]
    assert sum(a is not None for a in grads[0]) == 19
    for a, b in zip(*grads):
        if a is not None:
            np.testing.assert_allclose(a, b, atol=1e-6)
    assert all(np.abs(g).max() > 0 for g in grads[0] if g is not None)
