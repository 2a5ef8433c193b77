"""paddle_tpu_torch.optimizer (the eager ``step()``, groups, clipping,
regularizers, the 14 LR schedulers) against the JAX package's, on the CPU.

Each of the ten optimizers runs 5 steps in seven variants (plain, L2, L1,
parameter groups with a scheduler, and each of the three clips) from the
same weights and gradients: the parameters and ``state_dict()`` within
1e-5 of the reference's (over each entry's largest value, at least 1).
The reference's runs of one optimizer are traced in one ``jax.jit`` (its
eager step compiles a fused apply per optimizer instance otherwise). The
schedulers are compared over 50 steps with a ``state_dict`` round trip.
Then the reference's ``tests/test_optimizer.py`` flows, its
``nn.Linear`` GradScaler and O2 tests (``tests/test_amp_bf16.py``) and its
float8 ``auto_cast`` Linear tests (``tests/test_precision.py``) on the
port.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device

OPTIMIZERS = ['SGD', 'Momentum', 'Adam', 'AdamW', 'Adamax', 'Adagrad',
              'Adadelta', 'RMSProp', 'Lamb', 'LarsMomentum']
VARIANTS = ['plain', 'l2', 'l1', 'groups', 'clip_value', 'clip_norm',
            'clip_global']
STEPS = 5
_EXTRA = {'Momentum': dict(use_nesterov=True),
          'RMSProp': dict(centered=True, momentum=0.5),
          'Adagrad': dict(initial_accumulator_value=0.1)}
_NO_WEIGHT_DECAY = ('Lamb', 'LarsMomentum')


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


def _data():
    rng = np.random.RandomState(7)
    w = [rng.randn(4, 3).astype('f4'), rng.randn(3).astype('f4')]
    grads = [[rng.randn(*x.shape).astype('f4') * (i + 1) for x in w]
             for i in range(STEPS)]
    return w, grads


def _make(P, name, ps, variant):
    """The optimizer of one variant over Parameters ``ps`` -> (optimizer,
    scheduler or None)."""
    cls = getattr(P.optimizer, name)
    kw = dict(_EXTRA.get(name, {}), learning_rate=0.05)
    R, nn = P.regularizer, P.nn
    sched = None
    if variant in ('l2', 'l1'):
        reg = (R.L2Decay if variant == 'l2' else R.L1Decay)(0.03)
        if name in _NO_WEIGHT_DECAY:
            return cls(parameters=[{'params': ps, 'weight_decay': reg}],
                       **kw), None
        kw['weight_decay'] = reg
    elif variant == 'groups':
        sched = P.optimizer.lr.StepDecay(0.05, step_size=2, gamma=0.5)
        kw['learning_rate'] = sched
        return cls(parameters=[
            {'params': [ps[0]], 'learning_rate': 0.5,
             'weight_decay': R.L2Decay(0.1)},
            {'params': [ps[1]], 'weight_decay': None,
             'grad_clip': nn.ClipGradByValue(0.2)}], **kw), sched
    elif variant.startswith('clip'):
        kw['grad_clip'] = {'clip_value': nn.ClipGradByValue(0.4, -0.3),
                           'clip_norm': nn.ClipGradByNorm(0.8),
                           'clip_global': nn.ClipGradByGlobalNorm(1.5)}[
                               variant]
    return cls(parameters=ps, **kw), sched


def _steps(P, name, variant, w, grads, value):
    """STEPS eager steps; each step's gradients set by backward() of
    sum(p * G) -> (params, state_dict) through ``value``."""
    ps = [P.nn.Parameter(x) for x in w]
    opt, sched = _make(P, name, ps, variant)
    for g in grads:
        loss = sum((p * P.to_tensor(gg)).sum() for p, gg in zip(ps, g))
        loss.backward()
        opt.step()
        opt.clear_grad()
        if sched is not None:
            sched.step()
    sd = {k: value(v) for k, v in opt.state_dict().items()
          if k != 'LR_Scheduler'}
    return [value(p) for p in ps], sd


_runnable = [(n, v) for n in OPTIMIZERS for v in VARIANTS]


@pytest.fixture(scope='module')
def reference_runs():
    w, grads = _data()
    # every run in one jax.jit: one compile, ~2 s less than one a class
    res = jax.jit(lambda gs: [
        _steps(ref, n, v, w, gs, lambda t: t._value)
        for n, v in _runnable])(grads)
    return {nv: jax.tree_util.tree_map(np.asarray, r)
            for nv, r in zip(_runnable, res)}


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize('name,variant', _runnable,
                         ids=[f'{n}-{v}' for n, v in _runnable])
def test_five_steps_match_the_reference(name, variant, reference_runs):
    w, grads = _data()
    (tp, tsd) = _steps(port, name, variant, w, grads,
                       lambda t: t.numpy())
    (rp, rsd) = reference_runs[(name, variant)]
    for a, b in zip(tp, rp):
        _close(a, b)
        assert not np.allclose(a, w[0] if a.shape == w[0].shape else w[1])
    assert sorted(tsd) == sorted(rsd)
    assert bool(tsd) is (name != 'SGD')
    for k in rsd:
        _close(tsd[k], rsd[k])


def test_functional_apply_clips_as_the_reference_does():
    """The train steps' path: grad_clip over all the gradients, then the
    update; in place on the port."""
    w, grads = _data()
    tree = {'w': w[0], 'blocks': {'b': w[1]}}
    for clip in ('ClipGradByGlobalNorm', 'ClipGradByNorm',
                 'ClipGradByValue'):
        jo = ref.optimizer.AdamW(learning_rate=0.05, weight_decay=0.02,
                                 grad_clip=getattr(ref.nn, clip)(0.5))
        to = port.optimizer.AdamW(learning_rate=0.05, weight_decay=0.02,
                                  grad_clip=getattr(port.nn, clip)(0.5))
        jp = jax.tree_util.tree_map(jax.numpy.asarray, tree)
        tp = jax.tree_util.tree_map(torch.from_numpy, tree)
        tp = {'w': tp['w'].clone(), 'blocks': {'b': tp['blocks']['b'].clone()}}
        js, ts = jo.functional_init(jp), to.functional_init(tp)
        for g in grads:
            gt = {'w': g[0], 'blocks': {'b': g[1]}}
            jp, js = jo.functional_apply(
                jp, jax.tree_util.tree_map(jax.numpy.asarray, gt), js)
            tp2, _ = to.functional_apply(
                tp, {'blocks': {'b': torch.from_numpy(g[1])},
                     'w': torch.from_numpy(g[0])}, ts)
            assert tp2 is tp
        _close(tp['w'].numpy(), np.asarray(jp['w']))
        _close(tp['blocks']['b'].numpy(), np.asarray(jp['blocks']['b']))
        _close(ts['w']['moment2'].numpy(), np.asarray(js['w']['moment2']))


def test_accepted_knobs_change_nothing_as_in_the_reference():
    """AdamW's lr_ratio / apply_decay_param_fun, Lamb's
    exclude_from_weight_decay_fn and Lars' exclude_from_weight_decay are
    stored and not read, in the reference and in the port."""
    w, grads = _data()
    knobs = {'AdamW': dict(lr_ratio=lambda p: 0.0,
                           apply_decay_param_fun=lambda n: False),
             'Lamb': dict(exclude_from_weight_decay_fn=lambda p: True),
             'LarsMomentum': dict(exclude_from_weight_decay=['w'])}
    for name, kw in knobs.items():
        for P in (ref, port):
            runs = []
            for extra in ({}, kw):
                ps = [P.nn.Parameter(x) for x in w]
                opt = getattr(P.optimizer, name)(learning_rate=0.05,
                                                 parameters=ps, **extra)
                for g in grads[:2]:
                    sum((p * P.to_tensor(gg)).sum()
                        for p, gg in zip(ps, g)).backward()
                    opt.step()
                    opt.clear_grad()
                runs.append([p.numpy() for p in ps])
            for a, b in zip(*runs):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the 14 schedulers
# ---------------------------------------------------------------------------

SCHEDULERS = [
    ('NoamDecay', dict(d_model=64, warmup_steps=10, learning_rate=2.0)),
    ('PiecewiseDecay', dict(boundaries=[5, 20], values=[0.1, 0.05, 0.01])),
    ('NaturalExpDecay', dict(learning_rate=0.1, gamma=0.05)),
    ('InverseTimeDecay', dict(learning_rate=0.1, gamma=0.2)),
    ('PolynomialDecay', dict(learning_rate=0.1, decay_steps=20,
                             power=2.0, cycle=True)),
    ('LinearWarmup', dict(learning_rate=None, warmup_steps=10,
                          start_lr=0.0, end_lr=0.1)),
    ('ExponentialDecay', dict(learning_rate=0.1, gamma=0.9)),
    ('MultiStepDecay', dict(learning_rate=0.1, milestones=[3, 9, 30])),
    ('StepDecay', dict(learning_rate=0.1, step_size=7, gamma=0.5)),
    ('LambdaDecay', dict(learning_rate=0.1, lr_lambda=lambda e: 0.97 ** e)),
    ('MultiplicativeDecay', dict(learning_rate=0.1,
                                 lr_lambda=lambda e: 0.95)),
    ('CosineAnnealingDecay', dict(learning_rate=0.1, T_max=15,
                                  eta_min=0.01)),
    ('ReduceOnPlateau', dict(learning_rate=0.1, patience=2, cooldown=1,
                             factor=0.5)),
    ('CyclicLR', dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=4, step_size_down=6,
                      mode='triangular2')),
    ('OneCycleLR', dict(max_learning_rate=0.1, total_steps=40)),
]
_METRICS = [1.0, 0.9, 0.9, 0.95, 0.97, 0.99, 0.8, 0.85, 0.9, 0.9] * 5


def _sched(P, name, kw):
    kw = dict(kw)
    if name == 'LinearWarmup':
        kw['learning_rate'] = P.optimizer.lr.PolynomialDecay(
            0.1, decay_steps=30)
    return getattr(P.optimizer.lr, name)(**kw)


def _drive(s, name, steps, start=0):
    vals = []
    for i in range(start, start + steps):
        vals.append(s())
        if name == 'ReduceOnPlateau':
            s.step(_METRICS[i])
        else:
            s.step()
    return vals


@pytest.mark.parametrize('name,kw', SCHEDULERS, ids=[n for n, _ in
                                                     SCHEDULERS])
def test_scheduler_matches_the_reference_over_50_steps(name, kw):
    want = _drive(_sched(ref, name, kw), name, 50)
    got = _drive(_sched(port, name, kw), name, 50)
    np.testing.assert_allclose(got, want, rtol=1e-12)

    def round_trip(P):
        """25 steps, state_dict into a fresh scheduler, 25 more."""
        s = _sched(P, name, kw)
        _drive(s, name, 25)
        t = _sched(P, name, kw)
        t.set_state_dict(s.state_dict())
        if name == 'LinearWarmup':
            t.lr.set_state_dict(s.lr.state_dict())
        assert t.state_dict() == s.state_dict()
        return _drive(t, name, 25, 25)
    got, rwant = round_trip(port), round_trip(ref)
    np.testing.assert_allclose(got, rwant, rtol=1e-12)
    if name != 'MultiplicativeDecay':
        # (its running product is not in the reference's state either)
        np.testing.assert_allclose(got, want[25:], rtol=1e-12)


# ---------------------------------------------------------------------------
# the reference's tests/test_optimizer.py flows
# ---------------------------------------------------------------------------

def _quadratic(P, name, lr, steps, **kw):
    target = np.array([3.0, -2.0], 'float32')
    p = P.nn.Parameter(np.zeros(2, 'float32'))
    opt = getattr(P.optimizer, name)(learning_rate=lr, parameters=[p], **kw)
    errs = []
    for _ in range(steps):
        loss = ((p - P.to_tensor(target)) ** 2).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        errs.append(np.abs(p.numpy() - target).max())
    return np.array(errs)


@pytest.mark.parametrize('name,lr,steps', [
    ('SGD', 0.1, 150), ('Momentum', 0.05, 150), ('Adam', 0.2, 150),
    ('AdamW', 0.2, 150), ('Adamax', 0.3, 150), ('Adagrad', 0.9, 150),
    ('RMSProp', 0.05, 150), ('Adadelta', 30.0, 400), ('Lamb', 0.1, 150)])
def test_converges(name, lr, steps):
    errs = _quadratic(port, name, lr, steps)
    if name != 'Lamb':
        assert errs[-1] < 0.2, f'{name} err={errs[-1]}'
        return
    # Lamb at lr 0.1 reaches the optimum and then circles it (its step is
    # lr * trust ~ 0.1 x |p|), so where it stands at step 150 depends on
    # rounding: XLA's fused update rounds one ulp apart from the same ops
    # one at a time (the reference's eager jnp ops equal the port's). The
    # port follows the reference's path for 90 steps, passes 0.2 at the
    # same step, and both circle alike after.
    want = _quadratic(ref, name, lr, steps)
    np.testing.assert_allclose(errs[:90], want[:90], atol=1e-4)
    assert errs.min() < 0.2
    assert np.argmax(errs < 0.2) == np.argmax(want < 0.2)
    for e in (errs, want):
        assert e[-60:].max() < 0.7 and e[-60:].mean() < 0.3, e[-60:]


def test_weight_decay_and_clip():
    p = port.nn.Parameter(np.ones(2, 'float32') * 10)
    opt = port.optimizer.SGD(learning_rate=0.1, parameters=[p],
                             weight_decay=0.5,
                             grad_clip=port.nn.ClipGradByGlobalNorm(0.001))
    p.sum().backward()
    opt.step()
    assert p.numpy()[0] < 10 - 0.1 * 0.5 * 10 + 0.01


def test_lr_scheduler_values():
    lr = port.optimizer.lr
    s = lr.StepDecay(learning_rate=1.0, step_size=2, gamma=0.1)
    vals = []
    for _ in range(5):
        vals.append(s())
        s.step()
    assert np.allclose(vals, [1.0, 1.0, 0.1, 0.1, 0.01])
    s = lr.MultiStepDecay(1.0, milestones=[2, 4], gamma=0.5)
    vals = [s()]
    for _ in range(4):
        s.step()
        vals.append(s())
    assert np.allclose(vals, [1.0, 1.0, 0.5, 0.5, 0.25])
    s = lr.CosineAnnealingDecay(1.0, T_max=10)
    assert abs(s() - 1.0) < 1e-6
    for _ in range(10):
        s.step()
    assert abs(s()) < 1e-6
    s = lr.NoamDecay(d_model=128, warmup_steps=10, learning_rate=1.0)
    s.step()
    assert all(s() > 0 for _ in range(3))
    s = lr.LinearWarmup(0.5, warmup_steps=5, start_lr=0.0, end_lr=0.5)
    assert s() == 0.0
    for _ in range(5):
        s.step()
    assert abs(s() - 0.5) < 1e-9
    s = lr.PiecewiseDecay([2, 5], [0.1, 0.01, 0.001])
    seq = []
    for _ in range(6):
        seq.append(s())
        s.step()
    assert np.allclose(seq, [0.1, 0.1, 0.01, 0.01, 0.01, 0.001])


def test_scheduler_with_optimizer_and_set_lr():
    p = port.nn.Parameter(np.ones(2, 'float32'))
    sched = port.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    opt = port.optimizer.SGD(learning_rate=sched, parameters=[p])
    assert opt.get_lr() == 0.1
    sched.step()
    assert opt.get_lr() == 0.05
    opt.set_lr(0.3)
    assert opt.get_lr() == 0.3
    p.sum().backward()
    opt.step()
    np.testing.assert_allclose(p.numpy(), 0.7, rtol=1e-6)


def test_state_dict_roundtrip():
    p = port.nn.Parameter(np.ones(3, 'float32'))
    sched = port.optimizer.lr.ExponentialDecay(0.1, gamma=0.5)
    opt = port.optimizer.Adam(parameters=[p], learning_rate=sched)
    p.sum().backward()
    opt.step()
    sched.step()
    sd = opt.state_dict()
    assert sd['LR_Scheduler'] == sched.state_dict()
    assert isinstance(sd['param_0.moment1'], port.Tensor)
    sched2 = port.optimizer.lr.ExponentialDecay(0.1, gamma=0.5)
    opt2 = port.optimizer.Adam(parameters=[p], learning_rate=sched2)
    opt2.set_state_dict(sd)
    assert sched2.last_epoch == 1 and opt2.get_lr() == opt.get_lr()
    for k in ('moment1', 'moment2', 'beta1_pow'):
        np.testing.assert_array_equal(opt2._states[id(p)][k].numpy(),
                                      opt._states[id(p)][k].numpy())
    assert opt2._states[id(p)]['moment1'] is not opt._states[id(p)][
        'moment1']


def test_minimize_and_clear_grad():
    p = port.nn.Parameter(np.ones(2, 'float32'))
    opt = port.optimizer.SGD(learning_rate=0.1, parameters=[p])
    loss = (p * p).sum()
    _, pg = opt.minimize(loss)          # no gradient yet: runs backward
    np.testing.assert_allclose(p.numpy(), 0.8, rtol=1e-6)
    assert p.grad is None and pg[0][0] is p
    loss = (p * p).sum()
    loss.backward()
    opt.minimize(loss)                  # collects the existing gradient
    np.testing.assert_allclose(p.numpy(), 0.64, rtol=1e-6)


def test_a_step_updates_in_place_and_keeps_a_trainable_leaf():
    """The update is in place on each Parameter's leaf, as torch.optim and
    Paddle update (the reference rebinds a new array): a detached view
    sees it, a graph kept past its backward refers to the same leaf and so
    keeps no copy of the old weights; a model loaded from another's
    state dict, a Parameter made from a tensor and one given a value by
    ``set_value`` each own their storage, so stepping one leaves the
    other alone; a frozen Parameter is not stepped."""
    import gc
    lin = port.nn.Linear(3, 2)
    held = lin.weight.detach()
    leaf = lin.weight._value
    before = held.numpy().copy()
    opt = port.optimizer.Momentum(learning_rate=0.1,
                                  parameters=lin.parameters())
    kept = []

    def live():
        gc.collect()
        return sum(type(o) is torch.Tensor and o.shape == (3, 2)
                   for o in gc.get_objects())
    for i in range(4):
        loss = lin(port.ones([4, 3])).sum()
        loss.backward()
        kept.append(loss)
        opt.step()
        opt.clear_grad()
        if i == 1:
            n = live()
    assert live() == n                  # the kept graphs hold no copies
    w = lin.weight
    assert w._value is leaf and w._value.requires_grad
    np.testing.assert_array_equal(held.numpy(), w.numpy())
    assert not np.array_equal(w.numpy(), before)
    m, m2 = port.nn.Linear(3, 2), port.nn.Linear(3, 2)
    m2.set_state_dict(m.state_dict())
    m_before = {k: v.numpy().copy() for k, v in m.state_dict().items()}
    opt = port.optimizer.SGD(learning_rate=0.5, parameters=m2.parameters())
    m2(port.ones([4, 3])).sum().backward()
    opt.step()
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), m_before[k])
        assert not np.array_equal(m2.state_dict()[k].numpy(), m_before[k])
    src = port.ones([2])
    a = port.nn.Parameter(src)
    b = port.nn.Parameter(np.zeros(2, 'f4'))
    b.set_value(a)
    opt = port.optimizer.SGD(learning_rate=0.5, parameters=[
        {'params': [a], 'learning_rate': 1.0}, {'params': [b]}])
    (a.sum() + 2 * b.sum()).backward()
    opt.step()
    np.testing.assert_array_equal(a.numpy(), [0.5, 0.5])
    np.testing.assert_array_equal(b.numpy(), [0.0, 0.0])
    np.testing.assert_array_equal(src.numpy(), [1.0, 1.0])
    frozen = port.nn.Linear(3, 2, weight_attr=port.ParamAttr(
        trainable=False))
    f0 = frozen.weight.numpy().copy()
    opt = port.optimizer.SGD(parameters=frozen.parameters())
    frozen(port.ones([1, 3])).sum().backward()
    opt.step()
    np.testing.assert_array_equal(frozen.weight.numpy(), f0)


def test_gradscaler_over_a_parameter():
    p = port.nn.Parameter(np.ones(2, 'float32'))
    opt = port.optimizer.SGD(learning_rate=0.1, parameters=[p])
    scaler = port.amp.GradScaler(init_loss_scaling=4.0)
    scaler.scale((p * p).sum()).backward()
    scaler.step(opt)
    assert np.allclose(p.numpy(), 0.8, atol=1e-5)


def test_parameter_groups():
    p1 = port.nn.Parameter(np.ones(4, 'float32'))
    p2 = port.nn.Parameter(np.ones(4, 'float32'))
    opt = port.optimizer.SGD(learning_rate=0.1, parameters=[
        {'params': [p1], 'learning_rate': 0.5}, {'params': [p2]}])
    (p1.sum() + p2.sum()).backward()
    opt.step()
    opt.clear_grad()
    np.testing.assert_allclose(p1.numpy(), 1 - 0.05, atol=1e-6)
    np.testing.assert_allclose(p2.numpy(), 1 - 0.1, atol=1e-6)


def _two_linears(share=True):
    l1 = port.nn.Linear(4, 4, bias_attr=False)
    l2 = port.nn.Linear(4, 4, bias_attr=False)
    if share:
        l2.weight.set_value(l1.weight)      # identical start, a copy
    return l1, l2


def _zero_grads(*layers, scale=1.0):
    for l in layers:
        (l(port.to_tensor(np.zeros((2, 4), 'float32'))) * scale).sum(
        ).backward()


def test_parameter_groups_weight_decay():
    l1, l2 = _two_linears()
    opt = port.optimizer.SGD(learning_rate=0.1, parameters=[
        {'params': l1.parameters(), 'weight_decay': 0.5},
        {'params': l2.parameters()}])
    _zero_grads(l1, l2)
    opt.step()
    assert np.abs(l1.weight.numpy()).sum() < np.abs(l2.weight.numpy()).sum()


def test_adamw_group_decay_exemption():
    l1, l2 = _two_linears()
    w0 = l1.weight.numpy().copy()
    opt = port.optimizer.AdamW(learning_rate=0.1, weight_decay=0.5,
                               parameters=[{'params': l1.parameters()},
                                           {'params': l2.parameters(),
                                            'weight_decay': 0.0}])
    _zero_grads(l1, l2, scale=0)
    opt.step()
    np.testing.assert_array_equal(l2.weight.numpy(), w0)
    np.testing.assert_allclose(l1.weight.numpy(), w0 * (1 - 0.1 * 0.5),
                               rtol=1e-6)


def test_none_and_int_zero_group_decay_are_overrides():
    l1, l2 = _two_linears(share=False)
    b1, b2 = l1.weight.numpy().copy(), l2.weight.numpy().copy()
    opt = port.optimizer.AdamW(learning_rate=0.1, weight_decay=0.5,
                               parameters=[{'params': l1.parameters(),
                                            'weight_decay': None},
                                           {'params': l2.parameters()}])
    _zero_grads(l1, l2, scale=0)
    opt.step()
    np.testing.assert_array_equal(l1.weight.numpy(), b1)
    np.testing.assert_allclose(l2.weight.numpy(), b2 * (1 - 0.1 * 0.5),
                               rtol=1e-6)
    for wd in (None, 0):
        l3 = port.nn.Linear(4, 4, bias_attr=False)
        b3 = l3.weight.numpy().copy()
        opt = port.optimizer.SGD(learning_rate=0.1, weight_decay=0.01,
                                 parameters=[{'params': l3.parameters(),
                                              'weight_decay': wd}])
        _zero_grads(l3, scale=0)
        opt.step()
        np.testing.assert_array_equal(l3.weight.numpy(), b3)


# ---------------------------------------------------------------------------
# amp over nn.Linear (tests/test_amp_bf16.py, tests/test_precision.py)
# ---------------------------------------------------------------------------

def _quad_net():
    net = port.nn.Linear(4, 4)
    x = port.to_tensor(np.random.RandomState(0).rand(8, 4).astype('f4'))
    return net, x


def test_gradscaler_skips_step_on_inf_grads():
    net, x = _quad_net()
    opt = port.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    scaler = port.amp.GradScaler(init_loss_scaling=1024.0,
                                 decr_every_n_nan_or_inf=1)
    w_before = net.weight.numpy().copy()
    scaler.scale(net(x).mean()).backward()
    net.weight.grad = torch.full_like(net.weight.grad._value, float('inf'))
    scaler.step(opt)
    opt.clear_grad()
    np.testing.assert_array_equal(net.weight.numpy(), w_before)
    assert scaler.get_loss_scaling() == 512.0


def test_gradscaler_steps_and_grows_on_finite_grads():
    net, x = _quad_net()
    opt = port.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    scaler = port.amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                                 incr_ratio=2.0)
    w_before = net.weight.numpy().copy()
    for _ in range(2):
        scaler.scale(net(x).mean()).backward()
        scaler.step(opt)
        opt.clear_grad()
    assert not np.allclose(net.weight.numpy(), w_before)
    assert scaler.get_loss_scaling() == 16.0


def test_gradscaler_unscales_before_apply():
    xv = np.random.RandomState(1).rand(8, 4).astype('float32')

    def train(scaling):
        port.seed(7)
        net = port.nn.Linear(4, 2)
        opt = port.optimizer.SGD(learning_rate=0.1,
                                 parameters=net.parameters())
        scaler = port.amp.GradScaler(init_loss_scaling=scaling,
                                     use_dynamic_loss_scaling=False)
        scaler.scale(net(port.to_tensor(xv)).mean()).backward()
        scaler.step(opt)
        return net.weight.numpy()

    np.testing.assert_allclose(train(1.0), train(4096.0), rtol=1e-5)


def test_o2_eager_full_training_step():
    nn = port.nn
    net = nn.Linear(8, 8)
    sched = port.optimizer.lr.CosineAnnealingDecay(learning_rate=0.1,
                                                   T_max=10)
    opt = port.optimizer.AdamW(learning_rate=sched,
                               grad_clip=nn.ClipGradByGlobalNorm(1.0),
                               parameters=net.parameters())
    scaler = port.amp.GradScaler(init_loss_scaling=1024)
    x = port.to_tensor(np.random.RandomState(0).rand(4, 8).astype('f4'))
    losses = []
    for _ in range(3):
        with port.amp.auto_cast(level='O2'):
            out = net(x)
            assert 'bfloat16' in str(out.dtype)
            loss = (out.astype('float32') ** 2).mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_auto_cast_float8_runs_and_restores():
    net = port.nn.Linear(8, 4)
    x = port.to_tensor(np.random.RandomState(0).randn(2, 8).astype('f4'))
    with port.amp.auto_cast(dtype='float8'):
        y = net(x)
        assert port.amp.amp_state()['fp8']
    assert str(y.dtype) == 'torch.bfloat16'
    assert not port.amp.amp_state()['fp8']
    with pytest.raises(ValueError, match='dtype'):
        with port.amp.auto_cast(dtype='int8'):
            pass


def test_auto_cast_float8_grads_flow():
    net = port.nn.Linear(8, 4)
    x = port.to_tensor(np.ones((2, 8), 'float32'), stop_gradient=False)
    with port.amp.auto_cast(dtype='float8'):
        loss = net(x).sum()
    loss.backward()
    assert x.grad is not None and net.weight.grad is not None


def test_decorate_o2_casts_the_layers_parameters():
    net = port.nn.Sequential(port.nn.Linear(4, 4), port.nn.LayerNorm(4))
    port.amp.decorate(net, level='O2')
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    opt = port.optimizer.Adam(learning_rate=0.01,
                              parameters=net.parameters())
    net(port.ones([2, 4]).astype('bfloat16')).sum().backward()
    opt.step()
    assert all(p.dtype == torch.bfloat16 and p._value.is_leaf
               for p in net.parameters())
