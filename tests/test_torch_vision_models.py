"""paddle_tpu_torch.vision.models against the JAX package's, on the CPU.

Each model is built in both packages, the reference's ``state_dict``
carried into the port through numpy: LeNet at [2, 1, 28, 28]; ResNet-18
and -50, VGG-11 (with BatchNorm) and MobileNetV1/V2 at ``scale=0.25`` at
[2, 3, 32, 32]. Logits within 1e-4 in eval mode; in train mode
(BatchNorm on the batch's statistics, at batch 4 and 64 x 64, so that
no BatchNorm normalizes two values; dropout off on both sides: its masks
come from different streams) the logits within 1e-4 and the running
statistics after the call within 1e-5, beyond what the port's own result
moves under a 1e-7 change of its input. The reference's forward is
traced under ``jax.jit`` through its ``functional_call``.

Also: a hapi ``fit`` step of ResNet-18 (Adam) against the
reference's (the loss, the BatchNorm statistics, the parameters beyond
what Adam's epsilon makes of each side's own gradients:
``torch_nn_cases.mlm_agreement``), a ``.pdparams`` the reference's
``paddle.save`` wrote loading into the port with the same logits (and
the reverse), ``flops``, BatchNorm's dtypes under bfloat16 ``auto_cast``,
and ``pretrained=True`` refused.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
import torch_nn_cases as C
from paddle_tpu_torch import device as port_device

LOGIT_TOL = 1e-4
STAT_TOL = 1e-5

MODELS = {
    'lenet': (lambda P: P.vision.models.LeNet(), (2, 1, 28, 28)),
    'resnet18': (lambda P: P.vision.models.resnet18(num_classes=10),
                 (2, 3, 32, 32)),
    'resnet50': (lambda P: P.vision.models.resnet50(num_classes=10),
                 (2, 3, 32, 32)),
    'vgg11_bn': (lambda P: P.vision.models.vgg11(batch_norm=True,
                                                 num_classes=10),
                 (2, 3, 32, 32)),
    'mobilenet_v1': (lambda P: P.vision.models.mobilenet_v1(
        scale=0.25, num_classes=10), (2, 3, 32, 32)),
    'mobilenet_v2': (lambda P: P.vision.models.mobilenet_v2(
        scale=0.25, num_classes=10), (2, 3, 32, 32)),
}


@pytest.fixture(autouse=True, scope='module')
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


def _np_state(net):
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def _dropout_off(P, net):
    for layer in net.sublayers():
        if isinstance(layer, P.nn.Dropout):
            layer.eval()


def _reference_forward(rnet, x):
    """(logits, buffers after) of the reference's forward, traced."""
    params = ref.nn.param_arrays(rnet)
    buffers = ref.nn.buffer_arrays(rnet)
    out, new_b = jax.jit(lambda p, b, v: ref.nn.functional_call(
        rnet, p, b, v))(params, buffers, x)
    return np.asarray(out), {k: np.asarray(v) for k, v in new_b.items()}


@pytest.fixture(scope='module')
def pairs():
    return {}


def _pair(pairs, name):
    if name not in pairs:
        make, shape = MODELS[name]
        ref.seed(0)
        rnet = make(ref)
        pnet = make(port)
        pnet.set_state_dict(_np_state(rnet))
        x = np.random.RandomState(1).randn(*shape).astype('float32')
        pairs.clear()                 # one model's weights held at a time
        pairs[name] = (rnet, pnet, x)
    return pairs[name]


def _train_call(pnet, x):
    """The port's train-mode logits and state after one call; the state
    put back."""
    before = _np_state(pnet)
    out = pnet(port.to_tensor(x)).numpy()
    after = _np_state(pnet)
    pnet.set_state_dict(before)
    return out, after, before


def _held(got, want, tol, sens=0.0):
    """|got - want| over the part's largest value (at least 1) within
    ``tol``, beyond 4 x ``sens``."""
    err = float(np.abs(got - want).max())
    return err <= tol * max(1.0, float(np.abs(want).max())) + 4 * sens, err


@pytest.mark.parametrize('name', list(MODELS))
def test_eval_logits_match_the_reference(name, pairs):
    rnet, pnet, x = _pair(pairs, name)
    for P, net in ((ref, rnet), (port, pnet)):
        net.eval()
    want, _ = _reference_forward(rnet, x)
    got = pnet(port.to_tensor(x)).numpy()
    assert got.shape == want.shape == (2, 10)
    ok, err = _held(got, want, LOGIT_TOL)
    assert ok, err


@pytest.mark.parametrize('name', list(MODELS))
def test_train_logits_and_statistics_match_the_reference(name, pairs):
    """Train mode (BatchNorm on the batch's statistics) at batch 4: the
    logits and the running statistics after the call within 1e-4 and
    1e-5 of the part's largest value, beyond 4 x how far the port's own
    result moves when the input moves by 1e-7 (relative). That
    sensitivity is ~1e-6 but for ResNet-50, whose 53 train-mode
    BatchNorms turn a 1e-7 input change (or another torch thread count)
    into ~1e-4 of its logits."""
    rnet, pnet, _ = _pair(pairs, name)
    shape = (4,) + MODELS[name][1][1:2] + ((28, 28) if name == 'lenet'
                                          else (64, 64))
    x = np.random.RandomState(3).randn(*shape).astype('float32')
    for P, net in ((ref, rnet), (port, pnet)):
        net.train()
        _dropout_off(P, net)
    want, want_b = _reference_forward(rnet, x)
    got, after, before = _train_call(pnet, x)
    nudged = (x * (1 + 1e-7 * np.random.RandomState(4).randn(*shape))) \
        .astype('float32')
    got2, after2, _ = _train_call(pnet, nudged)
    ok, err = _held(got, want, LOGIT_TOL, float(np.abs(got - got2).max()))
    assert ok, (err, float(np.abs(got - got2).max()))
    assert sorted(want_b) == sorted(k for k in after
                                    if k.endswith(('_mean', '_variance')))
    for k, v in want_b.items():
        ok, err = _held(after[k], v, STAT_TOL,
                        float(np.abs(after[k] - after2[k]).max()))
        assert ok, (k, err)
        assert not np.array_equal(after[k], before[k]), k   # they moved


# ---------------------------------------------------------------------------
# hapi: a fit step of ResNet-18
# ---------------------------------------------------------------------------

def _record_reference(opt):
    calls, inner = [], opt.functional_apply

    def apply(params, grads, opt_state, lr=None):
        def store(g, lr_):
            calls.append(({k: np.asarray(v, np.float32)
                           for k, v in g.items()}, float(lr_)))
        jax.debug.callback(store, grads, lr)
        return inner(params, grads, opt_state, lr)
    opt.functional_apply = apply
    return calls


def _fit(P, net, record, xs, ys):
    model = P.Model(net)
    opt = P.optimizer.Adam(1e-3, parameters=net.parameters())
    calls = record(opt)
    model.prepare(opt, P.nn.CrossEntropyLoss(), metrics=P.metric.Accuracy())
    data = P.io.TensorDataset([P.to_tensor(xs), P.to_tensor(ys)])
    np.random.seed(3)
    return C.fit_record(P, model, P.io.DataLoader(data, batch_size=4,
                                                  shuffle=True),
                        1, calls, value=lambda t: np.asarray(
                            t.numpy(), np.float32))


def test_a_fit_step_of_resnet18_matches_the_reference():
    ref.seed(0)
    rnet = ref.vision.models.resnet18(num_classes=10)
    pnet = port.vision.models.resnet18(num_classes=10)
    start = _np_state(rnet)
    pnet.set_state_dict(start)
    rs = np.random.RandomState(4)
    xs = rs.randn(4, 3, 64, 64).astype('float32')
    ys = rs.randint(0, 10, (4, 1)).astype('int64')
    want = _fit(ref, rnet, _record_reference, xs, ys)
    got = _fit(port, pnet, C.record_applies, xs, ys)
    assert len(got[0]) == len(want[0]) == 1
    stats = [k for k in start if k.endswith(('_mean', '_variance'))]
    assert len(stats) == 2 * 20
    for k in stats:
        assert not np.array_equal(got[3][k], start[k]), k   # they moved
        np.testing.assert_allclose(got[3][k], want[3][k], rtol=STAT_TOL,
                                   atol=STAT_TOL, err_msg=k)
    params = {k: v for k, v in start.items() if k not in stats}
    res = C.mlm_agreement(
        (got[0], got[1], got[2], {k: got[3][k] for k in params}),
        (want[0], want[1], want[2], {k: want[3][k] for k in params}),
        params, coeff=0.0, clip_norm=None)
    assert res['ok'], res


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def test_reference_pdparams_loads_into_the_port_with_equal_logits(tmp_path):
    """A .pdparams of resnet18 written by the reference's paddle.save
    (running statistics moved off their start) loads with the port's
    paddle.load: the same names (bn._mean, bn._variance) and logits (eval
    mode); and the reverse, bit for bit."""
    ref.seed(2)
    rnet = ref.vision.models.resnet18()
    rs = np.random.RandomState(5)
    rnet.set_state_dict({
        k: (rs.uniform(0.5, 2.0, v.shape) if k.endswith('_variance')
            else rs.randn(*v.shape) * 0.1).astype('float32')
        for k, v in rnet.state_dict().items()
        if k.endswith(('_mean', '_variance'))})
    rnet.eval()
    path = str(tmp_path / 'resnet18.pdparams')
    ref.save(rnet.state_dict(), path)
    sd = port.load(path)
    pnet = port.vision.models.resnet18()
    assert sorted(sd) == sorted(pnet.state_dict())
    assert 'bn1._mean' in sd and 'layer4.1.bn2._variance' in sd
    pnet.set_state_dict(sd)
    pnet.eval()
    x = np.random.RandomState(6).randn(2, 3, 32, 32).astype('float32')
    want, _ = _reference_forward(rnet, x)
    got = pnet(port.to_tensor(x)).numpy()
    ok, err = _held(got, want, LOGIT_TOL)
    assert ok, err
    back = str(tmp_path / 'port.pdparams')
    port.save(pnet.state_dict(), back)
    loaded = ref.load(back)
    for k, v in rnet.state_dict().items():
        np.testing.assert_array_equal(np.asarray(loaded[k]), v.numpy(), k)


# ---------------------------------------------------------------------------
# flops, amp dtypes, pretrained
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name,shape', [('resnet18', [1, 3, 224, 224]),
                                        ('lenet', [1, 1, 28, 28]),
                                        ('mobilenet_v2', [1, 3, 224, 224])])
def test_flops_equal_the_reference(name, shape):
    make = {'resnet18': lambda P: P.vision.models.resnet18(),
            'lenet': lambda P: P.vision.models.LeNet(),
            'mobilenet_v2': lambda P: P.vision.models.mobilenet_v2(
                scale=0.25)}[name]
    want = ref.flops(make(ref), shape)
    assert want > 0 and port.flops(make(port), shape) == want


def test_batchnorm_under_bfloat16_autocast_keeps_the_reference_dtypes():
    """Conv2D runs in bfloat16 under auto_cast; BatchNorm gives the
    reference's output dtype (bfloat16 activations meet its float32
    statistics), in train and eval mode, and keeps its running
    statistics float32."""
    x = np.random.RandomState(0).randn(2, 3, 8, 8).astype('float32')
    got = {}
    for P in (ref, port):
        P.seed(0)
        conv, bn, fc = P.nn.Conv2D(3, 4, 3), P.nn.BatchNorm2D(4), \
            P.nn.Linear(4, 2)
        dts = []
        for mode in ('train', 'eval'):
            getattr(bn, mode)()
            with P.amp.auto_cast(dtype='bfloat16'):
                c = conv(P.to_tensor(x))
                b = bn(c)
                out = fc(b.mean([2, 3]))
            dts += [str(v.dtype).split('.')[-1] for v in (c, b, out)]
        got[P.__name__] = dts
        assert all(str(v.dtype).endswith('float32')
                   for v in bn.state_dict().values())
    assert got['paddle_tpu_torch'] == got['paddle_tpu']
    assert got['paddle_tpu_torch'][0] == 'bfloat16'


def test_pretrained_weights_are_refused_as_the_reference_refuses_them():
    for P in (ref, port):
        m = P.vision.models
        for fn in (m.resnet18, m.vgg11, m.mobilenet_v1, m.mobilenet_v2):
            with pytest.raises(RuntimeError, match='pretrained'):
                fn(pretrained=True)


def test_the_models_have_the_reference_names_and_sizes():
    for name in ('resnet18', 'mobilenet_v1', 'lenet'):
        make, _ = MODELS[name]
        r, t = make(ref), make(port)
        assert list(t.state_dict()) == list(r.state_dict())
        assert [p.shape for p in t.parameters()] == [
            p.shape for p in r.parameters()]
    assert sum(p.size for p in port.vision.models.resnet50()
               .parameters()) == 25557032
    assert torch.float32 == port.vision.models.LeNet().fc[0].weight.dtype
