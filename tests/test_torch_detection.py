"""The detection and OCR models of paddle_tpu_torch against the JAX
package's, on the CPU.

Each model is built in both packages, the reference's with weights drawn
by numpy from a seed (``torch_vision_cases.build_seeded``), its state
(BatchNorm's running statistics included) carried into the port through
numpy (``carry_state``), and fed the same seeded inputs:

- ``PPYOLOE(num_classes=4, width=8, reg_max=8)`` at [2, 3, 64, 64] on the
  synthetic boxes of ``examples/train_detection.py``: the eval forward
  within 1e-4, ``decode`` within 1e-5, the train-mode ``loss`` and every
  parameter's gradient within 1e-4; 8 Adam steps lower the loss below 0.9
  of the first, as ``tests/test_detection_train.py`` asserts of the
  reference;
- ``SVTRLite(num_classes=12, dim=32, num_heads=2)`` and
  ``CRNN(num_classes=11)`` at [2, 1, 32, 64] on glyph strips: logits,
  ``nn.CTCLoss`` and the gradients within 1e-4; 6 Adam steps lower the
  CTC loss;
- the served detector (``decode``, the best score, ``nms_static(...,
  unroll=True)``) through ``jit.save`` at 64 x 64: one ``nms_static`` node
  in the ``.pt2`` program whatever the 84 anchors, and the layer-free
  Predictor's outputs equal to the Layer's (``keep`` and ``valid``
  exactly).

The reference's forward, loss and gradients are traced under ``jax.jit``
through its ``functional_call`` (eagerly it compiles each primitive), and
compiled at XLA's lowest CPU optimization level (``FAST_COMPILE``).
"""
import contextlib
import importlib
import os

import jax
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
import torch_vision_cases as V
from paddle_tpu.nn.layer_base import functional_call_method
from paddle_tpu_torch import device as port_device

TOL = 1e-4
DECODE_TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


def _held(got, want, tol):
    got, want = np.asarray(got, 'f8'), np.asarray(want, 'f8')
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


# the reference's traces are compiled with XLA's CPU code generation at
# its lowest optimization level: the same HLO, compiled in ~60% of the time
FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}


def _traced(f, *args):
    """``f(*args)`` under ``jax.jit``, compiled with ``FAST_COMPILE``."""
    return jax.jit(f).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def _reference(rnet, fn, *xs):
    """(fn's value, the gradient of each parameter) of the reference's
    Layer, traced: fn(*Tensors) -> a scalar Tensor."""
    params = ref.nn.param_arrays(rnet)
    buffers = ref.nn.buffer_arrays(rnet)

    def f(p, b, *a):
        out, _ = functional_call_method(rnet, fn, p, b, *a)
        return out
    with _fresh_tables():
        val, grads = _traced(jax.value_and_grad(f), params, buffers, *xs)
    return float(val), {k: np.asarray(v) for k, v in grads.items()}


@contextlib.contextmanager
def _fresh_tables():
    """The reference memoizes interpolation tables as arrays: clear them
    around a trace, so no trace reuses another's."""
    common = importlib.import_module('paddle_tpu.nn.functional.common')
    names = ('_nearest_index', '_area_weights', '_resize_taps')
    for m in names:
        getattr(common, m).cache_clear()
    try:
        yield
    finally:
        for m in names:
            getattr(common, m).cache_clear()


def _port(pnet, fn, *xs):
    for p in pnet.parameters():
        p.clear_grad()
    val = fn(*[port.to_tensor(x) for x in xs])
    val.backward()
    return float(val), {n: p.grad.numpy() for n, p in pnet.named_parameters()
                        if p.grad is not None}


def _grads_held(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        _held(got[k], want[k], tol)


def _pair(make):
    rnet = V.build_seeded(ref, make)
    pnet = make(port)
    V.carry_state(rnet, pnet)
    return rnet, pnet


def _det(P):
    return P.models.PPYOLOE(num_classes=4, width=8, reg_max=8)


@pytest.fixture(scope='module')
def detector():
    rnet, pnet = _pair(_det)
    batch = V.synth_detection_batch(np.random.RandomState(0), 2, 64, 4)
    return rnet, pnet, batch


def test_ppyoloe_forward_and_decode_match_the_reference(detector):
    rnet, pnet, (x, *_) = detector
    for net in (rnet, pnet):
        net.eval()

    def fwd(P, net):
        def run(xt):
            outs = net(xt)
            boxes, scores = net.decode(outs, conf_thresh=0.1)
            return [t for pair in outs for t in pair] + [boxes, scores]
        return run

    params, buffers = (ref.nn.param_arrays(rnet), ref.nn.buffer_arrays(rnet))
    with _fresh_tables():
        want, _ = _traced(lambda p, b, v: functional_call_method(
            rnet, fwd(ref, rnet), p, b, v), params, buffers, x)
    got = [t.numpy() for t in fwd(port, pnet)(port.to_tensor(x))]
    assert len(got) == 8 and got[6].shape == (2, 84, 4)
    for g, w in zip(got[:6], want[:6]):
        _held(g, w, TOL)
    for g, w in zip(got[6:], want[6:]):
        _held(g, w, DECODE_TOL)


def test_ppyoloe_loss_and_grads_match_the_reference(detector):
    rnet, pnet, (x, gb, gl, gm) = detector
    for net in (rnet, pnet):
        net.train()

    def loss_fn(net, P):
        return lambda xt: net.loss(net(xt), P.to_tensor(gb),
                                   P.to_tensor(gl), P.to_tensor(gm))
    want, wgrads = _reference(rnet, loss_fn(rnet, ref), x)
    got, pgrads = _port(pnet, loss_fn(pnet, port), x)
    assert np.isfinite(got)
    _held(got, want, TOL)
    _grads_held(pgrads, wgrads)


def test_ppyoloe_train_lowers_the_loss():
    port.seed(0)
    net = _det(port)
    opt = port.optimizer.Adam(learning_rate=2e-3,
                              parameters=net.parameters())
    x, gb, gl, gm = (port.to_tensor(a) for a in V.synth_detection_batch(
        np.random.RandomState(1), 2, 64, 4))
    losses = []
    for _ in range(8):
        loss = net.loss(net(x), gb, gl, gm)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert all(np.isfinite(v) for v in losses)
    assert losses[-1] < losses[0] * 0.9, losses


OCR = {
    'svtr': lambda P: P.models.SVTRLite(num_classes=12, dim=32, num_heads=2),
    'crnn': lambda P: P.models.CRNN(num_classes=11),
}


def _ctc_fn(P, net, labels, in_len, lab_len):
    ctc = P.nn.CTCLoss(blank=0)

    def run(xt):
        logits = net(xt)
        return ctc(P.transpose(logits, [1, 0, 2]), P.to_tensor(labels),
                   P.to_tensor(in_len), P.to_tensor(lab_len))
    return run


@pytest.mark.parametrize('name', list(OCR))
def test_ocr_logits_ctc_loss_and_grads_match_the_reference(name):
    rnet, pnet = _pair(OCR[name])
    classes = 12 if name == 'svtr' else 11
    x, labels, in_len, lab_len = V.ocr_batch(np.random.RandomState(2), 2, 64,
                                             classes)
    for net in (rnet, pnet):
        net.eval()
    params, buffers = (ref.nn.param_arrays(rnet), ref.nn.buffer_arrays(rnet))
    want, _ = _traced(lambda p, b, v: ref.nn.functional_call(rnet, p, b, v),
                      params, buffers, x)
    got = pnet(port.to_tensor(x)).numpy()
    assert got.shape == (2, 16, classes)
    _held(got, want, TOL)
    for net in (rnet, pnet):
        net.train()
    want, wgrads = _reference(rnet, _ctc_fn(ref, rnet, labels, in_len,
                                            lab_len), x)
    got, pgrads = _port(pnet, _ctc_fn(port, pnet, labels, in_len, lab_len),
                        x)
    assert np.isfinite(got)
    _held(got, want, TOL)
    _grads_held(pgrads, wgrads)


@pytest.mark.parametrize('name', list(OCR))
def test_ocr_train_lowers_the_ctc_loss(name):
    port.seed(3)
    net = OCR[name](port)
    classes = 12 if name == 'svtr' else 11
    opt = port.optimizer.Adam(learning_rate=1e-3,
                              parameters=net.parameters())
    x, labels, in_len, lab_len = V.ocr_batch(np.random.RandomState(4), 2, 64,
                                             classes)
    step = _ctc_fn(port, net, labels, in_len, lab_len)
    losses = []
    for _ in range(6):
        loss = step(port.to_tensor(x))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert all(np.isfinite(v) for v in losses)
    assert losses[-1] < losses[0], losses


class _Served:
    """The reference's served detector (``tests/test_detection_train.py``):
    decode, the best score, nms_static(unroll=True)."""

    @staticmethod
    def make(P, det, max_out=10):
        class Served(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.det = det

            def forward(self, x):
                boxes, scores = self.det.decode(self.det(x))
                best = scores[0].max(axis=-1)
                keep, valid = P.vision.ops.nms_static(
                    boxes[0], best, iou_threshold=0.5, max_out=max_out,
                    unroll=True)
                return boxes, scores, keep, valid
        return Served()


def test_served_detector_exports_nms_as_one_operator(tmp_path, detector):
    import torch
    _, pnet, _ = detector
    pnet.eval()
    served = _Served.make(port, pnet)
    served.eval()
    x = np.random.RandomState(2).rand(1, 3, 64, 64).astype('f4')
    want = [t.numpy() for t in served(port.to_tensor(x))]
    path = os.path.join(tmp_path, 'ppyoloe')
    spec = [port.static.InputSpec(shape=[1, 3, 64, 64], dtype='float32')]
    port.jit.save(served, path, input_spec=spec)
    pred = port.inference.create_predictor(
        port.inference.Config(path + '.pdmodel'))
    # the .pt2 program as the Predictor loaded it (torch.export.load)
    program = pred._exec
    assert isinstance(program, torch.fx.GraphModule)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == 'call_function']
    assert targets.count('paddle_tpu_torch.nms_static.default') == 1
    got = [np.asarray(g) for g in pred.run([x])]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert 0 < int(got[3]) <= 10
    for g, w in zip(got[:2], want[:2]):
        _held(g, w, DECODE_TOL)
