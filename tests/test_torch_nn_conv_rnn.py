"""The rest of paddle_tpu_torch.nn (conv, pooling, the functional
extensions, RNNs, decoding and quantization) against the JAX package's,
on the CPU.

Every case of ``torch_nn_cases.J3_CASES`` runs in both packages on the
same numpy inputs, a Layer's weights carried across by ``state_dict``:
outputs and the state after the call within 1e-5, input and parameter
gradients within 1e-4, each over the part's largest value (at least 1);
bfloat16 cases within one bfloat16 rounding (``torch_nn_cases.BF16``).
The reference's cases are traced under one ``jax.jit`` per chunk, its
tape backward included; a case that reads a value back to the host in
the call (``dynamic_decode``, ``sequence_mask`` without ``maxlen``) runs
eagerly.

Also: calibration (post-training quantization and QAT's moving-average
scales) against the reference, ``class_center_sample`` (its own stream:
held to shape and range), the behaviours kept from the reference
(pooling's ignored options, RNNs' ignored ``sequence_length`` and
``dropout``, greedy ``dynamic_decode``, the transposed conv's ignored
``output_size``), the float32 conv route of the card run on the CPU, and
the step-J3 names.
"""
import importlib
import inspect
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.nn.functional import conv as tconv

import torch_nn_cases as C

CHUNK = 60
F32_TOL = (1e-5, 1e-4)


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


def _reference_chunk(cases):
    objs = [C.prepare(ref, c) for c in cases]
    befores = [C.state_of(o) for o, _ in objs]

    def f(all_arrays):
        return [C.forward_backward(ref, c, o, a, value=lambda t: t._value)
                for c, (o, _), a in zip(cases, objs, all_arrays)]
    res = jax.tree_util.tree_map(np.asarray, jax.jit(f)(
        [a for _, a in objs]))
    for r, b in zip(res, befores):
        r['before'] = b
    return res


@pytest.fixture(scope='module')
def reference_results():
    traced = [c for c in C.J3_CASES if not c.eager]
    out = {}
    for i in range(0, len(traced), CHUNK):
        chunk = traced[i:i + CHUNK]
        out.update(zip((c.name for c in chunk), _reference_chunk(chunk)))
    for c in C.J3_CASES:
        if c.eager:
            out[c.name] = C.run(ref, c)
    return out


@pytest.mark.parametrize('case', C.J3_CASES, ids=str)
def test_case_matches_the_reference(case, reference_results):
    want = reference_results[case.name]
    got = C.run(port, case, state=want['before'])
    res = C.compare(got, want, case, *(case.tol or F32_TOL))
    assert res['ok'], res


_J3_MODULES = ('nn.layer_conv', 'nn.layer_pooling', 'nn.layer_rnn',
               'nn.decode', 'nn.quant', 'nn.functional.conv',
               'nn.functional.pooling', 'nn.functional.extension')


def test_the_table_covers_every_step_j3_name():
    """Every public Layer and function of the step-J3 modules, and
    quantization's passes, has a case; class_center_sample (random by
    nature) is held below."""
    used = set()
    for c in C.J3_CASES:
        used |= {part for part in c.name.replace('.', ' ').split()}
        used |= set(c.make.__code__.co_names)
    names = [n for mod in _J3_MODULES
             for n, v in vars(importlib.import_module(
                 f'paddle_tpu_torch.{mod}')).items()
             if not n.startswith('_') and callable(v)
             and getattr(v, '__module__', '') == f'paddle_tpu_torch.{mod}']
    names += ['HSigmoidLoss', 'MaxUnPool2D', 'ImperativeQuantAware',
              'PostTrainingQuantization', 'quantize_weights']
    assert len(names) > 70
    missing = [n for n in names if n not in used
               and n != 'class_center_sample']
    # quant_post_dynamic is PostTrainingQuantization's body
    assert missing == [], missing


# ---------------------------------------------------------------------------
# quantization: calibration against the reference
# ---------------------------------------------------------------------------

def test_post_training_calibration_equals_the_reference():
    """The same seeded conv net calibrated on the same batches: the
    activation scales, int8 banks and weight scales of the converted
    layers equal the reference's, and so do the served logits."""
    r, t = C.ptq_net(ref), C.ptq_net(port)
    rs, ts = C.state_of(r), C.state_of(t)
    assert sorted(rs) == sorted(ts)
    assert any(k.endswith('act_scale') for k in rs)
    for k, v in rs.items():
        if v.dtype == np.int8:
            assert np.abs(ts[k].astype(int) - v.astype(int)).max() <= 1, k
        else:
            np.testing.assert_allclose(ts[k], v, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    x = C.calibration_batches(4)[3]
    np.testing.assert_allclose(t(port.to_tensor(x)).numpy(),
                               r(ref.to_tensor(x)).numpy(), rtol=1e-4,
                               atol=1e-5)
    assert type(t[0]).__name__ == 'WeightOnlyConv2D'
    assert type(t[6]).__name__ == 'WeightOnlyLinear'


def test_qat_moving_average_scales_follow_the_reference():
    """ImperativeQuantAware over the same seeded net, three training
    forwards: the moving-average activation scales after each equal the
    reference's; in eval mode they stay."""
    def run(P):
        net = C.seeded(C._ConvNet(P.nn))
        P.quantization.ImperativeQuantAware(moving_rate=0.5).quantize(net)
        seen = []
        for x in C.calibration_batches(3):
            net(P.to_tensor(x))
            seen.append({k: float(v.numpy()) for k, v in
                         net.state_dict().items() if 'act_scale' in k})
        net.eval()
        net(P.to_tensor(C.calibration_batches(1)[0] * 10))
        seen.append({k: float(v.numpy()) for k, v in
                     net.state_dict().items() if 'act_scale' in k})
        return seen
    got, want = run(port), run(ref)
    assert len(want[0]) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-6 * max(1.0, abs(w[k])), (k, g, w)
    assert got[-1] == got[-2]


def test_quantization_passes_validate_as_the_reference():
    for P in (ref, port):
        with pytest.raises(ValueError):
            P.quantization.ImperativeQuantAware(weight_quantize_type='x')
        with pytest.raises(ValueError):
            P.quantization.ImperativeQuantAware(
                quantizable_layer_type=('Conv2D', 'LSTM'))
        with pytest.raises(TypeError):
            P.quantization.PostTrainingQuantization(P.nn.Linear(2, 2),
                                                    executor=1)
        with pytest.raises(ValueError, match='no calibration batches'):
            P.quantization.quant_post_dynamic(P.nn.Sequential(
                P.nn.Linear(2, 2)))
        with pytest.raises(TypeError):
            P.nn.quant.weight_only_quantize(P.nn.Linear(2, 2),
                                            layer_types=(P.nn.ReLU,))
    # save_quantized_model exports through jit.save: the state, the
    # metadata and the torch.export program, the fake-quant ops traced in
    quanter = port.quantization.ImperativeQuantAware()
    net = quanter.quantize(port.nn.Sequential(port.nn.Linear(2, 2)))
    x = np.array([[0.5, -1.0]], 'float32')
    net(port.to_tensor(x))            # a training step's activation scale
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, 'qat')
        quanter.save_quantized_model(
            net, path, input_spec=[port.static.InputSpec([-1, 2])])
        for ext in ('.pdparams', '.pdmodel', '.pt2'):
            assert os.path.exists(path + ext), ext
        got = port.inference.create_predictor(
            port.inference.Config(path + '.pdmodel')).run([x])[0]
    net.eval()
    np.testing.assert_allclose(got, net(port.to_tensor(x)).numpy(),
                               atol=1e-6)
    assert np.abs(got).max() > 0.01


# ---------------------------------------------------------------------------
# class_center_sample: the port's own stream
# ---------------------------------------------------------------------------

def test_class_center_sample_keeps_the_positives_and_remaps():
    """Every positive class kept, negatives from the rest up to
    num_samples, sorted, the labels remapped into them; a seed repeats
    the draw (the reference draws from numpy: a known difference)."""
    lbl = np.array([11, 3, 3, 17, 0], 'int32')

    def draw(seed):
        port.seed(seed)
        return [a.numpy() for a in port.nn.functional.class_center_sample(
            port.to_tensor(lbl), 20, 8)]
    remapped, sampled = draw(0)
    assert sampled.dtype == np.int32 and remapped.dtype == np.int32
    assert sampled.shape == (8,) and np.all(np.diff(sampled) > 0)
    assert set([0, 3, 11, 17]) <= set(sampled) and sampled.max() < 20
    np.testing.assert_array_equal(sampled[remapped], lbl)
    np.testing.assert_array_equal(draw(0)[1], sampled)
    assert any(not np.array_equal(draw(s)[1], sampled) for s in (1, 2, 3))
    r_remapped, r_sampled = ref.nn.functional.class_center_sample(
        ref.to_tensor(lbl), 20, 8)
    assert r_sampled.shape == [8] and set([0, 3, 11, 17]) <= set(
        r_sampled.numpy())
    # fewer samples than positives: the positives alone
    _, only = port.nn.functional.class_center_sample(port.to_tensor(lbl),
                                                     20, 2)
    np.testing.assert_array_equal(only.numpy(), [0, 3, 11, 17])


# ---------------------------------------------------------------------------
# the reference's behaviour, kept (ROADMAP "Known, deliberate differences")
# ---------------------------------------------------------------------------

def _np(x):
    return np.asarray(x.numpy())


def test_pooling_ignores_ceil_mode_return_mask_and_divisor():
    x = port.to_tensor(np.random.RandomState(0).randn(2, 3, 7, 7)
                       .astype('f4'))
    F = port.nn.functional
    np.testing.assert_array_equal(
        _np(F.max_pool2d(x, 2, ceil_mode=True, return_mask=True)),
        _np(F.max_pool2d(x, 2)))
    np.testing.assert_array_equal(
        _np(F.avg_pool2d(x, 2, ceil_mode=True, divisor_override=3)),
        _np(F.avg_pool2d(x, 2)))
    assert F.max_pool2d(x, 2, ceil_mode=True).shape == [2, 3, 3, 3]


def test_rnns_ignore_sequence_length_and_dropout():
    port.seed(0)
    net = port.nn.LSTM(4, 6, num_layers=2, dropout=0.5)
    x = port.to_tensor(np.random.RandomState(1).randn(3, 5, 4).astype('f4'))
    out, (h, c) = net(x)
    out2, (h2, c2) = net(x, sequence_length=port.to_tensor(
        np.array([2, 5, 1], 'int32')))
    for a, b in ((out, out2), (h, h2), (c, c2)):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_dynamic_decode_is_greedy_whatever_the_beam_size():
    port.seed(0)
    dec_net = C._Decoder(port.nn, 1)
    h = port.to_tensor(np.random.RandomState(2).randn(2, 6).astype('f4'))
    c = port.to_tensor(np.random.RandomState(3).randn(2, 6).astype('f4'))
    ids, scores = dec_net(h, c)
    nn = port.nn
    for beam in (1, 5):
        dec = nn.BeamSearchDecoder(dec_net.cell, 0, 1, beam,
                                   embedding_fn=dec_net.emb,
                                   output_fn=dec_net.out)
        ids_b, scores_b = nn.dynamic_decode(dec, inits=(h, c),
                                            max_step_num=6)
        np.testing.assert_array_equal(_np(ids_b), _np(ids))
        np.testing.assert_array_equal(_np(scores_b), _np(scores))
    assert ids.shape[0] == 2 and ids.dtype == torch.int32


def test_dynamic_decode_stops_when_every_row_ends():
    """The end token on every row stops the loop early."""
    class Cell(port.nn.Layer):
        def forward(self, x, state):
            logits = np.zeros((2, 3), 'float32')
            logits[:, 2] = 1.0
            return port.to_tensor(logits), state
    dec = port.nn.BeamSearchDecoder(Cell(), 0, 2, 1)
    ids, _ = port.nn.dynamic_decode(dec, inits=port.zeros([2, 1]),
                                    max_step_num=9)
    assert ids.shape == [2, 1]


def test_conv_transpose_ignores_output_size():
    F = port.nn.functional
    x = port.to_tensor(np.random.RandomState(0).randn(1, 2, 4, 4)
                       .astype('f4'))
    w = port.to_tensor(np.random.RandomState(1).randn(2, 3, 3, 3)
                       .astype('f4'))
    a = F.conv2d_transpose(x, w, stride=2, output_size=[9, 9])
    np.testing.assert_array_equal(_np(a), _np(F.conv2d_transpose(
        x, w, stride=2)))
    assert a.shape == [1, 3, 9, 9]
    b = port.nn.Conv2DTranspose(2, 3, 3, stride=2)(x, output_size=[10, 10])
    assert b.shape == [1, 3, 9, 9]


def test_conv_transpose_refuses_string_padding_as_the_reference():
    for P in (ref, port):
        x = P.to_tensor(np.ones((1, 2, 4, 4), 'f4'))
        w = P.to_tensor(np.ones((2, 3, 3, 3), 'f4'))
        with pytest.raises(ValueError, match='(?i)string padding'):
            P.nn.functional.conv2d_transpose(x, w, stride=2, padding='SAME')


# ---------------------------------------------------------------------------
# the card's float32 conv route, run on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('transposed', [False, True])
def test_float32_conv_route_equals_autograd_and_restores_the_flag(
        transposed):
    """``_ConvF32`` (what a CUDA float32 conv runs: cuDNN's TF32 off in
    its forward and its backward) gives autograd's conv and gradients;
    ``_no_tf32`` turns ``cudnn.allow_tf32`` off and puts it back."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 6, 7, generator=g, requires_grad=True)
    w = torch.randn((4, 3) if transposed else (3, 4), generator=g)
    w = torch.cat([w[..., None, None]] * 3, -1).expand(
        *w.shape, 3, 3).clone().requires_grad_()
    args = ([2, 1], [1, 0], [1, 2], transposed,
            [1, 0] if transposed else [0, 0], 1)
    out = tconv._ConvF32.apply(x, w, *args)
    want = torch.ops.aten.convolution(x, w, None, *args)
    gy = torch.randn(out.shape, generator=g)
    gx, gw = torch.autograd.grad(out, (x, w), gy)
    wx, ww = torch.autograd.grad(want, (x, w), gy)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(gx, wx, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gw, ww, rtol=1e-6, atol=1e-6)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tconv._no_tf32():
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_float32_conv_on_a_cuda_tensor_takes_the_no_tf32_route(monkeypatch):
    """The route is chosen by the tensor: a CUDA float32 input goes
    through ``_ConvF32``, a CPU one or a bfloat16 one does not."""
    calls = []
    monkeypatch.setattr(tconv._ConvF32, 'apply',
                        staticmethod(lambda *a: calls.append(a) or 0))

    class FakeCuda:
        is_cuda, dtype = True, torch.float32
    tconv._convolution(FakeCuda(), None, (1, 1), (0, 0), (1, 1), False,
                       (0, 0), 1)
    assert len(calls) == 1
    x = torch.randn(1, 1, 4, 4)
    tconv._convolution(x, torch.randn(1, 1, 3, 3), (1, 1), (0, 0), (1, 1),
                       False, (0, 0), 1)
    tconv._convolution(x.bfloat16(), torch.randn(1, 1, 3, 3).bfloat16(),
                       (1, 1), (0, 0), (1, 1), False, (0, 0), 1)
    assert len(calls) == 1


def test_bfloat16_conv_gives_bfloat16():
    F = port.nn.functional
    x = port.to_tensor(np.ones((1, 2, 5, 5), 'f4')).astype('bfloat16')
    w = port.to_tensor(np.ones((3, 2, 3, 3), 'f4')).astype('bfloat16')
    assert F.conv2d(x, w, padding=1).dtype == torch.bfloat16
    with port.amp.auto_cast(dtype='bfloat16'):
        conv = port.nn.Conv2D(2, 3, 3)
        y = conv(port.to_tensor(np.ones((1, 2, 5, 5), 'f4')))
    assert y.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32


# ---------------------------------------------------------------------------
# names
# ---------------------------------------------------------------------------

def test_vision_names_beyond_the_models_raise_citing_step_h():
    v = port.vision
    for obj, args in ((v.transforms.Compose, ([],)), (v.datasets.MNIST, ()),
                      (v.ops.nms, (1,)), (v.set_image_backend, ('pil',)),
                      (v.detection.giou_loss, (1, 2))):
        with pytest.raises(NotImplementedError, match=r'step H \(rest\)'):
            obj(*args)
    r = importlib.import_module('paddle_tpu.vision')
    assert [n for n in dir(r) if not n.startswith('_')
            and not hasattr(v, n)] == []
    assert inspect.ismodule(v.models) and v.resnet50 is v.models.resnet50


# ---------------------------------------------------------------------------
# the reference's tests/test_nn_layers.py conv, pooling and RNN flows
# ---------------------------------------------------------------------------

def test_conv_pooling_and_rnn_flows_of_the_reference_tests():
    paddle, nn = port, port.nn
    x = paddle.randn([2, 3, 8, 8])
    assert nn.Conv2D(3, 6, 3)(x).shape == [2, 6, 6, 6]
    assert nn.Conv2D(3, 6, 3, padding=1)(x).shape == [2, 6, 8, 8]
    assert nn.Conv2D(3, 6, 3, stride=2, padding=1)(x).shape == [2, 6, 4, 4]
    assert nn.Conv2D(3, 3, 3, padding=1, groups=3)(x).shape == [2, 3, 8, 8]
    assert nn.Conv2DTranspose(3, 6, 2, stride=2)(x).shape == [2, 6, 16, 16]
    xn = paddle.randn([2, 8, 8, 3])
    assert nn.Conv2D(3, 6, 3, data_format='NHWC')(xn).shape == [2, 6, 6, 6]
    x1 = paddle.randn([1, 1, 5, 5])
    conv = nn.Conv2D(1, 1, 3, padding=1, bias_attr=False)
    w = np.zeros((1, 1, 3, 3), 'float32')
    w[0, 0, 1, 1] = 1.0
    conv.weight.set_value(w)
    np.testing.assert_allclose(conv(x1).numpy(), x1.numpy(), atol=1e-6)
    xp = paddle.randn([1, 2, 8, 8])
    assert nn.MaxPool2D(2)(xp).shape == [1, 2, 4, 4]
    assert nn.AvgPool2D(2)(xp).shape == [1, 2, 4, 4]
    assert nn.AdaptiveAvgPool2D(1)(xp).shape == [1, 2, 1, 1]
    a = np.arange(16, dtype='float32').reshape(1, 1, 4, 4)
    out = nn.MaxPool2D(2)(paddle.to_tensor(a)).numpy()
    np.testing.assert_allclose(out[0, 0], [[5, 7], [13, 15]])
    cell = nn.LSTMCell(4, 8)
    y, (h, c) = cell(paddle.randn([2, 4]))
    assert y.shape == [2, 8] and h.shape == [2, 8] and c.shape == [2, 8]
    out, h = nn.GRU(4, 8, num_layers=1)(paddle.randn([2, 5, 4]))
    assert out.shape == [2, 5, 8] and h.shape == [1, 2, 8]
