"""paddle_tpu_torch.vision.ops and vision.detection against the JAX
package's, on the CPU.

The vision ops (``roi_align``, ``psroi_pool``, ``yolo_box``,
``box_coder``, ``deform_conv2d``, ``yolo_loss``) on the seeded inputs of
``torch_vision_cases.op_cases`` within 1e-5 of the part's largest value;
the detection losses, ``dfl_decode``, ``anchor_points`` and the
task-aligned assigner on seeded inputs (the assigner's labels and
foreground exact); NMS, ``nms`` and ``nms_static``, exactly equal to the
reference's over ``torch_vision_cases.nms_cases`` (ties, categories,
``max_out`` below and above the count, dense overlap, and 2,100 boxes
against the reference's ``fori_loop`` sweep); ``nms_static`` as one
operator with a fake implementation, and a CUDA tensor refused without a
card.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
import torch_vision_cases as V
from paddle_tpu.nn.layer_base import functional_call_method
from paddle_tpu.vision import detection as RD
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.ops import nms as port_nms
from paddle_tpu_torch.vision import detection as PD

OP_TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return np.asarray(x.numpy() if hasattr(x, 'numpy') else x)


def _close(got, want, tol):
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        assert g.shape == w.shape, (g.shape, w.shape)
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g.astype('f8') - w.astype('f8')).max())
        assert err <= tol * scale, (err, scale)


OPS = V.op_cases()


def _tensors(P, args, kw):
    """Float arrays as each package's Tensors, the rest as they are."""
    t = (lambda a: P.to_tensor(a) if isinstance(a, np.ndarray)   # noqa: E731
         and a.dtype == np.float32 else a)
    return [t(a) for a in args], {k: t(v) for k, v in kw.items()}


def _reference_traced(fn, args, kw):
    """The reference's op traced once under ``jax.jit``, its array
    arguments traced and the rest (sizes, anchor lists) fixed."""
    pure = getattr(fn, 'pure', None) or (
        lambda *a, **k: fn(*a, **k)._value)
    slots = [(i, a) for i, a in enumerate(args) if isinstance(a, np.ndarray)]
    kslots = [(k, v) for k, v in kw.items() if isinstance(v, np.ndarray)]

    def f(arrs, karrs):
        a = list(args)
        for (i, _), v in zip(slots, arrs):
            a[i] = v
        k = dict(kw, **dict(zip([n for n, _ in kslots], karrs)))
        return pure(*a, **k)
    out = jax.jit(f)([a for _, a in slots], [v for _, v in kslots])
    return _np(list(out) if isinstance(out, tuple) else out)


@pytest.mark.parametrize('case', list(OPS))
def test_vision_op_matches_the_reference(case):
    fn, args, kw = OPS[case]
    want = _reference_traced(getattr(ref.vision.ops, fn), args, kw)
    args, kw = _tensors(port, args, kw)
    got = _np(getattr(port.vision.ops, fn)(*args, **kw))
    _close(got, want, OP_TOL)


def test_deform_conv2d_layer_and_its_grads():
    """DeformConv2D with the reference's weights: output and the input's
    and weight's gradients within 1e-5."""
    _, (x, off, w), kw = OPS['deform_conv2d']
    rl = V.build_seeded(ref, lambda P: P.vision.ops.DeformConv2D(4, 6, 3))
    pl = port.vision.ops.DeformConv2D(4, 6, 3)
    V.carry_state(rl, pl)

    def f(params, xv):       # the reference's layer, traced once
        y, _ = functional_call_method(
            rl, lambda xt: rl(xt, ref.to_tensor(off)), params,
            ref.nn.buffer_arrays(rl), xv)
        return (y * y).sum(), y
    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(ref.nn.param_arrays(rl), x)
    want = [_np(y), _np(gx), _np(gp['weight'])]
    xt = port.to_tensor(x, stop_gradient=False)
    y = pl(xt, port.to_tensor(off))
    (y * y).sum().backward()
    got = [_np(y), _np(xt.grad), _np(pl.weight.grad)]
    for g, w_ in zip(got, want):
        _close(g, w_, OP_TOL)


def test_detection_losses_and_decode_match_the_reference():
    rng = np.random.RandomState(2)
    pred = V.random_boxes(rng, 50)
    tgt = V.random_boxes(rng, 50)
    logits = rng.randn(50, 6).astype('f4') * 2
    score = np.where(rng.rand(50, 6) < 0.2, rng.rand(50, 6), 0).astype('f4')
    dist = rng.randn(50, 4, 9).astype('f4') * 2
    t = (rng.rand(50, 4) * 8).astype('f4')
    jit = jax.jit        # the reference's functions, traced once each
    pairs = [
        (jit(RD.pairwise_iou)(pred[:20], tgt),
         PD.pairwise_iou(pred[:20], tgt)),
        (jit(RD.giou_loss)(pred, tgt), PD.giou_loss(pred, tgt)),
        (jit(RD.varifocal_loss)(logits, score),
         PD.varifocal_loss(logits, score)),
        (jit(RD.distribution_focal_loss)(dist[:, 0], t[:, 0]),
         PD.distribution_focal_loss(dist[:, 0], t[:, 0])),
        (jit(RD.dfl_decode)(dist), PD.dfl_decode(dist)),
    ]
    for (rp, rs), (pp, ps) in [(RD.anchor_points([(4, 6), (2, 3)], [8, 16]),
                                PD.anchor_points([(4, 6), (2, 3)], [8, 16]))]:
        pairs += [(rp, pp), (rs, ps)]
    for want, got in pairs:
        _close(_np(got), np.asarray(want), OP_TOL)


def test_task_aligned_assign_matches_the_reference_batched_and_single():
    """One image and a batch of 3 (the port's leading dims against the
    reference's per image): foreground and labels exact, boxes and quality
    targets within 1e-5."""
    rng = np.random.RandomState(3)
    pts, _ = RD.anchor_points([(8, 8), (4, 4)], [8, 16])
    pts = np.asarray(pts)
    A, C, M, B = pts.shape[0], 5, 4, 3
    scores = rng.rand(B, A, C).astype('f4')
    boxes = np.concatenate([pts - rng.uniform(2, 20, (B, A, 2)),
                            pts + rng.uniform(2, 20, (B, A, 2))],
                           -1).astype('f4')
    gt = np.stack([V.random_boxes(rng, M, lo=10, hi=40) for _ in range(B)])
    labels = rng.randint(0, C, (B, M)).astype('i4')
    mask = rng.rand(B, M) < 0.8
    mask[:, 0] = True
    got = [_np(v) for v in PD.task_aligned_assign(scores, boxes, pts, gt,
                                                  labels, mask)]
    assign = jax.jit(RD.task_aligned_assign)
    for b in range(B):
        want = [np.asarray(v) for v in assign(
            scores[b], boxes[b], pts, gt[b], labels[b], mask[b])]
        one = [_np(v) for v in PD.task_aligned_assign(
            scores[b], boxes[b], pts, gt[b], labels[b], mask[b])]
        for g in (one, [v[b] for v in got]):
            np.testing.assert_array_equal(g[0], want[0])
            np.testing.assert_array_equal(g[1], want[1])
            _close(g[2], want[2], OP_TOL)
            _close(g[3], want[3], OP_TOL)
        assert want[0].any()


@pytest.mark.parametrize('case', V.nms_cases(), ids=lambda c: c[0])
def test_nms_static_and_nms_equal_the_reference(case):
    name, boxes, scores, cats, thr, max_out = case
    rk, rv = ref.vision.ops.nms_static(boxes, scores, thr, max_out=max_out,
                                       category_idxs=cats)
    pk, pv = port.vision.ops.nms_static(boxes, scores, thr, max_out=max_out,
                                        category_idxs=cats, unroll=True)
    np.testing.assert_array_equal(_np(pk), np.asarray(rk._value))
    assert int(_np(pv)) == int(np.asarray(rv._value))
    assert _np(pk).dtype == np.int32 and _np(pv).dtype == np.int32
    assert 0 < int(_np(pv)) <= max_out
    if len(boxes) <= 300:      # the reference's eager loop is host numpy
        top_k = None if max_out >= len(boxes) else max_out
        want = np.asarray(ref.vision.ops.nms(
            boxes, thr, scores, category_idxs=cats, top_k=top_k)._value)
        got = _np(port.vision.ops.nms(boxes, thr, scores,
                                      category_idxs=cats, top_k=top_k))
        np.testing.assert_array_equal(got, want)


def test_nms_without_scores_and_unroll_inert():
    """Scores default to ones (index order wins every tie), and
    ``unroll`` changes nothing on the port."""
    boxes = V.random_boxes(np.random.RandomState(4), 40)
    want = np.asarray(ref.vision.ops.nms(boxes, 0.3)._value)
    np.testing.assert_array_equal(_np(port.vision.ops.nms(boxes, 0.3)), want)
    s = np.random.RandomState(5).rand(40).astype('f4')
    a = port.vision.ops.nms_static(boxes, s, 0.3, 12, unroll=False)
    b = port.vision.ops.nms_static(boxes, s, 0.3, 12, unroll=True)
    np.testing.assert_array_equal(_np(a[0]), _np(b[0]))


def test_nms_static_is_one_operator_with_fake_shapes():
    """The operator's fake implementation gives the shapes, so an export
    records one node whatever n; a CUDA tensor launches the kernel or
    raises (no card here: it raises)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Net(torch.nn.Module):
        def forward(self, b, s):
            return torch.ops.paddle_tpu_torch.nms_static(b, s, None, 0.5, 9)

    b = torch.from_numpy(V.random_boxes(np.random.RandomState(6), 500))
    s = torch.rand(500)
    ep = torch.export.export(Net(), (b, s), strict=False)
    nodes = [str(n.target) for n in ep.graph.nodes
             if n.op == 'call_function' and 'getitem' not in str(n.target)]
    assert nodes == ['paddle_tpu_torch.nms_static.default']
    with FakeTensorMode() as mode:
        keep, valid = port_nms.nms_op(mode.from_tensor(b),
                                      mode.from_tensor(s), None, 0.5, 9)
    assert keep.shape == (9,) and keep.dtype == torch.int32
    assert valid.shape == () and valid.dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            port_nms.nms_static_cuda(b.to('cuda'), s.to('cuda'), 0.5, 9)
    assert port_nms.nms_static_cuda.launches == 0
