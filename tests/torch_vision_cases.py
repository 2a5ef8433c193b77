"""Inputs of the detection and OCR slice, numpy only: the CPU tests feed
them to both packages, ``chip_smoke.py`` to the port on the card and on
the CPU.

- ``synth_detection_batch``: images with bright rectangles and their boxes,
  as ``examples/train_detection.py`` makes them;
- ``synth_strip``: 32-row glyph strips and their labels, as
  ``examples/train_ocr.py`` makes them;
- ``nms_cases``: seeded NMS inputs (ties, categories, ``max_out`` below
  and above the kept count, dense overlap);
- ``op_cases``: seeded inputs of the vision ops;
- ``seeded_init``: an initializer of numpy draws from one seed, for
  ``nn.initializer.set_global_initializer`` (either package): the
  reference's own initializers compile a random-number program for each
  new shape, ~0.5 s each on a CPU;
- ``np_state`` / ``carry_state``: a Layer's parameters and buffers
  (BatchNorm's running statistics included) as numpy, loaded into
  another Layer of the same structure (either package).
"""
import numpy as np


def synth_detection_batch(rng, batch, size, num_classes, max_boxes=4):
    """Images with bright rectangles; the boxes are the ground truth.
    -> (x [B,3,S,S] f32, gt_boxes [B,M,4] xyxy, gt_labels [B,M] int32,
    gt_mask [B,M] bool)."""
    x = rng.rand(batch, 3, size, size).astype('f4') * 0.2
    gt_boxes = np.zeros((batch, max_boxes, 4), 'f4')
    gt_labels = np.zeros((batch, max_boxes), 'i4')
    gt_mask = np.zeros((batch, max_boxes), bool)
    for b in range(batch):
        n = rng.randint(1, max_boxes)
        for i in range(n):
            w, h = rng.randint(12, size // 2, 2)
            x0 = rng.randint(0, size - w)
            y0 = rng.randint(0, size - h)
            c = rng.randint(0, num_classes)
            x[b, c % 3, y0:y0 + h, x0:x0 + w] = 0.9
            gt_boxes[b, i] = [x0, y0, x0 + w, y0 + h]
            gt_labels[b, i] = c
            gt_mask[b, i] = True
    return x, gt_boxes, gt_labels, gt_mask


def synth_strip(rng, n_chars, n_classes, char_w=16):
    """Each class a distinct vertical-bar pattern, blank-separable.
    -> (img [1, 32, n_chars*char_w] f32, labels [n_chars])."""
    w = n_chars * char_w
    img = np.zeros((32, w), 'f4')
    labels = rng.randint(1, n_classes, n_chars)
    for i, c in enumerate(labels):
        x0 = i * char_w
        for b in range(4):
            if (c >> b) & 1:
                img[4 + b * 6: 8 + b * 6, x0 + 2:x0 + char_w - 2] = 1.0
    return img[None], labels


def ocr_batch(rng, batch, width, n_classes):
    """``batch`` strips of ``width // 16`` glyphs -> (x [B,1,32,W] f32,
    labels [B, n] int32, input lengths [B] (W / 4), label lengths [B])."""
    n = width // 16
    imgs, labs = zip(*(synth_strip(rng, n, n_classes) for _ in range(batch)))
    return (np.stack(imgs).astype('f4'), np.stack(labs).astype('i4'),
            np.full((batch,), width // 4, 'i8'), np.full((batch,), n, 'i8'))


def random_boxes(rng, n, size=64.0, lo=4.0, hi=24.0):
    """n xyxy boxes inside [0, size]^2 with sides in [lo, hi)."""
    wh = rng.uniform(lo, hi, (n, 2)).astype('f4')
    xy = (rng.rand(n, 2) * (size - wh)).astype('f4')
    return np.concatenate([xy, xy + wh], 1).astype('f4')


def nms_cases(big=2100):
    """[(name, boxes, scores, category_idxs or None, iou_threshold,
    max_out)], seeded. ``big`` boxes in the last case (2,100: the anchors
    of a 320 x 320 input)."""
    rng = np.random.RandomState(0)
    cases = []
    b = random_boxes(rng, 60)
    s = rng.rand(60).astype('f4')
    cases.append(('plain', b, s, None, 0.5, 60))
    cases.append(('max_out_below', b, s, None, 0.3, 7))
    cases.append(('max_out_above', b, s, None, 0.7, 100))
    # ties: scores from 4 values, so the stable sort's index order decides
    cases.append(('ties', b, (rng.randint(0, 4, 60) / 4.0).astype('f4'),
                  None, 0.4, 60))
    cases.append(('all_equal', b, np.ones(60, 'f4'), None, 0.5, 60))
    cases.append(('categories', b, s, rng.randint(0, 3, 60).astype('i4'),
                  0.3, 60))
    # dense overlap: jittered copies of a few boxes, most IoUs above 0.5
    base = random_boxes(rng, 5, lo=20.0, hi=40.0)
    dense = (base[rng.randint(0, 5, 300)]
             + rng.normal(0, 1.5, (300, 4))).astype('f4')
    cases.append(('dense_overlap', dense, rng.rand(300).astype('f4'), None,
                  0.5, 100))
    cases.append(('dense_categories', dense, rng.rand(300).astype('f4'),
                  rng.randint(0, 4, 300).astype('i4'), 0.5, 100))
    cases.append((f'n{big}', random_boxes(rng, big, size=320.0),
                  rng.rand(big).astype('f4'), None, 0.5, 100))
    return cases


def op_cases():
    """{case: (op name, args, kwargs)} numpy inputs of the vision ops,
    seeded."""
    rng = np.random.RandomState(1)
    f = lambda *s: rng.randn(*s).astype('f4')          # noqa: E731
    x = f(2, 8, 12, 12)
    rois = np.asarray([[1.0, 2.0, 9.5, 10.0], [0.5, 0.5, 5.0, 7.0],
                       [3.0, 1.0, 11.0, 6.5]], 'f4')
    boxes_num = np.asarray([2, 1], 'i4')
    ps_x = f(2, 2 * 3 * 3, 10, 10)
    yolo_x = f(2, 3 * (5 + 4), 5, 5)
    img_size = np.asarray([[160, 160], [128, 96]], 'i4')
    prior = np.asarray([[0.1, 0.1, 0.4, 0.5], [0.3, 0.2, 0.9, 0.8]], 'f4')
    var = np.asarray([[0.1, 0.1, 0.2, 0.2]] * 2, 'f4')
    target = np.asarray([[0.15, 0.1, 0.5, 0.6], [0.2, 0.3, 0.7, 0.7],
                         [0.0, 0.0, 0.3, 0.3]], 'f4')
    deltas = (f(3, 2, 4) * 0.1).astype('f4')
    dx = f(2, 4, 7, 7)
    gt_box = np.asarray([[[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.4, 0.5],
                          [0.0, 0.0, 0.0, 0.0]],
                         [[0.5, 0.5, 0.6, 0.6], [0.2, 0.8, 0.1, 0.1],
                          [0.52, 0.48, 0.3, 0.2]]], 'f4')
    gt_label = np.asarray([[1, 3, 0], [2, 0, 1]], 'i4')
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    return {
        'roi_align': ('roi_align', (x, rois, boxes_num, 3), dict(spatial_scale=1.0)),
        'roi_align_unaligned': ('roi_align', (x, rois, boxes_num, (2, 4)),
                                dict(spatial_scale=0.5, aligned=False)),
        'psroi_pool': ('psroi_pool', (ps_x, rois, boxes_num, 3), dict(spatial_scale=1.0)),
        'yolo_box': ('yolo_box', (yolo_x, img_size, [10, 13, 16, 30, 33, 23], 4, 0.3),
                     dict(downsample_ratio=32)),
        'yolo_box_scaled': ('yolo_box', (yolo_x, img_size, [10, 13, 16, 30, 33, 23], 4,
                             0.0), dict(downsample_ratio=32, clip_bbox=False,
                                        scale_x_y=1.2)),
        'box_coder_encode': ('box_coder', (prior, var, target), {}),
        'box_coder_decode': ('box_coder', (prior, var, deltas),
                             dict(code_type='decode_center_size')),
        'box_coder_pixels': ('box_coder', (prior * 100, None, target * 100),
                             dict(box_normalized=False)),
        'deform_conv2d': ('deform_conv2d', (dx, f(2, 2 * 9, 5, 5) * 0.7, f(6, 4, 3, 3)),
                          dict(bias=f(6))),
        'deform_conv2d_v2': ('deform_conv2d', (dx, f(2, 2 * 2 * 9, 4, 4), f(6, 2, 3, 3)),
                             dict(stride=2, padding=1, deformable_groups=2,
                                  groups=2, mask=rng.rand(2, 2 * 9, 4, 4)
                                  .astype('f4'))),
        'yolo_loss': ('yolo_loss', (yolo_x, gt_box, gt_label, anchors, [0, 1, 2], 4, 0.5,
                       32), {}),
        'yolo_loss_mixup': ('yolo_loss', (yolo_x, gt_box, gt_label, anchors, [3, 4, 5],
                             4, 0.3, 32),
                            dict(gt_score=rng.rand(2, 3).astype('f4'),
                                 use_label_smooth=False, scale_x_y=1.1)),
    }


class seeded_init:
    """(shape, dtype) -> a float32 numpy array: uniform within
    +-sqrt(3 / fan_in) x ``gain`` (fan_in: the product of the dims after
    the first, or the one dim of a vector), from one numpy seed."""

    def __init__(self, seed, gain=1.0):
        self.rng = np.random.RandomState(seed)
        self.gain = gain

    def __call__(self, shape, dtype=None):
        shape = tuple(int(d) for d in shape)
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        lim = self.gain * np.sqrt(3.0 / max(fan_in, 1))
        return self.rng.uniform(-lim, lim, shape).astype('f4')


def build_seeded(P, make, seed=0):
    """``make(P)`` with every parameter drawn by ``seeded_init``: weights
    from ``seed``, biases (and BatchNorm's shifts) from ``seed + 1`` at a
    tenth of the scale."""
    init = P.nn.initializer.set_global_initializer
    init(seeded_init(seed), seeded_init(seed + 1, 0.1))
    try:
        return make(P)
    finally:
        init(None, None)


def np_state(net):
    """A Layer's state dict (parameters and buffers) as numpy arrays."""
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def carry_state(src, dst):
    """Load ``src``'s parameters and buffers (BatchNorm's running
    statistics included) into ``dst`` through numpy; -> the names."""
    state = np_state(src)
    missing = set(dst.state_dict()) ^ set(state)
    if missing:
        raise KeyError(f'state names differ: {sorted(missing)}')
    dst.set_state_dict(state)
    return sorted(state)
