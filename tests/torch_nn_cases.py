"""Cases of ``paddle.nn`` (layers and functionals) run the same way in any
package with Paddle's API: the JAX package and paddle_tpu_torch on the
CPU (``tests/test_torch_nn.py``), and paddle_tpu_torch on the card
against the CPU (``chip_smoke.py``). Numpy only: the package is an
argument.

A case makes a Layer or a function from ``(nn, F)`` and its inputs from a
numpy RandomState. ``run`` feeds the inputs (float ones requiring grad),
backs a fixed random projection of every float output into them, and
returns the outputs, the inputs' and parameters' gradients and the
state after the call; a Layer's weights are carried in as numpy through
``set_state_dict``. Shapes repeat across cases, so the JAX package
compiles each primitive once.
"""
import zlib

import numpy as np

E = (3, 7)                    # elementwise inputs
IMG = (2, 4, 5, 6)            # NCHW
SEQ = (2, 5, 16)              # [batch, seq, embed]


class Case:
    """``const``: indices of float inputs that take no gradient; ``tol``:
    (output, gradient) tolerances of a case in bfloat16 (else the
    caller's); ``eager``: the reference reads a value back to the host
    in the call, so it runs outside ``jax.jit``."""

    def __init__(self, name, make, inputs, train=True, const=(), tol=None,
                 eager=False):
        self.name, self.make, self.inputs = name, make, inputs
        self.train, self.const = train, tuple(const)
        self.tol, self.eager = tol, eager

    def __repr__(self):
        return self.name


def _seed(name):
    return zlib.crc32(name.encode()) % (2 ** 31)


def normal(*shape, scale=1.0, shift=0.0):
    return lambda rng: (shift + scale * rng.randn(*shape)).astype('float32')


def uniform(*shape, lo=0.05, hi=0.95):
    return lambda rng: rng.uniform(lo, hi, shape).astype('float32')


def ints(*shape, hi):
    return lambda rng: rng.randint(0, hi, shape).astype('int32')


def const(a):
    return lambda rng: np.asarray(a)


def pm1(*shape):
    return lambda rng: np.where(rng.rand(*shape) < 0.5, -1.0,
                                1.0).astype('float32')


def fn(f):
    """A case maker for a function of the inputs: ``f(F, *xs)``."""
    return lambda nn, F: (lambda *xs: f(F, *xs))


CASES = []


def add(name, make, *inputs, **kw):
    CASES.append(Case(name, make, list(inputs), **kw))


# ---- activations (functional and layer) ---------------------------------
_ACTS = ['relu', 'relu6', 'elu', 'selu', 'celu', 'gelu', 'sigmoid',
         'hardsigmoid', 'hardswish', 'hardtanh', 'hardshrink', 'softshrink',
         'tanhshrink', 'leaky_relu', 'log_sigmoid', 'softplus', 'softsign',
         'swish', 'silu', 'mish', 'tanh', 'thresholded_relu', 'softmax',
         'log_softmax']
for _a in _ACTS:
    add(f'F.{_a}', fn(lambda F, x, _a=_a: getattr(F, _a)(x)),
        normal(*E, scale=2.0))
add('F.gelu_tanh', fn(lambda F, x: F.gelu(x, approximate=True)),
    normal(*E, scale=2.0))
add('F.elu_alpha', fn(lambda F, x: F.elu(x, alpha=0.5)), normal(*E))
add('F.celu_alpha', fn(lambda F, x: F.celu(x, alpha=2.0)), normal(*E))
add('F.softplus_beta', fn(lambda F, x: F.softplus(x, beta=2, threshold=3)),
    normal(*E, scale=3.0))
add('F.softmax_axis0', fn(lambda F, x: F.softmax(x, axis=0)), normal(*E))
add('F.log_softmax_axis0', fn(lambda F, x: F.log_softmax(x, axis=0)),
    normal(*E))
add('F.maxout', fn(lambda F, x: F.maxout(x, groups=2, axis=1)),
    normal(*IMG))
add('F.glu', fn(lambda F, x: F.glu(x, axis=1)), normal(*IMG))
add('F.prelu_channels', fn(lambda F, x, w: F.prelu(x, w)), normal(*IMG),
    uniform(4))
add('F.rrelu', fn(lambda F, x: F.rrelu(x)), normal(*E))
add('F.relu_', fn(lambda F, x: F.relu_(x)), normal(*E))
add('F.softmax_', fn(lambda F, x: F.softmax_(x)), normal(*E))
for _l, _args in [('ReLU', ()), ('ReLU6', ()), ('ELU', (0.7,)),
                  ('SELU', ()), ('CELU', (1.5,)), ('GELU', (True,)),
                  ('Sigmoid', ()), ('Hardsigmoid', ()), ('Hardswish', ()),
                  ('Hardtanh', (-0.5, 0.8)), ('Hardshrink', (0.3,)),
                  ('Softshrink', (0.3,)), ('Tanhshrink', ()),
                  ('LeakyReLU', (0.2,)), ('LogSigmoid', ()),
                  ('Softplus', (1, 20)), ('Softsign', ()), ('Swish', ()),
                  ('Silu', ()), ('Mish', ()), ('Tanh', ()),
                  ('ThresholdedReLU', (0.4,)), ('Softmax', (0,)),
                  ('LogSoftmax', (-1,)), ('RReLU', ())]:
    add(f'nn.{_l}', lambda nn, F, _l=_l, _args=_args: getattr(nn, _l)(*_args),
        normal(*E, scale=2.0))
add('nn.Maxout', lambda nn, F: nn.Maxout(2), normal(*IMG))
add('nn.PReLU', lambda nn, F: nn.PReLU(4, 0.1), normal(*IMG))

# ---- common --------------------------------------------------------------
add('F.linear', fn(lambda F, x, w, b: F.linear(x, w, b)), normal(2, 5, 7),
    normal(7, 3), normal(3))
add('F.linear_nobias', fn(lambda F, x, w: F.linear(x, w)), normal(*E),
    normal(7, 3))
for _mode in ('constant', 'reflect', 'replicate', 'circular'):
    add(f'F.pad_{_mode}', fn(lambda F, x, _m=_mode: F.pad(
        x, [1, 2, 2, 1], mode=_m, value=0.5)), normal(*IMG))
add('F.pad_full', fn(lambda F, x: F.pad(x, [0, 0, 1, 0, 0, 2, 1, 1])),
    normal(*IMG))
add('F.pad_nhwc', fn(lambda F, x: F.pad(x, [1, 0, 0, 2], mode='reflect',
                                        data_format='NHWC')), normal(*IMG))
add('F.zeropad2d', fn(lambda F, x: F.zeropad2d(x, [1, 0, 2, 1])),
    normal(*IMG))
add('F.embedding', fn(lambda F, i, w: F.embedding(i, w)), ints(2, 5, hi=9),
    normal(9, 6))
add('F.embedding_padding', fn(lambda F, i, w: F.embedding(
    i, w, padding_idx=3)), const([[3, 1, 3], [0, 2, 8]]), normal(9, 6))
add('F.one_hot', fn(lambda F, i: F.one_hot(i, 6)), ints(2, 5, hi=6))
add('F.label_smooth', fn(lambda F, x: F.label_smooth(x, epsilon=0.2)),
    uniform(*E))
add('F.cosine_similarity', fn(lambda F, a, b: F.cosine_similarity(a, b)),
    normal(*IMG), normal(*IMG))
add('F.pixel_shuffle', fn(lambda F, x: F.pixel_shuffle(x, 2)),
    normal(2, 8, 3, 2))
add('F.pixel_shuffle_nhwc', fn(lambda F, x: F.pixel_shuffle(
    x, 2, data_format='NHWC')), normal(2, 3, 2, 8))
add('F.unfold', fn(lambda F, x: F.unfold(x, [2, 3], strides=[1, 2],
                                         paddings=1, dilations=[2, 1])),
    normal(*IMG))
for _name, _kw in [
        ('nearest_up', dict(size=[7, 9], mode='nearest')),
        ('nearest_down', dict(size=[3, 4], mode='nearest')),
        ('bilinear_up', dict(scale_factor=2, mode='bilinear')),
        ('bilinear_down', dict(size=[3, 4], mode='bilinear')),
        ('bilinear_corners', dict(size=[7, 9], mode='bilinear',
                                  align_corners=True)),
        ('bilinear_mode1', dict(size=[7, 9], mode='bilinear',
                                align_mode=1)),
        ('bicubic', dict(size=[7, 9], mode='bicubic')),
        ('area', dict(size=[3, 4], mode='area')),
        ('nhwc', dict(size=[7, 3], mode='bilinear', data_format='NHWC'))]:
    add(f'F.interpolate_{_name}', fn(lambda F, x, _kw=_kw: F.interpolate(
        x, **_kw)), normal(*IMG))
add('F.interpolate_linear1d', fn(lambda F, x: F.interpolate(
    x, size=[9], mode='linear', data_format='NCW')), normal(2, 4, 6))
add('F.interpolate_trilinear', fn(lambda F, x: F.interpolate(
    x, size=[3, 4, 5], mode='trilinear', data_format='NCDHW')),
    normal(1, 2, 2, 3, 4))
add('F.upsample', fn(lambda F, x: F.upsample(x, scale_factor=2)),
    normal(*IMG))
add('F.affine_grid', fn(lambda F, t: F.affine_grid(t, [2, 3, 4, 5])),
    normal(2, 2, 3))
add('F.affine_grid_centers', fn(lambda F, t: F.affine_grid(
    t, [2, 3, 4, 5], align_corners=False)), normal(2, 2, 3))
add('F.grid_sample', fn(lambda F, x, g: F.grid_sample(x, g)), normal(*IMG),
    uniform(2, 3, 4, 2, lo=-1.1, hi=1.1))
add('F.grid_sample_nearest', fn(lambda F, x, g: F.grid_sample(
    x, g, mode='nearest', align_corners=False)), normal(*IMG),
    uniform(2, 3, 4, 2, lo=-0.9, hi=0.9))
add('F.bilinear', fn(lambda F, a, b, w, c: F.bilinear(a, b, w, c)),
    normal(3, 4), normal(3, 5), normal(2, 4, 5), normal(2))
add('F.temporal_shift', fn(lambda F, x: F.temporal_shift(x, 2)),
    normal(4, 8, 2, 3))
add('F.npair_loss_dummy', fn(lambda F, x: F.npair_loss_dummy(x)),
    normal(*E))
add('F.dropout_p0', fn(lambda F, x: F.dropout(x, 0.0)), normal(*E))
add('F.dropout_eval', fn(lambda F, x: F.dropout(x, 0.5, training=False)),
    normal(*E))

# ---- norm ----------------------------------------------------------------
add('F.normalize', fn(lambda F, x: F.normalize(x)), normal(*IMG))
add('F.normalize_p1', fn(lambda F, x: F.normalize(x, p=1, axis=-1)),
    normal(*E))
add('F.layer_norm', fn(lambda F, x, w, b: F.layer_norm(x, 16, w, b)),
    normal(*SEQ, scale=3.0, shift=1.0), normal(16), normal(16))
add('F.layer_norm_2d', fn(lambda F, x: F.layer_norm(x, [5, 6])),
    normal(*IMG, scale=2.0))
add('F.group_norm', fn(lambda F, x, w, b: F.group_norm_fn(x, 2, w, b)),
    normal(*IMG), normal(4), normal(4))
add('F.instance_norm', fn(lambda F, x, w, b: F.instance_norm(
    x, weight=w, bias=b)), normal(*IMG), normal(4), normal(4))
add('F.instance_norm_fn', fn(
    lambda F, x: F.instance_norm_fn(x, epsilon=1e-3)), normal(*IMG))
add('F.batch_norm_eval', fn(lambda F, x, m, v, w, b: F.batch_norm(
    x, m, v, w, b)), normal(*IMG), normal(4), uniform(4, lo=0.5, hi=2.0),
    normal(4), normal(4))
add('F.local_response_norm', fn(lambda F, x: F.local_response_norm(x, 3)),
    normal(*IMG))
for _l, _args, _x in [
        ('BatchNorm1D', (4,), normal(6, 4, scale=2.0, shift=1.0)),
        ('BatchNorm2D', (4,), normal(*IMG, scale=2.0, shift=1.0)),
        ('BatchNorm3D', (2,), normal(2, 2, 3, 2, 2, scale=2.0)),
        ('BatchNorm', (4,), normal(*IMG, scale=2.0, shift=1.0)),
        ('SyncBatchNorm', (4,), normal(*IMG, scale=2.0, shift=1.0)),
        ('LayerNorm', ([5, 6],), normal(*IMG, scale=3.0)),
        ('GroupNorm', (2, 4), normal(*IMG)),
        ('InstanceNorm1D', (4,), normal(2, 4, 7)),
        ('InstanceNorm2D', (4,), normal(*IMG)),
        ('InstanceNorm3D', (2,), normal(2, 2, 3, 2, 2)),
        ('LocalResponseNorm', (5,), normal(*IMG))]:
    add(f'nn.{_l}', lambda nn, F, _l=_l, _a=_args: getattr(nn, _l)(*_a), _x)
add('nn.BatchNorm2D_eval', lambda nn, F: nn.BatchNorm2D(4), normal(*IMG),
    train=False)
add('nn.BatchNorm_relu_nhwc', lambda nn, F: nn.BatchNorm(
    4, act='relu', data_layout='NHWC'), normal(2, 5, 6, 4))
add('nn.SpectralNorm', lambda nn, F: nn.SpectralNorm([6, 4], power_iters=3),
    normal(6, 4))

# ---- losses ----------------------------------------------------------------
_CE = (normal(6, 5), ints(6, hi=5))
add('F.cross_entropy', fn(lambda F, x, y: F.cross_entropy(x, y)), *_CE)
add('F.cross_entropy_ignore', fn(lambda F, x, y: F.cross_entropy(x, y)),
    normal(6, 5), const([0, -100, 3, 4, -100, 1]))
add('F.cross_entropy_weight', fn(lambda F, x, y, w: F.cross_entropy(
    x, y, weight=w)), *_CE, uniform(5))
add('F.cross_entropy_sum_label2d', fn(lambda F, x, y: F.cross_entropy(
    x, y, reduction='sum')), normal(6, 5), ints(6, 1, hi=5))
add('F.cross_entropy_soft', fn(lambda F, x, y: F.cross_entropy(
    x, y, soft_label=True)), normal(6, 5), uniform(6, 5))
add('F.cross_entropy_axis1', fn(lambda F, x, y: F.cross_entropy(
    x, y, axis=1, reduction='none')), normal(2, 5, 3), ints(2, 3, hi=5))
add('F.cross_entropy_probs', fn(lambda F, x, y: F.cross_entropy(
    x, y, use_softmax=False)), uniform(6, 5), ints(6, hi=5))
add('F.softmax_with_cross_entropy', fn(
    lambda F, x, y: F.softmax_with_cross_entropy(x, y)), normal(6, 5),
    ints(6, 1, hi=5))
add('F.softmax_with_cross_entropy_soft', fn(
    lambda F, x, y: F.softmax_with_cross_entropy(x, y, soft_label=True,
                                                 return_softmax=True)),
    normal(6, 5), uniform(6, 5))
for _n in ('mse_loss', 'l1_loss', 'smooth_l1_loss', 'square_error_cost',
           'log_loss'):
    add(f'F.{_n}', fn(lambda F, a, b, _n=_n: getattr(F, _n)(a, b)),
        uniform(*E), uniform(*E))
add('F.mse_loss_sum', fn(lambda F, a, b: F.mse_loss(a, b, 'sum')),
    normal(*E), normal(*E))
add('F.l1_loss_none', fn(lambda F, a, b: F.l1_loss(a, b, 'none')),
    normal(*E), normal(*E))
add('F.nll_loss', fn(lambda F, x, y: F.nll_loss(x, y)), normal(6, 5),
    const([0, -100, 3, 4, 2, 1]))
add('F.nll_loss_weight', fn(lambda F, x, y, w: F.nll_loss(x, y, w)),
    normal(6, 5), ints(6, hi=5), uniform(5))
add('F.binary_cross_entropy', fn(lambda F, p, y, w: F.binary_cross_entropy(
    p, y, w)), uniform(*E), uniform(*E), uniform(*E))
add('F.bce_with_logits', fn(lambda F, x, y: F.binary_cross_entropy_with_logits(
    x, y)), normal(*E, scale=3.0), uniform(*E))
add('F.bce_with_logits_pos', fn(
    lambda F, x, y, p: F.binary_cross_entropy_with_logits(
        x, y, pos_weight=p, reduction='sum')), normal(*E), uniform(*E),
    uniform(7, lo=0.5, hi=2.0))
add('F.kl_div', fn(lambda F, x, y: F.kl_div(x, y)), normal(*E), uniform(*E))
add('F.kl_div_batchmean', fn(lambda F, x, y: F.kl_div(x, y, 'batchmean')),
    normal(*E), uniform(*E))
add('F.margin_ranking_loss', fn(lambda F, a, b, y: F.margin_ranking_loss(
    a, b, y, margin=0.1)), normal(*E), normal(*E), pm1(*E))
add('F.hinge_embedding_loss', fn(lambda F, x, y: F.hinge_embedding_loss(
    x, y)), normal(*E), pm1(*E))
add('F.cosine_embedding_loss', fn(lambda F, a, b, y: F.cosine_embedding_loss(
    a, b, y, margin=0.2)), normal(6, 5), normal(6, 5), pm1(6))
add('F.triplet_margin_loss', fn(lambda F, a, p, n: F.triplet_margin_loss(
    a, p, n)), normal(6, 5), normal(6, 5), normal(6, 5))
add('F.triplet_margin_loss_swap', fn(
    lambda F, a, p, n: F.triplet_margin_loss(a, p, n, p=1, swap=True)),
    normal(6, 5), normal(6, 5), normal(6, 5))
add('F.sigmoid_focal_loss', fn(lambda F, x, y: F.sigmoid_focal_loss(
    x, y)), normal(*E), uniform(*E))
add('F.npair_loss', fn(lambda F, a, p, y: F.npair_loss(a, p, y)),
    normal(6, 5), normal(6, 5), const([0, 1, 0, 2, 1, 3]))
add('F.ctc_loss', fn(lambda F, x, y, il, ll: F.ctc_loss(x, y, il, ll)),
    normal(7, 2, 5), const([[1, 2, 2], [3, 1, 0]]), const([7, 5]),
    const([3, 2]))
add('F.ctc_loss_none', fn(lambda F, x, y, il, ll: F.ctc_loss(
    x, y, il, ll, blank=4, reduction='none')), normal(7, 2, 5),
    const([[1, 2, 2], [3, 1, 0]]), const([7, 6]), const([3, 2]))
add('F.ctc_loss_fn', fn(lambda F, x, y, il, ll: F.ctc_loss_fn(
    F.log_softmax(x), y, il, ll)), normal(7, 2, 5),
    const([[1, 2, 2], [3, 1, 0]]), const([7, 6]), const([3, 2]))
add('F.dice_loss', fn(lambda F, x, y: F.dice_loss(x, y)), uniform(6, 5),
    ints(6, 1, hi=5))
for _l, _make, _ins in [
        ('CrossEntropyLoss', lambda nn: nn.CrossEntropyLoss(), _CE),
        ('MSELoss', lambda nn: nn.MSELoss(), (normal(*E), normal(*E))),
        ('L1Loss', lambda nn: nn.L1Loss('sum'), (normal(*E), normal(*E))),
        ('NLLLoss', lambda nn: nn.NLLLoss(), _CE),
        ('BCELoss', lambda nn: nn.BCELoss(), (uniform(*E), uniform(*E))),
        ('BCEWithLogitsLoss', lambda nn: nn.BCEWithLogitsLoss(),
         (normal(*E), uniform(*E))),
        ('KLDivLoss', lambda nn: nn.KLDivLoss(), (normal(*E), uniform(*E))),
        ('SmoothL1Loss', lambda nn: nn.SmoothL1Loss(delta=0.5),
         (normal(*E), normal(*E))),
        ('MarginRankingLoss', lambda nn: nn.MarginRankingLoss(0.2),
         (normal(*E), normal(*E), pm1(*E))),
        ('HingeEmbeddingLoss', lambda nn: nn.HingeEmbeddingLoss(),
         (normal(*E), pm1(*E))),
        ('CosineEmbeddingLoss', lambda nn: nn.CosineEmbeddingLoss(),
         (normal(6, 5), normal(6, 5), pm1(6))),
        ('TripletMarginLoss', lambda nn: nn.TripletMarginLoss(),
         (normal(6, 5), normal(6, 5), normal(6, 5))),
        ('CTCLoss', lambda nn: nn.CTCLoss(),
         (normal(7, 2, 5), const([[1, 2, 2], [3, 1, 0]]), const([7, 5]),
          const([3, 2])))]:
    add(f'nn.{_l}', lambda nn, F, _m=_make: _m(nn), *_ins)

# ---- common layers and containers -------------------------------------------
for _l, _make, _ins in [
        ('Linear', lambda nn: nn.Linear(7, 4), (normal(2, 3, 7),)),
        ('Linear_nobias', lambda nn: nn.Linear(7, 4, bias_attr=False),
         (normal(*E),)),
        ('Embedding', lambda nn: nn.Embedding(9, 6, padding_idx=2),
         (ints(2, 5, hi=9),)),
        ('Flatten', lambda nn: nn.Flatten(), (normal(*IMG),)),
        ('Upsample', lambda nn: nn.Upsample(scale_factor=2, mode='bilinear'),
         (normal(*IMG),)),
        ('UpsamplingNearest2D', lambda nn: nn.UpsamplingNearest2D(
            size=[7, 9]), (normal(*IMG),)),
        ('UpsamplingBilinear2D', lambda nn: nn.UpsamplingBilinear2D(
            size=[7, 9]), (normal(*IMG),)),
        ('Pad1D', lambda nn: nn.Pad1D([1, 2], mode='reflect'),
         (normal(2, 4, 6),)),
        ('Pad2D', lambda nn: nn.Pad2D([1, 0, 2, 1], mode='replicate'),
         (normal(*IMG),)),
        ('Pad3D', lambda nn: nn.Pad3D([1, 1, 0, 1, 1, 0], value=2.0),
         (normal(1, 2, 2, 3, 4),)),
        ('ZeroPad2D', lambda nn: nn.ZeroPad2D([1, 2, 0, 1]),
         (normal(*IMG),)),
        ('CosineSimilarity', lambda nn: nn.CosineSimilarity(axis=-1),
         (normal(*E), normal(*E))),
        ('PairwiseDistance', lambda nn: nn.PairwiseDistance(),
         (normal(*E), normal(*E))),
        ('PixelShuffle', lambda nn: nn.PixelShuffle(2),
         (normal(2, 8, 3, 2),)),
        ('Unfold', lambda nn: nn.Unfold([3, 2], paddings=[1, 0]),
         (normal(*IMG),)),
        ('Bilinear', lambda nn: nn.Bilinear(4, 5, 3),
         (normal(3, 4), normal(3, 5))),
        ('Identity', lambda nn: nn.Identity(), (normal(*E),)),
        ('Dropout_eval', lambda nn: nn.Dropout(0.5), (normal(*E),)),
        ('AlphaDropout_p0', lambda nn: nn.AlphaDropout(0.0), (normal(*E),)),
        ('Sequential', lambda nn: nn.Sequential(
            nn.Linear(7, 8), nn.GELU(), nn.LayerNorm(8), nn.Linear(8, 3)),
         (normal(*E),)),
        ('LayerList', lambda nn: _Stack(nn, nn.LayerList(
            [nn.Linear(7, 7), nn.Tanh(), nn.Linear(7, 7)])), (normal(*E),)),
        ('LayerDict', lambda nn: _Stack(nn, nn.LayerDict(
            {'a': nn.Linear(7, 5), 'b': nn.ReLU()})), (normal(*E),)),
        ('ParameterList', lambda nn: _Scale(nn), (normal(*E),))]:
    add(f'nn.{_l}', lambda nn, F, _m=_make: _m(nn), *_ins,
        train=not _l.endswith('_eval'))


def _Stack(nn, container):
    """A Layer running a LayerList's / LayerDict's layers in order."""
    class Stack(nn.Layer):
        def __init__(self):
            super().__init__()
            self.body = container

        def forward(self, x):
            layers = (self.body.values() if hasattr(self.body, 'values')
                      else self.body)
            for l in layers:
                x = l(x)
            return x
    return Stack()


def _Scale(nn):
    """A Layer over a ParameterList: x * p0 + p1."""
    class Scale(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ps = nn.ParameterList([
                self.create_parameter([7]), self.create_parameter(
                    [7], is_bias=True)])

        def forward(self, x):
            return x * self.ps[0] + self.ps[1]
    return Scale()


# ---- attention and the transformer stack ------------------------------------
def _kpm(b, s, lens):
    """A bool key-padding mask [B, 1, 1, S]: True for the first lens[i]."""
    m = np.arange(s)[None, :] < np.asarray(lens)[:, None]
    return const(m[:, None, None, :])


add('F.sdpa_plain', fn(lambda F, q, k, v: F.scaled_dot_product_attention(
    q, k, v)), normal(2, 5, 4, 4), normal(2, 6, 4, 4), normal(2, 6, 4, 4))
add('F.sdpa_plain_causal_mask', fn(
    lambda F, q, k, v, m: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m, is_causal=True)), normal(2, 5, 4, 4),
    normal(2, 5, 4, 4), normal(2, 5, 4, 4),
    normal(1, 4, 5, 5, scale=0.5))
add('F.sdpa_kernel', fn(lambda F, q, k, v: F.scaled_dot_product_attention(
    q, k, v)), normal(2, 9, 2, 64), normal(2, 9, 2, 64), normal(2, 9, 2, 64))
add('F.sdpa_kernel_causal', fn(
    lambda F, q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)),
    normal(2, 9, 2, 64), normal(2, 9, 2, 64), normal(2, 9, 2, 64))
add('F.sdpa_kernel_keymask', fn(
    lambda F, q, k, v, m: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=m)),
    normal(2, 9, 2, 64), normal(2, 9, 2, 64), normal(2, 9, 2, 64),
    _kpm(2, 9, [9, 4]))
add('F.sdpa_kernel_additive_keymask', fn(
    lambda F, q, k, v, m: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=m)),
    normal(2, 9, 2, 64), normal(2, 9, 2, 64), normal(2, 9, 2, 64),
    const(np.where(np.arange(9) < 6, 0.0, -1e9).astype('float32')[None]),
    const=(3,))
add('nn.MultiHeadAttention', lambda nn, F: nn.MultiHeadAttention(16, 4),
    normal(*SEQ))
add('nn.MultiHeadAttention_cross_mask', lambda nn, F: _Cross(nn),
    normal(*SEQ), normal(2, 7, 16), _kpm(2, 7, [7, 3]))
add('nn.MultiHeadAttention_d64', lambda nn, F: nn.MultiHeadAttention(64, 1),
    normal(2, 5, 64))
add('nn.TransformerEncoderLayer', lambda nn, F: nn.TransformerEncoderLayer(
    16, 4, 32, dropout=0.0, activation='gelu'), normal(*SEQ),
    _kpm(2, 5, [5, 3]))
add('nn.TransformerEncoderLayer_pre', lambda nn, F: nn.TransformerEncoderLayer(
    16, 4, 32, dropout=0.0, normalize_before=True), normal(*SEQ))
add('nn.TransformerEncoder', lambda nn, F: nn.TransformerEncoder(
    nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0), 2,
    nn.LayerNorm(16)), normal(*SEQ))
add('nn.TransformerDecoderLayer', lambda nn, F: nn.TransformerDecoderLayer(
    16, 4, 32, dropout=0.0), normal(2, 4, 16), normal(*SEQ))
add('nn.TransformerDecoder', lambda nn, F: nn.TransformerDecoder(
    nn.TransformerDecoderLayer(16, 4, 32, dropout=0.0,
                               normalize_before=True), 2, nn.LayerNorm(16)),
    normal(2, 4, 16), normal(*SEQ))
add('nn.Transformer', lambda nn, F: nn.Transformer(
    16, 4, 1, 1, 32, dropout=0.0), normal(*SEQ), normal(2, 4, 16))


def _Cross(nn):
    class Cross(nn.Layer):
        def __init__(self):
            super().__init__()
            self.attn = nn.MultiHeadAttention(16, 4, kdim=16, vdim=16)

        def forward(self, q, kv, mask):
            return self.attn(q, kv, kv, attn_mask=mask)
    return Cross()


# ---- step J3: conv, pooling, extensions, RNN, decoding, quantization --------
# A list of its own (``J3_CASES``): ``tests/test_torch_nn_conv_rnn.py``
# holds it against the JAX package, ``chip_smoke.py`` phase 30 card
# against CPU.
J3_CASES = []
BF16 = (1e-2, 3e-2)             # one bfloat16 rounding of the output


def add_j3(name, make, *inputs, **kw):
    J3_CASES.append(Case(name, make, list(inputs), **kw))


def parent(nn):
    """The module holding a case's ``nn`` (its package) or ``F`` (nn)."""
    import importlib
    return importlib.import_module(nn.__name__.rsplit('.', 1)[0])


def bf16(f):
    """``f(F, *xs)`` over the float inputs cast to bfloat16."""
    return fn(lambda F, *xs: f(F, *[x.astype('bfloat16') for x in xs]))


def seeded(net, seed=0):
    """``net`` with every parameter drawn from a numpy seed (its order
    in ``state_dict``), so that both packages start equal before a pass
    that depends on the weights (calibration)."""
    rng = np.random.RandomState(seed)
    sd = net.state_dict()
    net.set_state_dict({k: (0.5 * rng.randn(*v.shape)).astype('float32')
                        for k, v in sd.items()
                        if 'float' in str(v.dtype)})
    return net


def _dim(make, axis):
    """The size along ``axis`` of what an input maker draws (a conv's
    output channels, for its bias)."""
    return make(np.random.RandomState(0)).shape[axis]


_X1 = normal(2, 4, 9)                          # NCL
_X2 = normal(2, 4, 7, 8)                       # NCHW
_X3 = normal(1, 2, 4, 5, 6)                    # NCDHW
_W2 = normal(6, 4, 3, 3, scale=0.3)
for _n, _kw, _x, _w in [
        ('conv1d', dict(stride=2, padding=1), _X1, normal(6, 4, 3)),
        ('conv1d_nlc_same', dict(stride=2, padding='SAME',
                                 data_format='NLC'), normal(2, 9, 4),
         normal(6, 4, 3)),
        ('conv2d', dict(padding=1), _X2, _W2),
        ('conv2d_stride_dilation', dict(stride=2, dilation=2,
                                        padding=[1, 2]),
         normal(2, 4, 9, 10), _W2),
        ('conv2d_groups', dict(groups=2, padding=1), _X2,
         normal(6, 2, 3, 3)),
        ('conv2d_depthwise', dict(groups=4, stride=2, padding=1), _X2,
         normal(4, 1, 3, 3)),
        ('conv2d_asym', dict(padding=[0, 1, 2, 0]), _X2, _W2),
        ('conv1d_nested', dict(padding=[[0, 0], [0, 0], [1, 2]]), _X1,
         normal(6, 4, 3)),
        ('conv3d_nested', dict(padding=[[0, 0], [0, 0], [1, 0], [0, 2],
                                        [2, 1]]), _X3,
         normal(3, 2, 2, 3, 3)),
        ('conv2d_same', dict(stride=2, padding='SAME'), _X2, _W2),
        ('conv2d_valid', dict(stride=(1, 2), padding='VALID'), _X2, _W2),
        ('conv2d_nhwc', dict(stride=2, padding=1, data_format='NHWC'),
         normal(2, 7, 8, 4), _W2),
        ('conv3d', dict(stride=(1, 2, 1), padding=1), _X3,
         normal(3, 2, 2, 3, 3)),
        ('conv3d_ndhwc', dict(padding='SAME', data_format='NDHWC'),
         normal(1, 4, 5, 6, 2), normal(3, 2, 2, 3, 3))]:
    _f = 'conv' + _n[4:6]
    add_j3(f'F.{_n}', fn(lambda F, x, w, b, _f=_f, _kw=_kw: getattr(F, _f)(
        x, w, b, **_kw)), _x, _w, normal(_dim(_w, 0)))
add_j3('F.conv2d_bf16', bf16(lambda F, x, w, b: F.conv2d(
    x, w, b, stride=2, padding=1)), _X2, _W2, normal(6), tol=BF16)
add_j3('F.conv2d_nobias', fn(lambda F, x, w: F.conv2d(x, w, padding=1)),
       _X2, _W2)
for _n, _kw, _x, _w in [
        ('conv1d_transpose', dict(stride=2, padding=1, output_padding=1),
         normal(2, 4, 5), normal(4, 3, 3)),
        ('conv2d_transpose', dict(stride=2, padding=1), normal(2, 4, 5, 6),
         normal(4, 3, 3, 3)),
        ('conv2d_transpose_opad', dict(stride=3, padding=[1, 0],
                                       output_padding=2),
         normal(2, 4, 5, 6), normal(4, 3, 3, 3)),
        ('conv2d_transpose_groups', dict(stride=2, dilation=2, groups=2,
                                         padding=[1, 0, 0, 2]),
         normal(2, 4, 5, 6), normal(4, 3, 3, 3)),
        ('conv2d_transpose_wide', dict(padding=3), normal(2, 4, 5, 6),
         normal(4, 3, 3, 3)),
        ('conv2d_transpose_nhwc', dict(stride=2, padding=1,
                                       data_format='NHWC'),
         normal(2, 5, 6, 4), normal(4, 3, 3, 3)),
        ('conv3d_transpose', dict(stride=(2, 1, 2), padding=1),
         normal(1, 2, 3, 4, 3), normal(2, 3, 3, 2, 3))]:
    _f = 'conv' + _n[4:6] + '_transpose'
    add_j3(f'F.{_n}', fn(lambda F, x, w, b, _f=_f, _kw=_kw: getattr(F, _f)(
        x, w, b, **_kw)), _x, _w, normal(_dim(_w, 1) * _kw.get('groups', 1)))
add_j3('F.conv2d_transpose_bf16', bf16(lambda F, x, w: F.conv2d_transpose(
    x, w, stride=2, padding=1)), normal(2, 4, 5, 6), normal(4, 3, 3, 3),
    tol=BF16)
for _l, _make, _x in [
        ('Conv1D', lambda nn: nn.Conv1D(4, 6, 3, padding=1), _X1),
        ('Conv2D', lambda nn: nn.Conv2D(4, 6, 3, stride=2, padding=1), _X2),
        ('Conv2D_nobias_groups', lambda nn: nn.Conv2D(
            4, 6, (3, 2), groups=2, bias_attr=False), _X2),
        ('Conv2D_nhwc', lambda nn: nn.Conv2D(4, 6, 3, padding='SAME',
                                             data_format='NHWC'),
         normal(2, 7, 8, 4)),
        ('Conv3D', lambda nn: nn.Conv3D(2, 3, 2), _X3),
        ('Conv1DTranspose', lambda nn: nn.Conv1DTranspose(4, 3, 3, stride=2),
         _X1),
        ('Conv2DTranspose', lambda nn: nn.Conv2DTranspose(
            4, 6, 3, stride=2, padding=1, output_padding=1, groups=2), _X2),
        ('Conv3DTranspose', lambda nn: nn.Conv3DTranspose(2, 3, 2, stride=2),
         _X3)]:
    add_j3(f'nn.{_l}', lambda nn, F, _m=_make: _m(nn), _x)

# pooling: numeric and string padding, wide and nested pads, NHWC,
# integers, adaptive bins that do not divide
for _n, _f, _kw, _x in [
        ('max_pool1d', 'max_pool1d', dict(kernel_size=3, stride=2,
                                          padding=1), _X1),
        ('max_pool2d', 'max_pool2d', dict(kernel_size=3, stride=2,
                                          padding=1), _X2),
        ('max_pool2d_same', 'max_pool2d', dict(kernel_size=3, stride=2,
                                               padding='SAME'), _X2),
        ('max_pool2d_wide', 'max_pool2d', dict(kernel_size=3, padding=2),
         _X2),
        ('max_pool2d_nested', 'max_pool2d', dict(
            kernel_size=(2, 3), stride=(2, 1), padding=[(1, 0), (0, 2)]),
         _X2),
        ('max_pool2d_nhwc', 'max_pool2d', dict(kernel_size=2,
                                               data_format='NHWC'),
         normal(2, 7, 8, 4)),
        ('max_pool2d_ignored', 'max_pool2d', dict(
            kernel_size=3, stride=2, ceil_mode=True, return_mask=True), _X2),
        ('max_pool3d', 'max_pool3d', dict(kernel_size=2, stride=(1, 2, 2)),
         _X3),
        ('avg_pool1d', 'avg_pool1d', dict(kernel_size=3, stride=2,
                                          padding=1), _X1),
        ('avg_pool2d', 'avg_pool2d', dict(kernel_size=3, stride=2,
                                          padding=1), _X2),
        ('avg_pool2d_inclusive', 'avg_pool2d', dict(
            kernel_size=3, stride=2, padding=1, exclusive=False), _X2),
        ('avg_pool2d_same', 'avg_pool2d', dict(kernel_size=3, stride=2,
                                               padding='SAME'), _X2),
        ('avg_pool2d_wide', 'avg_pool2d', dict(kernel_size=3, padding=2),
         _X2),
        ('avg_pool2d_nested', 'avg_pool2d', dict(
            kernel_size=(2, 3), padding=[(1, 0), (0, 2)]), _X2),
        ('avg_pool2d_ignored', 'avg_pool2d', dict(
            kernel_size=3, ceil_mode=True, divisor_override=2), _X2),
        ('avg_pool2d_nhwc', 'avg_pool2d', dict(kernel_size=2, padding=1,
                                               data_format='NHWC'),
         normal(2, 7, 8, 4)),
        ('avg_pool3d', 'avg_pool3d', dict(kernel_size=2, padding=1), _X3),
        ('adaptive_avg_pool1d', 'adaptive_avg_pool1d', dict(output_size=4),
         _X1),
        ('adaptive_avg_pool2d', 'adaptive_avg_pool2d', dict(
            output_size=(3, 5)), _X2),
        ('adaptive_avg_pool2d_none', 'adaptive_avg_pool2d', dict(
            output_size=[None, 3]), _X2),
        ('adaptive_avg_pool2d_nhwc', 'adaptive_avg_pool2d', dict(
            output_size=3, data_format='NHWC'), normal(2, 7, 8, 4)),
        ('adaptive_avg_pool3d', 'adaptive_avg_pool3d', dict(
            output_size=(3, 2, 4)), _X3),
        ('adaptive_max_pool1d', 'adaptive_max_pool1d', dict(output_size=4),
         _X1),
        ('adaptive_max_pool2d', 'adaptive_max_pool2d', dict(
            output_size=(3, 5)), _X2),
        ('adaptive_max_pool3d', 'adaptive_max_pool3d', dict(
            output_size=(3, 2, 4)), _X3)]:
    add_j3(f'F.{_n}', fn(lambda F, x, _f=_f, _kw=_kw: getattr(F, _f)(
        x, **_kw)), _x)
add_j3('F.max_pool2d_int', fn(lambda F, x: F.max_pool2d(x, 3, 2, 1)),
       ints(2, 3, 7, 8, hi=1000))
add_j3('F.adaptive_max_pool2d_int', fn(lambda F, x: F.adaptive_max_pool2d(
    x, 3)), ints(2, 3, 7, 8, hi=1000))
for _l, _args, _x in [
        ('MaxPool1D', (3, 2, 1), _X1), ('MaxPool2D', (3, 2, 1), _X2),
        ('MaxPool3D', (2,), _X3), ('AvgPool1D', (2,), _X1),
        ('AvgPool2D', (3, 1, 1), _X2), ('AvgPool3D', (2, 1), _X3),
        ('AdaptiveAvgPool1D', (3,), _X1), ('AdaptiveAvgPool2D', ((1, 1),),
                                           _X2),
        ('AdaptiveAvgPool3D', (2,), _X3), ('AdaptiveMaxPool1D', (3,), _X1),
        ('AdaptiveMaxPool2D', (3,), _X2), ('AdaptiveMaxPool3D', (2,), _X3)]:
    add_j3(f'nn.{_l}', lambda nn, F, _l=_l, _a=_args: getattr(nn, _l)(*_a),
           _x)

# the functional extensions
add_j3('F.sequence_mask', fn(lambda F, n: F.sequence_mask(n, maxlen=6)),
       const(np.array([3, 1, 4], 'int32')))
add_j3('F.sequence_mask_auto', fn(lambda F, n: F.sequence_mask(
    n, dtype='float32')), const(np.array([[3, 1], [4, 2]], 'int32')),
    eager=True)
add_j3('F.diag_embed', fn(lambda F, x: F.diag_embed(x, offset=1)),
       normal(2, 3))
add_j3('F.diag_embed_dims', fn(lambda F, x: F.diag_embed(
    x, offset=-1, dim1=0, dim2=2)), normal(2, 3))
add_j3('F.gather_tree', fn(lambda F, i, p: F.gather_tree(i, p)),
       ints(4, 2, 3, hi=9), ints(4, 2, 3, hi=3))
_UNPOOL = np.stack([np.stack([np.random.RandomState(7 * n + c).permutation(
    16)[:4].reshape(2, 2) for c in range(3)]) for n in range(2)])
add_j3('F.max_unpool2d', fn(lambda F, x, i: F.max_unpool2d(x, i, 2)),
       normal(2, 3, 2, 2), const(_UNPOOL.astype('int32')))
add_j3('F.hsigmoid_loss', fn(lambda F, x, y, w, b: F.hsigmoid_loss(
    x, y, 7, w, b)), normal(4, 5), const(np.array([0, 3, 5, 6], 'int32')),
    normal(6, 5), normal(6, 1))
add_j3('F.margin_cross_entropy', fn(
    lambda F, x, y: F.margin_cross_entropy(x, y)),
    uniform(4, 6, lo=-0.9, hi=0.9), ints(4, hi=6))
add_j3('F.margin_cross_entropy_softmax', fn(
    lambda F, x, y: F.margin_cross_entropy(
        x, y, margin1=0.9, margin2=0.3, margin3=0.1, scale=8.0,
        return_softmax=True, reduction=None)),
    uniform(4, 6, lo=-0.9, hi=0.9), ints(4, 1, hi=6))
add_j3('F.elu_', fn(lambda F, x: F.elu_(x, 0.5)), normal(*E))
add_j3('F.tanh_', fn(lambda F, x: F.tanh_(x)), normal(*E))
add_j3('nn.HSigmoidLoss', lambda nn, F: nn.HSigmoidLoss(5, 6), normal(4, 5),
       const(np.array([0, 3, 5, 2], 'int32')))
add_j3('nn.MaxUnPool2D', lambda nn, F: nn.MaxUnPool2D(2), normal(2, 3, 2, 2),
       const(_UNPOOL.astype('int32')))


# RNNs: 2 layers bidirectional, both time_major, with initial states; the
# cells; RNN / BiRNN; dynamic_decode over an LSTMCell
def _Stateful(nn, rnn, states):
    """A Layer calling ``rnn(x, initial states)`` with ``states`` inputs
    after x (two of them, (h, c), for an LSTM)."""
    class Stateful(nn.Layer):
        def __init__(self):
            super().__init__()
            self.rnn = rnn

        def forward(self, x, *s):
            init = tuple(s) if states == 2 else (s[0] if s else None)
            return self.rnn(x, init)
    return Stateful()


for _l, _kw, _states in [
        ('SimpleRNN', dict(num_layers=2, direction='bidirect'), 1),
        ('SimpleRNN_time_major', dict(time_major=True), 0),
        ('LSTM', dict(num_layers=2, direction='bidirect', time_major=True),
         2),
        ('LSTM_batch_major', dict(num_layers=2), 0),
        ('GRU', dict(num_layers=2, direction='bidirectional'), 1),
        ('GRU_time_major', dict(num_layers=2, direction='bidirect',
                                time_major=True), 0)]:
    _dirs = 2 if 'direction' in _kw else 1
    _ins = [normal(5, 2, 4) if _kw.get('time_major') else normal(2, 5, 4)]
    _ins += [normal(_kw.get('num_layers', 1) * _dirs, 2, 6)] * _states
    # the reference closes over the initial states (its tape gives them no
    # gradient, layer_rnn.py:105-110); the port's get one: held apart
    add_j3(f'nn.{_l}', lambda nn, F, _l=_l, _kw=_kw, _s=_states: _Stateful(
        nn, getattr(nn, _l.split('_')[0])(4, 6, **_kw), _s), *_ins,
        const=range(1, 1 + _states))
for _l, _states in [('SimpleRNNCell', 1), ('LSTMCell', 2), ('GRUCell', 1),
                    ('GRUCell_zero', 0)]:
    add_j3(f'nn.{_l}', lambda nn, F, _l=_l, _s=_states: _Stateful(
        nn, getattr(nn, _l.split('_')[0])(4, 6), _s), normal(3, 4),
        *[normal(3, 6)] * _states)
add_j3('nn.RNN', lambda nn, F: _Stateful(nn, nn.RNN(nn.LSTMCell(4, 6)), 2),
       normal(2, 5, 4), normal(2, 6), normal(2, 6))
add_j3('nn.RNN_reverse_time_major', lambda nn, F: nn.RNN(
    nn.GRUCell(4, 6), is_reverse=True, time_major=True), normal(5, 2, 4))
add_j3('nn.BiRNN', lambda nn, F: nn.BiRNN(nn.SimpleRNNCell(4, 6),
                                          nn.GRUCell(4, 6)), normal(2, 5, 4))
add_j3('nn.RNNCellBase', lambda nn, F: _Stateful(nn, nn.RNNCellBase(4, 6), 1),
       normal(3, 4), normal(3, 6))


def _Decoder(nn, end_token):
    """dynamic_decode over an LSTMCell with an embedding and an output
    projection from initial states (h, c) -> (ids, scores)."""
    class Decoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(7, 4)
            self.cell = nn.LSTMCell(4, 6)
            self.out = nn.Linear(6, 7)

        def forward(self, h, c):
            dec = nn.BeamSearchDecoder(self.cell, 0, end_token, 3,
                                       embedding_fn=self.emb,
                                       output_fn=self.out)
            return nn.dynamic_decode(dec, inits=(h, c), max_step_num=6)
    return Decoder()


add_j3('nn.dynamic_decode', lambda nn, F: _Decoder(nn, 1),
       normal(2, 6, scale=2.0), normal(2, 6, scale=2.0), eager=True)
add_j3('nn.BeamSearchDecoder.tile_beam_merge_with_batch', fn(
    lambda F, x: parent(F).BeamSearchDecoder.tile_beam_merge_with_batch(
        x, 3)), normal(2, 3, 2))


# quantization: the fake quantizers, the wrappers, the weight-only layers
# and the passes over a small conv net
def _ConvNet(nn):
    return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.ReLU(),
                         nn.MaxPool2D(2), nn.Conv2D(4, 4, 1),
                         nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                         nn.Linear(4, 5))


_IMG3 = normal(2, 3, 6, 6)
add_j3('quant.fake_quantize_abs_max', fn(
    lambda F, x: parent(F).quant.fake_quantize_abs_max(x)),
    normal(*E, scale=3.0))
add_j3('quant.fake_channel_wise_quantize_abs_max', fn(
    lambda F, x: parent(F).quant.fake_channel_wise_quantize_abs_max(
        x, bits=4, axis=1)), normal(*E, scale=3.0))
add_j3('quant.fake_quantize_moving_average_abs_max', fn(
    lambda F, x: parent(F).quant.fake_quantize_moving_average_abs_max(
        x, 2.0)), normal(*E, scale=3.0))
add_j3('quant.FakeQuantAbsMax', lambda nn, F: nn.quant.FakeQuantAbsMax(6),
       normal(*E))
add_j3('quant.QuantizedLinear', lambda nn, F: nn.quant.QuantizedLinear(
    nn.Linear(7, 4), weight_quantize_type='abs_max'), normal(*E))
add_j3('quant.QuantizedConv2D', lambda nn, F: nn.quant.QuantizedConv2D(
    nn.Conv2D(3, 4, 3, padding=1),
    activation_quantize_type='moving_average_abs_max'), _IMG3)
add_j3('quant.WeightOnlyLinear', lambda nn, F: nn.quant.WeightOnlyLinear(
    nn.Linear(7, 4)), normal(*E))
add_j3('quant.WeightOnlyConv2D', lambda nn, F: nn.quant.WeightOnlyConv2D(
    nn.Conv2D(3, 4, 3, padding=1, data_format='NHWC')), normal(2, 6, 6, 3))
add_j3('quant.WeightOnlyEmbedding', lambda nn, F: nn.quant.WeightOnlyEmbedding(
    nn.Embedding(9, 6, padding_idx=2)), ints(2, 5, hi=9))
add_j3('quant.quantize_model', lambda nn, F: nn.quant.quantize_model(
    _ConvNet(nn)), _IMG3)
add_j3('quant.weight_only_quantize',
       lambda nn, F: nn.quant.weight_only_quantize(_ConvNet(nn)), _IMG3,
       train=False)
def calibrated_net(P):
    """``_ConvNet`` with seeded weights, QAT wrappers with moving-average
    scales observed over one batch, converted (``convert_calibrated``)."""
    net = P.nn.quant.quantize_model(
        seeded(_ConvNet(P.nn)),
        activation_quantize_type='moving_average_abs_max')
    net(P.to_tensor(calibration_batches(1)[0]))
    return P.nn.quant.convert_calibrated(net)


add_j3('quant.convert_calibrated', lambda nn, F: calibrated_net(parent(nn)),
       _IMG3, train=False)
add_j3('quantization.ImperativeQuantAware', lambda nn, F: parent(
    nn).quantization.ImperativeQuantAware().quantize(_ConvNet(nn)), _IMG3)
add_j3('quantization.quantize_weights', lambda nn, F: parent(
    nn).quantization.quantize_weights(_ConvNet(nn)), _IMG3, train=False)


def calibration_batches(n=3):
    rng = np.random.RandomState(11)
    return [rng.randn(2, 3, 6, 6).astype('float32') for _ in range(n)]


def ptq_net(P):
    """``_ConvNet`` with seeded weights through PostTrainingQuantization
    over ``calibration_batches``."""
    net = seeded(_ConvNet(P.nn))
    return P.quantization.PostTrainingQuantization(
        net, sample_generator=lambda: iter(calibration_batches()),
        batch_nums=2).quantize()


add_j3('quantization.PostTrainingQuantization', lambda nn, F: ptq_net(
    parent(nn)), _IMG3, train=False)


# ---- the run ---------------------------------------------------------------
def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _np(t):
    a = np.asarray(t.numpy())
    return a.astype('float32') if np.issubdtype(a.dtype, np.floating) else a


def state_of(obj, value=_np):
    """A Layer's state_dict through ``value`` (empty for a function)."""
    sd = getattr(obj, 'state_dict', None)
    return {k: value(v) for k, v in sd().items()} if sd else {}


def prepare(P, case, state=None):
    """(the case's Layer or function in package ``P`` with ``state``
    carried in, its numpy inputs)."""
    obj = case.make(P.nn, P.nn.functional)
    if isinstance(obj, P.nn.Layer):
        if state is not None:
            obj.set_state_dict(state)
        if not case.train:
            obj.eval()
    rng = np.random.RandomState(_seed(case.name))
    return obj, [make(rng) for make in case.inputs]


def forward_backward(P, case, obj, arrays, value=_np):
    """The call and its backward -> dict of outputs, input gradients,
    parameter gradients and the state after, each through ``value``
    (a Tensor -> array)."""
    xs = [P.to_tensor(a, stop_gradient=i in case.const or not np.issubdtype(
        a.dtype, np.floating)) for i, a in enumerate(arrays)]
    outs = _flat(obj(*xs))
    loss = None
    for i, o in enumerate(outs):
        if o is None or 'float' not in str(o.dtype):
            continue
        c = np.random.RandomState(_seed(case.name) + i + 1).standard_normal(
            tuple(o.shape)).astype('float32')
        term = (o * P.to_tensor(c)).sum()
        loss = term if loss is None else loss + term
    if loss is not None and not loss.stop_gradient:
        loss.backward()
    is_layer = isinstance(obj, P.nn.Layer)
    return {
        'out': [None if o is None else value(o) for o in outs],
        'in_grad': [None if x.grad is None else value(x.grad) for x in xs],
        'param_grad': ({n: value(p.grad) for n, p in obj.named_parameters()
                        if p.grad is not None} if is_layer else {}),
        'after': state_of(obj, value)}


def run(P, case, state=None):
    """One case in package ``P`` on its current device, eagerly -> the
    ``forward_backward`` dict with numpy values and 'before', the state
    the call started from."""
    obj, arrays = prepare(P, case, state)
    before = state_of(obj)
    res = forward_backward(P, case, obj, arrays)
    res['before'] = before
    return res


def compare(got, want, case, out_tol=1e-5, grad_tol=1e-4):
    """Largest error of each part over the part's largest value (at least
    1): -> {'out', 'grad', 'state', 'ok'}. A missing gradient equals an
    all-zero one; other mismatches of structure raise AssertionError."""

    def err(a, b):
        if a is None and b is None:
            return 0.0
        if a is None or b is None:
            other = np.asarray(b if a is None else a)
            if not np.any(other):
                return 0.0
            raise AssertionError(f'{case.name}: one side has no value')
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            raise AssertionError(f'{case.name}: shape {a.shape} vs '
                                 f'{b.shape}')
        if a.size == 0:
            return 0.0
        a64, b64 = a.astype('float64'), b.astype('float64')
        if not (np.isnan(a64) == np.isnan(b64)).all():
            return float('inf')
        fin = np.isfinite(b64)
        scale = max(1.0, float(np.max(np.abs(b64[fin]))) if fin.any()
                    else 1.0)
        d = np.where(np.isnan(b64), 0.0, np.abs(a64 - b64))
        return float(np.max(d)) / scale

    if len(got['out']) != len(want['out']) or set(got['after']) != set(
            want['after']):
        raise AssertionError(f'{case.name}: outputs or state differ in '
                             'structure')
    pg = set(got['param_grad']) | set(want['param_grad'])
    res = {
        'out': max([err(a, b) for a, b in zip(got['out'], want['out'])]
                   + [0.0]),
        'grad': max([err(a, b) for a, b in zip(got['in_grad'],
                                                want['in_grad'])]
                    + [err(got['param_grad'].get(k), want['param_grad'].get(
                        k)) for k in pg] + [0.0]),
        'state': max([err(got['after'][k], v)
                      for k, v in want['after'].items()] + [0.0]),
    }
    res['ok'] = (res['out'] <= out_tol and res['state'] <= out_tol
                 and res['grad'] <= grad_tol)
    return res


# ---- the ERNIE-width masked-LM program ------------------------------------
# ErnieConfig's defaults (paddle_tpu/models/ernie.py:19-34) written in
# paddle.nn; trained with opt.step() under the fine-tune recipe's
# schedule (examples/finetune_ernie.py:51-54).
ERNIE_BASE = dict(vocab=30522, hidden=768, layers=12, heads=12, ffn=3072,
                  max_seq_len=512, type_vocab=2, dropout=0.1)
MASK_ID = 3


def ernie_mlm(P, vocab, hidden, layers, heads, ffn, max_seq_len=512,
              type_vocab=2, dropout=0.1):
    """Word, position and type embeddings + LayerNorm + Dropout, a
    TransformerEncoder of post-norm GELU layers, a Linear head over the
    vocabulary; ``model.loss(tokens, types, mask, labels)`` is the masked
    LM loss (cross entropy, ignore_index -100, on float32 logits)."""
    nn, F = P.nn, P.nn.functional

    class ErnieMLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(vocab, hidden)
            self.pos = nn.Embedding(max_seq_len, hidden)
            self.type = nn.Embedding(type_vocab, hidden)
            self.norm = nn.LayerNorm(hidden)
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.TransformerEncoder(
                nn.TransformerEncoderLayer(hidden, heads, ffn,
                                           dropout=dropout,
                                           activation='gelu'), layers)
            self.head = nn.Linear(hidden, vocab)

        def forward(self, tokens, types, mask):
            s = tokens.shape[1]
            x = (self.word(tokens) + self.pos(P.arange(s))
                 + self.type(types))
            x = self.drop(self.norm(x))
            return self.head(self.encoder(x, src_mask=mask))

        def loss(self, tokens, types, mask, labels):
            logits = self(tokens, types, mask).astype('float32')
            return F.cross_entropy(logits.reshape([-1, vocab]),
                                   labels.reshape([-1]), ignore_index=-100)

    return ErnieMLM()


def ernie_mlm_mp(P, vocab, hidden, layers, heads, ffn, max_seq_len=512,
                 type_vocab=2, dropout=0.1):
    """``ernie_mlm`` written with ``fleet.meta_parallel``'s layers, one
    source for any mp degree: a Column qkv of 3 x hidden laid out head by
    head ([q_h, k_h, v_h] for each head h, so a column block holds whole
    heads) and a Row out-projection; a Column fc1 and a Row fc2
    (``input_is_parallel``); a ``VocabParallelEmbedding`` word table; a
    Column LM head with ``gather_output``; attention through
    ``F.scaled_dot_product_attention`` on the rank's heads (reshaped to
    [b, s, -1, head_dim], never a fixed head count). At mp = 1 it is
    ``ernie_mlm``'s function, weight for weight (``mlm_mp_state``)."""
    nn, F = P.nn, P.nn.functional
    fleet = P.distributed.fleet
    hd = hidden // heads

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.qkv = fleet.ColumnParallelLinear(hidden, 3 * hidden,
                                                  gather_output=False)
            self.out = fleet.RowParallelLinear(hidden, hidden,
                                               input_is_parallel=True)
            self.fc1 = fleet.ColumnParallelLinear(hidden, ffn,
                                                  gather_output=False)
            self.fc2 = fleet.RowParallelLinear(ffn, hidden,
                                               input_is_parallel=True)
            self.norm1 = nn.LayerNorm(hidden)
            self.norm2 = nn.LayerNorm(hidden)
            self.drop1 = nn.Dropout(dropout)
            self.drop2 = nn.Dropout(dropout)
            self.drop_act = nn.Dropout(dropout)

        def forward(self, x, mask):
            b, s = x.shape[0], x.shape[1]
            qkv = self.qkv(x).reshape([b, s, -1, 3 * hd])
            q, k, v = qkv[:, :, :, :hd], qkv[:, :, :, hd:2 * hd], \
                qkv[:, :, :, 2 * hd:]
            a = F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask,
                dropout_p=dropout if self.training else 0.0,
                training=self.training)
            x = self.norm1(x + self.drop1(self.out(a.reshape([b, s, -1]))))
            h = self.fc2(self.drop_act(F.gelu(self.fc1(x))))
            return self.norm2(x + self.drop2(h))

    class ErnieMLMmp(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = fleet.VocabParallelEmbedding(vocab, hidden)
            self.pos = nn.Embedding(max_seq_len, hidden)
            self.type = nn.Embedding(type_vocab, hidden)
            self.norm = nn.LayerNorm(hidden)
            self.drop = nn.Dropout(dropout)
            self.layers = nn.LayerList([Block() for _ in range(layers)])
            self.head = fleet.ColumnParallelLinear(hidden, vocab,
                                                   gather_output=True)

        def forward(self, tokens, types, mask):
            s = tokens.shape[1]
            x = (self.word(tokens) + self.pos(P.arange(s))
                 + self.type(types))
            x = self.drop(self.norm(x))
            for blk in self.layers:
                x = blk(x, mask)
            return self.head(x)

        def loss(self, tokens, types, mask, labels):
            logits = self(tokens, types, mask).astype('float32')
            return F.cross_entropy(logits.reshape([-1, vocab]),
                                   labels.reshape([-1]), ignore_index=-100)

    return ErnieMLMmp()


_MP_NAMES = (('self_attn.out_proj', 'out'), ('linear1', 'fc1'),
             ('linear2', 'fc2'), ('norm1', 'norm1'), ('norm2', 'norm2'))


def mlm_mp_state(state, heads):
    """``ernie_mlm``'s state dict (numpy, by name) -> ``ernie_mlm_mp``'s:
    q / k / v projections interleaved head by head into ``qkv``, the rest
    renamed."""
    out = {}
    for k, v in state.items():
        if not k.startswith('encoder.layers.'):
            out[k] = v
            continue
        i, rest = k[len('encoder.layers.'):].split('.', 1)
        for a, b in _MP_NAMES:
            if rest.startswith(a + '.'):
                out[f'layers.{i}.{b}{rest[len(a):]}'] = v
    n_layers = len({k.split('.')[2] for k in state
                    if k.startswith('encoder.layers.')})
    for i in range(n_layers):
        pre = f'encoder.layers.{i}.self_attn.'
        for kind in ('weight', 'bias'):
            parts = [np.asarray(state[f'{pre}{n}_proj.{kind}'])
                     for n in 'qkv']
            lead = parts[0].shape[:-1]
            h = parts[0].shape[-1]
            st = np.stack([p.reshape(lead + (heads, h // heads))
                           for p in parts], axis=-2)
            out[f'layers.{i}.qkv.{kind}'] = st.reshape(lead + (3 * h,))
    return out


def mlm_state_from_mp(state, heads):
    """``mlm_mp_state``'s inverse: ``ernie_mlm_mp``'s state -> the names
    and layout of ``ernie_mlm``'s."""
    out = {}
    for k, v in state.items():
        if not k.startswith('layers.'):
            out[k] = v
            continue
        i, rest = k[len('layers.'):].split('.', 1)
        for a, b in _MP_NAMES:
            if rest.startswith(b + '.'):
                out[f'encoder.layers.{i}.{a}{rest[len(b):]}'] = v
        if rest.startswith('qkv.'):
            kind = rest[len('qkv.'):]
            v = np.asarray(v)
            lead = v.shape[:-1]
            h = v.shape[-1] // 3
            st = v.reshape(lead + (heads, 3, h // heads))
            for j, n in enumerate('qkv'):
                out[f'encoder.layers.{i}.self_attn.{n}_proj.{kind}'] = \
                    st[..., j, :].reshape(lead + (h,))
    return out


def mlm_batch(vocab, b, s, lo, hi, seed=0, mask_share=0.15, per_row=None):
    """(tokens int32 [B, S], types int32 [B, S], key-padding mask bool
    [B, 1, 1, S], labels int32 [B, S], lengths): lengths from numpy
    ``seed`` in [lo, hi]; ``mask_share`` of the real positions masked
    (their labels the tokens, the inputs MASK_ID), -100 elsewhere; with
    ``per_row``, exactly that many real positions of each row (so every
    block of rows holds its share of the masked tokens: the mean of the
    blocks' mean losses is the batch's)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi + 1, b)
    pos = np.arange(s)[None, :]
    real = pos < lens[:, None]
    toks = np.where(real, rng.randint(5, vocab, (b, s)), 0).astype('int32')
    types = (real & (pos >= lens[:, None] // 2)).astype('int32')
    if per_row is None:
        picked = real & (rng.rand(b, s) < mask_share)
    else:
        picked = np.zeros((b, s), bool)
        for r in range(b):
            picked[r, rng.choice(lens[r], per_row, replace=False)] = True
    labels = np.where(picked, toks, -100).astype('int32')
    toks = np.where(picked, MASK_ID, toks).astype('int32')
    return toks, types, real[:, None, None, :], labels, lens


def mlm_optimizer(P, model, peak=1e-4, warmup=10, decay_steps=100):
    """AdamW over LinearWarmup(PolynomialDecay) with weight decay 0.01 and
    a global-norm clip of 1.0 -> (optimizer, scheduler)."""
    lr = P.optimizer.lr
    sched = lr.LinearWarmup(lr.PolynomialDecay(peak, decay_steps=decay_steps),
                            warmup_steps=warmup, start_lr=0.0, end_lr=peak)
    opt = P.optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                            grad_clip=P.nn.ClipGradByGlobalNorm(1.0),
                            parameters=model.parameters())
    return opt, sched


def mlm_step(P, model, opt, sched, batch, amp=None):
    """One training step: the loss (under ``auto_cast(dtype=amp)`` when
    ``amp`` names a dtype), ``loss.backward()``, ``opt.step()``,
    ``opt.clear_grad()``, ``sched.step()`` -> the loss Tensor."""
    with P.amp.auto_cast(enable=amp is not None, dtype=amp or 'bfloat16'):
        loss = model.loss(*batch)
    loss.backward()
    opt.step()
    opt.clear_grad()
    sched.step()
    return loss


def mlm_loss(P, vocab):
    """hapi's loss for the program: cross entropy (ignore_index -100) of
    float32 logits [B, S, vocab] against labels [B, S]."""
    ce = P.nn.CrossEntropyLoss(ignore_index=-100)

    def loss(logits, labels):
        return ce(logits.astype('float32').reshape([-1, vocab]),
                  labels.reshape([-1]))
    return loss


def mlm_rows(P, arrays):
    """A map dataset over ``mlm_batch``'s arrays, one row an item
    (tokens, types, key-padding mask, labels): what ``P.io.DataLoader``
    batches for ``P.Model(program).fit``."""
    class Rows(P.io.Dataset):
        def __getitem__(self, i):
            return tuple(a[i] for a in arrays)

        def __len__(self):
            return len(arrays[0])
    return Rows()


def _torch_np(t):
    """A torch tensor on any device as a float32 (or its own dtype)
    ndarray."""
    return _np(t.detach().cpu())


def record_applies(opt, value=_torch_np):
    """Wrap the port's ``opt.functional_apply`` (what hapi's step calls) ->
    a list that gets (gradients by name, learning rate) of each update,
    through ``value``."""
    calls, inner = [], opt.functional_apply

    def apply(params, grads, opt_state, lr=None):
        calls.append(({n: value(g) for n, g in grads.items()
                       if g is not None}, float(lr)))
        return inner(params, grads, opt_state, lr)
    opt.functional_apply = apply
    return calls


def fit_record(P, model, loader, epochs, calls, value=_np, **kw):
    """``model.fit(loader, epochs, log_freq=1)`` -> (each step's loss, each
    update's gradients, their learning rates, the state dict after),
    ``mlm_agreement``'s form; ``calls`` from ``record_applies``."""
    losses = []

    class Losses(P.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs['loss']))

    model.fit(loader, epochs=epochs, log_freq=1, verbose=0,
              callbacks=[Losses()], **kw)
    return (losses, [g for g, _ in calls], [lr for _, lr in calls],
            {k: value(v) for k, v in model.network.state_dict().items()})


def mlm_two_steps(P, model, arrays, value=_np, peak=1e-2, warmup=0):
    """Two steps of the program, with no warm-up so that both move the
    weights, each ``mlm_step`` with its gradients read before
    ``opt.step()`` -> (losses [2], gradients by name for each step, the
    learning rate of each step, state_dict after), each through
    ``value``."""
    batch = [P.to_tensor(a) for a in arrays]
    opt, sched = mlm_optimizer(P, model, peak=peak, warmup=warmup)
    losses, grads, lrs = [], [], []
    for _ in range(2):
        loss = model.loss(*batch)
        loss.backward()
        grads.append({n: value(p.grad) for n, p in model.named_parameters()})
        losses.append(value(loss))
        lrs.append(float(opt.get_lr()))
        opt.step()
        opt.clear_grad()
        sched.step()
    return losses, grads, lrs, {k: value(v) for k, v in
                                model.state_dict().items()}


def adamw_steps(start, grads, lrs, beta1=0.9, beta2=0.999, eps=1e-8,
                coeff=0.01, clip_norm=1.0):
    """``mlm_optimizer``'s steps in float64 (torch on the CPU, its threads:
    numpy's single thread took ~10 s at ERNIE-base width): per step the
    global-norm clip (none when ``clip_norm`` is None), the decoupled decay
    (none at ``coeff`` 0: plain Adam), then Adam's update -> parameters by
    name as numpy arrays (``start``'s entries without a gradient as they
    were)."""
    import torch

    def f64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64)
    p = {n: f64(v) for n, v in start.items()}
    m = {n: 0.0 for n in grads[0]}
    v = dict(m)
    for t, (gs, lr) in enumerate(zip(grads, lrs), 1):
        gs, lr = {n: f64(g) for n, g in gs.items()}, float(lr)
        norm = float(torch.sqrt(sum(torch.square(g).sum()
                                    for g in gs.values())))
        scale = 1.0 if clip_norm is None else clip_norm / max(norm,
                                                                clip_norm)
        for n, g in gs.items():
            g = g * scale
            m[n] = beta1 * m[n] + (1 - beta1) * g
            v[n] = beta2 * v[n] + (1 - beta2) * g * g
            p[n] = p[n] * (1 - lr * coeff) - lr * (m[n] / (1 - beta1 ** t)) / (
                torch.sqrt(v[n] / (1 - beta2 ** t)) + eps)
    return {n: x.numpy() for n, x in p.items()}


def mlm_agreement(got, want, start, **adamw):
    """How far ``mlm_two_steps``' results are apart, from the parameters
    ``start`` -> {'loss': relative, each step's, 'grad': each first
    gradient's largest error over its largest value (at least 1),
    'param': the parameters' largest error after two steps beyond what
    the gradients' gaps explain, over the leaf's largest value (at least
    1), 'param_raw': the same without taking the gaps out}.

    Where a gradient is near AdamW's epsilon, Adam's update is about
    g / eps, a gain of lr / eps (1e6 at a peak of 1e-2) on the gradient's
    last bits, which two f32 summation orders round apart (k_proj's bias,
    0 in exact arithmetic by the softmax's shift invariance, and weight
    entries that cancel to ~1e-9). So each package's parameters are taken
    less what ``adamw_steps`` makes of its own gradients, in float64, and
    the two remainders must agree within 1e-4: every entry, none exempt.
    ``adamw`` goes to ``adamw_steps`` (another optimizer's decay, clip,
    betas or eps); any number of steps.
    'raw_beyond' counts the entries more than 1e-4 apart before that, and
    'raw_beyond_grad_max' is the largest first gradient among them."""
    (gl, gg, glr, gp), (wl, wg, wlr, wp) = got, want
    if sorted(gg[0]) != sorted(wg[0]) or sorted(gp) != sorted(wp):
        raise AssertionError('the two programs name their weights apart')
    if not np.allclose(glr, wlr, rtol=1e-6, atol=0):
        raise AssertionError(f'learning rates {glr} against {wlr}')
    pg, pw = (adamw_steps(start, gg, glr, **adamw),
              adamw_steps(start, wg, wlr, **adamw))
    res = {'loss': max(abs(float(a) - float(b)) / abs(float(b))
                       for a, b in zip(gl, wl)),
           'grad': 0.0, 'param': 0.0, 'param_raw': 0.0, 'raw_beyond': 0,
           'raw_beyond_grad_max': 0.0}
    for n, w in wg[0].items():
        res['grad'] = max(res['grad'], float(np.abs(gg[0][n] - w).max())
                          / max(1.0, float(np.abs(w).max())))
    for n, w in wp.items():
        scale = max(1.0, float(np.abs(w).max()))
        raw = np.abs(np.asarray(gp[n], np.float64) - w)
        left = np.abs((gp[n] - pg[n]) - (w - pw[n]))
        res['param'] = max(res['param'], float(left.max()) / scale)
        res['param_raw'] = max(res['param_raw'], float(raw.max()) / scale)
        beyond = raw > 1e-4 * scale
        if beyond.any():
            res['raw_beyond'] += int(beyond.sum())
            res['raw_beyond_grad_max'] = max(
                res['raw_beyond_grad_max'],
                float(np.abs(wg[0][n])[beyond].max()))
    res['ok'] = (res['loss'] <= 1e-4 and res['grad'] <= 1e-4
                 and res['param'] <= 1e-4)
    return res
