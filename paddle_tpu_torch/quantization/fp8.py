"""fp8 matmul numerics with per-tensor delayed scaling.

Port of ``paddle_tpu/quantization/fp8.py``: ``x @ w`` with e4m3 forward
operands and an e5m2 output gradient, each tensor role scaled by the
largest value of its amax history ring (``HISTORY_LEN`` entries), so the
scale a step applies was computed from the steps before it.

The state rides the gradients, as in the reference: ``in_qdq`` and
``out_qdq`` (``torch.autograd.Function``s) return the UPDATED ``(scale,
ahist)`` as the "gradients" of their scale and history inputs, so
``torch.autograd.grad(loss, params + fp8 leaves)`` gives the parameters'
gradients and the new state in one backward pass. Nothing is written in
the forward: a block that ``torch.utils.checkpoint`` runs again in the
backward pushes each history once.

Two routes, chosen by the operands' device before the call:

 - a CPU tensor runs the twin, the reference's arithmetic step for step
   in f32 with torch's float8 casts (which round as JAX's do):
   ``quantize_dequantize`` of x and of w, a product in the compute dtype,
   and in the backward the output gradient quantize-dequantized in e5m2,
   then ``dx = qg @ qwᵀ`` and ``dw = qxᵀ @ qg``;
 - a CUDA tensor runs the products on the fp8 tensor cores through
   ``torch._scaled_mm`` with the per-tensor scales as f32 scalars on the
   device (the reference's divisor is the dequantization scale): the
   forward e4m3 x e4m3, dx e5m2 x e4m3, dw e4m3 x e5m2 (Hopper has no
   e5m2 x e5m2), f32 accumulation, the output in the compute dtype.
   Dimensions short of a multiple of 16 are padded with zeros, which
   change neither an amax nor a product. Each per-tensor scale must sit
   at a 16-byte aligned address (cuBLASLt has no fp8 algorithm for
   another): ``layer_scales`` gives a stacked [L] scale's per-layer views
   so. ``scaled_mm_calls`` counts the products requested from
   ``torch._scaled_mm``; a selective-checkpoint recompute that the cache
   serves requests one and launches nothing.

Over a mesh (the dp/mp train step) an operand is a block of the
reference's global tensor, whose amax is over the whole of it: each
amax is reduced (MAX) over the group of the axes that shard that operand
(``fp8_matmul(..., groups=(gx, gw, gg))``) before it enters the history,
so every rank's new scales and histories are the reference's. The
quantize itself needs no collective: it applies the (replicated) delayed
scale to the rank's block.

The reference computes this product with XLA outside any Pallas kernel;
the amax, the scale and the casts here are plain torch ops.
"""
import functools

import torch
import torch.nn.functional as F

__all__ = ['E4M3', 'E5M2', 'E4M3_MAX', 'E5M2_MAX', 'HISTORY_LEN',
           'available', 'dtype_max', 'compute_scale', 'update_history',
           'quantize_dequantize', 'qdq_dynamic', 'in_qdq', 'out_qdq',
           'fp8_matmul', 'fp8_matmul_reference', 'init_meta',
           'init_matmul_meta', 'layer_scales', 'found_inf']

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
E4M3_MAX = 448.0
E5M2_MAX = 57344.0
HISTORY_LEN = 16

# products requested from torch._scaled_mm (forward, dx and dw each one)
scaled_mm_calls = 0


def dtype_max(q_dtype):
    """Largest finite magnitude of an fp8 format."""
    return float(torch.finfo(q_dtype).max)


@functools.lru_cache(maxsize=None)
def available():
    """True when this torch carries the float8 dtypes and can cast
    through them (probed once per process, on the CPU)."""
    try:
        x = torch.ones((2, 2))
        torch.matmul(x.to(E4M3).float(), x.to(E5M2).float())
        return True
    except (RuntimeError, TypeError):
        return False


def _amax(x, group=None):
    """``max |x|`` in f32; with a ``Group``, over every rank's block."""
    a = torch.amax(torch.abs(x)).to(torch.float32)
    if group is not None and group.nranks > 1:
        from ..distributed.collective import pmax
        a = pmax(a, group)
    return a


def _scale_of(amax, q_dtype):
    """``amax / format max``, or 1 where amax is 0. The divisor is a
    tensor on amax's device: torch divides a CUDA tensor by a Python
    scalar as a multiply by its reciprocal, which can round one ulp away
    from the CPU's (and the reference's) quotient."""
    m = torch.full_like(amax, dtype_max(q_dtype))
    return torch.where(amax > 0.0, amax / m, torch.ones_like(amax))


def compute_scale(amax_history, q_dtype):
    """Delayed-scaling divisor from an amax history ring: the largest
    recent amax mapped to the format max; a cold all-zero history gives
    1."""
    return _scale_of(torch.amax(amax_history), q_dtype).to(torch.float32)


def update_history(amax_history, x, group=None):
    """Ring-push ``amax(|x|)`` into slot 0 (the oldest entry falls off);
    ``group``: the amax of the global tensor whose blocks the group's
    ranks hold."""
    return torch.cat([_amax(x, group)[None], amax_history[:-1]])


def _quantize(x, q_dtype, scale):
    """``x / scale`` saturated at the format max and rounded to ``q_dtype``."""
    m = dtype_max(q_dtype)
    return torch.clamp(x.to(torch.float32) / scale, -m, m).to(q_dtype)


def quantize_dequantize(x, q_dtype, scale):
    """Round-trip ``x`` through ``q_dtype`` with divisor ``scale``; the
    result keeps ``x``'s dtype, the arithmetic runs in f32."""
    return (_quantize(x, q_dtype, scale).to(torch.float32)
            * scale).to(x.dtype)


def qdq_dynamic(x, q_dtype=E4M3):
    """Current scaling (the scale from THIS tensor's amax): the eager
    ``amp.auto_cast(dtype='float8')`` path, which has no state to delay
    against."""
    return quantize_dequantize(x, q_dtype, _scale_of(_amax(x), q_dtype))


# ---------------------------------------------------------------------------
# the twin: state updates ride the gradients
# ---------------------------------------------------------------------------

class _InQdq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_dtype, x, scale, amax_history, group=None):
        new_hist = update_history(amax_history, x, group)
        ctx.save_for_backward(compute_scale(new_hist, q_dtype), new_hist)
        return quantize_dequantize(x, q_dtype, scale)

    @staticmethod
    def backward(ctx, g):
        new_scale, new_hist = ctx.saved_tensors
        return None, g, new_scale, new_hist, None


class _OutQdq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_dtype, out, scale, amax_history, group=None):
        ctx.q_dtype = q_dtype
        ctx.group = group
        ctx.save_for_backward(scale, amax_history)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        scale, amax_history = ctx.saved_tensors
        new_hist = update_history(amax_history, g, ctx.group)
        return (None, quantize_dequantize(g, ctx.q_dtype, scale),
                compute_scale(new_hist, ctx.q_dtype), new_hist, None)


def in_qdq(q_dtype, x, scale, amax_history, group=None):
    """Quantize-dequantize a forward operand (x or w) in ``q_dtype`` with
    the delayed scale. Backward: the operand's gradient passes through;
    the scale's and history's "gradients" are their updated values (the
    amax over ``group``'s blocks, when given)."""
    return _InQdq.apply(q_dtype, x, scale, amax_history, group)


def out_qdq(q_dtype, out, scale, amax_history, group=None):
    """Identity forward; the backward quantize-dequantizes the output
    gradient in ``q_dtype`` (e5m2) with the delayed scale, and the scale's
    and history's "gradients" carry the state observed from that
    gradient (over ``group``'s blocks, when given)."""
    return _OutQdq.apply(q_dtype, out, scale, amax_history, group)


# ---------------------------------------------------------------------------
# the card: products on the fp8 tensor cores
# ---------------------------------------------------------------------------

def _scaled_mm(a, b, scale_a, scale_b, out_dtype):
    """``(a * scale_a) @ (b * scale_b)``: ``a`` row-major and ``b``
    column-major fp8, f32 accumulation."""
    global scaled_mm_calls
    if scale_a.data_ptr() % 16 or scale_b.data_ptr() % 16:
        raise ValueError('fp8_matmul: a scale at an address that is not '
                         '16-byte aligned (take per-layer views of a '
                         'stacked scale with fp8.layer_scales)')
    scaled_mm_calls += 1
    return torch._scaled_mm(a, b, scale_a=scale_a, scale_b=scale_b,
                            out_dtype=out_dtype, use_fast_accum=False)


def _pad16(t):
    """``t`` [r, c] padded with zeros to multiples of 16."""
    r, c = t.shape
    pr, pc = -r % 16, -c % 16
    return F.pad(t, (0, pc, 0, pr)) if pr or pc else t


class _ScaledMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, sx, hx, sw, hw, sg, hg, groups=(None,) * 3):
        k, n = w.shape
        lead = x.shape[:-1]
        x2 = x.reshape(-1, k)
        qx = _quantize(_pad16(x2), E4M3, sx)          # [M, K] row-major
        qw = _quantize(_pad16(w), E4M3, sw)           # [K, N] row-major
        out = _scaled_mm(qx, qw.t().contiguous().t(), sx, sw, x.dtype)
        new_hx = update_history(hx, x, groups[0])
        new_hw = update_history(hw, w, groups[1])
        ctx.group_g = groups[2]
        ctx.save_for_backward(qx, qw, sx, sw, sg, hg,
                              compute_scale(new_hx, E4M3), new_hx,
                              compute_scale(new_hw, E4M3), new_hw)
        ctx.shape = (x2.shape[0], k, n, lead)
        return out[:x2.shape[0], :n].reshape(*lead, n)

    @staticmethod
    def backward(ctx, g):
        qx, qw, sx, sw, sg, hg, nsx, nhx, nsw, nhw = ctx.saved_tensors
        m, k, n, lead = ctx.shape
        g2 = g.reshape(m, n)
        qg = _quantize(_pad16(g2), E5M2, sg)          # [M, N] row-major
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _scaled_mm(qg, qw.t(), sg, sw, g.dtype)[:m, :k]
            dx = dx.reshape(*lead, k)
        if ctx.needs_input_grad[1]:
            dw = _scaled_mm(qx.t().contiguous(), qg.t().contiguous().t(),
                            sx, sg, g.dtype)[:k, :n]
        nhg = update_history(hg, g2, ctx.group_g)
        return (dx, dw, nsx, nhx, nsw, nhw, compute_scale(nhg, E5M2), nhg,
                None)


def _meta_leaves(meta):
    return [meta[r][k] for r in ('x', 'w', 'g') for k in ('scale', 'ahist')]


def fp8_matmul_reference(x, w, meta, groups=None):
    """The twin, on any device: the reference's ``fp8_matmul``
    (quantize-dequantize x and w, a product in their dtype, the output
    gradient quantize-dequantized in the backward)."""
    gx, gw, gg = groups or (None,) * 3
    m = _meta_leaves(meta)
    qx = in_qdq(E4M3, x, m[0], m[1], gx)
    qw = in_qdq(E4M3, w, m[2], m[3], gw)
    return out_qdq(E5M2, torch.matmul(qx, qw), m[4], m[5], gg)


def fp8_matmul(x, w, meta, groups=None):
    """``x @ w`` ([..., K] @ [K, N]) with e4m3 forward operands and an
    e5m2 gradient, per-tensor delayed scaling from ``meta``
    (``init_matmul_meta``). Differentiating w.r.t. ``meta`` gives the
    updated state, not a gradient. CPU tensors run the twin
    (``fp8_matmul_reference``), CUDA tensors the fp8 tensor cores;
    anything else raises. ``groups`` (a mesh step's): the ``Group`` (or
    None) whose ranks hold blocks of x, of w and of the output gradient,
    each amax reduced over it."""
    if x.device.type == 'cpu':
        return fp8_matmul_reference(x, w, meta, groups)
    if x.device.type != 'cuda':
        raise ValueError(f'fp8_matmul runs on cuda or cpu, not {x.device}')
    if x.dtype != w.dtype or w.dim() != 2:
        raise ValueError(f'fp8_matmul takes x and a 2-D w of one dtype, got '
                         f'{x.dtype} and {w.dtype} {tuple(w.shape)}')
    return _ScaledMatmul.apply(x, w, *_meta_leaves(meta),
                               groups or (None,) * 3)


# ---------------------------------------------------------------------------
# the scaling state
# ---------------------------------------------------------------------------

def init_meta(layers=None, history_len=HISTORY_LEN, device=None):
    """One tensor role's scaling state ``{'scale', 'ahist'}`` (f32) on
    ``device`` (the card unless the caller names the CPU). ``layers``
    stacks a leading dim, one meta a layer beside the stacked blocks."""
    from .. import resolve_device
    dev = resolve_device(device)
    lead = () if layers is None else (int(layers),)
    return {'scale': torch.ones(lead, dtype=torch.float32, device=dev),
            'ahist': torch.zeros(lead + (history_len,), dtype=torch.float32,
                                 device=dev)}


def init_matmul_meta(layers=None, history_len=HISTORY_LEN, device=None):
    """Scaling state for one matmul: roles 'x' (activation, e4m3), 'w'
    (weight, e4m3) and 'g' (output gradient, e5m2)."""
    return {r: init_meta(layers, history_len, device) for r in ('x', 'w', 'g')}


def layer_scales(scale):
    """A stacked [L] scale as L 0-d views, each at a 16-byte aligned
    address (``_scaled_mm`` needs it; ``scale.unbind(0)`` puts layer l 4l
    bytes in). The backward routes each layer's value back to its slot."""
    return F.pad(scale[:, None], (0, 3))[:, 0].unbind(0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def found_inf(state):
    """A bool tensor on the state's device: any non-finite amax or scale
    anywhere in an fp8 state tree (an overflow lands in the freshest
    history slot). No host sync: the caller decides when to read it."""
    leaves = _leaves(state)
    if not leaves:
        return torch.zeros((), dtype=torch.bool)
    return torch.stack([~torch.isfinite(t).all() for t in leaves]).any()
