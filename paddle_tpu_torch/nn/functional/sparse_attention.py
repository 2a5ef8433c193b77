"""Attention functionals. Port of
``paddle_tpu/nn/functional/sparse_attention.py``.

``scaled_dot_product_attention`` routes, as the reference routes to its
Pallas kernels (``:48-95``), to ``ops.flash_attention.flash_attention``:
kernel 1 forward, kernels 2 and 3 backward on a CUDA tensor (their twins
on a CPU tensor), whenever the kernels take the call (``kernel_route``):
head dim in ``HEAD_DIMS``, q, k and v of one dtype, float32 or bfloat16,
kv heads dividing q heads, no mask or a key-padding mask, dropout below 1.
The route is decided from shapes and dtypes before any launch; a CUDA
call on the kernel route whose kernel cannot load raises. Every other call
(float16, other head dims, dense [S_q, S_k] masks such as a causal
additive mask, dropout 1) takes ``_sdpa_plain``, the reference's
``_sdpa_xla``. The reference's TPU-only ``S_k >= 128`` gate is not
carried over: the port's kernels take every S_k.

Dropout on the kernel route is the kernels' counter hash of a u32 seed
drawn from the port's CPU generator (``tensor/random.py``; ``paddle.seed``
seeds it, and drawing on the host costs the card no sync); on the plain
route a Bernoulli mask from the generator of q's device.
"""
import math

import torch

from ...core import dispatch
from ...core.dispatch import _unwrap, wrap_out
from ...ops import flash_attention as fa
from ...tensor.random import generator

__all__ = ['scaled_dot_product_attention']


def _sdpa_plain(q, k, v, mask=None, dropout_p=0.0, causal=False,
                scale=None):
    """softmax(q k^T * scale [+ mask]) v over [B, S, H, D] tensors, the
    reference's ``_sdpa_xla``: a bool mask keeps True entries (others
    -1e30), another adds; a mask of rank < 4 broadcasts as a key-padding
    mask (``lift_mask_4d``). Inverted dropout on the probabilities."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum('...qhd,...khd->...hqk', q, k) * scale
    neg = torch.full((), -1e30, dtype=scores.dtype, device=scores.device)
    if causal:
        qlen, klen = scores.shape[-2], scores.shape[-1]
        cm = torch.ones((qlen, klen), dtype=torch.bool,
                        device=q.device).tril(klen - qlen)
        scores = torch.where(cm, scores, neg)
    if mask is not None:
        mask = fa.lift_mask_4d(mask)
        if mask.dtype == torch.bool:
            scores = torch.where(mask, scores, neg)
        else:
            scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1)
    if dropout_p:
        if dropout_p >= 1.0:
            # everything dropped: zeros with zero gradients
            return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
        u = torch.rand(probs.shape, generator=generator(q.device),
                       device=q.device, dtype=torch.float32)
        probs = torch.where(u < 1.0 - dropout_p, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.einsum('...hqk,...khd->...qhd', probs, v)


def kernel_route(q, k, v, mask, drop):
    """True when kernels 1-3 take the call (their twins on the CPU): a
    rule over shapes and dtypes, decided before any launch."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return False
    b, h, d = int(q.shape[0]), int(q.shape[2]), int(q.shape[3])
    s_k, h_kv = int(k.shape[1]), int(k.shape[2])
    if h_kv == 0 or h % h_kv or int(v.shape[2]) != h_kv:
        return False
    if mask is not None and not fa._key_mask_normalizable(mask, b, s_k):
        return False
    return (drop < 1.0 and d in fa.HEAD_DIMS
            and q.dtype in (torch.float32, torch.bfloat16)
            and k.dtype == q.dtype and v.dtype == q.dtype
            and tuple(v.shape[:2]) == tuple(k.shape[:2]))


def _draw_seed():
    """A u32 dropout seed for the kernels, from the port's CPU
    generator."""
    g = generator(torch.device('cpu'))
    return int(torch.randint(0, 2 ** 32, (), generator=g,
                             dtype=torch.int64))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """query / key / value: [batch, seq, heads, head_dim] (Paddle's
    layout). Attention dropout (``dropout_p`` while training) stays on
    the kernel route: kernels 1-3 draw their mask from a counter hash of
    the seed, regenerated in the backward."""
    q, k, v = _unwrap([query, key, value])
    hook = dispatch.amp_cast_hook
    if hook is not None:
        q, k, v = hook('scaled_dot_product_attention', [q, k, v])
    mask = _unwrap(attn_mask)
    drop = float(dropout_p or 0.0) if training else 0.0
    if kernel_route(q, k, v, mask, drop):
        seed = _draw_seed() if drop else None
        out = fa.flash_attention(q, k, v, causal=is_causal, mask=mask,
                                 dropout_rate=drop, dropout_seed=seed)
    else:
        out = _sdpa_plain(q, k, v, mask=mask, causal=is_causal,
                          dropout_p=drop)
    return wrap_out(out)
