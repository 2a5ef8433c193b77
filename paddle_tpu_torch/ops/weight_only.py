"""Weight-only int8 numerics for serving, shared by every weight consumer
of the GPT and MoE serving paths (``wo_bmm``: the MoE expert banks), and
the int8 KV-cache rows of the dense decode cache and the page pool.

Port of ``paddle_tpu/ops/weight_only.py``. A weight is either a raw tensor
(``[in, out]`` for matmuls, ``[V, H]`` for the tied embedding) kept in the
parameter dtype, or its weight-only int8 form ``{'int8': int8 [..., out],
'scale': f32 [..., out]}``: symmetric per-channel, one f32 scale per
output channel (per vocab row for ``wte``). Each helper takes either, so
one model body serves both:

    y @ (q * s)  ==  (y @ q.to(cdt)) * s        (s broadcast over rows)

A raw weight is cast to the compute dtype before the product, exactly as
the reference does (``y @ w.astype(cdt)``); a caller may hand in weights
already cast (the engine keeps such a copy, made once at load): the ``.to``
is then a no-op and the numbers are the same. The reference's int8 products
lower through XLA, which folds the int8 -> compute-dtype convert into the
matmul's operand read; here the convert is its own op before
``torch.matmul`` (it reads the int8 bytes, writes and rereads a
compute-dtype copy), so the int8 form saves memory, not time.
"""

import torch


def quantize_weight(w, reduce_axis):
    """Symmetric per-channel int8: amax over ``reduce_axis`` (the
    contraction/input axis), ``scale = max(amax, 1e-8) / 127``, values
    rounded half to even (``torch.round``, as ``jnp.round``) and clipped to
    [-127, 127]. -> ``{'int8', 'scale'}`` with ``scale`` shaped like ``w``
    minus the reduced axis."""
    q, scale = _quantize(w, reduce_axis)
    return {'int8': q, 'scale': scale.squeeze(reduce_axis)}


def dequantize_weight(w, reduce_axis):
    """Reconstruct the f32 weight (test/inspection helper)."""
    return w['int8'].float() * w['scale'].unsqueeze(reduce_axis)


def is_weight_only(w):
    return isinstance(w, dict) and 'int8' in w and 'scale' in w


def _quantize(w, reduce_axis):
    a = w.float()
    scale = torch.clamp(a.abs().amax(dim=reduce_axis, keepdim=True),
                        min=1e-8) / 127.0
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_param(w, reduce_axis):
    """Like ``quantize_weight`` but the scale KEEPS the reduced axes (size-1
    dims), so ``int8 * scale`` broadcasts back to the original shape."""
    q, scale = _quantize(w, reduce_axis)
    return {'int8': q, 'scale': scale}


def dequantize_param(w, dtype):
    """Inverse of ``quantize_param``: broadcast-multiply back to ``dtype``."""
    return (w['int8'].float() * w['scale']).to(dtype)


def wo_matmul(y, w, cdt):
    """``y @ w`` where ``w`` is raw ``[in, out]`` or weight-only
    ``{'int8': [in, out], 'scale': [out]}``."""
    if not is_weight_only(w):
        return y @ w.to(cdt)
    return (y @ w['int8'].to(cdt)) * w['scale'].to(cdt)


def wo_bmm(a, w, cdt):
    """Per-expert product ``[E, C, in] @ w``, where ``w`` is a raw expert
    bank ``[E, in, out]`` or its weight-only form ``{'int8': [E, in, out],
    'scale': [E, out]}`` (one scale per expert and output channel, the
    MoE banks of ``models/moe_gpt.quantize_decode_params``), applied after
    the product as ``scale[:, None, :]``, as the reference's
    ``_expert_mm`` does."""
    if not is_weight_only(w):
        return torch.bmm(a, w.to(cdt))
    return (torch.bmm(a, w['int8'].to(cdt))
            * w['scale'][:, None, :].to(cdt))


def wo_take(w, idx):
    """Row gather (embedding lookup) from a raw ``[V, H]`` table, or from a
    weight-only table with per-ROW scales ``{'int8': [V, H], 'scale': [V]}``
    (f32 rows, as the reference gives)."""
    if not is_weight_only(w):
        return w[idx]
    return w['int8'][idx].float() * w['scale'][idx][..., None]


def wo_lm_head(x, wte, cdt):
    """Tied LM head ``x @ wte.T`` for a raw or weight-only (per-row-scaled)
    embedding table."""
    if not is_weight_only(wte):
        return x @ wte.to(cdt).T
    return (x @ wte['int8'].to(cdt).T) * wte['scale'].to(cdt)


def quantize_kv(t):
    """Quantize KV rows ``[..., D]`` to int8 with one f32 scale per row:
    ``scale = max(amax over D, 1e-8) / 127``, values rounded half to even
    (``torch.round``, as ``jnp.round``) and clipped to [-127, 127].
    -> (int8 rows, f32 scales ``[...]``)."""
    a = t.float()
    scale = torch.clamp(a.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(a / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, cdt):
    return q.to(cdt) * scale[..., None].to(cdt)


def kv_plane(x):
    """The value plane of a KV store (a dense cache or a page pool, or
    one layer of either): the tensor itself, or an int8 bank's 'int8'."""
    return x['int8'] if is_weight_only(x) else x


def kv_layer(x, layer):
    """Layer ``layer`` of a stacked KV store (raw, or an int8 bank), as
    views that writes go through."""
    if is_weight_only(x):
        return {'int8': x['int8'][layer], 'scale': x['scale'][layer]}
    return x[layer]


def init_kv_bank(shape, device):
    """Zeroed int8 KV bank ``{'int8': [*shape] int8, 'scale': [*shape[:-1]]
    f32}`` on ``device``: the layout ``quantize_kv``, ``dequantize_kv`` and
    ``flash_decode_int8`` share."""
    return {'int8': torch.zeros(shape, dtype=torch.int8, device=device),
            'scale': torch.zeros(shape[:-1], dtype=torch.float32,
                                 device=device)}
