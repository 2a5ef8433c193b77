"""Weight helpers shared by every weight consumer of the GPT serving path,
and the int8 KV-cache rows of the dense decode cache.

Port of ``paddle_tpu/ops/weight_only.py:53-124`` for raw float weights.
A weight is a raw tensor (``[in, out]`` for matmuls, ``[V, H]`` for the
tied embedding) kept in the parameter dtype; each helper casts it to the
compute dtype before the product, exactly as the reference does
(``y @ w.astype(cdt)``). A caller may hand in weights already cast to the
compute dtype (the engine keeps such a copy, made once at load): the
``.to`` is then a no-op and the numbers are the same.

The int8 weight-only form ``{'int8', 'scale'}`` is not ported yet and
raises (ROADMAP Queue 1, "Low precision": ``precision='int8_wo'``).
"""

import torch

_INT8_TODO = ('int8 weight-only weights ({"int8", "scale"}) are not ported '
              'yet (ROADMAP Queue 1, "Low precision": int8_wo)')


def is_weight_only(w):
    return isinstance(w, dict) and 'int8' in w and 'scale' in w


def _raw(w):
    if is_weight_only(w):
        raise NotImplementedError(_INT8_TODO)
    return w


def wo_matmul(y, w, cdt):
    """``y @ w`` for a raw ``[in, out]`` weight, cast to ``cdt`` first."""
    return y @ _raw(w).to(cdt)


def wo_take(w, idx):
    """Row gather (embedding lookup) from a raw ``[V, H]`` table."""
    return _raw(w)[idx]


def wo_lm_head(x, wte, cdt):
    """Tied LM head ``x @ wte.T`` for a raw embedding table."""
    return x @ _raw(wte).to(cdt).T


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
