"""GPT-style causal LM — the serving half, ported to PyTorch.

Port of ``paddle_tpu/models/gpt.py``: the config, the stacked-block
parameter layout, and the paged KV-cache forward that the
continuous-batching engine (serving/generation.py) drives. Parameters are
a plain dict of tensors with the reference's structure — transformer
blocks STACKED on a leading layer dim — so a reference parameter tree
(as numpy arrays) converts one to one (``params_from_numpy``).

The numerics that decide greedy parity are copied from the reference:
the residual stream is kept in the compute dtype; LayerNorm runs on it
with eps 1e-5 in the reference's formula (f32 gains promote the
normalized rows, which are then cast back); GELU is the tanh
approximation (``jax.nn.gelu``'s default); every matmul weight is cast to
the compute dtype before the product; ``wpe`` is read at positions
clipped to ``max_seq_len - 1``.

Where the reference scans the layer stack with ``lax.scan`` and donates
the KV pool, the port runs a Python loop over layers and writes each
layer's rows into ``pool[l]`` in place.

Not ported yet (ROADMAP Queue 1): training (forward/loss/train step), the
dense KV cache and ``generate()``, int8 KV, tensor parallelism.
"""
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.paged_attention import paged_attention
from ..ops.paged_kv import flat_write_indices, init_paged_pool, paged_write
from ..ops.weight_only import wo_lm_head, wo_matmul, wo_take

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def torch_dtype(name):
    """The torch dtype for a config dtype string ('bfloat16', 'float32')."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f'unsupported dtype {name!r}') from None


def validate_gqa(num_heads, num_kv_heads, mp):
    """Shared GQA/tensor-parallel config contract."""
    kvh = num_kv_heads or num_heads
    if num_heads % kvh != 0:
        raise ValueError(
            f'num_kv_heads={kvh} must divide num_heads={num_heads}')
    if mp > 1 and (kvh % mp != 0 or num_heads % mp != 0):
        raise ValueError(
            f'mp={mp} must divide both num_heads={num_heads} and '
            f'num_kv_heads={kvh} (each tensor-parallel rank owns whole kv '
            'heads with their query groups)')


@dataclasses.dataclass
class GPTConfig:
    """The reference's config, field for field (``paddle_tpu/models/
    gpt.py:50-132``), so a reference config converts with
    ``GPTConfig(**dataclasses.asdict(ref_cfg))``. Fields that steer
    training or parallelism are carried but not used by the serving
    path."""
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    # GQA/MQA: kv heads (0 = MHA). Must divide num_heads.
    num_kv_heads: int = 0
    ffn_mult: int = 4
    max_seq_len: int = 1024
    dropout: float = 0.0
    dtype: str = 'bfloat16'
    param_dtype: str = 'float32'
    remat: bool = True
    remat_policy: str = 'dots'
    use_flash: bool = True
    mp: int = 1
    pp: int = 1
    sp: int = 1
    n_microbatches: int = 1
    pp_schedule: str = 'gpipe'
    xent_chunk: int = 8192
    # int8 KV pools are not ported yet: the serving path raises on True
    kv_cache_int8: bool = False
    scan_unroll: int = 1
    grad_quant: str = 'none'
    matmul_precision: str = 'none'

    def __post_init__(self):
        validate_gqa(self.num_heads, self.num_kv_heads, self.mp)
        if self.grad_quant not in ('none', 'bf16', 'int8', 'int4', 'fp8'):
            raise ValueError(
                f"grad_quant must be one of 'none'/'bf16'/'int8'/'int4'/"
                f"'fp8', got {self.grad_quant!r}")
        if self.matmul_precision not in ('none', 'fp8'):
            raise ValueError(
                f"matmul_precision must be 'none' or 'fp8', "
                f"got {self.matmul_precision!r}")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads

    @property
    def ffn_size(self):
        return self.hidden_size * self.ffn_mult


def init_params(config: GPTConfig, generator, device):
    """Stacked-block parameter dict with the reference's layout and stds
    (normal 0.02; the residual projections 0.02/sqrt(2L); wpe 0.01), drawn
    from ``generator`` on ``device`` (the generator must live there). The
    draws differ from ``jax.random``'s: to hold the port against the
    reference, convert the reference's own params (``params_from_numpy``)."""
    h, f, v, L = (config.hidden_size, config.ffn_size, config.vocab_size,
                  config.num_layers)
    pdt = torch_dtype(config.param_dtype)
    std = 0.02

    def nrm(shape, scale=std):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * scale).to(pdt)

    def zeros(shape):
        return torch.zeros(shape, dtype=pdt, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=pdt, device=device)

    # GQA: per-kv-head packing [q_0..q_{g-1}|k|v] -> (g+2)*kv_heads*hd cols
    qkv_cols = (config.num_heads + 2 * config.kv_heads) * config.head_dim
    blocks = {
        'ln1_g': ones((L, h)), 'ln1_b': zeros((L, h)),
        'qkv_w': nrm((L, h, qkv_cols)),
        'qkv_b': zeros((L, qkv_cols)),
        'proj_w': nrm((L, h, h), std / math.sqrt(2 * L)),
        'proj_b': zeros((L, h)),
        'ln2_g': ones((L, h)), 'ln2_b': zeros((L, h)),
        'fc_w': nrm((L, h, f)), 'fc_b': zeros((L, f)),
        'out_w': nrm((L, f, h), std / math.sqrt(2 * L)),
        'out_b': zeros((L, h)),
    }
    return {
        'wte': nrm((v, h)),
        'wpe': nrm((config.max_seq_len, h), 0.01),
        'blocks': blocks,
        'lnf_g': ones((h,)), 'lnf_b': zeros((h,)),
    }


def _param_shapes(config):
    h, f, v, L = (config.hidden_size, config.ffn_size, config.vocab_size,
                  config.num_layers)
    qkv = (config.num_heads + 2 * config.kv_heads) * config.head_dim
    return {
        'wte': (v, h), 'wpe': (config.max_seq_len, h),
        'lnf_g': (h,), 'lnf_b': (h,),
        'blocks': {
            'ln1_g': (L, h), 'ln1_b': (L, h), 'qkv_w': (L, h, qkv),
            'qkv_b': (L, qkv), 'proj_w': (L, h, h), 'proj_b': (L, h),
            'ln2_g': (L, h), 'ln2_b': (L, h), 'fc_w': (L, h, f),
            'fc_b': (L, f), 'out_w': (L, f, h), 'out_b': (L, h)},
    }


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == 'bfloat16':       # numpy has no bf16 of its own
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, config, device):
    """Turn the reference's parameter tree (``paddle_tpu.models.gpt.
    init_params``, leaves converted to numpy arrays) into the port's dict
    of tensors on ``device``, checking every shape against ``config``."""
    want = _param_shapes(config)
    out = {'blocks': {}}
    for key, shape in want.items():
        if key == 'blocks':
            continue
        out[key] = _to_tensor(tree[key], device)
    for key in want['blocks']:
        out['blocks'][key] = _to_tensor(tree['blocks'][key], device)
    for key, shape in want.items():
        if key == 'blocks':
            for bk, bshape in shape.items():
                got = tuple(out['blocks'][bk].shape)
                if got != bshape:
                    raise ValueError(f'blocks.{bk}: shape {got}, config '
                                     f'wants {bshape}')
        elif tuple(out[key].shape) != shape:
            raise ValueError(f'{key}: shape {tuple(out[key].shape)}, '
                             f'config wants {shape}')
    return out


_CAST_ONCE = ('qkv_w', 'qkv_b', 'proj_w', 'proj_b', 'fc_w', 'fc_b',
              'out_w', 'out_b')


def serving_params(params, config):
    """The parameters the serving forward reads: the block matmul weights
    and biases cast to the compute dtype once, here, instead of on every
    call (the reference casts them inside each product; the cast values
    are the same, so the numbers are too). LayerNorm parameters, ``wte``
    (looked up in the parameter dtype before the cast of the sum) and
    ``wpe`` stay as they are."""
    cdt = torch_dtype(config.dtype)
    blocks = dict(params['blocks'])
    for k in _CAST_ONCE:
        blocks[k] = blocks[k].to(cdt)
    return dict(params, blocks=blocks)


def _layer_norm(x, g, b, eps=1e-5):
    m = x.mean(dim=-1, keepdim=True)
    v = torch.square(x - m).mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * g + b


def _block_qkv(bp, y, nh, hd, cdt, kvh=None):
    """Fused QKV projection. Packing is per KV HEAD: [q_0..q_{g-1}|k|v]
    (g = query group size; g=1 is classic head-major MHA)."""
    B, S, _ = y.shape
    kvh = nh if kvh is None else kvh
    g = nh // kvh
    qkv = wo_matmul(y, bp['qkv_w'], cdt) + bp['qkv_b'].to(cdt)
    qkv = qkv.reshape(B, S, kvh, g + 2, hd)
    q = qkv[..., :g, :].reshape(B, S, nh, hd)
    return q, qkv[..., g, :], qkv[..., g + 1, :]


def _block_mlp(bp, y, cdt):
    """fc -> gelu (tanh approximation) -> out projection (bias added by
    the caller)."""
    y = F.gelu(wo_matmul(y, bp['fc_w'], cdt) + bp['fc_b'].to(cdt),
               approximate='tanh')
    return wo_matmul(y, bp['out_w'], cdt)


def init_paged_kv_cache(config, num_pages, page_size, device):
    """Shared page pool for the continuous-batching decode path:
    ``{'k','v': [L, num_pages, page_size, H_kv, Dh]}`` in the compute
    dtype on ``device``."""
    if config.kv_cache_int8:
        raise NotImplementedError(
            'kv_cache_int8 pools are not ported yet (ROADMAP Queue 1 '
            'item 3: int8 KV cache, kernels 5 and 7)')
    return init_paged_pool(config.num_layers, num_pages, page_size,
                           config.kv_heads, config.head_dim,
                           torch_dtype(config.dtype), device)


def is_paged(cache):
    """True when ``cache`` is a paged decode cache: ``{'k','v'}`` page
    pools plus a ``'page_table'`` [B, P_max] int32 and an optional
    ``'valid'`` [B] int32 (prefill: per-slot real prompt lengths)."""
    return isinstance(cache, dict) and 'page_table' in cache


def cached_attention(x, q, k, v, k_cache, v_cache, pos, proj_w, proj_b, cdt,
                     page_table, valid=None, flat_idx=None):
    """Paged branch of the reference's KV-cache attention core: writes the
    fresh k/v rows into the single-layer page pools ``[N, page_size, H_kv,
    D]`` in place (rows past ``valid[b]`` land in the trash page), attends
    each q row to the paged cache through ``paged_attention``, and applies
    the output projection + residual. ``pos`` is a [B] int32 vector.
    Returns (x_new, k_cache, v_cache).

    The reference runs a multi-token call that is not a prefix-cache tail
    through its flash forward kernel over the fresh rows; that kernel is
    not ported yet, and attention over the paged cache computes the same
    rows, so every call here goes through the paged kernel."""
    B, T, h = x.shape
    paged_write(k_cache, k, page_table, pos, valid, flat_idx)
    paged_write(v_cache, v, page_table, pos, valid, flat_idx)
    a = paged_attention(q.contiguous(), k_cache, v_cache, page_table,
                        pos).reshape(B, T, h)
    return (x + wo_matmul(a, proj_w, cdt) + proj_b.to(cdt),
            k_cache, v_cache)


def _cached_block(bp, x, k_cache, v_cache, pos, config, page_table,
                  valid=None, flat_idx=None):
    """One block over a [B, T, H] slice starting at ``pos``."""
    cdt = torch_dtype(config.dtype)
    y = _layer_norm(x, bp['ln1_g'], bp['ln1_b']).to(cdt)
    q, k, v = _block_qkv(bp, y, config.num_heads, config.head_dim, cdt,
                         config.kv_heads)
    x, k_cache, v_cache = cached_attention(
        x, q, k, v, k_cache, v_cache, pos, bp['proj_w'], bp['proj_b'], cdt,
        page_table, valid=valid, flat_idx=flat_idx)
    y = _layer_norm(x, bp['ln2_g'], bp['ln2_b']).to(cdt)
    x = x + _block_mlp(bp, y, cdt) + bp['out_b'].to(cdt)
    return x, k_cache, v_cache


def paged_forward_with_cache(params, tokens, cache, pos, config,
                             last_only=False):
    """Run [B, T] tokens whose absolute positions start at ``pos`` ([B]
    int32, one per slot) through the paged cache: ``cache`` carries the
    page pools ``{'k','v'}`` + ``page_table`` (+ optional ``valid``).
    Each layer writes its rows into ``cache['k'][l]`` / ``cache['v'][l]``
    in place. Returns (logits, cache) — logits [B,T,V], or [B,1,V] with
    ``last_only`` (each slot's last REAL row when ``valid`` is given) —
    with the table/valid passed through."""
    cdt = torch_dtype(config.dtype)
    B, T = tokens.shape
    dev = tokens.device
    pos_v = pos.to(device=dev, dtype=torch.int32).reshape(-1)
    page_table = cache['page_table']
    valid = cache.get('valid')
    ppos = torch.clamp(pos_v.long()[:, None]
                       + torch.arange(T, device=dev)[None, :],
                       0, config.max_seq_len - 1)                # [B, T]
    x = (wo_take(params['wte'], tokens.long())
         + params['wpe'][ppos]).to(cdt)
    k_pool, v_pool = cache['k'], cache['v']
    # every layer writes the same rows: compute their pool offsets once
    flat_idx = flat_write_indices(page_table, pos_v, T, k_pool.shape[2],
                                  valid)
    blocks = params['blocks']
    for layer in range(config.num_layers):
        bp = {k: w[layer] for k, w in blocks.items()}
        x, _, _ = _cached_block(bp, x, k_pool[layer], v_pool[layer], pos_v,
                                config, page_table, valid, flat_idx)
    if last_only:
        if valid is not None:
            # per-slot prompt lengths: pick each slot's last REAL row
            idx = torch.clamp(valid.to(dev).long() - 1, 0, T - 1)
            x = x[torch.arange(B, device=dev), idx][:, None]
        else:
            x = x[:, -1:]
    x = _layer_norm(x, params['lnf_g'], params['lnf_b']).to(cdt)
    logits = wo_lm_head(x, params['wte'], cdt)
    out = {'k': k_pool, 'v': v_pool, 'page_table': page_table}
    if valid is not None:
        out['valid'] = valid
    return logits, out


def forward_with_cache(params, tokens, cache, pos, config: GPTConfig,
                       last_only=False):
    """The reference's cached forward. A paged cache (``is_paged``) routes
    to ``paged_forward_with_cache`` with ``pos`` as a per-slot [B] vector;
    the dense contiguous cache is the next slice of the port."""
    if is_paged(cache):
        return paged_forward_with_cache(params, tokens, cache, pos, config,
                                        last_only=last_only)
    raise NotImplementedError(
        'the dense KV cache (init_kv_cache / generate()) is not ported yet '
        '(ROADMAP Queue 1 item 2: dense KV-cache decode)')


# ---------------------------------------------------------------------------
# Sampling. The reference draws with jax.random keyed by
# fold_in(PRNGKey(seed), position); torch has no threefry, so the port
# keys its own counter-based draw by (seed, position) alone: Gumbel-max
# over a murmur3-style hash of (seed, position, vocab index). A stream
# therefore never depends on slot index or batch composition, and a
# restarted sequence redraws the same tokens. It cannot match jax.random
# bit for bit; greedy decoding (argmax) matches exactly.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 tensors holding u32 values, split in
    16-bit halves so no intermediate overflows int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x):
    """murmur3's 32-bit finalizer on int64 tensors holding u32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def gumbel_noise(seeds, positions, vocab):
    """[B, vocab] f32 standard Gumbel noise, a pure function of each row's
    (seed, position) and the vocab index."""
    dev = seeds.device
    s = _fmix32(seeds.long() & _M32)
    k = _fmix32((s + _mul32(positions.long() & _M32, 0x9E3779B1)) & _M32)
    idx = torch.arange(vocab, device=dev, dtype=torch.int64)
    x = _fmix32((k[:, None] + _mul32(idx, 0x7FEB352D)[None, :]) & _M32)
    u = ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))      # (0, 1)
    return -torch.log(-torch.log(u))


def _sample(logits, temperature, top_k, top_p=None, seeds=None,
            positions=None):
    """Greedy / temperature / top-k / nucleus next-token draw over
    ``logits`` [B, V] -> [B] int32. Greedy is ``argmax`` (first maximum).
    Otherwise the filters are the reference's (top_k and top_p compose;
    the argmax always survives the nucleus) and the draw is Gumbel-max
    keyed by per-row ``seeds`` and ``positions`` ([B] integer tensors)."""
    if temperature == 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if seeds is None or positions is None:
        raise ValueError('sampling with temperature > 0 needs per-row seeds '
                         'and positions')
    lg = logits.float() / temperature
    nucleus = top_p is not None and top_p < 1.0
    if top_k or nucleus:
        # ONE descending sort serves both filters
        srt = torch.sort(lg, dim=-1, descending=True).values
        ninf = float('-inf')
        if top_k:
            kth = srt[:, top_k - 1:top_k]
            lg = torch.where(lg < kth, ninf, lg)
            rank = torch.arange(srt.shape[-1], device=srt.device)
            srt = torch.where(rank < top_k, srt, ninf)
        if nucleus:
            # keep the smallest prefix of the sorted distribution whose
            # cumulative prob reaches top_p; the argmax is ALWAYS kept
            probs = torch.softmax(srt, dim=-1)
            keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
            keep[:, 0] = True
            cut = torch.where(keep, srt, float('inf')).amin(dim=-1,
                                                            keepdim=True)
            lg = torch.where(lg < cut, ninf, lg)
    g = gumbel_noise(seeds.to(lg.device), positions.to(lg.device),
                     lg.shape[-1])
    return torch.argmax(lg + g, dim=-1).to(torch.int32)
