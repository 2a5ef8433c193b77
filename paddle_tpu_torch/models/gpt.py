"""GPT-style causal LM, ported to PyTorch.

Port of ``paddle_tpu/models/gpt.py``: the config, the stacked-block
parameter layout, the plain forward (``forward``), the loss and the
single-device train step (``loss_fn``, ``make_train_step``), the dense
KV-cache decode behind ``GPTForCausalLM.generate`` (bf16/f32 or int8
cache), and the paged KV-cache forward that the continuous-batching
engine (serving/generation.py) drives (bf16/f32 or int8 pool).
Parameters are
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
the KV cache, the port runs a Python loop over layers and writes each
layer's rows into ``cache[l]`` in place. Where the reference jits its
decode loop and buckets loop lengths to bound retraces, the port runs
exactly the steps it needs as a Python loop whose position stays on the
device (no step waits on the host).

Attention runs the port's Hopper kernels on the card (their plain twins
on the CPU): the forward's causal attention is kernel 1 (with attention
dropout in training), its backward kernels 2 and 3, the dense decode
kernel 4 (kernel 5 over int8 banks), the paged decode kernel 6 (kernel 7
over int8 pools).

Training. The reference scans the blocks under ``jax.checkpoint``; the
port loops over them under ``torch.utils.checkpoint`` (``_remat``). The
train step takes the u32 dropout seed where the reference takes a PRNG
key and draws the seed from it with ``jax.random.bits`` (which torch
cannot reproduce): pass ``jax.random.bits(key, (1,), uint32)[0]`` to
match it.

Not ported yet (ROADMAP Queue 1): int8 weight-only serving (item 5), fp8
matmuls (item 5), quantized gradient all-reduce and tensor, sequence and
pipeline parallelism (item 10).
"""
import dataclasses
import functools
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from .. import resolve_device
from .decode_cache import CapturedFn, DecodeFnCache, tensor_key
from ..ops.flash_attention import (_M32, _mul32, attention_reference,
                                   decode_attention, flash_attention,
                                   per_layer_seeds, repeat_kv)
from ..ops.xent import softmax_xent_blockwise
from ..ops.paged_attention import paged_attention
from ..ops.paged_kv import flat_write_indices, init_paged_pool, paged_write
from ..ops.weight_only import (init_kv_bank, is_weight_only, kv_layer,
                               kv_plane, quantize_kv, wo_lm_head, wo_matmul,
                               wo_take)

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
    ``GPTConfig(**dataclasses.asdict(ref_cfg))``. The
    parallelism fields (mp, pp, sp, n_microbatches, pp_schedule),
    grad_quant, matmul_precision and scan_unroll are carried; the train
    step raises on values it does not take."""
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
    # int8 banks with per-row scales for the dense cache and the page pool
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
    check_param_shapes(out, config)
    return out


def check_param_shapes(params, config):
    """Raise unless ``params`` has every tensor ``config`` wants, at its
    shape."""
    for key, shape in _param_shapes(config).items():
        if key == 'blocks':
            for bk, bshape in shape.items():
                got = tuple(params['blocks'][bk].shape)
                if got != bshape:
                    raise ValueError(f'blocks.{bk}: shape {got}, config '
                                     f'wants {bshape}')
        elif tuple(params[key].shape) != shape:
            raise ValueError(f'{key}: shape {tuple(params[key].shape)}, '
                             f'config wants {shape}')


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


def _attention(q, k, v, config, drop_seed=None):
    """Causal self-attention of the plain forward (the reference's
    ``_attention`` without sequence parallelism). q [B,S,H,D], k/v
    [B,S,H_kv,D]. ``use_flash`` runs kernel 1 with kernels 2 and 3 as its
    backward (their twins on the CPU); ``use_flash=False`` runs the
    reference's own einsum path (``gpt.py:277-285``): scores in the
    compute dtype, f32 softmax. ``drop_seed`` (a u32, training only) turns
    on ``config.dropout``: in the kernels on the flash path, through the
    same counter-hash mask in ``attention_reference`` otherwise."""
    if config.sp > 1:
        raise NotImplementedError('sequence parallelism (sp > 1) is not '
                                  'ported yet (ROADMAP Queue 1 item 10)')
    if config.dropout > 0.0 and drop_seed is not None:
        if config.use_flash:
            return flash_attention(q, k, v, causal=True,
                                   dropout_rate=config.dropout,
                                   dropout_seed=drop_seed)
        return attention_reference(q, k, v, True, None, config.dropout,
                                   drop_seed)
    if config.use_flash:
        return flash_attention(q, k, v, causal=True)
    k, v = repeat_kv(k, v, int(q.shape[2]))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum('bqhd,bkhd->bhqk', q, k) * scale
    S = q.shape[1]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', p, v)


def block_fn(bp, x, config, drop_seed=None):
    """One transformer block of the plain forward (``gpt.py:320``, mp=1,
    no fp8). bp: this layer's params (no leading L dim); x: [B, S, H];
    ``drop_seed``: this layer's u32 dropout seed, or None."""
    cdt = torch_dtype(config.dtype)
    B, S, h = x.shape
    y = _layer_norm(x, bp['ln1_g'], bp['ln1_b']).to(cdt)
    q, k, v = _block_qkv(bp, y, config.num_heads, config.head_dim, cdt,
                         config.kv_heads)
    a = _attention(q, k, v, config, drop_seed).reshape(B, S, h)
    x = x + wo_matmul(a, bp['proj_w'], cdt) + bp['proj_b'].to(cdt)
    y = _layer_norm(x, bp['ln2_g'], bp['ln2_b']).to(cdt)
    return x + _block_mlp(bp, y, cdt) + bp['out_b'].to(cdt)


def _layer(blocks, layer):
    return {k: w[layer] for k, w in blocks.items()}


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy='dots'``: keep the
    outputs of the block matmuls (``y @ w`` lowers to ``aten.mm`` /
    ``aten.addmm``), recompute everything else, kernel 1 included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, config):
    """The configured rematerialisation of a block body (``gpt.py:206``):
    'dots' keeps the matmul outputs (the reference's
    ``dots_with_no_batch_dims_saveable``), any other policy recomputes
    the whole block in the backward. Under both, the attention forward
    (kernel 1) runs again in the backward, as the reference recomputes
    its custom call."""
    kw = {}
    if config.remat_policy == 'dots':
        kw['context_fn'] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_matmuls)

    def run(*args):
        return _ckpt.checkpoint(body, *args, use_reentrant=False, **kw)
    return run


def forward_hidden(params, tokens, config, dropout_seed=None):
    """tokens [B, S] -> final hidden states [B, S, H] (pre-LM-head), a
    Python loop over the stacked blocks. ``dropout_seed`` (a u32, training
    only) turns on ``config.dropout`` with one derived seed per layer
    (``per_layer_seeds``); None leaves it off. With ``config.remat`` and
    autograd recording, each block runs under ``_remat``."""
    cdt = torch_dtype(config.dtype)
    B, S = tokens.shape
    L = config.num_layers
    if S > config.max_seq_len:
        raise ValueError(f'{S} tokens exceed max_seq_len '
                         f'{config.max_seq_len}')
    seeds = [None] * L
    if config.dropout > 0.0 and dropout_seed is not None:
        seeds = per_layer_seeds(int(dropout_seed), L).tolist()
    body = block_fn
    if config.remat and torch.is_grad_enabled():
        body = _remat(block_fn, config)
    pos = torch.arange(S, device=tokens.device)
    x = (wo_take(params['wte'], tokens.long()) + params['wpe'][pos]).to(cdt)
    # one unbind per stacked weight: its backward stacks the L gradients
    # once, where per-layer indexing would add L full-size zero tensors
    layers = {k: w.unbind(0) for k, w in params['blocks'].items()}
    for layer in range(L):
        bp = {k: w[layer] for k, w in layers.items()}
        x = body(bp, x, config, seeds[layer])
    return _layer_norm(x, params['lnf_g'], params['lnf_b']).to(cdt)


def forward(params, tokens, config, dropout_seed=None):
    """tokens [B, S] -> logits [B, S, V]."""
    x = forward_hidden(params, tokens, config, dropout_seed=dropout_seed)
    return wo_lm_head(x, params['wte'], x.dtype)


def loss_fn(params, tokens, targets, config, dropout_seed=None):
    """Mean token cross-entropy (``gpt.py:418``), f32. ``dropout_seed``:
    the u32 the reference draws from its key (``jax.random.bits(key,
    (1,), uint32)[0]``), used only when ``config.dropout > 0``. With
    ``xent_chunk`` dividing the vocab, the blockwise LM-head loss
    (``ops/xent.py``) never builds the [B, S, V] logits; otherwise the
    logits go through an f32 ``log_softmax``."""
    seed = dropout_seed if config.dropout > 0.0 else None
    x = forward_hidden(params, tokens, config, dropout_seed=seed)
    if config.xent_chunk and config.vocab_size % config.xent_chunk == 0:
        B, S, H = x.shape
        return softmax_xent_blockwise(x.reshape(B * S, H), params['wte'],
                                      targets.reshape(B * S),
                                      config.xent_chunk)
    logits = wo_lm_head(x, params['wte'], x.dtype)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -ll.mean()


def _check_trainable(config, mesh):
    """Raise on the train-step options that are not ported, naming their
    ROADMAP items."""
    later = []
    if mesh is not None:
        later.append('a device mesh (item 10, distributed training)')
    for name in ('mp', 'sp', 'pp'):
        if getattr(config, name) > 1:
            later.append(f'{name} > 1 (item 10, distributed training)')
    if config.grad_quant not in (None, 'none'):
        later.append('grad_quant (item 10, the quantized dp all-reduce)')
    if config.matmul_precision == 'fp8':
        later.append("matmul_precision='fp8' (item 5, low precision)")
    if later:
        raise NotImplementedError('not ported yet: ' + '; '.join(later)
                                  + ' (ROADMAP Queue 1)')


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _rebuild(tree, leaves):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(tree)


def make_train_step(config, optimizer, mesh=None):
    """The single-device train step (``gpt.py:888-897``):
    ``step(params, opt_state, seed, lr, tokens, targets) -> (loss, params,
    opt_state)``. ``seed`` is the step's u32 dropout seed (an int), used
    only when ``config.dropout > 0``, in place of the reference's PRNG key
    (see the module docstring). The loss and its gradients come from
    autograd over ``loss_fn``; ``optimizer.functional_apply`` then updates
    ``params`` and ``opt_state`` in place (the reference donates them) and
    the same dicts are returned. A mesh, mp/sp/pp > 1, grad_quant and fp8
    matmuls raise."""
    _check_trainable(config, mesh)

    def step(params, opt_state, seed, lr, tokens, targets):
        leaves = _leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss = loss_fn(_rebuild(params, live), tokens, targets, config,
                           seed if config.dropout > 0.0 else None)
            grads = torch.autograd.grad(loss, live)
        params, opt_state = optimizer.functional_apply(
            params, _rebuild(params, grads), opt_state, lr)
        return loss.detach(), params, opt_state

    return step


def init_kv_cache(config, batch, device=None):
    """The dense decode cache: ``{'k','v': [L, B, S_max, H_kv, Dh]}`` in
    the compute dtype, or with ``config.kv_cache_int8`` each of k/v an
    int8 bank ``{'int8': that shape, 'scale': [L, B, S_max, H_kv] f32}``,
    zeroed on ``device`` (cuda unless 'cpu' is asked for)."""
    dev = resolve_device(device)
    shape = (config.num_layers, batch, config.max_seq_len, config.kv_heads,
             config.head_dim)
    if config.kv_cache_int8:
        return {'k': init_kv_bank(shape, dev), 'v': init_kv_bank(shape, dev)}
    cdt = torch_dtype(config.dtype)
    return {'k': torch.zeros(shape, dtype=cdt, device=dev),
            'v': torch.zeros(shape, dtype=cdt, device=dev)}


def zero_kv(store):
    """Zero a KV store (a dense cache or a page pool, raw or int8 banks)
    in place: captured graphs hold its addresses, so it is reused, never
    reallocated."""
    for plane in (store['k'], store['v']):
        for t in (plane.values() if is_weight_only(plane) else (plane,)):
            t.zero_()


def dense_rows(pos, t, s_max, device):
    """The cache rows a T-row call at ``pos`` (an int or a one-element
    tensor) writes, and the ``wpe`` rows it reads: the start clamped to
    [0, S_max - T] as the reference's ``dynamic_update_slice`` clamps it,
    so an index never leaves the cache (on the card an out-of-range index
    is a device-side assert). -> [T] int64 on ``device``, computed there."""
    start = torch.as_tensor(pos, device=device).reshape(-1)[:1].long()
    return torch.clamp(start, 0, s_max - t) + torch.arange(t, device=device)


def _dense_write(cache, rows, idx):
    """Write [B, T, H_kv, D] rows into one layer's dense cache at positions
    ``idx``, in place; int8 banks quantize the rows on the way in."""
    if is_weight_only(cache):
        qr, sr = quantize_kv(rows)
        cache['int8'].index_copy_(1, idx, qr)
        cache['scale'].index_copy_(1, idx, sr)
    else:
        cache.index_copy_(1, idx, rows.to(cache.dtype))


def init_paged_kv_cache(config, num_pages, page_size, device):
    """Shared page pool for the continuous-batching decode path:
    ``{'k','v': [L, num_pages, page_size, H_kv, Dh]}`` in the compute
    dtype on ``device`` (int8 banks with ``config.kv_cache_int8``)."""
    return init_paged_pool(config.num_layers, num_pages, page_size,
                           config.kv_heads, config.head_dim,
                           torch_dtype(config.dtype), device,
                           int8=config.kv_cache_int8)


def is_paged(cache):
    """True when ``cache`` is a paged decode cache: ``{'k','v'}`` page
    pools plus a ``'page_table'`` [B, P_max] int32 and an optional
    ``'valid'`` [B] int32 (prefill: per-slot real prompt lengths)."""
    return isinstance(cache, dict) and 'page_table' in cache


def cached_attention(x, q, k, v, k_cache, v_cache, pos, proj_w, proj_b, cdt,
                     page_table=None, valid=None, flat_idx=None):
    """KV-cache attention core: writes the fresh k/v rows into the caches
    in place, attends each q row to the cache positions up to its own, and
    applies the output projection + residual. Returns (x_new, k_cache,
    v_cache).

    Dense (``page_table`` None): the caches are one layer's ``[B, S_max,
    H_kv, D]`` (or int8 banks, whose rows quantize on write); ``pos`` is
    an int or an int32 [1] tensor; ``flat_idx`` may carry the call's
    ``dense_rows``. Routing follows the reference (``gpt.py:584-593``): a
    Python int 0 runs kernel 1 (causal attention over the fresh rows
    equals attention over the cache, whose later rows are masked);
    anything else, a device tensor 0 included, runs kernel 4 over the
    cache (kernel 5 for int8 banks) for every T, where the TPU took its
    einsum fallback past T = 128.

    Paged (``page_table`` given): the caches are single-layer page pools
    ``[N, page_size, H_kv, D]`` (or int8 banks: kernel 7) and ``pos`` is a
    [B] int32 vector. Rows past ``valid[b]`` land in the trash page, and
    their attention output is zero (the kernel skips their q tiles);
    ``flat_idx`` may carry precomputed pool offsets. The reference runs a
    multi-token call that is not a prefix-cache tail through its flash
    forward over the fresh rows; attention over the paged cache computes the same rows, so every
    call here goes through the paged kernel."""
    B, T, h = x.shape
    if page_table is not None:
        paged_write(k_cache, k, page_table, pos, valid, flat_idx)
        paged_write(v_cache, v, page_table, pos, valid, flat_idx)
        a = paged_attention(q.contiguous(), k_cache, v_cache, page_table,
                            pos, valid)
    else:
        s_max = int(kv_plane(k_cache).shape[1])
        idx = (flat_idx if flat_idx is not None
               else dense_rows(pos, T, s_max, x.device))
        _dense_write(k_cache, k, idx)
        _dense_write(v_cache, v, idx)
        if isinstance(pos, int) and pos == 0:
            a = flash_attention(q, k, v, causal=True)
        else:
            a = decode_attention(q, k_cache, v_cache, pos)
    return (x + wo_matmul(a.reshape(B, T, h), proj_w, cdt) + proj_b.to(cdt),
            k_cache, v_cache)


def _cached_block(bp, x, k_cache, v_cache, pos, config, page_table=None,
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
    (int8 banks: both planes) in place. Returns (logits, cache) — logits
    [B,T,V], or [B,1,V] with
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
    flat_idx = flat_write_indices(page_table, pos_v, T,
                                  kv_plane(k_pool).shape[2], valid)
    # the attention kernels read valid on the device, as int32
    valid_v = (None if valid is None
               else valid.to(device=dev, dtype=torch.int32).reshape(-1))
    for layer in range(config.num_layers):
        x, _, _ = _cached_block(_layer(params['blocks'], layer), x,
                                kv_layer(k_pool, layer),
                                kv_layer(v_pool, layer), pos_v, config,
                                page_table, valid_v, flat_idx)
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
    """Run [B, T] tokens whose absolute positions start at ``pos`` through
    the KV cache. Returns (logits, cache): logits [B,T,V], or [B,1,V] with
    ``last_only``.

    A paged cache (``is_paged``) routes to ``paged_forward_with_cache``
    with ``pos`` a per-slot [B] vector. The dense cache (``init_kv_cache``)
    takes ``pos`` as an int or a one-element tensor. A Python int 0 is
    passed on as it is (it routes to kernel 1, see ``cached_attention``);
    any other position becomes an int32 [1] tensor on the tokens' device,
    once. Each layer writes its rows into ``cache['k'][l]`` /
    ``cache['v'][l]`` in place."""
    if is_paged(cache):
        return paged_forward_with_cache(params, tokens, cache, pos, config,
                                        last_only=last_only)
    cdt = torch_dtype(config.dtype)
    B, T = tokens.shape
    dev = tokens.device
    if T > config.max_seq_len:
        raise ValueError(f'{T} tokens exceed the cache of '
                         f'{config.max_seq_len}')
    if not (isinstance(pos, int) and pos == 0):
        pos = torch.as_tensor(pos, device=dev).to(torch.int32).reshape(1)
    rows = dense_rows(pos, T, config.max_seq_len, dev)
    x = (wo_take(params['wte'], tokens.long())
         + params['wpe'][rows]).to(cdt)
    for layer in range(config.num_layers):
        x, _, _ = _cached_block(
            _layer(params['blocks'], layer), x,
            kv_layer(cache['k'], layer), kv_layer(cache['v'], layer),
            pos, config, flat_idx=rows)
    if last_only:
        x = x[:, -1:]
    x = _layer_norm(x, params['lnf_g'], params['lnf_b']).to(cdt)
    return wo_lm_head(x, params['wte'], cdt), cache


# ---------------------------------------------------------------------------
# Sampling. The reference draws with jax.random keyed by
# fold_in(PRNGKey(seed), position); torch has no threefry, so the port
# keys its own counter-based draw by (seed, position) alone: Gumbel-max
# over a murmur3-style hash of (seed, position, vocab index). A stream
# therefore never depends on slot index or batch composition, and a
# restarted sequence redraws the same tokens. It cannot match jax.random
# bit for bit; greedy decoding (argmax) matches exactly. The u32 helpers
# (_M32, _mul32) are the dropout hash's, from ops/flash_attention.py.
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Dense KV-cache decoding: prefill, step, the generation loop, and the
# GPTForCausalLM wrapper
# ---------------------------------------------------------------------------

def make_decode_fns(config: GPTConfig):
    """-> (prefill, step), the reference's pair (``gpt.py:806``); both
    write the cache in place.

    prefill(params, prompt [B,T], cache) -> (last logits [B,V], cache)
    step(params, tok [B], pos, cache)    -> (logits [B,V], cache)

    The prefill passes its position as a device tensor 0, as the
    reference passes ``jnp.int32(0)``: not a Python int, so the prefill
    runs the decode kernel over the cache, never kernel 1."""
    @torch.no_grad()
    def prefill(params, prompt, cache):
        zero = torch.zeros(1, dtype=torch.int32, device=prompt.device)
        logits, cache = forward_with_cache(params, prompt, cache, zero,
                                           config, last_only=True)
        return logits[:, -1], cache

    @torch.no_grad()
    def step(params, tok, pos, cache):
        logits, cache = forward_with_cache(params, tok[:, None], cache, pos,
                                           config)
        return logits[:, 0], cache

    return prefill, step


def make_generate_loop(config, temperature=0.0, top_k=None, top_p=None,
                       forward_fn=None, capture=True):
    """Autoregressive generation over the dense cache (``gpt.py:770``).

    -> gen(params, tok0 [B] int32, pos0 int32 [1], cache, seeds, n_steps)
       returning (tokens [B, n_steps] int32, cache). ``tok0`` is the input
    of the first step; each step's draw is emitted and fed to the next.
    ``seeds`` ([B] integers, or None for greedy) key each row's draw with
    the position of the row it is drawn from. ``forward_fn(params, tokens,
    cache, pos, config)`` defaults to ``forward_with_cache``.

    The reference runs the steps as one jitted ``lax.scan``, a single
    dispatch. Here one step (the forward, the draw, the drawn token fed
    back into the input buffer, ``pos += 1``) is one captured CUDA graph
    (``decode_cache.CapturedFn``), replayed once per token, and one copy a
    step moves its tokens into the result; no step waits on the host. The
    graph is captured on the first call for a (params, cache) pair, keyed
    by where their tensors live (``decode_cache.tensor_key``) in a bounded
    ``DecodeFnCache``, so later calls over the same tensors only replay.
    Its warm-up runs start from the call's own inputs and write only cache
    rows at or past ``pos0``, which the steps rewrite before any read. On
    the CPU, or with ``capture=False``, the same step runs eagerly."""
    fwd = forward_fn or forward_with_cache
    steps = DecodeFnCache(name='gpt.generate_loop')

    def build(params, cache, inputs, dev):
        b = inputs['tok'].shape[0]
        state = {k: v.to(dev).clone() for k, v in inputs.items()}

        def step(tok, pos, seeds=None):
            logits, _ = fwd(params, tok[:, None], cache, pos, config)
            nxt = _sample(logits[:, 0], temperature, top_k, top_p,
                          seeds=seeds, positions=pos.expand(b))
            tok.copy_(nxt)
            pos.add_(1)
            return tok

        return CapturedFn(step, state, dev, capture=capture)

    @torch.no_grad()
    def gen(params, tok0, pos0, cache, seeds, n_steps):
        b, dev = tok0.shape[0], tok0.device
        out = torch.empty((b, n_steps), dtype=torch.int32, device=dev)
        if n_steps == 0:
            return out, cache
        inputs = {'tok': tok0.to(torch.int32),
                  'pos': torch.as_tensor(pos0).to(dev, torch.int32).reshape(1)}
        if seeds is not None:
            inputs['seeds'] = seeds.to(dev, torch.int64)
        key = (tensor_key(params), tensor_key(cache), b, str(dev),
               seeds is not None)
        fn = steps.get(key, lambda: build(params, cache, inputs, dev))
        for k in range(n_steps):
            out[:, k].copy_(fn.replay(**(inputs if k == 0 else {})))
        return out, cache

    return gen


class GPTForCausalLM(nn.Module):
    """The reference's layer wrapper (``gpt.py:1136``) as an ``nn.Module``:
    ``model(tokens)`` gives logits, ``model.generate(...)`` decodes.

    ``params`` is a parameter dict in the reference's layout (for example
    ``params_from_numpy`` of the reference's own); without it the
    parameters are drawn from ``seed`` (``init_params``). They are held as
    frozen parameters named as in the dict (``wte``, ``blocks.qkv_w``, ...)
    on ``device``: cuda unless 'cpu' is asked for, and raising when there
    is no card."""

    def __init__(self, config=None, params=None, device=None, seed=0,
                 **kwargs):
        super().__init__()
        self.config = config or GPTConfig(**kwargs)
        dev = resolve_device(device)
        if params is None:
            params = init_params(
                self.config, torch.Generator(device=dev).manual_seed(seed),
                dev)
        check_param_shapes(params, self.config)
        self.blocks = nn.Module()
        for key, t in params['blocks'].items():
            self.blocks.register_parameter(
                key, nn.Parameter(t.to(dev), requires_grad=False))
        for key, t in params.items():
            if key != 'blocks':
                self.register_parameter(
                    key, nn.Parameter(t.to(dev), requires_grad=False))
        # generate()'s captured prefills and loops, the serving parameters
        # they read, and the private switch to eager runs (comparisons)
        self._decode_fns = DecodeFnCache(name='gpt.decode_fns')
        self._serving = (None, None)
        self._capture = True

    @property
    def device(self):
        return self.wte.device

    def param_dict(self):
        """The parameters as the functional core takes them."""
        out = {k: v for k, v in self.named_parameters(recurse=False)}
        out['blocks'] = dict(self.blocks.named_parameters())
        return out

    def _tokens(self, tokens):
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        return tokens.to(self.device, torch.int32)

    @torch.no_grad()
    def forward(self, tokens):
        """tokens [B, S] -> logits [B, S, V] (kernel 1 with ``use_flash``)."""
        return forward(self.param_dict(), self._tokens(tokens), self.config)

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens=32, temperature=1.0,
                 top_k=None, top_p=None, seed=None):
        """KV-cache decoding (``gpt.py:1166``): a prefill, then one cached
        step per token while the window has room, then the sliding-window
        recompute. -> [B, T0 + max_new_tokens] int32.

        Greedy (``temperature=0``) takes the argmax. Otherwise the draws
        are the port's counter-based sampler keyed by (seed, position):
        row b draws with seed ``seed + b``, as an engine request with that
        seed would; ``seed=None`` takes one from ``torch``'s global
        generator.

        The prefill and each cached step are replayed CUDA graphs, the
        reference's jitted prefill and ``lax.scan`` loop: captured on the
        first call for a (B, T0, sampling knobs) and kept with their cache
        (``_decode_entry``); the sliding window runs eagerly."""
        cfg = self.config
        toks = self._tokens(tokens)
        B, T0 = toks.shape
        dev = toks.device
        # +1: the last cached step runs at pos max_seq_len-1 and its logits
        # see the full window, as the sliding path's first step would
        n_cached = (min(max_new_tokens, cfg.max_seq_len - T0 + 1)
                    if T0 < cfg.max_seq_len else 0)
        seeds, params = None, None
        if temperature != 0:
            if seed is None:
                seed = int(torch.randint(0, 2 ** 31 - 1, ()))
            seeds = torch.arange(B, device=dev, dtype=torch.int64) + seed
        if n_cached > 0:
            entry = self._decode_entry(B, T0, temperature, top_k, top_p,
                                       seeds is not None)
            with entry['lock']:
                first = entry['prefill'].replay(
                    prompt=toks,
                    **({} if seeds is None else {'seeds': seeds})).clone()
                pieces = [toks, first[:, None]]
                if n_cached > 1:
                    pos0 = torch.full((1,), T0, dtype=torch.int32,
                                      device=dev)
                    new, _ = entry['loop'](entry['params'], first, pos0,
                                           entry['cache'], seeds,
                                           n_cached - 1)
                    pieces.append(new)
            toks = torch.cat(pieces, dim=1)
            params = entry['params']
        rest = max_new_tokens - n_cached
        if rest > 0:
            return self._generate_sliding(toks, rest, temperature, top_k,
                                          top_p, seeds, params)
        return toks

    def _serving_params(self):
        """``serving_params`` of the current parameters, made once per set
        of parameter tensors and kept: captured graphs read them."""
        src = self.param_dict()
        key = tensor_key(src)
        if self._serving[0] != key:
            self._serving = (key, serving_params(src, self.config))
        return self._serving[1]

    def _decode_entry(self, b, t0, temperature, top_k, top_p, seeded):
        """generate()'s captured prefill and loop for a batch of ``b``
        prompts of ``t0`` tokens, with the dense cache they write and the
        serving parameters they read, from the model's ``DecodeFnCache``
        keyed by (config, sampling knobs, B, T0, device, the parameter
        tensors). The prefill refreshes the cast parameters from the
        model's own (weights changed in place are seen), zeroes the cache,
        fills it and draws the first token, all in one graph."""
        cfg, dev = self.config, self.device
        src = self.param_dict()
        key = (repr(cfg), temperature, top_k, top_p, b, t0, str(dev),
               seeded, tensor_key(src), self._capture)

        def build():
            params = self._serving_params()
            # (cast, source) of every parameter cast into a tensor of its
            # own (f32 configs keep the source itself)
            pairs = [(params['blocks'][k], src['blocks'][k])
                     for k in _CAST_ONCE if params['blocks'][k].data_ptr()
                     != src['blocks'][k].data_ptr()]
            cache = init_kv_cache(cfg, b, dev)
            prefill, _ = make_decode_fns(cfg)
            bufs = {'prompt': torch.zeros((b, t0), dtype=torch.int32,
                                          device=dev)}
            if seeded:
                bufs['seeds'] = torch.zeros(b, dtype=torch.int64, device=dev)

            def run(prompt, seeds=None):
                for dst, s in pairs:
                    dst.copy_(s)
                zero_kv(cache)
                logits, _ = prefill(params, prompt, cache)
                return _sample(logits, temperature, top_k, top_p,
                               seeds=seeds, positions=torch.full(
                                   (b,), t0 - 1, device=dev))

            return {'prefill': CapturedFn(run, bufs, dev,
                                          capture=self._capture),
                    'cache': cache, 'params': params,
                    'loop': make_generate_loop(cfg, temperature, top_k,
                                               top_p, capture=self._capture),
                    'lock': threading.Lock()}

        return self._decode_fns.get(key, build)

    @torch.no_grad()
    def _generate_sliding(self, toks, max_new_tokens, temperature, top_k,
                          top_p=None, seeds=None, params=None):
        """Full-context recompute over the last ``max_seq_len`` tokens: the
        continuation once generation outgrows the cache. Each step is one
        plain forward (kernel 1); the LM head runs on the last row only."""
        cfg = self.config
        if params is None:
            params = serving_params(self.param_dict(), cfg)
        B = toks.shape[0]
        for _ in range(max_new_tokens):
            x = forward_hidden(params, toks[:, -cfg.max_seq_len:], cfg)
            lg = wo_lm_head(x[:, -1], params['wte'], x.dtype)
            last = torch.full((B,), toks.shape[1] - 1, device=toks.device)
            nxt = _sample(lg, temperature, top_k, top_p, seeds=seeds,
                          positions=last)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
        return toks

    def enable_int8_decode(self, enable=True):
        raise NotImplementedError(
            'int8 weight-only decode is not ported yet (ROADMAP Queue 1 '
            'item 5: low precision, int8 weight-only)')
