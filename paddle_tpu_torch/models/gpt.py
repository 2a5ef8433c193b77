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

Weight-only int8 serving (``quantize_decode_params``,
``GPTForCausalLM.enable_int8_decode``): the four block matrices and the
tied embedding as ``{'int8', 'scale'}`` banks (ops/weight_only.py), which
every weight consumer takes in place of a raw tensor.

fp8 training (``matmul_precision='fp8'``): the four block matmuls run
``quantization/fp8.py``'s e4m3/e5m2 delayed-scaling product (the fp8
tensor cores on the card), with the scaling state (``init_fp8_state``)
threaded through ``forward_hidden`` / ``loss_fn`` and the train step
``step(params, opt_state, fp8_state, seed, lr, tokens, targets)``.

Hybrid-parallel training (``make_train_step(config, opt, mesh)``, step
K1): one process a rank over ``torch.distributed``, the reference's
explicit-collective route for every layout: dp, Megatron mp (``block_fn``
with the mesh), sp (ring flash attention, kernels 1-3 a hop), GPipe or
1F1B pp, and the quantized dp all-reduce (``grad_quant``);
``place_params`` / ``gather_params`` move between the global parameters
and a rank's blocks.
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
                                   kernel_takes,
                                   per_layer_seeds, repeat_kv)
from ..ops.xent import softmax_xent_blockwise
from ..ops.paged_attention import paged_attention
from ..ops.paged_kv import init_paged_pool, paged_write, write_plan
from ..ops.weight_only import (init_kv_bank, is_weight_only, kv_layer,
                               kv_plane, quantize_kv, quantize_weight,
                               wo_lm_head, wo_matmul, wo_take)
from ..quantization import fp8 as _fp8

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
    """The shape of every parameter ``config`` wants: GPT's blocks, or
    with ``n_experts`` (``models.moe_gpt.MoEConfig``) the MoE block's
    router and expert banks in place of the dense FFN."""
    h, f, v, L = (config.hidden_size, config.ffn_size, config.vocab_size,
                  config.num_layers)
    qkv = (config.num_heads + 2 * config.kv_heads) * config.head_dim
    blocks = {
        'ln1_g': (L, h), 'ln1_b': (L, h), 'qkv_w': (L, h, qkv),
        'qkv_b': (L, qkv), 'proj_w': (L, h, h), 'proj_b': (L, h),
        'ln2_g': (L, h), 'ln2_b': (L, h)}
    E = getattr(config, 'n_experts', None)
    if E is None:
        blocks.update(fc_w=(L, h, f), fc_b=(L, f), out_w=(L, f, h),
                      out_b=(L, h))
    else:
        blocks.update(gate_w=(L, h, E), w_in=(L, E, h, f),
                      w_out=(L, E, f, h))
    return {
        'wte': (v, h), 'wpe': (config.max_seq_len, h),
        'lnf_g': (h,), 'lnf_b': (h,), 'blocks': blocks,
    }


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == 'bfloat16':       # numpy has no bf16 of its own
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, config, device):
    """Turn the reference's parameter tree (``paddle_tpu.models.gpt.
    init_params`` or ``moe_gpt.init_params``, leaves converted to numpy
    arrays) into the port's dict of tensors on ``device``, checking every
    shape against ``config`` (a ``GPTConfig`` or a ``MoEConfig``)."""
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


def serving_params(params, config, keys=_CAST_ONCE):
    """The parameters the serving forward reads: the block matmul weights
    and biases (``keys``: GPT's by default) cast to the compute dtype
    once, here, instead of on every call (the reference casts them inside
    each product; the cast values are the same, so the numbers are too).
    Weight-only int8 banks (``quantize_decode_params``) pass through as
    they are: a compute-dtype copy beside them would undo their memory
    saving. LayerNorm parameters,
    ``wte`` (looked up in the parameter dtype before the cast of the sum)
    and ``wpe`` stay as they are."""
    cdt = torch_dtype(config.dtype)
    blocks = dict(params['blocks'])
    for k in keys:
        if not is_weight_only(blocks[k]):
            blocks[k] = blocks[k].to(cdt)
    return dict(params, blocks=blocks)


def quantize_decode_params(params):
    """Weight-only int8 snapshot of a parameter dict for serving
    (``gpt.py:473``): ``qkv_w``, ``proj_w``, ``fc_w`` and ``out_w`` go int8
    with one f32 scale per output channel (amax over axis 1 of the stacked
    ``[L, in, out]``), ``wte`` with one per vocab row; biases, norms and
    ``wpe`` stay as they are (the same tensors). The result drops into
    ``forward`` / ``forward_with_cache`` / the engine as it is."""
    blocks = dict(params['blocks'])
    for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
        blocks[k] = quantize_weight(blocks[k], reduce_axis=1)
    return dict(params, blocks=blocks,
                wte=quantize_weight(params['wte'], reduce_axis=1))


def _layer_norm(x, g, b, eps=1e-5):
    m = x.mean(dim=-1, keepdim=True)
    v = torch.square(x - m).mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * g + b


def _mm(y, w, cdt, fp8_meta=None, groups=None):
    """One block matmul: raw or weight-only through ``wo_matmul``, or,
    given an fp8 scaling meta, the e4m3/e5m2 delayed-scaling product over
    the weight cast to the compute dtype first (``gpt.py:288``); a mesh
    step's ``groups`` reduce each operand's amax over the ranks holding
    its blocks (``fp8.fp8_matmul``)."""
    if fp8_meta is None:
        return wo_matmul(y, w, cdt)
    if groups is None:
        return _fp8.fp8_matmul(y, w.to(cdt), fp8_meta)
    return _fp8.fp8_matmul(y, w.to(cdt), fp8_meta, groups)


def _block_qkv(bp, y, nh, hd, cdt, kvh=None, fp8_meta=None, groups=None):
    """Fused QKV projection. Packing is per KV HEAD: [q_0..q_{g-1}|k|v]
    (g = query group size; g=1 is classic head-major MHA)."""
    B, S, _ = y.shape
    kvh = nh if kvh is None else kvh
    g = nh // kvh
    qkv = _mm(y, bp['qkv_w'], cdt, fp8_meta, groups) + bp['qkv_b'].to(cdt)
    qkv = qkv.reshape(B, S, kvh, g + 2, hd)
    q = qkv[..., :g, :].reshape(B, S, nh, hd)
    return q, qkv[..., g, :], qkv[..., g + 1, :]


def _block_mlp(bp, y, cdt, fp8_fc=None, fp8_out=None, groups=(None, None)):
    """fc -> gelu (tanh approximation) -> out projection (bias added by
    the caller); ``groups``: the fp8 amax groups of the column and the row
    product (``_fp8_groups``)."""
    y = F.gelu(_mm(y, bp['fc_w'], cdt, fp8_fc, groups[0])
               + bp['fc_b'].to(cdt), approximate='tanh')
    return _mm(y, bp['out_w'], cdt, fp8_out, groups[1])


def _attention(q, k, v, config, drop_seed=None, mesh=None):
    """Causal self-attention of the forward (the reference's
    ``_attention``, ``gpt.py:221-285``). q [B,S,H,D], k/v [B,S,H_kv,D].
    ``use_flash`` runs kernel 1 with kernels 2 and 3 as its backward
    (their twins on the CPU) where a kernel instance takes the shape
    (``kernel_takes``: head dim 64/128/256, f32/bf16; the reference's
    ``flash_attention_available`` gate, ``gpt.py:270-276``);
    ``use_flash=False``, or a shape no instance takes, runs the
    reference's own einsum path (``gpt.py:277-285``): scores in the
    compute dtype, f32 softmax. ``drop_seed`` (a u32, training only) turns on
    ``config.dropout``: in the kernels on the flash path, through the
    same counter-hash mask in ``attention_reference`` otherwise. With
    ``config.sp > 1`` (and the train step's ``mesh``) q, k, v are this
    rank's sequence block and attention runs the ring over the mesh's sp
    axis: ``ring_flash_attention`` (kernels 1-3 a hop; GQA kv blocks
    rotate un-repeated) with ``use_flash``, the plain ``ring_attention``
    over repeated kv heads without it."""
    flash = config.use_flash and kernel_takes(q, k, v)
    if config.sp > 1:
        from ..parallel.ring_attention import (ring_attention,
                                               ring_flash_attention)
        if mesh is None:
            raise ValueError('sp > 1 runs inside the mesh train step '
                             '(make_train_step(config, opt, mesh))')
        drop = config.dropout > 0.0 and drop_seed is not None
        if flash:
            return ring_flash_attention(
                q, k, v, 'sp', causal=True,
                drop_rate=config.dropout if drop else 0.0,
                seed=drop_seed if drop else None, mesh=mesh)
        if drop:
            raise NotImplementedError(
                'attention dropout under sequence parallelism needs the '
                'ring flash path (use_flash=True, 128-multiple local '
                'shard) — or set dropout=0')
        k, v = repeat_kv(k, v, int(q.shape[2]))
        return ring_attention(q, k, v, 'sp', causal=True, mesh=mesh)
    if config.dropout > 0.0 and drop_seed is not None:
        if flash:
            return flash_attention(q, k, v, causal=True,
                                   dropout_rate=config.dropout,
                                   dropout_seed=drop_seed)
        return attention_reference(q, k, v, True, None, config.dropout,
                                   drop_seed)
    if flash:
        return flash_attention(q, k, v, causal=True)
    k, v = repeat_kv(k, v, int(q.shape[2]))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum('bqhd,bkhd->bhqk', q, k) * scale
    S = q.shape[1]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', p, v)


def _fp8_groups(config, mesh):
    """The fp8 amax groups of a mesh step's (column, row) products: each
    an (x, w, g) triple of the ``Group``s whose ranks hold blocks of that
    operand (a column product's x is this dp block, replicated over mp,
    its w and its output gradient split over mp; a row product's x is
    split over mp, its output gradient summed by g, so replicated over
    mp). None outside a mesh."""
    if mesh is None:
        return None, None
    dp = mesh.group('dp')
    if config.mp == 1:
        return (dp, None, dp), (dp, None, dp)
    mp, both = mesh.group('mp'), mesh.group(('dp', 'mp'))
    return (dp, mp, both), (both, mp, dp)


def attention_residual(bp, x, config, drop_seed=None, fp8_meta=None,
                       mesh=None):
    """The attention half of a block: ``x + proj(attention(ln1(x))) +
    proj_b`` (``gpt.py:320-340``), MoE's too. ``mesh``: the mesh train
    step's (see ``block_fn``)."""
    cdt = torch_dtype(config.dtype)
    B, S, h = x.shape
    mp = config.mp if mesh is not None else 1
    nh, kvh = config.num_heads // mp, config.kv_heads // mp
    fm = fp8_meta or {}
    col, row = _fp8_groups(config, mesh) if fm else (None, None)
    y = _layer_norm(x, bp['ln1_g'], bp['ln1_b']).to(cdt)
    if mp > 1:
        from ..parallel.tp_ad import f_identity, g_allreduce
        grp = mesh.group('mp')
        y = f_identity(y, grp)
    q, k, v = _block_qkv(bp, y, nh, config.head_dim, cdt, kvh, fm.get('qkv'),
                         col)
    a = _attention(q, k, v, config, drop_seed, mesh).reshape(B, S, h // mp)
    a = _mm(a, bp['proj_w'], cdt, fm.get('proj'), row)
    if mp > 1:
        a = g_allreduce(a, grp)
    return x + a + bp['proj_b'].to(cdt)


def block_fn(bp, x, config, drop_seed=None, fp8_meta=None, mesh=None):
    """One transformer block (``gpt.py:320-356``). bp: this layer's params
    (no leading L dim); x: [B, S, H]; ``drop_seed``: this layer's u32
    dropout seed, or None; ``fp8_meta``: this layer's ``{name: matmul
    meta}`` for ``FP8_MATMULS``, or None. ``mesh`` (the mesh train step's,
    the reference's ``explicit_mp``): with ``config.mp > 1`` the qkv/fc
    weights are this rank's column blocks and proj/out its row blocks,
    Megatron's f/g pair over the mesh's mp axis around each; with
    ``config.sp > 1`` attention runs the ring over its sp axis; fp8
    products reduce their amax over the ranks holding each operand's
    blocks (``_fp8_groups``)."""
    cdt = torch_dtype(config.dtype)
    mp = config.mp if mesh is not None else 1
    fm = fp8_meta or {}
    x = attention_residual(bp, x, config, drop_seed, fm, mesh)
    y = _layer_norm(x, bp['ln2_g'], bp['ln2_b']).to(cdt)
    if mp > 1:
        from ..parallel.tp_ad import f_identity, g_allreduce
        grp = mesh.group('mp')
        y = f_identity(y, grp)
    y = _block_mlp(bp, y, cdt, fm.get('fc'), fm.get('out'),
                   _fp8_groups(config, mesh) if fm else (None, None))
    if mp > 1:
        y = g_allreduce(y, grp)
    return x + y + bp['out_b'].to(cdt)


def _layer(blocks, layer):
    """Layer ``layer`` of the stacked blocks (an int8 bank: of both of its
    planes)."""
    return {k: kv_layer(w, layer) for k, w in blocks.items()}


_SAVED_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                  torch.ops.aten._scaled_mm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy='dots'``: keep the
    outputs of the block matmuls (``y @ w`` lowers to ``aten.mm`` /
    ``aten.addmm``; the fp8 products on the card to ``aten._scaled_mm``),
    recompute everything else, kernel 1 and the fp8 casts included."""
    if op in _SAVED_MATMULS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, config):
    """The configured rematerialisation of a block body (``gpt.py:206``):
    'dots' keeps the matmul outputs (the reference's
    ``dots_with_no_batch_dims_saveable``), any other policy, or a config
    without one (``MoEConfig``: ``jax.checkpoint`` of the whole block),
    recomputes the whole block in the backward. Under both, the attention
    forward (kernel 1) runs again in the backward, as the reference
    recomputes its custom call."""
    kw = {}
    if getattr(config, 'remat_policy', None) == 'dots':
        kw['context_fn'] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_matmuls)

    def run(*args):
        return _ckpt.checkpoint(body, *args, use_reentrant=False, **kw)
    return run


def forward_hidden(params, tokens, config, dropout_seed=None,
                   fp8_state=None):
    """tokens [B, S] -> final hidden states [B, S, H] (pre-LM-head), a
    Python loop over the stacked blocks. ``dropout_seed`` (a u32, training
    only) turns on ``config.dropout`` with one derived seed per layer
    (``per_layer_seeds``); None leaves it off. ``fp8_state``
    (``init_fp8_state``, training only) gives each layer its slice of the
    stacked metas; gradients w.r.t. it are the UPDATED state
    (``quantization/fp8.py``). With ``config.remat`` and autograd
    recording, each block runs under ``_remat``."""
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
    metas = fp8_layers(fp8_state, L)
    pos = torch.arange(S, device=tokens.device)
    x = (wo_take(params['wte'], tokens.long()) + params['wpe'][pos]).to(cdt)
    for layer, bp in enumerate(layer_views(params['blocks'])):
        x = body(bp, x, config, seeds[layer], metas[layer])
    return _layer_norm(x, params['lnf_g'], params['lnf_b']).to(cdt)


def layer_views(blocks):
    """The stacked blocks as one parameter dict a layer (int8 banks: both
    planes), from one unbind per stacked weight: its backward stacks the L
    gradients once, where per-layer indexing would add L full-size zero
    tensors."""
    layers = {k: ({p: t.unbind(0) for p, t in w.items()}
                  if is_weight_only(w) else w.unbind(0))
              for k, w in blocks.items()}
    return [{k: kv_layer(w, layer) for k, w in layers.items()}
            for layer in range(blocks['ln1_g'].shape[0])]


def fp8_layers(fp8_state, num_layers):
    """The stacked fp8 metas as one ``{name: {role: {'scale', 'ahist'}}}``
    a layer, from one unbind per stacked tensor (as ``layer_views``; the
    scales 16-byte aligned, ``_fp8.layer_scales``); ``[None] *
    num_layers`` without a state."""
    if fp8_state is None:
        return [None] * num_layers
    views = {n: {r: {'scale': _fp8.layer_scales(role['scale']),
                     'ahist': role['ahist'].unbind(0)}
                 for r, role in meta.items()}
             for n, meta in fp8_state['blocks'].items()}
    return [{n: {r: {k: t[layer] for k, t in role.items()}
                 for r, role in meta.items()} for n, meta in views.items()}
            for layer in range(num_layers)]


def forward(params, tokens, config, dropout_seed=None):
    """tokens [B, S] -> logits [B, S, V]."""
    x = forward_hidden(params, tokens, config, dropout_seed=dropout_seed)
    return wo_lm_head(x, params['wte'], x.dtype)


def loss_fn(params, tokens, targets, config, dropout_seed=None,
            fp8_state=None):
    """Mean token cross-entropy (``gpt.py:418``), f32. ``dropout_seed``:
    the u32 the reference draws from its key (``jax.random.bits(key,
    (1,), uint32)[0]``), used only when ``config.dropout > 0``. With
    ``xent_chunk`` dividing the vocab, the blockwise LM-head loss
    (``ops/xent.py``) never builds the [B, S, V] logits; otherwise the
    logits go through an f32 ``log_softmax``. ``fp8_state``: see
    ``forward_hidden``."""
    seed = dropout_seed if config.dropout > 0.0 else None
    x = forward_hidden(params, tokens, config, dropout_seed=seed,
                       fp8_state=fp8_state)
    if config.xent_chunk and config.vocab_size % config.xent_chunk == 0:
        B, S, H = x.shape
        return softmax_xent_blockwise(x.reshape(B * S, H), params['wte'],
                                      targets.reshape(B * S),
                                      config.xent_chunk)
    logits = wo_lm_head(x, params['wte'], x.dtype)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -ll.mean()


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
    """The train step (``gpt.py:832-1044``): ``step(params, opt_state,
    seed, lr, tokens, targets) -> (loss, params, opt_state)``, or with
    ``matmul_precision='fp8'`` (one device or a dp/mp mesh)
    ``step(params, opt_state, fp8_state, seed, lr, tokens, targets) ->
    (loss, params, opt_state, fp8_state)``. ``seed`` is the step's u32 (an int), used for attention
    dropout and the quantized all-reduce's rounding, in place of the
    reference's PRNG key (see the module docstring). The loss and its
    gradients come from autograd; ``optimizer.functional_apply`` then
    updates ``params`` and ``opt_state`` in place (the reference donates
    them), and the same dicts are returned.

    Without a mesh, and with mp = sp = pp = 1 and no grad_quant, this is
    the single-device step over ``loss_fn``. Otherwise ``mesh`` (a
    ``distributed.topology.Mesh`` or ``HybridTopology``; default the
    process topology's) runs the hybrid-parallel step: ``params`` and
    ``opt_state`` are this rank's blocks (``place_params``), every rank
    passes the global batch and the step takes its (dp, sp) block, the
    loss is the global mean on every rank. See ``_mesh_train_step``."""
    if mesh is None and _uses_mesh(config):
        from ..distributed.topology import get_mesh
        mesh = get_mesh()
    if mesh is None:
        return autograd_step(loss_fn, config, optimizer)
    return _mesh_train_step(config, optimizer, getattr(mesh, 'mesh', mesh))


def autograd_step(loss, config, optimizer):
    """``step(params, opt_state, seed, lr, tokens, targets) -> (loss,
    params, opt_state)`` over ``loss(params, tokens, targets, config,
    seed)``: its gradients from autograd, then one ``optimizer.
    functional_apply`` in place. GPT's and MoE's train steps. With
    ``matmul_precision='fp8'`` the step also takes ``fp8_state`` after
    ``opt_state``: its leaves join the differentiated inputs, their
    "gradients" are the new state (``quantization/fp8.py``), which is
    copied into them in place."""
    def run(params, fp8_state, seed, tokens, targets):
        leaves = _leaves(params)
        metas = [] if fp8_state is None else _leaves(fp8_state)
        kw = {}
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            live_m = [m.detach().requires_grad_(True) for m in metas]
            if fp8_state is not None:
                kw['fp8_state'] = _rebuild(fp8_state, live_m)
            value = loss(_rebuild(params, live), tokens, targets, config,
                         seed if config.dropout > 0.0 else None, **kw)
            grads = torch.autograd.grad(value, live + live_m)
        with torch.no_grad():
            for m, new in zip(metas, grads[len(live):]):
                m.copy_(new)
        return value.detach(), _rebuild(params, grads[:len(live)])

    if config.matmul_precision == 'fp8':
        def fp8_step(params, opt_state, fp8_state, seed, lr, tokens,
                     targets):
            value, grads = run(params, fp8_state, seed, tokens, targets)
            params, opt_state = optimizer.functional_apply(
                params, grads, opt_state, lr)
            return value, params, opt_state, fp8_state
        return fp8_step

    def step(params, opt_state, seed, lr, tokens, targets):
        value, grads = run(params, None, seed, tokens, targets)
        params, opt_state = optimizer.functional_apply(
            params, grads, opt_state, lr)
        return value, params, opt_state

    return step


# ---------------------------------------------------------------------------
# Hybrid-parallel train step (step K1)
# ---------------------------------------------------------------------------

# Logical axis names per parameter (parallel/partitioner.py), the
# reference's (``gpt.py:177-190``): the Megatron column/row and pipeline
# layout falls out of one rules table.
LOGICAL_AXES = {
    'wte': ('vocab', 'embed'),
    'wpe': ('positions', 'embed'),
    'blocks': {
        'ln1_g': ('layers', 'embed'), 'ln1_b': ('layers', 'embed'),
        'qkv_w': ('layers', 'embed', 'heads'),
        'qkv_b': ('layers', 'heads'),
        'proj_w': ('layers', 'heads', 'embed'),
        'proj_b': ('layers', 'embed'),
        'ln2_g': ('layers', 'embed'), 'ln2_b': ('layers', 'embed'),
        'fc_w': ('layers', 'embed', 'mlp'), 'fc_b': ('layers', 'mlp'),
        'out_w': ('layers', 'mlp', 'embed'), 'out_b': ('layers', 'embed'),
    },
    'lnf_g': ('embed',), 'lnf_b': ('embed',),
}


def _uses_mesh(config):
    """The layouts only the mesh step runs: mp/sp/pp > 1 or a quantized
    gradient all-reduce."""
    return (config.mp > 1 or config.sp > 1 or config.pp > 1
            or config.grad_quant not in (None, 'none'))


def _uses_shard_map(config):
    """The reference's explicit-collective layouts (``gpt.py:822-827``)."""
    return (config.sp > 1 or config.pp > 1
            or config.grad_quant not in (None, 'none'))


def _partitioner(config, explicit):
    from ..parallel.partitioner import Partitioner, model_rules
    return Partitioner(rules=model_rules(
        mp=config.mp, pp=config.pp, sp=config.sp, explicit=explicit))


def param_specs(config):
    """PartitionSpecs of the reference's GSPMD path (vocab and heads over
    'mp'), from LOGICAL_AXES through the rules table."""
    return _partitioner(config, explicit=False).tree_specs(LOGICAL_AXES)


def train_specs(config):
    """PartitionSpecs of the parameters the port's mesh step takes: the
    explicit-collective rules (vocab replicated; 'mp', 'pp' only where >
    1) for every layout. The reference takes these for its shard_map
    layouts and ``param_specs`` for dp/mp, which the port also runs on the
    explicit route (ROADMAP "Known, deliberate differences")."""
    return _partitioner(config, explicit=True).tree_specs(LOGICAL_AXES)


def place_params(params, config, mesh):
    """This rank's blocks of the global parameter dict (every rank passes
    the same global dict), by ``train_specs``: copies, which the step
    updates in place."""
    from ..optimizer.optimizer import tree_map
    from ..parallel.partitioner import shard
    mesh = getattr(mesh, 'mesh', mesh)
    return tree_map(lambda x, s: shard(x, s, mesh).clone(), params,
                    train_specs(config))


def gather_params(params, config, mesh):
    """The global parameter dict from every rank's blocks (all-gathered
    over each sharded dim's axis): the counterpart of reading a sharded
    ``jax.Array`` whole, for tests and checkpoints."""
    from ..parallel.partitioner import unshard_tree
    return unshard_tree(params, train_specs(config), getattr(mesh, 'mesh',
                                                             mesh))


def _check_mesh(config, mesh):
    """The reference's refusals (``gpt.py:855-868``, ``:908-910``), and the
    config's degrees against the mesh's."""
    if config.dropout > 0.0 and config.pp > 1:
        raise NotImplementedError(
            'attention dropout under pipeline parallelism is not '
            'implemented — set dropout=0, or use dp/mp/sp layouts')
    if config.matmul_precision == 'fp8' and _uses_shard_map(config):
        raise NotImplementedError(
            "matmul_precision='fp8' under the explicit-collective "
            '(shard_map) layouts (sp/pp/grad_quant) is not implemented '
            '— use the GSPMD dp/mp path or matmul_precision=none')
    if (config.pp > 1 and config.pp_schedule == '1f1b'
            and config.grad_quant != 'none'):
        raise NotImplementedError(
            'grad_quant under the fused 1F1B schedule is not '
            "implemented — use pp_schedule='gpipe' or grad_quant='none'")
    for ax in ('mp', 'sp', 'pp'):
        if mesh.axis_size(ax) != getattr(config, ax):
            raise ValueError(
                f'config.{ax}={getattr(config, ax)} but the mesh has '
                f'{ax}={mesh.axis_size(ax)} ({mesh})')


_SHARED = ('lnf_b', 'lnf_g', 'wpe', 'wte')


def _mesh_train_step(config, optimizer, mesh):
    """The hybrid-parallel step over ``mesh`` (``gpt.py:832-1109``), one
    process a rank, on the explicit-collective route for every layout:

     - the batch: this rank's (dp, sp) block of the global ``tokens`` /
       ``targets``;
     - the forward: the embedding at this sp block's positions, the
       rank's layers (Megatron mp inside ``block_fn``, the sp ring inside
       ``_attention``), or with pp > 1 the GPipe pipeline over them
       (``pipeline_apply``; the loss kept on the last stage) or the fused
       1F1B schedule (``pp_schedule='1f1b'``); then the final norm, the
       tied head over the whole vocab and the f32 cross-entropy mean;
     - after the backward: the loss and the shared parameters' gradients
       summed over pp, then the loss and every gradient averaged over dp
       (through ``quant_collectives.psum_tree`` with ``grad_quant``) and
       sp;
     - ``optimizer.functional_apply`` on this rank's blocks, in place.

    Dropout seeds follow the reference's folds (``gpt.py:929-944``): the
    step's seed mixed with the dp index (and the mp index), one seed a
    layer, the ring folding in its (q rank, kv rank) pair; the quantized
    all-reduce rounds from ``mix_seed(seed ^ 0xA5A5F00D)``.

    ``matmul_precision='fp8'`` (dp/mp only, as the reference's GSPMD path)
    takes ``step(params, opt_state, fp8_state, seed, lr, tokens,
    targets)``: each product's amax is reduced over the ranks holding its
    operand's blocks (``_fp8_groups``) and each rank differentiates its
    share of the global mean (its tokens' loss over the global count, the
    gradients then summed over dp), so an output gradient is the
    reference's at these rows and every rank's new state is the
    reference's; ``fp8_state`` is replicated and updated in place."""
    from ..distributed import collective as coll
    from ..distributed import quant_collectives as qc
    from ..ops.flash_attention import mix_seed
    from ..optimizer.optimizer import tree_map
    from ..parallel.pipeline import (last_stage_mask, pipeline_apply,
                                     pipeline_train_1f1b)
    _check_mesh(config, mesh)
    fp8 = config.matmul_precision == 'fp8'
    if fp8 and config.mp > 1:
        mesh.group(('dp', 'mp'))         # every rank builds it, here
    quant = config.grad_quant
    data_spec = _partitioner(config, explicit=True).spec(('batch', 'length'))
    needs_seed = config.dropout > 0.0 or quant in ('int8', 'int4')
    cdt = torch_dtype(config.dtype)
    sp_idx = mesh.axis_index('sp')
    pp_grp = mesh.group('pp')

    def embed(sh, tok):
        s = tok.shape[1]
        pos = sp_idx * s + torch.arange(s, device=tok.device)
        return (sh['wte'][tok.long()] + sh['wpe'][pos]).to(cdt)

    def head_loss(sh, x, tgt):
        x = _layer_norm(x, sh['lnf_g'], sh['lnf_b']).to(cdt)
        logits = x @ sh['wte'].t().to(cdt)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, tgt.long()[..., None])[..., 0].mean()

    def stage_fn(blocks, x):
        # a pipeline stage: recomputed whole in its backward tick, so its
        # layers run without a checkpoint of their own
        for bp in layer_views(blocks):
            x = block_fn(bp, x, config, mesh=mesh)
        return x

    def spmd_loss(params, tok, tgt, seed, fp8_state=None):
        x = embed(params, tok)
        if config.pp > 1:
            x = pipeline_apply(stage_fn, params['blocks'], x,
                               config.n_microbatches, 'pp', mesh)
        else:
            body = (_remat(block_fn, config)
                    if config.remat and torch.is_grad_enabled()
                    else block_fn)
            seeds = mesh_layer_seeds(config, mesh, seed)
            metas = fp8_layers(fp8_state, config.num_layers)
            for layer, bp in enumerate(layer_views(params['blocks'])):
                x = body(bp, x, config, seeds[layer], metas[layer], mesh)
        loss = head_loss(params, x, tgt)
        if config.pp > 1:
            # the head is valid on the last stage only; the psum over pp
            # comes after the backward
            loss = loss * float(last_stage_mask('pp', mesh))
        return loss

    def reduce(loss, grads, seed):
        for ax in ('dp', 'sp'):
            grp = mesh.group(ax)
            if ax == 'sp' and config.sp == 1:
                continue
            loss = coll.pmean(loss, grp)
            if ax == 'dp' and quant != 'none':
                qseed = (int(mix_seed((int(seed) ^ 0xA5A5F00D) & _M32))
                         if needs_seed and seed is not None else None)
                grads = qc.psum_tree(grads, grp, mode=quant, seed=qseed,
                                     stochastic=qseed is not None, mean=True)
            elif grp is not None and grp.nranks > 1:
                grads = tree_map(lambda g, _g=grp: coll.pmean(g, _g), grads)
        return loss, grads

    def valgrad(params, tok, tgt, seed):
        leaves = _leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            loss = spmd_loss(_rebuild(params, live), tok, tgt, seed)
            got = torch.autograd.grad(loss, live, allow_unused=True)
        grads = _rebuild(params, [torch.zeros_like(p) if g is None else g
                                  for p, g in zip(leaves, got)])
        loss = loss.detach()
        if config.pp > 1:
            loss = coll.psum(loss, pp_grp)
            grads = {k: (v if k == 'blocks' else coll.psum(v, pp_grp))
                     for k, v in grads.items()}
        return reduce(loss, grads, seed)

    def grads_1f1b(params, tok, tgt, seed):
        shared = {k: params[k].detach().requires_grad_() for k in _SHARED}
        blocks = {k: v.detach().requires_grad_()
                  for k, v in params['blocks'].items()}
        loss, g_blocks, g_shared = pipeline_train_1f1b(
            stage_fn, embed, head_loss, blocks, shared, tok, tgt,
            config.n_microbatches, 'pp', mesh)
        return reduce(loss, dict(g_shared, blocks=g_blocks), seed)

    def valgrad_fp8(params, fp8_state, tok, tgt, seed):
        # this rank's share of the global mean (dp blocks are equal), so
        # every output gradient is the reference's at these rows
        leaves, metas = _leaves(params), _leaves(fp8_state)
        dp = mesh.axis_size('dp')
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            live_m = [m.detach().requires_grad_() for m in metas]
            loss = spmd_loss(_rebuild(params, live), tok, tgt, seed,
                             _rebuild(fp8_state, live_m))
            got = torch.autograd.grad(loss / dp, live + live_m)
        with torch.no_grad():
            for m, new in zip(metas, got[len(live):]):
                m.copy_(new)
        grads = _rebuild(params, list(got[:len(live)]))
        if dp > 1:
            grp = mesh.group('dp')
            loss = coll.pmean(loss.detach(), grp)
            grads = tree_map(lambda g: coll.psum(g, grp), grads)
        return loss.detach(), grads

    run = (grads_1f1b if config.pp > 1 and config.pp_schedule == '1f1b'
           else valgrad)

    def grads_fn(params, fp8_state, tok, tgt, seed):
        seed = seed if needs_seed else None
        if fp8:
            return valgrad_fp8(params, fp8_state, tok, tgt, seed)
        return run(params, tok, tgt, seed)

    return mesh_step(optimizer, mesh, data_spec, grads_fn, fp8)


def mesh_layer_seeds(config, mesh, seed):
    """One dropout seed a layer on this rank of a mesh step, by the
    reference's folds (``gpt.py:929-944``): the step's seed mixed with the
    dp index, then (mp > 1) with the mp index. Nones without dropout or a
    seed. Shared by GPT's and MoE's mesh steps."""
    from ..ops.flash_attention import mix_seed
    if not (config.dropout > 0.0 and seed is not None):
        return [None] * config.num_layers
    seed_eff = mix_seed((int(seed) + _mul32(
        torch.tensor(mesh.axis_index('dp')), 0x165667B1)) & _M32)
    if config.mp > 1:
        seed_eff = mix_seed((seed_eff + _mul32(
            torch.tensor(mesh.axis_index('mp')), 0xD3A2646D)) & _M32)
    return per_layer_seeds(seed_eff, config.num_layers).tolist()


def mesh_step(optimizer, mesh, data_spec, grads_fn, fp8):
    """A mesh step around ``grads_fn(params, fp8_state, tok, tgt, seed) ->
    (loss, grads)`` (fp8_state None unless ``fp8``): this rank's block
    (``data_spec``) of the global batch on the parameters' device, then
    ``optimizer.functional_apply`` in place. ``step(params, opt_state,
    seed, lr, tokens, targets) -> (loss, params, opt_state)``, with fp8
    ``step(params, opt_state, fp8_state, seed, lr, tokens, targets) ->
    (..., fp8_state)``. Shared by GPT's and MoE's mesh steps."""
    from ..parallel.partitioner import shard

    def run(params, opt_state, fp8_state, seed, lr, tokens, targets):
        dev = params['wte'].device
        tok = shard(torch.as_tensor(tokens), data_spec, mesh).to(dev)
        tgt = shard(torch.as_tensor(targets), data_spec, mesh).to(dev)
        loss, grads = grads_fn(params, fp8_state, tok, tgt, seed)
        params, opt_state = optimizer.functional_apply(params, grads,
                                                       opt_state, lr)
        return loss, params, opt_state

    if fp8:
        def step(params, opt_state, fp8_state, seed, lr, tokens, targets):
            return run(params, opt_state, fp8_state, seed, lr, tokens,
                       targets) + (fp8_state,)
    else:
        def step(params, opt_state, seed, lr, tokens, targets):
            return run(params, opt_state, None, seed, lr, tokens, targets)
    step.mesh = mesh
    return step


# fp8 training state -------------------------------------------------------

FP8_MATMULS = ('qkv', 'proj', 'fc', 'out')


def init_fp8_state(config, device=None, matmuls=FP8_MATMULS):
    """Delayed-scaling state for ``matmul_precision='fp8'``: one {x, w, g}
    x {scale, amax history} meta per block matmul (``matmuls``), stacked
    on the layer dim beside ``params['blocks']``, on ``device`` (the card
    unless the caller names the CPU). Pass it to the fp8 train step as its
    third argument; the step updates it in place and returns it."""
    return {'blocks': {name: _fp8.init_matmul_meta(config.num_layers,
                                                   device=device)
                       for name in matmuls}}


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
    ``flat_idx`` may carry the call's ``paged_kv.write_plan``. The
    reference runs a multi-token call that is not a prefix-cache tail
    through its flash forward over the fresh rows; attention over the
    paged cache computes the same rows, so every call here goes through
    the paged kernel."""
    B, T, h = x.shape
    a = cached_attend(q, k, v, k_cache, v_cache, pos, page_table, valid,
                      flat_idx)
    return (x + wo_matmul(a.reshape(B, T, h), proj_w, cdt) + proj_b.to(cdt),
            k_cache, v_cache)


def cached_attend(q, k, v, k_cache, v_cache, pos, page_table=None,
                  valid=None, flat_idx=None):
    """``cached_attention``'s write and attention, without the projection:
    -> [B, T, H, D]."""
    T = q.shape[1]
    if page_table is not None:
        paged_write(k_cache, k, page_table, pos, valid, flat_idx)
        paged_write(v_cache, v, page_table, pos, valid, flat_idx)
        return paged_attention(q.contiguous(), k_cache, v_cache, page_table,
                               pos, valid)
    s_max = int(kv_plane(k_cache).shape[1])
    idx = (flat_idx if flat_idx is not None
           else dense_rows(pos, T, s_max, q.device))
    _dense_write(k_cache, k, idx)
    _dense_write(v_cache, v, idx)
    if isinstance(pos, int) and pos == 0 and kernel_takes(q, k, v):
        return flash_attention(q, k, v, causal=True)
    return decode_attention(q, k_cache, v_cache, pos)


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
                             last_only=False, block=_cached_block):
    """Run [B, T] tokens whose absolute positions start at ``pos`` ([B]
    int32, one per slot) through the paged cache: ``cache`` carries the
    page pools ``{'k','v'}`` + ``page_table`` (+ optional ``valid``).
    ``block`` is the block body (``_cached_block``'s signature), so
    ``moe_gpt`` reuses this forward with its own, as the reference's does.
    Each layer writes its rows into ``cache['k'][l]`` / ``cache['v'][l]``
    (int8 banks: both planes) in place. Returns (logits, cache) — logits
    [B,T,V], or [B,1,V] with
    ``last_only`` (each slot's last REAL row when ``valid`` is given) —
    with the table/valid passed through."""
    cdt = torch_dtype(config.dtype)
    T = tokens.shape[1]
    dev = tokens.device
    pos_v = pos.to(device=dev, dtype=torch.int32).reshape(-1)
    page_table, valid = cache['page_table'], cache.get('valid')
    # the attention kernels read valid on the device, as int32
    valid_v = (None if valid is None
               else valid.to(device=dev, dtype=torch.int32).reshape(-1))
    x = (wo_take(params['wte'], tokens.long())
         + params['wpe'][_row_positions(pos_v, T, config)]).to(cdt)
    k_pool, v_pool = cache['k'], cache['v']
    flat_idx = _paged_plan(page_table, pos_v, T, k_pool, valid_v)
    for layer in range(config.num_layers):
        x, _, _ = block(_layer(params['blocks'], layer), x,
                        kv_layer(k_pool, layer), kv_layer(v_pool, layer),
                        pos_v, config, page_table, valid_v, flat_idx)
    if last_only:
        x = _last_rows(x, valid_v)
    x = _layer_norm(x, params['lnf_g'], params['lnf_b']).to(cdt)
    return (wo_lm_head(x, params['wte'], cdt),
            _paged_out(k_pool, v_pool, page_table, valid))


def _row_positions(pos_v, T, config):
    """[B, T] absolute positions of T rows from each slot's ``pos_v``,
    clamped into the position table."""
    return torch.clamp(pos_v.long()[:, None]
                       + torch.arange(T, device=pos_v.device)[None, :],
                       0, config.max_seq_len - 1)


def _paged_plan(page_table, pos_v, T, k_pool, valid):
    """Every layer writes the same rows: their pool offsets (and which row
    supplies each one), computed once a call (``write_plan``)."""
    n_pages, ps = kv_plane(k_pool).shape[1:3]
    return write_plan(page_table, pos_v, T, ps, n_pages * ps, valid)


def _last_rows(x, valid):
    """[B, 1, H]: each slot's last REAL row (per-slot prompt lengths
    ``valid``), or the last row without it."""
    if valid is None:
        return x[:, -1:]
    idx = torch.clamp(valid.to(x.device).long() - 1, 0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]


def _paged_out(k_pool, v_pool, page_table, valid):
    """The cache a paged forward returns: the pools written in place, the
    table and ``valid`` passed through."""
    out = {'k': k_pool, 'v': v_pool, 'page_table': page_table}
    if valid is not None:
        out['valid'] = valid
    return out


def forward_with_cache(params, tokens, cache, pos, config: GPTConfig,
                       last_only=False, block=_cached_block):
    """Run [B, T] tokens whose absolute positions start at ``pos`` through
    the KV cache. Returns (logits, cache): logits [B,T,V], or [B,1,V] with
    ``last_only``.

    A paged cache (``is_paged``) routes to ``paged_forward_with_cache``
    with ``pos`` a per-slot [B] vector. The dense cache (``init_kv_cache``)
    takes ``pos`` as an int or a one-element tensor. A Python int 0 is
    passed on as it is (it routes to kernel 1, see ``cached_attention``);
    any other position becomes an int32 [1] tensor on the tokens' device,
    once. Each layer writes its rows into ``cache['k'][l]`` /
    ``cache['v'][l]`` in place. ``block``: the block body, as in
    ``paged_forward_with_cache``."""
    if is_paged(cache):
        return paged_forward_with_cache(params, tokens, cache, pos, config,
                                        last_only=last_only, block=block)
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
        x, _, _ = block(
            _layer(params['blocks'], layer), x,
            kv_layer(cache['k'], layer), kv_layer(cache['v'], layer),
            pos, config, flat_idx=rows)
    if last_only:
        x = x[:, -1:]
    x = _layer_norm(x, params['lnf_g'], params['lnf_b']).to(cdt)
    return wo_lm_head(x, params['wte'], cdt), cache


# ---------------------------------------------------------------------------
# The paged forward over a serving mesh (parallel/mesh_engine.py): one
# process, N shards. Replicated work runs once a device, a shard's
# Megatron block (its heads over its own pool, its FFN columns) once a
# shard, and the row-parallel partials meet in ``ctx.psum``.
# ---------------------------------------------------------------------------

def _firsts(ctx):
    """{device: the first shard on it}: replicated work runs there once."""
    out = {}
    for i, d in enumerate(ctx.devices):
        out.setdefault(d, i)
    return out


def _owners(ctx, kind):
    """The shards computing a ``kind`` ('heads', 'mlp') of a layer: all of
    them when it is split over the mesh, else shard 0 alone (a fallback
    keeps the whole product on every shard)."""
    return (range(ctx.size) if ctx.split.get(kind, False) else range(1))


def mesh_attention_residual(bps, x, kcs, vcs, pos, config, page_table, valid,
                            flat_idx, ctx):
    """The attention half of a block over the mesh: ``x`` and the inputs
    ``{device: tensor}``, ``bps`` / ``kcs`` / ``vcs`` a shard's layer
    params and pool planes each. Each owning shard writes and attends its
    heads (kernel 6 or 7 over its own pool), projects them through its
    rows of ``proj_w``; the partials sum on every device."""
    cdt = torch_dtype(config.dtype)
    B, T, h = next(iter(x.values())).shape
    n = ctx.size if ctx.split.get('heads', False) else 1
    firsts = _firsts(ctx)
    y = {d: _layer_norm(x[d], bps[i]['ln1_g'], bps[i]['ln1_b']).to(cdt)
         for d, i in firsts.items()}
    parts = []
    for i in _owners(ctx, 'heads'):
        d, bp = ctx.devices[i], bps[i]
        q, k, v = _block_qkv(bp, y[d], config.num_heads // n,
                             config.head_dim, cdt, config.kv_heads // n)
        a = cached_attend(q, k, v, kcs[i], vcs[i], pos[d], page_table[d],
                          valid[d], flat_idx[d])
        parts.append(wo_matmul(a.reshape(B, T, h // n), bp['proj_w'], cdt))
    a = ctx.psum(parts)
    return {d: x[d] + a[d] + bps[i]['proj_b'].to(cdt)
            for d, i in firsts.items()}


def mesh_cached_block(bps, x, kcs, vcs, pos, config, page_table, valid,
                      flat_idx, ctx):
    """``_cached_block`` over the mesh: the attention half, then each
    owning shard's FFN columns and rows, the partials summed."""
    cdt = torch_dtype(config.dtype)
    x = mesh_attention_residual(bps, x, kcs, vcs, pos, config, page_table,
                                valid, flat_idx, ctx)
    firsts = _firsts(ctx)
    y = {d: _layer_norm(x[d], bps[i]['ln2_g'], bps[i]['ln2_b']).to(cdt)
         for d, i in firsts.items()}
    f = ctx.psum([_block_mlp(bps[i], y[ctx.devices[i]], cdt)
                  for i in _owners(ctx, 'mlp')])
    return {d: x[d] + f[d] + bps[i]['out_b'].to(cdt)
            for d, i in firsts.items()}


def mesh_forward_with_cache(shards, tokens, cache, pos, config,
                            last_only=False, *, ctx, block=mesh_cached_block):
    """``paged_forward_with_cache`` over a serving mesh: ``shards`` the
    per-shard parameter dicts (``ctx.shards(placed)``), ``cache`` the
    per-shard pools ``{'k', 'v': [pool a shard]}`` with the (replicated)
    ``page_table`` / ``valid``. The tied embedding and head run over the
    vocab blocks (a masked lookup summed, the logits' columns
    concatenated) when the vocab is split. -> (logits on the first
    shard's device, cache)."""
    cdt = torch_dtype(config.dtype)
    T = tokens.shape[1]
    firsts = _firsts(ctx)
    d0 = ctx.devices[0]

    def put(t):
        return None if t is None else {d: t.to(d) for d in firsts}

    pos_v = pos.to(dtype=torch.int32).reshape(-1)
    page_table, valid = cache['page_table'], cache.get('valid')
    tok, pos_d = put(tokens.long()), put(pos_v)
    ppos_d = put(_row_positions(pos_v, T, config))
    table_d = put(page_table)
    valid_d = (put(valid.to(dtype=torch.int32).reshape(-1))
               if valid is not None else {d: None for d in firsts})
    k_pools, v_pools = cache['k'], cache['v']
    plan = {d: _paged_plan(table_d[d], pos_d[d], T, k_pools[0], valid_d[d])
            for d in firsts}
    if ctx.split.get('vocab', False):
        V = sum(int(sh['wte'].shape[0]) for sh in shards)
        off = [i * (V // ctx.size) for i in range(ctx.size)]
        emb = ctx.psum([_masked_take(sh['wte'], tok[ctx.devices[i]] - off[i])
                        for i, sh in enumerate(shards)])
    else:
        emb = {d: wo_take(shards[i]['wte'], tok[d])
               for d, i in firsts.items()}
    x = {d: (emb[d] + shards[i]['wpe'][ppos_d[d]]).to(cdt)
         for d, i in firsts.items()}
    for layer in range(config.num_layers):
        bps = [_layer(sh['blocks'], layer) for sh in shards]
        x = block(bps, x, [kv_layer(p, layer) for p in k_pools],
                  [kv_layer(p, layer) for p in v_pools], pos_d, config,
                  table_d, valid_d, plan, ctx)
    x = x[d0]
    if last_only:
        x = _last_rows(x, valid_d[d0])
    x = _layer_norm(x, shards[0]['lnf_g'], shards[0]['lnf_b']).to(cdt)
    if ctx.split.get('vocab', False):
        logits = torch.cat([wo_lm_head(x.to(sh['wte'].device), sh['wte'],
                                       cdt).to(d0) for sh in shards], dim=-1)
    else:
        logits = wo_lm_head(x, shards[0]['wte'], cdt)
    return logits, _paged_out(k_pools, v_pools, page_table, valid)


def _masked_take(wte, local):
    """Rows of a vocab block for ids ``local`` (ids minus the block's
    first), zero for ids outside it."""
    inside = (local >= 0) & (local < wte.shape[0])
    rows = wte[torch.where(inside, local, torch.zeros_like(local))]
    return rows * inside[..., None].to(rows.dtype)


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


def cast_pairs(params, src, keys=_CAST_ONCE):
    """(cast, source) of every block weight of ``keys`` that
    ``serving_params`` cast into a tensor of its own (f32 configs keep the
    source itself; int8 banks pass through)."""
    return [(params['blocks'][k], src['blocks'][k]) for k in keys
            if not is_weight_only(src['blocks'][k])
            and params['blocks'][k].data_ptr() != src['blocks'][k].data_ptr()]


def decode_entry(config, params, pairs, b, t0, temperature, top_k, top_p,
                 seeded, device, capture, prefill, loop):
    """generate()'s captured prefill for a batch of ``b`` prompts of ``t0``
    tokens over ``params`` (serving parameters), with the dense cache it
    writes: one graph copies each (cast, source) of ``pairs`` (weights
    changed in place are seen), zeroes the cache, runs ``prefill``
    (``make_decode_fns``' first) and draws the first token. -> {'prefill':
    the CapturedFn over buffers 'prompt' (and 'seeds' when ``seeded``),
    'cache', 'params', 'loop': ``loop`` (a ``make_generate_loop``),
    'lock'}."""
    cache = init_kv_cache(config, b, device)
    bufs = {'prompt': torch.zeros((b, t0), dtype=torch.int32,
                                  device=device)}
    if seeded:
        bufs['seeds'] = torch.zeros(b, dtype=torch.int64, device=device)

    def run(prompt, seeds=None):
        for dst, s in pairs:
            dst.copy_(s)
        zero_kv(cache)
        logits, _ = prefill(params, prompt, cache)
        return _sample(logits, temperature, top_k, top_p, seeds=seeds,
                       positions=torch.full((b,), t0 - 1, device=device))

    return {'prefill': CapturedFn(run, bufs, device, capture=capture),
            'cache': cache, 'params': params, 'loop': loop,
            'lock': threading.Lock()}


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
        # enable_int8_decode: the switch and the snapshot (made lazily)
        self._int8_decode = False
        self._int8_params = None

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
        (``_decode_entry``); the sliding window runs eagerly. After
        ``enable_int8_decode()`` every path reads the int8 snapshot."""
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
        """``serving_params`` of the parameters generate() reads
        (``_decode_params``), made once per set of parameter tensors and
        kept: captured graphs read them."""
        src = self._decode_params()
        key = tensor_key(src)
        if self._serving[0] != key:
            self._serving = (key, serving_params(src, self.config))
        return self._serving[1]

    def _decode_entry(self, b, t0, temperature, top_k, top_p, seeded):
        """generate()'s captured prefill and loop for a batch of ``b``
        prompts of ``t0`` tokens, with the dense cache they write and the
        serving parameters they read, from the model's ``DecodeFnCache``
        keyed by (config, sampling knobs, B, T0, device, the tensors of
        ``_decode_params``: the model's own, or the int8 snapshot's, so a
        re-snapshot never replays a graph over the old banks). Over the
        float parameters the prefill refreshes the cast copies from the
        model's own (weights changed in place are seen); the int8 snapshot
        stays frozen until the next ``enable_int8_decode()``, as the
        reference's does. Then the prefill zeroes the cache, fills it and
        draws the first token, all in one graph."""
        cfg, dev = self.config, self.device
        src = self._decode_params()
        key = (repr(cfg), temperature, top_k, top_p, b, t0, str(dev),
               seeded, tensor_key(src), self._capture)

        def build():
            params = self._serving_params()
            pairs = [] if self._int8_decode else cast_pairs(params, src)
            return decode_entry(
                cfg, params, pairs, b, t0, temperature, top_k, top_p, seeded,
                dev, self._capture, make_decode_fns(cfg)[0],
                make_generate_loop(cfg, temperature, top_k, top_p,
                                   capture=self._capture))

        return self._decode_fns.get(key, build)

    @torch.no_grad()
    def _generate_sliding(self, toks, max_new_tokens, temperature, top_k,
                          top_p=None, seeds=None, params=None):
        """Full-context recompute over the last ``max_seq_len`` tokens: the
        continuation once generation outgrows the cache. Each step is one
        plain forward (kernel 1); the LM head runs on the last row only."""
        cfg = self.config
        if params is None:
            params = serving_params(self._decode_params(), cfg)
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
        """Serve ``generate`` from weight-only int8 matrices
        (``quantize_decode_params``): the snapshot of the CURRENT weights is
        taken lazily at the next ``generate``; call again after further
        training to re-snapshot, or with False to go back to the float
        weights. ``forward`` and training are untouched. Graphs captured
        over an earlier snapshot are dropped with it."""
        self._int8_decode = bool(enable)
        self._int8_params = None
        self._decode_fns.clear()
        self._serving = (None, None)
        return self

    def _decode_params(self):
        """The parameters generate() and an engine built from this model
        serve: the model's own, or after ``enable_int8_decode()`` the int8
        snapshot. The snapshot is frozen, as the reference's (immutable
        arrays): the tensors it keeps unquantized are copies."""
        if not self._int8_decode:
            return self.param_dict()
        if self._int8_params is None:
            snap = quantize_decode_params(self.param_dict())

            def frozen(w):
                return w if is_weight_only(w) else w.detach().clone()
            self._int8_params = {
                k: ({bk: frozen(bw) for bk, bw in w.items()}
                    if k == 'blocks' else frozen(w))
                for k, w in snap.items()}
        return self._int8_params
