"""Mixtral-style MoE causal LM, ported to PyTorch.

Port of ``paddle_tpu/models/moe_gpt.py`` on one device: GPT's attention
blocks with a top-2 Mixture-of-Experts FFN (``parallel/moe.py``) in place
of the dense one. Parameters are a dict of tensors in the reference's
stacked layout (``gate_w`` [L, H, E], ``w_in`` [L, E, H, F], ``w_out``
[L, E, F, H]; no ``fc_*``/``out_*``), which ``gpt.params_from_numpy``
converts from the reference's tree.

Everything but the FFN is GPT's (``models/gpt.py``): LayerNorm, the fused
QKV projection, attention on the port's kernels (kernel 1 in the forward
with kernels 2 and 3 in its backward, kernels 4/5 in ``generate``'s dense
cache, kernels 6/7 in the engine's page pool), the paged forward
(``gpt.paged_forward_with_cache(..., block=_cached_block)``), the
generation loop on captured CUDA graphs (``gpt.make_generate_loop``) and
the autograd train step (``gpt.autograd_step``). The router's product
runs in the compute dtype before its f32 softmax, as the reference's.

Routing couples the rows of a call: expert capacity is
``int(capacity_factor * T / E + 1)`` for the call's T = B * S rows, so a
decode step's slots (idle ones included) compete for experts, and a
padded prefill's padding rows take first-choice slots that decide which
real rows keep their second choice.

fp8 training (``matmul_precision='fp8'``) runs the dense attention
matmuls, qkv and proj, through GPT's delayed-scaling product; the experts
stay in the compute dtype, as in the reference (``moe_gpt.py:56-63``).

Over a mesh (``make_train_step(config, opt, mesh)``) the step trains
the reference's global function with one process a rank: the batch over
dp, the experts over ep, heads and each expert's FFN width over mp
(GPT's Megatron pair; the vocab replicated, as GPT's mesh step keeps
it), routing global over dp (``parallel/moe.py`` ``moe_ffn_mesh``). The
reference's own refusals stand: sp > 1 (its step has no ``shard_map``
region, so its ring attention meets an unbound 'sp' axis) raises; pp > 1,
which its step ignores (the layers stay replicated), trains as pp = 1 on
every pp rank.
"""
import dataclasses
import warnings

import torch

from . import gpt as _gpt
from .decode_cache import DecodeFnCache, tensor_key
from .gpt import (_block_qkv, _layer_norm, attention_residual,
                  cached_attention, check_param_shapes, fp8_layers,
                  init_kv_cache, layer_views, params_from_numpy, torch_dtype,
                  validate_gqa)
from ..ops.flash_attention import per_layer_seeds
from ..ops.weight_only import quantize_weight, wo_lm_head, wo_take
from ..ops.xent import softmax_xent_blockwise
from ..parallel import moe as _moe
from ..parallel.moe import moe_ffn, moe_ffn_mesh

__all__ = ['MoEConfig', 'init_params', 'params_from_numpy',
           'check_param_shapes', 'forward', 'forward_hidden', 'loss_fn',
           'make_train_step', 'init_fp8_state', 'FP8_MATMULS',
           'LOGICAL_AXES', 'param_specs', 'train_specs', 'place_params',
           'gather_params',
           'quantize_decode_params', 'serving_params',
           'init_kv_cache', 'forward_with_cache', 'mesh_cached_block',
           'make_decode_fns',
           'generate']


@dataclasses.dataclass
class MoEConfig:
    """The reference's config, field for field (``paddle_tpu/models/
    moe_gpt.py:30-80``), so a reference config converts with
    ``MoEConfig(**dataclasses.asdict(ref_cfg))``. sp/mp/pp and
    matmul_precision are carried; the train step raises on values it does
    not take."""
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    n_experts: int = 8
    # GQA/MQA (0 = MHA); must divide num_heads
    num_kv_heads: int = 0
    ffn_mult: int = 4
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    max_seq_len: int = 1024
    dropout: float = 0.0
    dtype: str = 'bfloat16'
    param_dtype: str = 'float32'
    remat: bool = True
    use_flash: bool = True
    sp: int = 1
    mp: int = 1
    pp: int = 1
    xent_chunk: int = 8192
    kv_cache_int8: bool = False
    matmul_precision: str = 'none'

    def __post_init__(self):
        validate_gqa(self.num_heads, self.num_kv_heads, self.mp)
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


def init_params(config: MoEConfig, generator, device):
    """Stacked-block parameter dict with the reference's layout and stds
    (normal 0.02; the router 0.01; wpe 0.01), drawn from ``generator`` on
    ``device``. The draws differ from ``jax.random``'s: to hold the port
    against the reference, convert the reference's own params
    (``params_from_numpy``)."""
    h, f, v, L, E = (config.hidden_size, config.ffn_size, config.vocab_size,
                     config.num_layers, config.n_experts)
    pdt = torch_dtype(config.param_dtype)

    def nrm(shape, scale=0.02):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * scale).to(pdt)

    def const(shape, fill):
        return torch.full(shape, fill, dtype=pdt, device=device)

    qkv_cols = (config.num_heads + 2 * config.kv_heads) * config.head_dim
    blocks = {
        'ln1_g': const((L, h), 1.0), 'ln1_b': const((L, h), 0.0),
        'qkv_w': nrm((L, h, qkv_cols)), 'qkv_b': const((L, qkv_cols), 0.0),
        'proj_w': nrm((L, h, h)), 'proj_b': const((L, h), 0.0),
        'ln2_g': const((L, h), 1.0), 'ln2_b': const((L, h), 0.0),
        'gate_w': nrm((L, h, E), 0.01),
        'w_in': nrm((L, E, h, f)),
        'w_out': nrm((L, E, f, h)),
    }
    return {'wte': nrm((v, h)), 'wpe': nrm((config.max_seq_len, h), 0.01),
            'blocks': blocks, 'lnf_g': const((h,), 1.0),
            'lnf_b': const((h,), 0.0)}


def _ffn(bp, y, config, cdt):
    """The MoE FFN of one layer; the expert banks go in as they are (raw
    ones are cast to the compute dtype in their product, int8 ones scaled
    after it)."""
    return moe_ffn(y, bp['gate_w'].to(cdt), bp['w_in'], bp['w_out'],
                   capacity_factor=config.capacity_factor)


def block_fn(bp, x, config, drop_seed=None, fp8_meta=None, mesh=None):
    """One block of the plain forward (``moe_gpt.py:140``). bp: this
    layer's params; x [B, S, H]; ``drop_seed``: this layer's u32 dropout
    seed, or None; ``fp8_meta``: this layer's qkv and proj metas, or None.
    ``mesh`` (the mesh train step's): attention is GPT's Megatron half
    over mp, the FFN ``moe_ffn_mesh``. -> (x, this layer's aux loss; over
    a mesh, this rank's share of it)."""
    cdt = torch_dtype(config.dtype)
    x = attention_residual(bp, x, config, drop_seed, fp8_meta, mesh)
    y = _layer_norm(x, bp['ln2_g'], bp['ln2_b']).to(cdt)
    if mesh is None:
        ff, aux = _ffn(bp, y, config, cdt)
    else:
        ff, aux = moe_ffn_mesh(y, bp['gate_w'].to(cdt), bp['w_in'],
                               bp['w_out'], config.capacity_factor, mesh)
    return x + ff, aux


def forward_hidden(params, tokens, config, dropout_seed=None,
                   fp8_state=None):
    """tokens [B, S] -> (final hidden [B, S, H], aux load-balance loss
    summed over layers in f32). ``dropout_seed`` (a u32, training only)
    turns on ``config.dropout`` with one derived seed per layer;
    ``fp8_state`` (``init_fp8_state``) gives each layer its qkv and proj
    metas (see ``gpt.forward_hidden``); with ``config.remat`` and autograd
    recording, each whole block is recomputed in the backward (the
    reference's ``jax.checkpoint``)."""
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
        body = _gpt._remat(block_fn, config)
    pos = torch.arange(S, device=tokens.device)
    x = (wo_take(params['wte'], tokens.long()) + params['wpe'][pos]).to(cdt)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    metas = fp8_layers(fp8_state, L)
    for layer, bp in enumerate(layer_views(params['blocks'])):
        x, a = body(bp, x, config, seeds[layer], metas[layer])
        aux = aux + a
    return _layer_norm(x, params['lnf_g'], params['lnf_b']).to(cdt), aux


def forward(params, tokens, config, dropout_seed=None):
    """tokens [B, S] -> (logits [B, S, V], aux)."""
    x, aux = forward_hidden(params, tokens, config, dropout_seed)
    return wo_lm_head(x, params['wte'], x.dtype), aux


FP8_MATMULS = ('qkv', 'proj')


def init_fp8_state(config, device=None):
    """Delayed-scaling state for ``matmul_precision='fp8'``: the dense
    qkv and proj matmuls only (``moe_gpt.py:210-216``); as
    ``gpt.init_fp8_state``."""
    return _gpt.init_fp8_state(config, device, FP8_MATMULS)


def loss_fn(params, tokens, targets, config, dropout_seed=None,
            fp8_state=None):
    """Mean token cross-entropy plus ``aux_weight / num_layers`` times the
    aux loss (``moe_gpt.py:218``), f32. ``dropout_seed``: the u32 the
    reference draws from its key. With ``xent_chunk`` dividing the vocab,
    the blockwise LM-head loss (``ops/xent.py``); otherwise the full
    logits through an f32 ``log_softmax``. ``fp8_state``: see
    ``forward_hidden``."""
    seed = dropout_seed if config.dropout > 0.0 else None
    aux_scale = config.aux_weight / config.num_layers
    x, aux = forward_hidden(params, tokens, config, seed,
                            fp8_state=fp8_state)
    if config.xent_chunk and config.vocab_size % config.xent_chunk == 0:
        B, S, H = x.shape
        ce = softmax_xent_blockwise(x.reshape(B * S, H), params['wte'],
                                    targets.reshape(B * S),
                                    config.xent_chunk)
        return ce + aux_scale * aux
    logits = wo_lm_head(x, params['wte'], x.dtype)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -ll.mean() + aux_scale * aux


# ---------------------------------------------------------------------------
# The mesh train step (dp, ep, mp)
# ---------------------------------------------------------------------------

# Logical axis names per parameter (``moe_gpt.py:109-125``): experts over
# 'expert' -> 'ep', attention and each expert's FFN width 'heads'/'mlp'
# -> 'mp', the tied embedding 'vocab'; 'router' (the gate's expert dim)
# unmapped: every rank routes with the whole gate.
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
        'gate_w': ('layers', 'embed', 'router'),
        'w_in': ('layers', 'expert', 'embed', 'mlp'),
        'w_out': ('layers', 'expert', 'mlp', 'embed'),
    },
    'lnf_g': ('embed',), 'lnf_b': ('embed',),
}


def param_specs(config):
    """The reference's PartitionSpecs (``moe_gpt.py:128-137``): experts
    over 'ep', heads, FFN width and vocab over 'mp', from LOGICAL_AXES
    through the rules table."""
    from ..parallel.partitioner import Partitioner, model_rules
    return Partitioner(rules=model_rules(mp=config.mp)).tree_specs(
        LOGICAL_AXES)


def train_specs(config):
    """The specs of the blocks the port's mesh step takes: as
    ``param_specs`` with the vocab replicated and 'mp' only where > 1
    (GPT's explicit route, ``gpt.train_specs``)."""
    from ..parallel.partitioner import Partitioner, model_rules
    return Partitioner(rules=model_rules(
        mp=config.mp, explicit=True)).tree_specs(LOGICAL_AXES)


def place_params(params, config, mesh):
    """This rank's blocks of the global parameter dict, by
    ``train_specs`` (copies, which the step updates in place)."""
    from ..optimizer.optimizer import tree_map
    from ..parallel.partitioner import shard
    mesh = getattr(mesh, 'mesh', mesh)
    return tree_map(lambda x, s: shard(x, s, mesh).clone(), params,
                    train_specs(config))


def gather_params(params, config, mesh):
    """The global parameter dict from every rank's blocks (as
    ``gpt.gather_params``)."""
    from ..parallel.partitioner import unshard_tree
    return unshard_tree(params, train_specs(config),
                        getattr(mesh, 'mesh', mesh))


def _check_mesh(config, mesh):
    """The reference's refusals, and the config's degrees against the
    mesh's. MoE's sp > 1 raises where the reference's step does (its
    attention calls the ring over 'sp' outside any ``shard_map`` region:
    ``NameError: unbound axis name: sp``); pp > 1 is ignored there (the
    layers stay replicated), so it is here."""
    if config.sp > 1:
        raise NotImplementedError(
            "MoE GPT with sp > 1: the reference's step has no shard_map "
            "region over 'sp' (its ring attention raises NameError: unbound "
            "axis name: sp), so there is no function to train here either")
    for ax in ('mp', 'sp'):
        if mesh.axis_size(ax) != getattr(config, ax):
            raise ValueError(
                f'config.{ax}={getattr(config, ax)} but the mesh has '
                f'{ax}={mesh.axis_size(ax)} ({mesh})')
    if config.n_experts % mesh.axis_size('ep'):
        raise ValueError(f'{config.n_experts} experts do not divide over '
                         f"ep={mesh.axis_size('ep')}")


def _mesh_train_step(config, optimizer, mesh):
    """The MoE step over ``mesh``'s dp, ep and mp axes (``moe_gpt.py:
    425-452`` under GSPMD), one process a rank: this rank's dp block of
    the global batch, the embedding and head whole (vocab replicated), each
    block GPT's Megatron attention half then ``moe_ffn_mesh`` (remat per
    block as the reference's ``jax.checkpoint``). Each rank differentiates
    its share of the global objective: its tokens' cross-entropy and its
    aux share over dp, the aux share once more over the (ep, mp) ranks
    that compute it alike (their f's backward sums it); then the router's
    gradient is summed over (ep, mp) and every gradient over dp. The
    returned loss is the global one on every rank. fp8 (qkv and proj) as
    GPT's mesh step: amaxes over the operands' ranks, the state
    replicated and updated in place. The dropout seeds
    (``gpt.mesh_layer_seeds``), the batch split and the step's wrapper
    (``gpt.mesh_step``) are GPT's.

    The step takes the mesh's (ep, mp) group (and, with fp8 and mp > 1,
    its (dp, mp) group), built here if the mesh has not built it: every
    rank of the world must build a mesh's groups together, so a mesh over
    some of the ranks needs ``mesh.group(('ep', 'mp'))`` (and
    ``(('dp', 'mp'))``) called on every rank first."""
    from ..distributed import collective as coll
    from ..optimizer.optimizer import tree_map
    from ..parallel.partitioner import PartitionSpec
    from .gpt import _leaves, _rebuild
    _check_mesh(config, mesh)
    dp, ep, mp = (mesh.axis_size(a) for a in ('dp', 'ep', 'mp'))
    dp_grp = mesh.group('dp')
    router_grp = mesh.group(('ep', 'mp')) if ep * mp > 1 else None
    if config.matmul_precision == 'fp8' and mp > 1:
        mesh.group(('dp', 'mp'))             # every rank builds it, here
    cdt = torch_dtype(config.dtype)
    aux_scale = config.aux_weight / config.num_layers
    fp8 = config.matmul_precision == 'fp8'

    def spmd_loss(params, tok, tgt, seed, fp8_state):
        s = tok.shape[1]
        pos = torch.arange(s, device=tok.device)
        x = (params['wte'][tok.long()] + params['wpe'][pos]).to(cdt)
        body = (_gpt._remat(block_fn, config) if config.remat else block_fn)
        seeds = _gpt.mesh_layer_seeds(config, mesh, seed)
        metas = fp8_layers(fp8_state, config.num_layers)
        aux = torch.zeros((), dtype=torch.float32, device=tok.device)
        for layer, bp in enumerate(layer_views(params['blocks'])):
            x, a = body(bp, x, config, seeds[layer], metas[layer], mesh)
            aux = aux + a
        x = _layer_norm(x, params['lnf_g'], params['lnf_b']).to(cdt)
        logits = x @ params['wte'].t().to(cdt)
        logp = torch.log_softmax(logits.float(), dim=-1)
        ce = -logp.gather(-1, tgt.long()[..., None])[..., 0].mean()
        return ce, aux

    def valgrad(params, fp8_state, tok, tgt, seed):
        leaves = _leaves(params)
        metas = [] if fp8_state is None else _leaves(fp8_state)
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            live_m = [m.detach().requires_grad_() for m in metas]
            ce, aux = spmd_loss(_rebuild(params, live), tok, tgt, seed,
                                None if fp8_state is None
                                else _rebuild(fp8_state, live_m))
            objective = (ce + aux_scale * aux / (ep * mp)) / dp
            got = torch.autograd.grad(objective, live + live_m)
        with torch.no_grad():
            for m, new in zip(metas, got[len(live):]):
                m.copy_(new)
        grads = _rebuild(params, list(got[:len(live)]))
        loss = (ce + aux_scale * aux).detach()
        if router_grp is not None:
            grads['blocks']['gate_w'] = coll.psum(grads['blocks']['gate_w'],
                                                  router_grp)
        if dp > 1:
            loss = coll.pmean(loss, dp_grp)
            grads = tree_map(lambda g: coll.psum(g, dp_grp), grads)
        return loss, grads

    return _gpt.mesh_step(optimizer, mesh, PartitionSpec('dp', None),
                          valgrad, fp8)


def make_train_step(config, optimizer, mesh=None):
    """The train step (``moe_gpt.py:425-452``): ``step(params, opt_state,
    seed, lr, tokens, targets) -> (loss, params, opt_state)``, with
    ``matmul_precision='fp8'`` ``step(params, opt_state, fp8_state, seed,
    lr, tokens, targets) -> (loss, params, opt_state, fp8_state)``, as
    ``gpt.make_train_step``: ``seed`` is the u32 dropout seed, params and
    states are updated in place.

    With a ``mesh`` (a ``distributed.topology.Mesh`` or
    ``HybridTopology``), or mp/sp/pp > 1 (then the process topology's),
    the mesh step (``_mesh_train_step``): ``params`` and ``opt_state``
    are this rank's blocks (``place_params``), every rank passes the
    global batch, the loss is the global one."""
    if mesh is None and (config.mp > 1 or config.sp > 1 or config.pp > 1):
        from ..distributed.topology import get_mesh
        mesh = get_mesh()
    if mesh is None:
        return _gpt.autograd_step(loss_fn, config, optimizer)
    return _mesh_train_step(config, optimizer, getattr(mesh, 'mesh', mesh))


# ---------------------------------------------------------------------------
# KV-cache decoding: the dense cache (generate) and the page pool (the
# engine). A call's rows compete for expert capacity, so a 1-wide decode
# step routes as the full forward does only when nothing is dropped.
# ---------------------------------------------------------------------------

_WO_AXES = (('qkv_w', 1), ('proj_w', 1), ('w_in', 2), ('w_out', 2))
# the block weights the serving forward reads in the compute dtype
_CAST_ONCE = ('qkv_w', 'qkv_b', 'proj_w', 'proj_b', 'gate_w', 'w_in',
              'w_out')


def quantize_decode_params(params):
    """Weight-only int8 snapshot for serving (``moe_gpt.py:253``):
    ``qkv_w`` and ``proj_w`` with one f32 scale per output channel (amax
    over axis 1 of [L, in, out]), the expert banks ``w_in``/``w_out`` with
    one per (layer, expert, output channel) (amax over axis 2 of [L, E,
    in, out]: scale [L, E, out]), ``wte`` per vocab row; the router,
    biases, norms and ``wpe`` stay as they are."""
    blocks = dict(params['blocks'])
    for k, ax in _WO_AXES:
        blocks[k] = quantize_weight(blocks[k], reduce_axis=ax)
    return dict(params, blocks=blocks,
                wte=quantize_weight(params['wte'], reduce_axis=1))


def serving_params(params, config):
    """``gpt.serving_params`` over MoE's block weights: attention, router
    and expert banks cast to the compute dtype once (int8 banks pass
    through)."""
    return _gpt.serving_params(params, config, _CAST_ONCE)


def _cached_block(bp, x, k_cache, v_cache, pos, config, page_table=None,
                  valid=None, flat_idx=None):
    """One block over a [B, T, H] slice starting at ``pos``, with
    ``gpt._cached_block``'s signature: GPT's cached attention, then the
    MoE FFN over the call's B * T rows."""
    cdt = torch_dtype(config.dtype)
    y = _layer_norm(x, bp['ln1_g'], bp['ln1_b']).to(cdt)
    q, k, v = _block_qkv(bp, y, config.num_heads, config.head_dim, cdt,
                         config.kv_heads)
    x, k_cache, v_cache = cached_attention(
        x, q, k, v, k_cache, v_cache, pos, bp['proj_w'], bp['proj_b'], cdt,
        page_table, valid=valid, flat_idx=flat_idx)
    y = _layer_norm(x, bp['ln2_g'], bp['ln2_b']).to(cdt)
    ff, _ = _ffn(bp, y, config, cdt)
    return x + ff, k_cache, v_cache


def mesh_cached_block(bps, x, kcs, vcs, pos, config, page_table, valid,
                      flat_idx, ctx):
    """``_cached_block`` over a serving mesh (``gpt.
    mesh_forward_with_cache``): GPT's attention half, then the MoE FFN
    routed once a device (the router is replicated) and each owning
    shard's experts over its FFN columns and rows, their combines summed
    in f32 and rounded once."""
    cdt = torch_dtype(config.dtype)
    x = _gpt.mesh_attention_residual(bps, x, kcs, vcs, pos, config,
                                     page_table, valid, flat_idx, ctx)
    firsts = _gpt._firsts(ctx)
    routed = {}
    for d, i in firsts.items():
        y = _layer_norm(x[d], bps[i]['ln2_g'], bps[i]['ln2_b']).to(cdt)
        routed[d] = _moe.dispatch(y, bps[i]['gate_w'].to(cdt),
                                  config.capacity_factor)
    parts = []
    for i in _gpt._owners(ctx, 'mlp'):
        expert_in, route = routed[ctx.devices[i]]
        out = _moe._experts(expert_in, bps[i]['w_in'], bps[i]['w_out'], cdt)
        parts.append(_moe.combine(out, route, cdt))
    f = ctx.psum(parts)
    return {d: x[d] + f[d].to(cdt).reshape(x[d].shape) for d in firsts}


def forward_with_cache(params, tokens, cache, pos, config, last_only=False):
    """[B, T] tokens at absolute positions from ``pos`` through the KV
    cache -> (logits, cache): ``gpt.forward_with_cache`` (the dense cache,
    or a paged cache through ``gpt.paged_forward_with_cache``) with this
    module's block."""
    return _gpt.forward_with_cache(params, tokens, cache, pos, config,
                                   last_only=last_only, block=_cached_block)


def make_decode_fns(config):
    """-> (prefill, step) as ``gpt.make_decode_fns``, over this module's
    cached forward."""
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


_decode_fns_cache = DecodeFnCache(name='moe_gpt.decode_fns')
_GEN_LOOPS = DecodeFnCache(name='moe_gpt.gen_loops')


def _decode_fns_for(config, params, b, t0, temperature, top_k, top_p,
                    seeded, device, capture):
    """generate()'s captured prefill, its dense cache and the serving
    parameters it reads (``gpt.decode_entry``), memoized in a bounded LRU
    keyed by (config, sampling knobs, B, T0, device, where ``params``'
    tensors live, capture). The prefill refreshes the cast copies from
    ``params`` (weights changed in place are seen)."""
    key = (repr(config), temperature, top_k, top_p, b, t0, str(device),
           seeded, tensor_key(params), capture)

    def build():
        serving = serving_params(params, config)
        return _gpt.decode_entry(
            config, serving, _gpt.cast_pairs(serving, params, _CAST_ONCE),
            b, t0, temperature, top_k, top_p, seeded, device, capture,
            make_decode_fns(config)[0],
            _generate_loop_for(config, temperature, top_k, top_p, capture))

    return _decode_fns_cache.get(key, build)


def _generate_loop_for(config, temperature, top_k, top_p, capture=True):
    """Memoized generation loop: ``gpt.make_generate_loop`` with this
    module's cached forward (one loop implementation for both models),
    its step captured once per (params, cache) it runs over."""
    cache_key = (dataclasses.astuple(config), temperature, top_k, top_p,
                 capture)
    return _GEN_LOOPS.get(cache_key, lambda: _gpt.make_generate_loop(
        config, temperature, top_k, top_p, forward_fn=forward_with_cache,
        capture=capture))


@torch.no_grad()
def generate(params, config, prompt, max_new_tokens, temperature=0.0,
             top_k=None, seed=None, *, top_p=None, capture=True):
    """Greedy or sampled generation over the dense KV cache (``moe_gpt.
    py:364``): ``prompt`` [B, T0] with T0 < max_seq_len, generation capped
    at the cache window (T0 + n <= max_seq_len + 1, with a warning).
    -> [B, T0 + n] int32 on the parameters' device.

    Greedy takes the argmax. Otherwise row b draws with the port's
    counter-based sampler keyed by (``seed`` + b, position), where the
    reference takes a PRNG key; ``seed=None`` takes one from ``torch``'s
    global generator. The prefill and each step are replayed CUDA graphs
    on the card (``capture=False``: eager, for comparisons), captured on
    the first call for a (params, B, T0, sampling knobs)."""
    dev = params['lnf_g'].device
    toks = torch.as_tensor(prompt).to(dev, torch.int32)
    B, T0 = toks.shape
    if T0 >= config.max_seq_len:
        raise ValueError(
            f'prompt length {T0} >= max_seq_len {config.max_seq_len}: the '
            'KV cache cannot hold it; truncate the prompt or raise '
            'max_seq_len')
    n = min(max_new_tokens, config.max_seq_len - T0 + 1)
    if n < max_new_tokens:
        warnings.warn(
            f'generate: max_new_tokens={max_new_tokens} exceeds the KV-cache '
            f'window (max_seq_len={config.max_seq_len}, prompt={T0}); only '
            f'{n} tokens will be generated')
    if n <= 0:
        return toks
    seeds = None
    if temperature != 0:
        if seed is None:
            seed = int(torch.randint(0, 2 ** 31 - 1, ()))
        seeds = torch.arange(B, device=dev, dtype=torch.int64) + seed
    entry = _decode_fns_for(config, params, B, T0, temperature, top_k, top_p,
                            seeds is not None, dev, capture)
    with entry['lock']:
        first = entry['prefill'].replay(
            prompt=toks, **({} if seeds is None else {'seeds': seeds}))
        pieces = [toks, first[:, None].clone()]
        if n > 1:
            pos0 = torch.full((1,), T0, dtype=torch.int32, device=dev)
            new, _ = entry['loop'](entry['params'], pieces[1][:, 0], pos0,
                                   entry['cache'], seeds, n - 1)
            pieces.append(new)
    return torch.cat(pieces, dim=1)
