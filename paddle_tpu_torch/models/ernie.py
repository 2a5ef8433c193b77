"""ERNIE/BERT-style masked-LM encoder, ported to PyTorch.

Port of ``paddle_tpu/models/ernie.py``: the config, the stacked-block
parameter layout (``init_params``; a reference parameter tree converts one
to one with ``params_from_numpy``), the encoder (``encode``), the
pretraining objective (``pretrain_loss``: masked LM over the full
[B, S, vocab] logits plus next-sentence prediction) and the stateful
``ErnieModel`` Layer.

The numerics are the reference's: bf16 compute over f32 parameters, every
weight cast to the compute dtype before its product; LayerNorm with eps
1e-12 in the reference's formula (mean and variance in the dtype of its
input, the f32 gain promoting the normalized rows, then cast back); GELU
the tanh approximation (``jax.nn.gelu``'s default); the key-padding mask
``attn_mask > 0`` an additive -1e30 bias rounded to the compute dtype.

Attention is bidirectional: with ``use_flash`` it runs kernel 1 on the card
(``ops.flash_attention``, its twin on the CPU) with the bias as the
kernel's key mask, and kernels 2 and 3 as its backward, where a kernel
instance takes the shape (``kernel_takes``: head dim 64/128/256, f32 or
bf16, the reference's gate); ``use_flash=False``, or another head dim,
runs the reference's plain path (``attention_reference``). No mask keeps
the kernels' no-mask path.

Where the reference scans the blocks under ``jax.checkpoint``, the port
loops over them under ``torch.utils.checkpoint`` (non-reentrant) when
autograd records and ``config.remat`` is set; serving runs under
``no_grad``, where it is off, as is a ``torch.export`` trace (``jit.save``:
the exported program keeps its activations). ``pretrain_loss`` takes the
u32 dropout seed where the reference takes a PRNG key and draws the seed
from it with ``jax.random.bits`` (which torch cannot reproduce): pass
``jax.random.bits(key, (1,), uint32)[0]`` to match it.
"""
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from ..nn.layer_base import Layer, Parameter
from ..core.tensor import Tensor, wrap
from ..ops.flash_attention import (attention_reference, flash_attention,
                                   kernel_takes, per_layer_seeds)
from .gpt import _to_tensor, torch_dtype

BLOCK_KEYS = ('fc_b', 'fc_w', 'ln1_b', 'ln1_g', 'ln2_b', 'ln2_g', 'out_b',
              'out_w', 'proj_b', 'proj_w', 'qkv_b', 'qkv_w')
TOP_KEYS = ('emb_ln_b', 'emb_ln_g', 'mlm_b', 'mlm_ln_b', 'mlm_ln_g', 'mlm_w',
            'nsp_b', 'nsp_w', 'pool_b', 'pool_w', 'wpe', 'wte', 'wtype')


@dataclasses.dataclass
class ErnieConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_mult: int = 4
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dtype: str = 'bfloat16'
    param_dtype: str = 'float32'
    remat: bool = True
    # kernel 1 (bidirectional, additive key-padding mask in the kernel)
    use_flash: bool = True
    # attention dropout (training; the kernels' counter-hash mask, one
    # derived seed per layer from pretrain_loss's dropout_seed)
    dropout: float = 0.0

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self):
        return self.hidden_size * self.ffn_mult


def _shapes(config):
    h, f, v, L = (config.hidden_size, config.ffn_size, config.vocab_size,
                  config.num_layers)
    blocks = {'qkv_w': (L, h, 3 * h), 'qkv_b': (L, 3 * h),
              'proj_w': (L, h, h), 'proj_b': (L, h),
              'ln1_g': (L, h), 'ln1_b': (L, h),
              'fc_w': (L, h, f), 'fc_b': (L, f),
              'out_w': (L, f, h), 'out_b': (L, h),
              'ln2_g': (L, h), 'ln2_b': (L, h)}
    return {'wte': (v, h), 'wpe': (config.max_seq_len, h),
            'wtype': (config.type_vocab_size, h),
            'emb_ln_g': (h,), 'emb_ln_b': (h,), 'blocks': blocks,
            'pool_w': (h, h), 'pool_b': (h,), 'mlm_w': (h, h), 'mlm_b': (h,),
            'mlm_ln_g': (h,), 'mlm_ln_b': (h,), 'nsp_w': (h, 2),
            'nsp_b': (2,)}


def init_params(config: ErnieConfig, generator, device):
    """The reference's parameter dict (matrices and embeddings normal 0.02,
    biases 0, LayerNorm gains 1), drawn from ``generator`` on ``device``
    (the generator must live there). The draws differ from
    ``jax.random``'s: to hold the port against the reference, convert the
    reference's own params (``params_from_numpy``)."""
    pdt = torch_dtype(config.param_dtype)

    def make(name, shape):
        if name.endswith('_g'):
            return torch.ones(shape, dtype=pdt, device=device)
        if name.endswith('_b'):
            return torch.zeros(shape, dtype=pdt, device=device)
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (0.02 * x).to(pdt)

    out = {}
    for key, shape in _shapes(config).items():
        if key == 'blocks':
            out[key] = {k: make(k, s) for k, s in shape.items()}
        else:
            out[key] = make(key, shape)
    return out


def params_from_numpy(tree, device):
    """The reference's parameter tree (``paddle_tpu.models.ernie.
    init_params``, leaves as numpy arrays) as the port's dict of tensors on
    ``device``."""
    out = {k: _to_tensor(v, device) for k, v in tree.items()
           if k != 'blocks'}
    out['blocks'] = {k: _to_tensor(v, device)
                     for k, v in tree['blocks'].items()}
    return out


def leaves(params):
    """The parameters in ``jax.tree_util.tree_flatten`` order of the
    reference's dict (the blocks' keys sorted, then the top level's): the
    order of ``ErnieModel``'s ``p0`` .. ``p24``."""
    return ([params['blocks'][k] for k in BLOCK_KEYS]
            + [params[k] for k in TOP_KEYS])


def from_leaves(values):
    """Inverse of ``leaves``."""
    n = len(BLOCK_KEYS)
    out = dict(zip(TOP_KEYS, values[n:]))
    out['blocks'] = dict(zip(BLOCK_KEYS, values[:n]))
    return out


def _ln(x, g, b, eps=1e-12):
    m = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - m).mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(var + eps) * g + b


def _block(bp, x, mask_bias, config, drop_seed=None):
    """One encoder block (``ernie.py:84``). bp: this layer's params; x
    [B, S, H] in the compute dtype; ``mask_bias`` the additive [B,1,1,S]
    bias or None; ``drop_seed`` this layer's u32 dropout seed or None."""
    cdt = torch_dtype(config.dtype)
    B, S, h = x.shape
    nh, hd = config.num_heads, config.head_dim
    qkv = x @ bp['qkv_w'].to(cdt) + bp['qkv_b'].to(cdt)
    q, k, v = (t.reshape(B, S, nh, hd) for t in qkv.split(h, dim=-1))
    drop = config.dropout if drop_seed is not None else 0.0
    mask = None if mask_bias is None else mask_bias.float()
    if config.use_flash and kernel_takes(q, k, v):
        a = flash_attention(q, k, v, causal=False, mask=mask,
                            dropout_rate=drop, dropout_seed=drop_seed)
    else:
        a = attention_reference(q, k, v, False, mask, drop, drop_seed)
    a = a.to(cdt).reshape(B, S, h)
    x = _ln(x + a @ bp['proj_w'].to(cdt) + bp['proj_b'].to(cdt),
            bp['ln1_g'], bp['ln1_b']).to(cdt)
    y = F.gelu(x @ bp['fc_w'].to(cdt) + bp['fc_b'].to(cdt),
               approximate='tanh')
    y = y @ bp['out_w'].to(cdt) + bp['out_b'].to(cdt)
    return _ln(x + y, bp['ln2_g'], bp['ln2_b']).to(cdt)


def _remat_block(bp, x, mask_bias, config, drop_seed):
    return _ckpt.checkpoint(_block, bp, x, mask_bias, config, drop_seed,
                            use_reentrant=False)


def encode(params, tokens, token_type=None, attn_mask=None, config=None,
           dropout_seed=None):
    """tokens [B, S] (and token types, and a [B, S] mask whose entries > 0
    are real keys) -> the encoder's output [B, S, H] in the compute dtype.
    ``dropout_seed`` (a u32, training only) turns on ``config.dropout``
    with one derived seed per layer (``per_layer_seeds``)."""
    cdt = torch_dtype(config.dtype)
    S = tokens.shape[1]
    if S > config.max_seq_len:
        # the reference's position gather clamps; on the card an index
        # past ``wpe`` would end the process's CUDA context
        raise ValueError(f'{S} tokens exceed max_seq_len '
                         f'{config.max_seq_len}')
    tokens = tokens.long()
    tt = (token_type.long() if token_type is not None
          else torch.zeros_like(tokens))
    pos = torch.arange(S, device=tokens.device)
    x = params['wte'][tokens] + params['wpe'][pos] + params['wtype'][tt]
    x = _ln(x, params['emb_ln_g'], params['emb_ln_b']).to(cdt)
    bias = None                # no mask: the kernels' no-mask path
    if attn_mask is not None:
        bias = torch.where(attn_mask[:, None, None, :] > 0, 0.0,
                           -1e30).to(cdt)
    L = config.num_layers
    seeds = [None] * L
    if config.dropout > 0.0 and dropout_seed is not None:
        seeds = per_layer_seeds(int(dropout_seed), L).tolist()
    body = _block
    if (config.remat and torch.is_grad_enabled()
            and not torch.compiler.is_exporting()):
        body = _remat_block
    blocks = params['blocks']
    for layer in range(L):
        bp = {k: w[layer] for k, w in blocks.items()}
        x = body(bp, x, bias, config, seeds[layer])
    return x


def pretrain_loss(params, tokens, token_type, attn_mask, mlm_labels,
                  nsp_labels, config, dropout_seed=None):
    """Masked-LM + next-sentence losses (the BERT pretraining objective):
    a f32 scalar. ``mlm_labels`` -100 where not predicted; the log-softmax
    runs over the full [B, S, vocab] logits in f32, as the reference's.
    ``dropout_seed``: the u32 that turns on ``config.dropout``."""
    seed = dropout_seed if config.dropout > 0.0 else None
    h = encode(params, tokens, token_type, attn_mask, config, seed)
    cdt = h.dtype
    mh = F.gelu(h @ params['mlm_w'].to(cdt) + params['mlm_b'].to(cdt),
                approximate='tanh')
    mh = _ln(mh, params['mlm_ln_g'], params['mlm_ln_b']).to(cdt)
    logits = mh @ params['wte'].t().to(cdt)
    logp = torch.log_softmax(logits.float(), dim=-1)
    mlm_labels = mlm_labels.long()
    valid = mlm_labels >= 0
    ll = torch.gather(logp, -1, mlm_labels.clamp(min=0)[..., None])[..., 0]
    mlm_loss = -torch.where(valid, ll, 0.0).sum() / valid.sum().clamp(min=1)
    pooled = torch.tanh(h[:, 0] @ params['pool_w'].to(cdt)
                        + params['pool_b'].to(cdt))
    nsp_logits = pooled @ params['nsp_w'].to(cdt) + params['nsp_b'].to(cdt)
    nsp_logp = torch.log_softmax(nsp_logits.float(), dim=-1)
    nsp_loss = -torch.gather(nsp_logp, -1,
                             nsp_labels.long()[:, None]).mean()
    return mlm_loss + nsp_loss


def num_params(config):
    """Parameters of ``config``, the embeddings included."""
    total = 0
    for key, shape in _shapes(config).items():
        for s in (shape.values() if key == 'blocks' else [shape]):
            total += int(np.prod(s))
    return total


def _raw(x):
    if x is None:
        return None
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, torch.Tensor):
        return x
    from ..device import current_device
    return torch.as_tensor(np.asarray(x), device=current_device())


class ErnieModel(Layer):
    """Stateful wrapper: ``forward(input_ids, token_type_ids=None,
    attention_mask=None)`` -> (sequence output [B, S, H], pooled [CLS]
    [B, H]). The parameters are ``p0`` .. ``p24`` in the reference's order
    (``leaves``), so its ``state_dict()`` and ``.pdparams`` load as they
    are. Made on the current place from the port's generator."""

    def __init__(self, config: ErnieConfig = None, **kwargs):
        super().__init__()
        self.config = config or ErnieConfig(**kwargs)
        from ..device import current_device
        from ..tensor.random import generator
        dev = current_device()
        raw = init_params(self.config, generator(dev), dev)
        vals = leaves(raw)
        self._n = len(vals)
        for i, v in enumerate(vals):
            self.add_parameter(f'p{i}', Parameter(v))

    def _params(self):
        return from_leaves([self._parameters[f'p{i}']._value
                            for i in range(self._n)])

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        cfg = self.config
        params = self._params()
        h = encode(params, _raw(input_ids), _raw(token_type_ids),
                   _raw(attention_mask), cfg)
        cdt = h.dtype
        pooled = torch.tanh(h[:, 0] @ params['pool_w'].to(cdt)
                            + params['pool_b'].to(cdt))
        return wrap(h), wrap(pooled)
