"""Blockwise softmax cross-entropy over a large vocabulary.

Port of ``paddle_tpu/ops/xent.py``. The LM-head loss never materializes
the [N, V] f32 logits: at the bench shape (8 x 1024 tokens, vocab 32768)
they would be 1 GiB, and the softmax backward as much again. Only one
[N, chunk] tile exists at a time:

  forward:  over vocab chunks, an online logsumexp (running max and sum)
            while each target's logit is picked up in its chunk;
  backward: each chunk's probabilities recomputed from the saved row lse,
            dx += (p - onehot) @ W_chunk, dW_chunk = (p - onehot)^T x.

The reference computes this in XLA, not in Pallas, so the port uses plain
``torch.matmul`` in f32 (on the card, cuBLAS; TF32 stays off unless the
caller turns it on).
"""
import torch

_NEG = -1e30


def _chunk_logits(xf, w, base, chunk):
    return xf @ w[base:base + chunk].float().T               # [N, chunk]


class _BlockwiseXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, chunk):
        n, _ = x.shape
        v = int(w.shape[0])
        if v % chunk:
            raise ValueError(f'chunk {chunk} must divide vocab {v}')
        xf = x.float()
        dev = x.device
        m = torch.full((n,), _NEG, dtype=torch.float32, device=dev)
        s = torch.zeros((n,), dtype=torch.float32, device=dev)
        tl = torch.zeros((n,), dtype=torch.float32, device=dev)
        tgt = targets.long()
        for base in range(0, v, chunk):
            logits = _chunk_logits(xf, w, base, chunk)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            local = tgt - base
            in_chunk = (local >= 0) & (local < chunk)
            got = logits.gather(1, local.clamp(0, chunk - 1)[:, None])[:, 0]
            tl = torch.where(in_chunk, got, tl)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, tgt, lse)
        ctx.chunk = chunk
        return (lse - tl).mean()

    @staticmethod
    def backward(ctx, g):
        x, w, tgt, lse = ctx.saved_tensors
        chunk = ctx.chunk
        n, h = x.shape
        v = int(w.shape[0])
        xf = x.float()
        gn = (g / n).float()                                 # d(mean)
        dx = torch.zeros((n, h), dtype=torch.float32, device=x.device)
        dw = torch.empty((v, h), dtype=torch.float32, device=x.device)
        cols = torch.arange(chunk, device=x.device)[None, :]
        for base in range(0, v, chunk):
            w_c = w[base:base + chunk].float()
            p = torch.exp(xf @ w_c.T - lse[:, None])         # [N, chunk]
            local = tgt - base
            in_chunk = (local >= 0) & (local < chunk)
            onehot = (cols == local.clamp(0, chunk - 1)[:, None]) \
                & in_chunk[:, None]
            d_logits = (p - onehot.float()) * gn
            dx += d_logits @ w_c
            dw[base:base + chunk] = d_logits.T @ xf
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def softmax_xent_blockwise(x, w, targets, chunk=8192):
    """Mean token cross-entropy of logits = x @ w.T against ``targets``.

    x: [N, H] (flattened [B*S, H]) activations; w: [V, H] (the tied LM
    head, ``wte``); targets: [N] integers. ``chunk`` must divide V.
    -> scalar f32 loss, differentiable in x and w."""
    return _BlockwiseXent.apply(x, w, targets, int(chunk))
