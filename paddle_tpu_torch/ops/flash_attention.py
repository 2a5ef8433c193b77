"""The part of ``paddle_tpu/ops/flash_attention.py`` the serving slice
shares: the mask fill, the normalizer floor, and GQA head repetition for
the plain (non-kernel) attention paths.

The flash kernels themselves (forward, both backwards, dense decode and
its int8 variant) are not ported yet: ROADMAP Queue 2, kernels 1-5.
"""
import torch

# Copied from paddle_tpu/ops/flash_attention.py:146-148: masked scores are
# filled with -1e30 (not -inf, so a fully masked row stays finite) and the
# softmax normalizer is floored at 1e-30.
_NEG_INF = -1e30
_EPS = 1e-30


def repeat_kv(k, v, n_q_heads):
    """Materialize GQA kv heads ([B, S, H_kv, D]) up to ``n_q_heads``
    (plain paths only — the kernel shares kv rows across the group)."""
    h_kv = int(k.shape[2])
    if h_kv == n_q_heads:
        return k, v
    rep = n_q_heads // h_kv
    return (torch.repeat_interleave(k, rep, dim=2),
            torch.repeat_interleave(v, rep, dim=2))
