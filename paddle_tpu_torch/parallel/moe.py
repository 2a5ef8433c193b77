"""Mixture-of-Experts FFN with top-2 capacity-bucketed routing.

Port of ``paddle_tpu/parallel/moe.py`` (single device; expert parallelism
over a mesh, ``expert_partition_specs``, waits for ROADMAP Queue 1 step
K). The reference routes with one-hot einsums over a [T, E, C] tensor
(tokens x experts x capacity slots), which XLA lowers to all-to-all under
a mesh. Each (expert, slot) holds at most one token and each token sits
in at most two slots, so the port computes the same function with
gathers: ``top2_route`` gives every token the flat slot index of its
first and second choice (a sink slot E*C when the choice was dropped)
and their combine weights; the experts' input is one gather of token
rows into [E, C, H] (an empty slot reads a zero row), and the output a
two-term weighted sum in f32, rounded once. Every shape is static: no
``nonzero``, boolean indexing or host read, so the routing runs inside a
captured CUDA graph.

``top2_gating`` and ``moe_ffn_einsum`` keep the reference's [T, E, C]
form, for the tests to hold the gather form against.

Gradients flow through the combine weights and through the aux loss's
``density_proxy`` (both functions of the softmax), and to the tokens
through the gather; the routing decisions themselves (argmax, capacity
positions) carry none, as in the reference.
"""
import torch
import torch.nn.functional as F

from ..ops.weight_only import wo_bmm

__all__ = ['top2_route', 'top2_gating', 'moe_ffn', 'moe_ffn_einsum',
           'capacity_of']


def capacity_of(capacity_factor, tokens, n_experts):
    """Slots per expert for a call of ``tokens`` rows: the reference's
    ``int(capacity_factor * T / E + 1)`` from the call's static shape."""
    return int(capacity_factor * tokens / n_experts + 1)


def top2_route(logits, capacity):
    """logits [T, E] f32 -> (idx1, idx2 [T] int64, w1, w2 [T] f32, aux).

    ``idx1``/``idx2``: the flat slot ``e * capacity + position`` of each
    token's first and second choice, or the sink ``E * capacity`` when the
    choice was dropped (its expert full); ``w1``/``w2``: their combine
    weights (0 when dropped), normalized over the two; ``aux``: the
    Switch/GShard load-balancing loss. The reference's rules: first
    choices fill each expert in token order; second choices queue behind
    every kept first choice of the call, padding rows included; argmax
    takes the first maximum."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    experts = torch.arange(E, device=logits.device)
    g1 = torch.argmax(probs, dim=-1)
    mask1 = (g1[:, None] == experts).to(logits.dtype)
    g2 = torch.argmax(probs * (1 - mask1), dim=-1)
    mask2 = (g2[:, None] == experts).to(logits.dtype)

    density = mask1.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux = (density * density_proxy).sum() * E

    # a token's position in its expert: running counts over the tokens,
    # exact in integers, scanned along the contiguous dim of [E, T] (a scan
    # down the T rows of [T, E] runs E lanes serially on the card)
    i32 = torch.int32
    m1 = (experts[:, None] == g1).to(i32)                       # [E, T]
    m2 = (experts[:, None] == g2).to(i32)
    pos1 = (torch.cumsum(m1, 1, dtype=i32) - m1).gather(0, g1[None])[0]
    keep1 = pos1 < capacity
    kept1 = (m1 * keep1).sum(dim=1, dtype=i32)                  # [E]
    pos2 = ((torch.cumsum(m2, 1, dtype=i32) - m2).gather(0, g2[None])[0]
            + kept1[g2])
    keep2 = pos2 < capacity

    w1 = probs.gather(1, g1[:, None])[:, 0] * keep1
    w2 = probs.gather(1, g2[:, None])[:, 0] * keep2
    denom = torch.clamp(w1 + w2, min=1e-9)
    w1, w2 = w1 / denom, w2 / denom
    sink = E * capacity
    idx1 = torch.where(keep1, g1 * capacity + pos1, sink)
    idx2 = torch.where(keep2, g2 * capacity + pos2, sink)
    return idx1, idx2, w1, w2, aux


def top2_gating(logits, capacity):
    """The reference's form: logits [T, E] -> (combine [T, E, C] f32,
    dispatch bool [T, E, C], aux), built from ``top2_route``."""
    T, E = logits.shape
    idx1, idx2, w1, w2, aux = top2_route(logits, capacity)
    flat = torch.zeros((T, E * capacity + 1), dtype=logits.dtype,
                       device=logits.device)
    flat = flat.scatter_add(1, idx1[:, None], w1[:, None])
    flat = flat.scatter_add(1, idx2[:, None], w2[:, None])
    combine = flat[:, :-1].reshape(T, E, capacity)
    return combine, combine > 0, aux


def _experts(expert_in, w_in, w_out, cdt):
    """[E, C, H] -> [E, C, H] through each expert's FFN (the reference's
    ``_expert_mm``: raw banks or int8 ones, ``ops/weight_only.wo_bmm``)."""
    h = F.gelu(wo_bmm(expert_in, w_in, cdt), approximate='tanh')
    return wo_bmm(h, w_out, cdt)


def moe_ffn(x, gate_w, w_in, w_out, capacity_factor=1.25):
    """x [B, S, H]; gate_w [H, E]; w_in [E, H, F]; w_out [E, F, H] (raw in
    x's dtype, or int8 banks). -> (y [B, S, H], aux). The gate's product
    runs in x's dtype and only then goes to f32, as the reference's does
    (an f32 product would move the argmax near ties). The gather form:
    one scatter of token ids into E*C + 1 slots (the last a sink for
    dropped choices), one gather of their rows (an empty slot reads the
    zero row T), the experts, and each token's two slots read back and
    summed with their weights in f32."""
    B, S, H = x.shape
    E = gate_w.shape[1]
    T = B * S
    cdt = x.dtype
    xt = x.reshape(T, H)
    C = capacity_of(capacity_factor, T, E)
    idx1, idx2, w1, w2, aux = top2_route((xt @ gate_w).float(), C)
    tok = torch.arange(T, device=x.device)
    src = torch.full((E * C + 1,), T, dtype=torch.int64, device=x.device)
    src = src.scatter(0, idx1, tok).scatter(0, idx2, tok)[:E * C]
    rows = torch.cat([xt, xt.new_zeros((1, H))])
    expert_in = rows.index_select(0, src).reshape(E, C, H)
    out = _experts(expert_in, w_in, w_out, cdt).reshape(E * C, H)
    out = torch.cat([out, out.new_zeros((1, H))])
    # the reference rounds its combine weights to x's dtype
    y = (w1.to(cdt).float()[:, None] * out.index_select(0, idx1).float()
         + w2.to(cdt).float()[:, None] * out.index_select(0, idx2).float())
    return y.to(cdt).reshape(B, S, H), aux


def moe_ffn_einsum(x, gate_w, w_in, w_out, capacity_factor=1.25):
    """The reference's one-hot einsum form of ``moe_ffn``, op for op
    (``paddle_tpu/parallel/moe.py:65-83``), for the tests."""
    B, S, H = x.shape
    cdt = x.dtype
    E = gate_w.shape[1]
    xt = x.reshape(B * S, H)
    capacity = capacity_of(capacity_factor, B * S, E)
    logits = (xt @ gate_w).float()
    combine, dispatch, aux = top2_gating(logits, capacity)
    combine = combine.to(cdt)
    expert_in = torch.einsum('tec,th->ech', dispatch.to(cdt), xt)
    expert_out = _experts(expert_in, w_in, w_out, cdt)
    y = torch.einsum('tec,ech->th', combine, expert_out)
    return y.reshape(B, S, H), aux
