"""Mixture-of-Experts FFN with top-2 capacity-bucketed routing.

Port of ``paddle_tpu/parallel/moe.py``, on one device (``moe_ffn``) and
over a mesh's dp, ep and mp axes (``moe_ffn_mesh``, the MoE GPT's mesh
train step). The reference routes with one-hot einsums over a [T, E, C] tensor
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

Over a mesh (``moe_ffn_mesh``). The reference shards the experts over
'ep' and lets GSPMD route the *global* token set, so the port computes
that global function with one process a rank:

 - routing is global over dp: the capacity counts every rank's tokens,
   ``int(cf * T_global / E + 1)``; a token's slot counts every earlier
   token of every earlier dp rank (an exclusive prefix of the ranks'
   per-expert counts, from one all-gather of a [2, E] count vector a
   layer), second choices queue behind the kept first choices of the
   whole batch; the aux loss's density is the global one, so each rank's
   ``sum(density * mean(probs_local)) * E`` averages over dp to the
   reference's ``sum(mean(mask1) * mean(probs)) * E``;
 - the slots reach their experts without an all-to-all: the tokens are
   replicated over ep (the batch rule maps to dp only), so every ep rank
   routes the same tokens, gathers the rows of its own E/ep experts'
   slots and runs them (each expert's FFN width split over mp, a
   column/row pair); the combine's f32 partial sums over the ranks'
   experts and mp blocks meet in one all-reduce over (ep, mp), Megatron's
   g, and the layer's input passes Megatron's f, whose backward sums the
   ranks' partial gradients. Chosen over the all-to-all of the slot rows
   because both ep ranks hold the same dp block: the slots they would
   exchange are already on both, and one all-reduce of [T, H] f32 moves
   no more than the two all-to-alls (there and back) of [E, C, H] rows
   with C ~ 1.25 * 2T / E. The router's gradient is each rank's share
   (its experts' combine weights), summed over (ep, mp) by the step.
"""
import torch
import torch.nn.functional as F

from ..ops.weight_only import wo_bmm

__all__ = ['top2_route', 'top2_gating', 'moe_ffn', 'moe_ffn_einsum',
           'moe_ffn_mesh', 'dispatch', 'combine', 'capacity_of',
           'expert_partition_specs']


def capacity_of(capacity_factor, tokens, n_experts):
    """Slots per expert for a call of ``tokens`` rows: the reference's
    ``int(capacity_factor * T / E + 1)`` from the call's static shape."""
    return int(capacity_factor * tokens / n_experts + 1)


def top2_route(logits, capacity, group=None):
    """logits [T, E] f32 -> (idx1, idx2 [T] int64, w1, w2 [T] f32, aux).

    ``idx1``/``idx2``: the flat slot ``e * capacity + position`` of each
    token's first and second choice, or the sink ``E * capacity`` when the
    choice was dropped (its expert full); ``w1``/``w2``: their combine
    weights (0 when dropped), normalized over the two; ``aux``: the
    Switch/GShard load-balancing loss. The reference's rules: first
    choices fill each expert in token order; second choices queue behind
    every kept first choice of the call, padding rows included; argmax
    takes the first maximum.

    ``group`` (a dp ``Group``): ``logits`` are this rank's block of the
    global token set, the blocks in rank order. Positions then count the
    earlier ranks' tokens, second choices queue behind every rank's kept
    first choices, and ``aux`` is this rank's share, ``sum(density *
    mean(probs)) * E`` with the global density (detached): its mean over
    the ranks is the reference's global aux loss."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    experts = torch.arange(E, device=logits.device)
    g1 = torch.argmax(probs, dim=-1)
    mask1 = (g1[:, None] == experts).to(logits.dtype)
    g2 = torch.argmax(probs * (1 - mask1), dim=-1)
    mask2 = (g2[:, None] == experts).to(logits.dtype)

    # a token's position in its expert: running counts over the tokens,
    # exact in integers, scanned along the contiguous dim of [E, T] (a scan
    # down the T rows of [T, E] runs E lanes serially on the card)
    i32 = torch.int32
    m1 = (experts[:, None] == g1).to(i32)                       # [E, T]
    m2 = (experts[:, None] == g2).to(i32)
    before1 = before2 = 0
    if group is not None and group.nranks > 1:
        from ..distributed.collective import gather_tensor
        counts = torch.stack([m1.sum(1, dtype=i32), m2.sum(1, dtype=i32)])
        every = gather_tensor(counts, group)                    # [n, 2, E]
        before = every[:group.index].sum(0, dtype=i32)          # [2, E]
        before1, before2 = before[0][g1], before[1][g2]
        total1 = every[:, 0].sum(0, dtype=i32)
        density = total1.to(logits.dtype) / (T * group.nranks)
        kept1 = torch.clamp(total1, max=capacity)               # [E]
    else:
        density = mask1.mean(dim=0)
    aux = (density * probs.mean(dim=0)).sum() * E

    pos1 = (torch.cumsum(m1, 1, dtype=i32) - m1).gather(0, g1[None])[0]
    pos1 = pos1 + before1
    keep1 = pos1 < capacity
    if group is None or group.nranks == 1:
        kept1 = (m1 * keep1).sum(dim=1, dtype=i32)              # [E]
    pos2 = ((torch.cumsum(m2, 1, dtype=i32) - m2).gather(0, g2[None])[0]
            + before2 + kept1[g2])
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


def dispatch(x, gate_w, capacity_factor=1.25, group=None, experts=None):
    """The routing and dispatch of ``moe_ffn``: x [B, S, H] -> (expert_in
    [E, C, H], route): ``route = (idx1, idx2, w1, w2, aux)`` of
    ``top2_route`` over the call's B * S rows. One scatter of token ids
    into E*C + 1 slots (the last a sink for dropped choices), one gather
    of their rows (an empty slot reads the zero row T). The gate's product
    runs in x's dtype and only then goes to f32, as the reference's does
    (an f32 product would move the argmax near ties). Over a mesh:
    ``group`` (dp) routes the ranks' tokens as one batch (``top2_route``;
    C from the global count), ``experts`` = (first, count) keeps the slots
    of this rank's experts only."""
    B, S, H = x.shape
    E = gate_w.shape[1]
    T = B * S
    xt = x.reshape(T, H)
    C = capacity_of(capacity_factor,
                    T * (group.nranks if group is not None else 1), E)
    route = top2_route((xt @ gate_w).float(), C, group)
    idx1, idx2 = route[:2]
    e0, n = experts or (0, E)
    tok = torch.arange(T, device=x.device)
    src = torch.full((E * C + 1,), T, dtype=torch.int64, device=x.device)
    src = src.scatter(0, idx1, tok).scatter(0, idx2, tok)[e0 * C:(e0 + n) * C]
    rows = torch.cat([xt, xt.new_zeros((1, H))])
    return rows.index_select(0, src).reshape(n, C, H), route


def combine(out, route, cdt):
    """Each token's two slots of the experts' output ``out`` [E, C, H]
    read back and summed with their weights, in f32 (not yet rounded):
    -> [T, H]. The reference rounds its combine weights to x's dtype."""
    E, C, H = out.shape
    idx1, idx2, w1, w2 = route[:4]
    out = torch.cat([out.reshape(E * C, H), out.new_zeros((1, H))])
    return (w1.to(cdt).float()[:, None] * out.index_select(0, idx1).float()
            + w2.to(cdt).float()[:, None] * out.index_select(0, idx2).float())


def moe_ffn(x, gate_w, w_in, w_out, capacity_factor=1.25):
    """x [B, S, H]; gate_w [H, E]; w_in [E, H, F]; w_out [E, F, H] (raw in
    x's dtype, or int8 banks). -> (y [B, S, H], aux). The gather form:
    ``dispatch``, the experts, ``combine`` rounded once to x's dtype."""
    B, S, H = x.shape
    cdt = x.dtype
    expert_in, route = dispatch(x, gate_w, capacity_factor)
    y = combine(_experts(expert_in, w_in, w_out, cdt), route, cdt)
    return y.to(cdt).reshape(B, S, H), route[4]


def moe_ffn_mesh(x, gate_w, w_in, w_out, capacity_factor, mesh):
    """``moe_ffn`` of this rank's blocks over ``mesh`` (a
    ``distributed.topology.Mesh``; see the module docstring): x [B, S, H]
    this rank's dp block of the batch (replicated over ep and mp); gate_w
    [H, E] whole; w_in [E/ep, H, F/mp] and w_out [E/ep, F/mp, H] this
    rank's experts and FFN columns. -> (y [B, S, H], this rank's aux
    share): y is the reference's global function at these rows on every
    ep and mp rank. The router's gradient on a rank is its experts'
    share; sum it over the (ep, mp) group after the backward (the aux
    loss's own share is the same on every one of those ranks)."""
    from .tp_ad import f_identity, g_allreduce
    B, S, H = x.shape
    E_loc = w_in.shape[0]
    cdt = x.dtype
    e0 = mesh.axis_index('ep') * E_loc
    grp = (mesh.group(('ep', 'mp'))
           if mesh.shape['ep'] * mesh.shape['mp'] > 1 else None)
    if grp is not None:
        x = f_identity(x, grp)
    expert_in, route = dispatch(x, gate_w, capacity_factor,
                                mesh.group('dp'), (e0, E_loc))
    out = _experts(expert_in, w_in, w_out, cdt)
    n = E_loc * expert_in.shape[1]

    def local(idx):
        # another rank's slot, or the sink, reads the zero row
        loc = idx - e0 * expert_in.shape[1]
        return torch.where((loc >= 0) & (loc < n), loc, n)

    y = combine(out, (local(route[0]), local(route[1])) + route[2:4], cdt)
    if grp is not None:
        y = g_allreduce(y, grp)
    return y.to(cdt).reshape(B, S, H), route[4]


def expert_partition_specs():
    """The experts' PartitionSpecs (``moe.py:86-89``): each expert's banks
    over 'ep', their FFN width over 'mp', the router replicated."""
    from .partitioner import PartitionSpec
    return {'gate_w': PartitionSpec(None, None),
            'w_in': PartitionSpec('ep', None, 'mp'),
            'w_out': PartitionSpec('ep', 'mp', None)}


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
