"""Pipeline parallelism over the 'pp' axis: GPipe and the fused 1F1B.

Port of ``paddle_tpu/parallel/pipeline.py:21-190``. The reference runs
every stage in one SPMD program (``shard_map``) and lets ``jax.grad``
transpose its ``ppermute``s into the reverse pipeline. The port is one
process a stage, and the reverse pipeline is written out: a rank's
autograd cannot reach the backward of a send whose output it never read
(stage 0 reads nothing its sends produce), so each schedule runs its
backward ticks by hand, recomputing the stage from its saved input
(whole-stage recompute, as the reference's 1F1B does), rotating
activations forward (``perm [(i, i+1)]``) and gradients backward (the
inverse permutation) once a tick over point-to-point ops.

 - ``pipeline_apply``: GPipe, a ``torch.autograd.Function``: m + pp - 1
   forward ticks (stage s runs microbatch t - s), the output valid on the
   last stage (zeros elsewhere; mask the loss with ``last_stage_mask`` and
   psum it over the axis after the backward), then m + pp - 1 backward
   ticks (stage s runs microbatch u - (pp - 1 - s)). Stored: every
   microbatch's stage input.
 - ``pipeline_train_1f1b``: the fused schedule (one loop of m + 2(pp - 1)
   ticks: at tick t stage s forwards microbatch t - s and backwards
   t - 2(pp - 1) + s), inputs kept in a ring of 2 pp - 1 slots; returns
   the loss and the gradients.

The stage function must be uniform across stages (the stacked
transformer blocks).
"""
import torch

from ..distributed.collective import exchange, psum
from .partitioner import tree_leaves as _leaves, tree_rebuild as _rebuild


def _group(axis_name, mesh):
    if not isinstance(axis_name, str):
        return axis_name
    if mesh is None:
        from ..distributed.topology import get_mesh
        mesh = get_mesh()
    return mesh.group(axis_name)


def _pos(grp):
    return (1, 0) if grp is None else (grp.nranks, grp.index)


def _neighbours(grp, sends, recv_like, fwd):
    """One tick's exchange: ``sends`` goes to the next stage (``fwd``) or
    the previous one, and a tensor like ``recv_like`` comes from the
    other side (zeros where there is none)."""
    p, s = _pos(grp)
    dst, src = (s + 1, s - 1) if fwd else (s - 1, s + 1)
    out = exchange(
        grp, [(sends, dst)] if 0 <= dst < p else [],
        [(recv_like.shape, recv_like.dtype, src, recv_like.device)]
        if 0 <= src < p else [])
    return out[0] if out else torch.zeros_like(recv_like)


def _vjp(fn, params_leaves, params_tree, h, g_out):
    """Recompute ``fn(params, h)`` with autograd and pull ``g_out`` back:
    -> (grads of the leaves that require them (None for the others), dh)."""
    with torch.enable_grad():
        live = [p.detach().requires_grad_(p.requires_grad)
                for p in params_leaves]
        hh = h.detach().requires_grad_()
        out = fn(_rebuild(params_tree, live), hh)
        want = [hh] + [p for p in live if p.requires_grad]
        got = torch.autograd.grad(out, want, g_out, allow_unused=True)
    it = iter(got[1:])
    grads = [next(it) if p.requires_grad else None for p in live]
    return grads, got[0]


def _accumulate(acc, grads):
    for i, g in enumerate(grads):
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i] + g


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, stage_fn, tree, m, *leaves):
        p, s = _pos(grp)
        b = x.shape[0]
        if b % m:
            raise ValueError(f'batch {b} does not split into {m} '
                             'microbatches')
        micro = x.reshape((m, b // m) + tuple(x.shape[1:]))
        params = _rebuild(tree, leaves)
        inputs, outputs = {}, torch.zeros_like(micro)
        state = torch.zeros_like(micro[0])
        for t in range(m + p - 1):
            j = t - s
            out = torch.zeros_like(micro[0])
            if 0 <= j < m:
                inputs[j] = micro[j] if s == 0 else state
                out = stage_fn(params, inputs[j])
                if s == p - 1:
                    outputs[j] = out
            if t < m + p - 2:
                state = _neighbours(grp, out, state, fwd=True)
        ctx.grp, ctx.stage_fn, ctx.tree, ctx.m = grp, stage_fn, tree, m
        ctx.inputs = inputs
        ctx.save_for_backward(*leaves)
        return outputs.reshape(x.shape)

    @staticmethod
    def backward(ctx, gy):
        grp, m = ctx.grp, ctx.m
        p, s = _pos(grp)
        leaves = ctx.saved_tensors
        g_micro = gy.reshape((m, -1) + tuple(gy.shape[1:]))
        gx = torch.zeros_like(g_micro)
        acc = [None] * len(leaves)
        g_state = torch.zeros_like(g_micro[0])
        for u in range(m + p - 1):
            j = u - (p - 1 - s)
            g_in = torch.zeros_like(g_micro[0])
            if 0 <= j < m:
                g_out = g_micro[j] if s == p - 1 else g_state
                grads, g_in = _vjp(ctx.stage_fn, leaves, ctx.tree,
                                   ctx.inputs[j], g_out)
                _accumulate(acc, grads)
                if s == 0:
                    gx[j] = g_in
            if u < m + p - 2:
                g_state = _neighbours(grp, g_in, g_state, fwd=False)
        ctx.inputs = None
        return (gx.reshape(gy.shape), None, None, None, None, *acc)


def pipeline_apply(stage_fn, stage_params, x, n_microbatches, axis_name='pp',
                   mesh=None):
    """GPipe over the pp axis, differentiable.

    stage_fn(params, h) -> h'   one stage's computation (uniform)
    stage_params: this rank's stage params (a dict of tensors)
    x: [B, ...] the local batch (only stage 0's is read)
    Returns y [B, ...], valid on the LAST stage (zeros on the others):
    mask the loss with ``last_stage_mask`` and psum it over the axis."""
    grp = _group(axis_name, mesh)
    return _GPipe.apply(x, grp, stage_fn, stage_params, n_microbatches,
                        *_leaves(stage_params))


def pipeline_train_1f1b(stage_fn, embed_fn, head_fn, stage_params,
                        shared_params, tokens, targets, n_microbatches,
                        axis_name='pp', mesh=None):
    """The fused 1F1B schedule (the reference's ``run_1f1b``).

    stage_fn(stage_params, h) -> h'        uniform stage body
    embed_fn(shared_params, tok_mb) -> h   input embedding (stage 0)
    head_fn(shared_params, h, tgt_mb) -> scalar mean loss (last stage)

    Returns (loss, stage_grads, shared_grads): the loss the mean over the
    local batch on every stage; the stage's gradients (pp-local) and the
    shared parameters' (summed over the axis), both dicts like the
    parameters. dp/sp reductions are the caller's."""
    grp = _group(axis_name, mesh)
    p, s = _pos(grp)
    m = n_microbatches
    b = tokens.shape[0]
    if b % m:
        raise ValueError(f'batch {b} does not split into {m} microbatches')
    tok = tokens.reshape((m, b // m) + tuple(tokens.shape[1:]))
    tgt = targets.reshape((m, b // m) + tuple(targets.shape[1:]))
    st_leaves, sh_leaves = _leaves(stage_params), _leaves(shared_params)
    with torch.no_grad():
        h0 = embed_fn(shared_params, tok[0])
    ring = 2 * p - 1
    buf = {}
    g_stage = [None] * len(st_leaves)
    g_shared = [None] * len(sh_leaves)
    loss_sum = torch.zeros((), dtype=torch.float32, device=h0.device)
    fwd_in = bwd_in = torch.zeros_like(h0)
    n_steps = m + 2 * (p - 1)
    for t in range(n_steps):
        jf = t - s
        h_out = torch.zeros_like(h0)
        if 0 <= jf < m:
            with torch.no_grad():
                h_in = embed_fn(shared_params, tok[jf]) if s == 0 else fwd_in
                buf[jf % ring] = h_in
                h_out = stage_fn(stage_params, h_in)
            if s == p - 1:
                # the loss head and the seed gradient of this microbatch
                def head(sh, h, _t=tgt[jf]):
                    return head_fn(sh, h, _t)
                with torch.enable_grad():
                    live = [x.detach().requires_grad_(x.requires_grad)
                            for x in sh_leaves]
                    hh = h_out.detach().requires_grad_()
                    loss_mb = head(_rebuild(shared_params, live), hh)
                    want = [hh] + [x for x in live if x.requires_grad]
                    got = torch.autograd.grad(loss_mb, want,
                                              allow_unused=True)
                it = iter(got[1:])
                _accumulate(g_shared, [next(it) if x.requires_grad else None
                                       for x in live])
                g_hout = got[0]
                loss_sum = loss_sum + loss_mb.detach().float()
        jb = t - 2 * (p - 1) + s
        g_in = torch.zeros_like(h0)
        if 0 <= jb < m:
            g_out = g_hout if s == p - 1 else bwd_in
            grads, g_in = _vjp(stage_fn, st_leaves, stage_params,
                               buf[jb % ring], g_out)
            _accumulate(g_stage, grads)
            if s == 0:
                def emb(sh, _h, _t=tok[jb]):
                    return embed_fn(sh, _t)
                grads, _ = _vjp(emb, sh_leaves, shared_params, h0, g_in)
                _accumulate(g_shared, grads)
        if t < n_steps - 1 and p > 1:
            # activations forward and gradients backward in one batch
            p2p = []
            if s < p - 1:
                p2p.append((h_out, s + 1))
            if s > 0:
                p2p.append((g_in, s - 1))
            recvs = []
            if s > 0:
                recvs.append((h0.shape, h0.dtype, s - 1, h0.device))
            if s < p - 1:
                recvs.append((h0.shape, h0.dtype, s + 1, h0.device))
            got = exchange(grp, p2p, recvs)
            if s > 0:
                fwd_in = got.pop(0)
            if s < p - 1:
                bwd_in = got.pop(0)
    inv_m = 1.0 / m
    loss = psum(loss_sum, grp) * inv_m
    g_stage = [None if g is None else g * inv_m for g in g_stage]
    # every stage reduces every shared leaf (zeros where it has none)
    g_shared = [psum(torch.zeros_like(x) if g is None else g, grp) * inv_m
                for g, x in zip(g_shared, sh_leaves)]
    return (loss, _rebuild(stage_params, g_stage),
            _rebuild(shared_params, g_shared))


def last_stage_mask(axis_name='pp', mesh=None):
    """True on the last stage of the pp axis."""
    p, s = _pos(_group(axis_name, mesh))
    return s == p - 1


def stack_stage_params(per_layer_params, n_stages):
    """[L, ...] stacked per-layer params -> [pp, L/pp, ...]."""
    def reshape(x):
        L = x.shape[0]
        if L % n_stages:
            raise ValueError(f'{L} layers do not split into {n_stages} '
                             'stages')
        return x.reshape((n_stages, L // n_stages) + tuple(x.shape[1:]))
    if isinstance(per_layer_params, dict):
        return {k: stack_stage_params(v, n_stages)
                for k, v in per_layer_params.items()}
    return reshape(per_layer_params)
