"""ZeRO stages 1-3 over the data axes.

Port of ``paddle_tpu/parallel/zero.py:30-174``. The reference writes ZeRO
as sharding annotations and lets GSPMD insert the collectives; here they
are explicit, over the data axes' group of the mesh:

  stage 1: the gradients all-reduced (mean); each rank updates its block
           of each parameter with its block of the optimizer state, then
           the blocks are all-gathered back     -> optimizer state / N
  stage 2: the gradients reduce-scattered (mean) straight to the blocks
                                                 -> (state + grads) / N
  stage 3: the parameters stay in blocks, all-gathered for the forward
           and backward                          -> (state + grads +
                                                     params) / N

A leaf's block is its largest dim that the data degree divides
(``shard_spec``, the reference's rule); a leaf with none stays whole on
every rank. Specs are the reference's ``PartitionSpec`` tuples. Where the
reference's arrays carry their sharding, the port's blocks are plain
tensors: ``replicate`` takes the specs they were cut by.
"""
import torch

from ..distributed.collective import pmean, reduce_scatter_axis
from ..optimizer.optimizer import tree_map
from .partitioner import (PartitionSpec, shard, tree_leaves, tree_rebuild,
                          unshard)


def _mesh(mesh):
    if mesh is None:
        from ..distributed.topology import get_mesh
        mesh = get_mesh()
    return mesh


def _axis_deg(mesh, axes):
    d = 1
    for a in axes:
        d *= mesh.shape.get(a, 1)
    return d


def shard_spec(x, deg, axes, base=None):
    """PartitionSpec sharding ``x``'s largest divisible dim over ``axes``.
    With ``base`` (an existing spec), its sharded dims are kept and skipped
    by the selection."""
    ndim = len(getattr(x, 'shape', ()))
    if ndim == 0 or deg <= 1:
        return PartitionSpec(*base) if base is not None else PartitionSpec()
    parts = (list(base) + [None] * (ndim - len(base))
             if base is not None else [None] * ndim)
    best = None
    for d, s in enumerate(x.shape):
        if (parts[d] is None and s % deg == 0 and s >= deg
                and (best is None or s > x.shape[best])):
            best = d
    if best is None:
        return PartitionSpec(*parts)
    parts[best] = tuple(axes) if len(axes) > 1 else axes[0]
    return PartitionSpec(*parts)


def zero_specs(tree, mesh=None, axes=('dp',)):
    """Tree of ZeRO PartitionSpecs (largest divisible dim per leaf)."""
    deg = _axis_deg(_mesh(mesh), axes)
    return tree_map(lambda x: shard_spec(x, deg, axes), tree)


def place(tree, mesh=None, axes=('dp',)):
    """This rank's ZeRO block of every leaf of a global tree."""
    mesh = _mesh(mesh)
    return tree_map(lambda x, s: shard(x, s, mesh), tree,
                    zero_specs(tree, mesh, axes))


def constrain(tree, mesh=None, axes=('dp',)):
    """Global tensors -> this rank's ZeRO blocks (``place``)."""
    return place(tree, mesh, axes)


def replicate(tree, specs, mesh=None):
    """Blocks cut by ``specs`` -> the global tensors (all-gathered)."""
    mesh = _mesh(mesh)
    return tree_map(lambda x, s: unshard(x, s, mesh), tree, specs)


def hybrid_zero3_specs(tree, base_specs, mesh=None, dp_axis='dp'):
    """ZeRO-3's dp sharding merged into an existing mp/pp spec tree
    (``zero.py:97-107``): each leaf keeps its Megatron / pipeline axes and
    also shards its largest still-unsharded divisible dim over
    ``dp_axis``. Cut a global tree with ``partitioner.shard_tree(tree,
    specs, mesh)``; ``replicate(blocks, specs, mesh)`` gathers it back."""
    deg = _mesh(mesh).shape.get(dp_axis, 1)
    return tree_map(lambda x, spec: shard_spec(x, deg, (dp_axis,),
                                               base=spec), tree, base_specs)


def _scatter_mean(g, spec, mesh, grp):
    """Reduce-scatter (mean) of a gradient to its block; a whole leaf is
    all-reduced."""
    for d, entry in enumerate(spec):
        if entry is not None:
            return reduce_scatter_axis(g, grp, dim=d, op='avg')
    return pmean(g, grp)


def make_zero_train_step(loss_fn, optimizer, mesh=None, stage=1,
                         axes=('dp',), batch_axes=('dp',), donate=True,
                         partitioner=None):
    """Build (step, init_state) implementing ZeRO stage 1/2/3.

    loss_fn(params, *batch) -> scalar loss (torch). ``init_state(params)``
    takes the global parameters and returns (params, opt_state): the
    global parameters (stages 1-2) or this rank's blocks (stage 3), and
    the optimizer state of this rank's blocks. ``step(params, opt_state,
    lr, *batch) -> (loss, params, opt_state)``: ``batch`` is this rank's
    block of the global batch (``step.place_batch``), the loss the global
    mean; params and state are updated in place. A ``partitioner``
    supplies the mesh and the data axes from its rules table."""
    if partitioner is not None:
        mesh = mesh or partitioner.mesh
        axes = batch_axes = partitioner.data_axes()
    mesh = _mesh(mesh)
    if stage not in (1, 2, 3):
        raise ValueError(f'zero stage must be 1/2/3, got {stage}')
    grp = mesh.group(tuple(axes))
    batch_grp = mesh.group(tuple(batch_axes))
    specs = {}

    def init_state(params):
        specs['tree'] = zero_specs(params, mesh, axes)
        blocks = tree_map(lambda x, s: shard(x, s, mesh), params,
                          specs['tree'])
        opt_state = optimizer.functional_init(blocks)
        return (blocks if stage >= 3 else params), opt_state

    def step(params, opt_state, lr, *batch):
        if 'tree' not in specs:
            raise RuntimeError('call init_state(params) before the step')
        zs = specs['tree']
        full = (tree_map(lambda x, s: unshard(x, s, mesh), params, zs)
                if stage >= 3 else params)
        with torch.enable_grad():
            live = [x.detach().requires_grad_() for x in tree_leaves(full)]
            loss = loss_fn(tree_rebuild(full, live), *batch)
            grads = tree_rebuild(full, torch.autograd.grad(loss, live))
        loss = pmean(loss.detach(), batch_grp)
        if stage >= 2:
            g_blocks = tree_map(lambda g, s: _scatter_mean(g, s, mesh, grp),
                                grads, zs)
        else:
            g_blocks = tree_map(lambda g, s: shard(pmean(g, grp), s, mesh),
                                grads, zs)
        p_blocks = (params if stage >= 3 else
                    tree_map(lambda x, s: shard(x, s, mesh), params, zs))
        optimizer.functional_apply(p_blocks, g_blocks, opt_state, lr)
        if stage < 3:
            def gather_into(x, b, s):
                with torch.no_grad():
                    x.copy_(unshard(b, s, mesh))
                return x
            params = tree_map(gather_into, params, p_blocks, zs)
        return loss, params, opt_state

    def place_batch(arr):
        arr = torch.as_tensor(arr)
        parts = [None] * arr.ndim
        parts[0] = tuple(batch_axes) if len(batch_axes) > 1 else batch_axes[0]
        return shard(arr, PartitionSpec(*parts), mesh)

    step.place_batch = place_batch
    step.specs = specs
    return step, init_state

