"""LocalSGD: k local optimizer steps a rank, then a parameter average.

Port of ``paddle_tpu/parallel/localsgd.py:1-98`` (reference:
fleet/meta_optimizers/localsgd_optimizer.py). The reference's replicas are
a leading array axis sharded over dp inside one ``shard_map`` step; here
they are the dp ranks: rank r holds the reference's replica r. Each rank
takes its block of the global batch (block r over ``axis``, the
reference's ``P(axis)``), its gradients stay local (no all-reduce: the
point of LocalSGD), its optimizer update runs on its own copy, and every
k-th step one mean all-reduce of the parameters (bucketed) runs over the
axis.
"""
import torch

from ..distributed.collective import pmean
from ..optimizer.optimizer import tree_map
from .partitioner import PartitionSpec, shard, tree_leaves, tree_rebuild

__all__ = ['replicate_for_localsgd', 'collapse_replicas',
           'make_localsgd_train_step']


def _group(mesh, axis):
    if mesh is None:
        from ..distributed.topology import get_mesh
        mesh = get_mesh()
    return mesh, mesh.group(axis)


def replicate_for_localsgd(tree, mesh=None, axis='dp'):
    """This rank's replica of ``tree``: a copy of every leaf (each rank
    starts from the same values)."""
    return tree_map(lambda x: x.detach().clone(), tree)


def collapse_replicas(tree, mesh=None, axis='dp'):
    """The replicas' mean over ``axis`` (e.g. for eval / checkpoint), on
    every rank."""
    _, grp = _group(mesh, axis)
    return tree_map(lambda x: pmean(x, grp), tree)


def make_localsgd_train_step(loss_fn, opt, mesh=None, k_steps=4, axis='dp',
                             post_update=None):
    """-> ``step(params_rep, opt_state_rep, batch, step_idx, lr) ->
    (mean_loss, params_rep, opt_state_rep)``: ``loss_fn(params, batch)``
    (torch) on this rank's block of the global ``batch``, the inner
    update in place, ``post_update(params)`` after it, and at every
    ``k_steps``-th step (``(step_idx + 1) % k_steps == 0``) the parameters
    averaged over ``axis``; the loss is the mean over the ranks."""
    from ..distributed.parallel import average_grads
    mesh, grp = _group(mesh, axis)

    def step(params_rep, state_rep, batch, step_idx, lr):
        batch = torch.as_tensor(batch)
        spec = PartitionSpec(*([axis] + [None] * (batch.dim() - 1)))
        block = shard(batch, spec, mesh)
        with torch.enable_grad():
            live = [x.detach().requires_grad_()
                    for x in tree_leaves(params_rep)]
            loss = loss_fn(tree_rebuild(params_rep, live), block)
            grads = tree_rebuild(params_rep,
                                 list(torch.autograd.grad(loss, live)))
        params_rep, state_rep = opt.functional_apply(params_rep, grads,
                                                     state_rep, lr)
        if post_update is not None:
            params_rep = post_update(params_rep)
        if (int(step_idx) + 1) % k_steps == 0:
            # the parameters' mean over the replicas: one all-reduce a
            # bucket
            average_grads(tree_leaves(params_rep), grp)
        return pmean(loss.detach(), grp), params_rep, state_rep

    return step
