"""The sharded train step: the glue between the Layer API and the ranks.

Port of ``paddle_tpu/parallel/parallelize.py:1-109``. The reference takes a
Layer whose parallel layers carry ``logical_axes`` names (or a raw
``mesh_axes`` PartitionSpec), places every parameter by its resolved spec
and jits one SPMD program over the mesh, GSPMD inserting the gradient
psum over dp and the tensor-parallel all-reduces over mp.

Here each rank holds its block of every annotated parameter (``shard``),
the forward's collectives are ``meta_parallel``'s layers' own (Megatron's
f / g over the mp group), and the step's update is
``fleet.distributed_optimizer``'s ``functional_apply`` over the batch
axes: the gradients averaged in buckets, clipped by the global norm
taken over every rank's blocks, the parameters updated in place.

A parameter cut into blocks carries a ``ShardInfo`` (``p._dist``): its
spec, the mesh and the full shape, so ``Layer.state_dict`` gives the full
tensor (all-gathered) and ``set_state_dict`` takes one (sliced).
"""
import torch

from .partitioner import Partitioner, PartitionSpec, shard, unshard


class ShardInfo:
    """Where a Parameter's local block sits in its global tensor:
    ``spec`` (a PartitionSpec), ``mesh`` and ``full_shape``."""

    def __init__(self, spec, mesh, full_shape):
        self.spec = PartitionSpec(*spec)
        self.mesh = mesh
        self.full_shape = tuple(full_shape)

    @property
    def axes(self):
        """The mesh axes of size > 1 the block is split over."""
        out = []
        for e in self.spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None and self.mesh.shape.get(a, 1) > 1:
                    out.append(a)
        return tuple(out)

    def group(self, axis):
        """The mesh's group along ``axis`` when the block is split over
        it, else None."""
        return self.mesh.group(axis) if axis in self.axes else None

    def gather(self, x):
        return unshard(x, self.spec, self.mesh)

    def slice(self, full):
        return shard(full, self.spec, self.mesh)


def shard_info(p):
    """A Parameter's ``ShardInfo`` when it holds a block, else None."""
    return getattr(p, '_dist', None)


def param_spec(p, name='', partitioner=None):
    """Resolve one Parameter's placement: ``logical_axes`` names through
    the rules table (default table if no partitioner given), else a raw
    ``mesh_axes`` PartitionSpec, else replicated."""
    la = getattr(p, 'logical_axes', None)
    if la is not None:
        return (partitioner or Partitioner()).spec(la)
    spec = getattr(p, 'mesh_axes', None)
    return spec if spec is not None else PartitionSpec()


def place_param(p, spec, mesh):
    """Cut a full-shaped Parameter into this rank's block of ``spec`` (a
    no-op for one that already holds a block, or a replicated spec)."""
    if shard_info(p) is not None or not any(
            e is not None and _deg(mesh, e) > 1 for e in spec):
        return p
    full = tuple(p._value.shape)
    p._replace_value(shard(p._value.detach(), spec, mesh))
    p._dist = ShardInfo(spec, mesh, full)
    return p


def _deg(mesh, entry):
    d = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        d *= mesh.shape.get(a, 1)
    return d


def shard_params(layer, mesh=None, partitioner=None):
    """Slice every annotated Parameter of a full-shaped Layer into this
    rank's block by its resolved spec (``logical_axes`` through the rules
    table, or ``mesh_axes``); replicated ones stay whole. -> the layer."""
    from ..distributed.topology import get_mesh
    mesh = mesh or (partitioner.mesh if partitioner is not None
                    and partitioner.mesh is not None else get_mesh())
    pt = partitioner or Partitioner(mesh=mesh)
    for n, p in layer.named_parameters():
        la = getattr(p, 'logical_axes', None)
        spec = (pt.spec(la, tuple(p._value.shape)) if la is not None
                else getattr(p, 'mesh_axes', None))
        if spec is not None:
            place_param(p, spec, mesh)
    return layer


def make_sharded_train_step(layer, loss_fn, optimizer, mesh=None,
                            batch_axes=('dp',), label_axes=None,
                            donate=True, partitioner=None):
    """Returns (step, init_state) where ``step(params, buffers, opt_state,
    key, lr, inputs, labels) -> (loss, params, buffers, opt_state)``.

    ``inputs`` / ``labels`` are tuples of the GLOBAL batch's arrays; each
    rank takes its block of dim 0 over ``batch_axes`` (``label_axes``:
    the labels', default the same; ``step.place_batch``). ``params`` are
    this rank's blocks (``init_state`` cuts them by the parameters'
    annotations), updated in place; the loss is the global mean (each
    rank's mean averaged over the batch axes). ``key``: an int the step
    reseeds the port's generators with (its dropout draws), or None to
    draw on. ``donate`` is accepted for the reference's signature: the
    update is in place either way."""
    from ..distributed.collective import pmean
    from ..distributed.fleet import _DistributedOptimizer
    from ..distributed.topology import get_mesh
    from ..nn.layer_base import functional_call
    from ..tensor import random as trandom
    if partitioner is not None:
        mesh = mesh or partitioner.mesh
        batch_axes = partitioner.data_axes()
    mesh = mesh or get_mesh()
    label_axes = tuple(label_axes or batch_axes)
    batch_axes = tuple(batch_axes)
    data = tuple(a for a in batch_axes if mesh.shape.get(a, 1) > 1)
    data_grp = mesh.group(data) if data else None
    pt = partitioner or Partitioner(mesh=mesh)
    dopt = _DistributedOptimizer(optimizer, None, mesh=mesh, axes=data)

    def set_mode(training):
        for sub in layer.sublayers(include_self=True):
            sub.training = training

    def init_state():
        shard_params(layer, mesh, pt)
        params = {n: p._value for n, p in layer.named_parameters()}
        buffers = {n: b._value for n, b in layer.named_buffers()}
        return params, buffers, optimizer.functional_init(params)

    named = dict(layer.named_parameters())

    def step(params, buffers, opt_state, key, lr, inputs, labels):
        inputs = [place_batch(x, batch_axes) for x in inputs]
        labels = [place_batch(x, label_axes) for x in labels]
        if key is not None:
            trandom.seed(int(key))
        set_mode(True)
        names = list(params)
        with torch.enable_grad():
            live = {n: params[n].detach().requires_grad_() for n in names}
            out, new_buf = functional_call(layer, live, buffers, *inputs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            from ..core.tensor import wrap
            loss = loss_fn(*[wrap(o) for o in outs],
                           *[wrap(x) for x in labels])
            loss = loss._value if hasattr(loss, '_value') else loss
            got = torch.autograd.grad(loss, [live[n] for n in names],
                                      allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, got)}
        dopt.set_shard_axes({n: shard_info(p).axes
                             for n, p in named.items()
                             if shard_info(p) is not None})
        dopt.functional_apply(params, grads, opt_state, lr)
        loss = pmean(loss.detach(), data_grp)
        return loss, params, {k: v.detach() for k, v in new_buf.items()}, \
            opt_state

    def place_batch(arr, axes=batch_axes):
        arr = arr._value if hasattr(arr, '_value') else torch.as_tensor(arr)
        if arr.dim() == 0:
            return arr
        parts = [None] * arr.dim()
        parts[0] = tuple(axes) if len(axes) > 1 else axes[0]
        return shard(arr, PartitionSpec(*parts), mesh)

    step.place_batch = place_batch
    return step, init_state
