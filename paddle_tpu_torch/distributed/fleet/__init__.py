"""Fleet: the distributed training entry.

Port of ``paddle_tpu/distributed/fleet/__init__.py:59-412``. ``fleet.init``
builds the hybrid topology (one subgroup a mesh axis) from
``strategy.hybrid_configs`` over the world's ranks and installs it as the
process topology. Each rank runs its block of the global batch, so:

 - ``distributed_model(model)`` returns the same Layer, as the reference
   does, with its gradients averaged over the data axes (dp x sharding)
   at the end of every backward through its call
   (``distributed.parallel.GradSync``, which then owns those Parameters);
 - ``distributed_optimizer(opt)`` averages the gradients no GradSync owns
   before its step (so the gradients are averaged exactly once a step,
   whether the program wrapped the model, the optimizer or both), clips
   by the global gradient's norm (``nn.clip`` with each Parameter's shard
   axes: a split parameter's squares summed over the ranks that split
   it, a whole one counted once), and with ``strategy.sharding`` runs
   ZeRO over the data axes (``parallel.zero``'s blocks: stage 1 the
   optimizer state, 2 the gradients too, reduced to the blocks; in
   ``functional_apply`` stage 3 takes and gives parameter blocks). ``strategy.lars`` wraps a Momentum
   or SGD into ``LarsMomentum``; ``make_localsgd_step`` builds
   ``parallel.localsgd``'s step. ASP masks wait for ROADMAP step M.

The launcher, the PS datasets and the data generators raise citing
ROADMAP Queue 1 step K4b.
"""
import torch

from ... import _deferred
from .strategy import DistributedStrategy  # noqa: F401
from ..topology import HybridTopology, get_mesh, get_topology, set_topology
from . import meta_parallel  # noqa: F401
from . import metrics  # noqa: F401
from . import utils  # noqa: F401
from .meta_parallel import (  # noqa: F401
    ColumnParallelLinear, LayerDesc, ParallelCrossEntropy, PipelineLayer,
    RowParallelLinear, SharedLayerDesc, VocabParallelEmbedding,
    get_rng_state_tracker)
from .utils import recompute  # noqa: F401

# the reference's names for the topology (fleet/base/topology.py)
CommunicateTopology = HybridTopology
HybridCommunicateGroup = HybridTopology

_fleet_state = {'initialized': False, 'strategy': None}


class Role:
    """Reference: fleet/base/role_maker.py Role enum."""
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


def init(role_maker=None, is_collective=False, strategy=None):
    """Validate the strategy's degrees against the world, build the
    ``HybridTopology`` and install it; -> the topology."""
    from .. import get_world_size
    strategy = strategy or DistributedStrategy()
    deg = strategy.validate_degrees(get_world_size())
    topo = HybridTopology(**deg)
    set_topology(topo)
    _fleet_state['initialized'] = True
    _fleet_state['strategy'] = strategy
    return topo


def is_initialized():
    return _fleet_state['initialized']


def get_strategy():
    return _fleet_state['strategy'] or DistributedStrategy()


def worker_index():
    from .. import get_rank
    return get_rank()


def worker_num():
    from .. import get_world_size
    return get_world_size()


def is_first_worker():
    return worker_index() == 0


def is_worker():
    """Collective-only stack: every process is a worker."""
    return True


def is_server():
    return False


def init_worker():
    """A parameter-server call: accepted, warned once (the collective-only
    stack has no PS runtime), as the reference's."""
    from .strategy import warn_na_once
    warn_na_once('ps_init_worker', (
        'fleet.init_worker is a parameter-server call; this collective-only '
        'stack has no PS runtime: training proceeds without it.'))


def stop_worker():
    from .strategy import warn_na_once
    warn_na_once('ps_stop_worker', (
        'fleet.stop_worker is a parameter-server call; nothing to stop in '
        'the collective-only stack.'))


def init_server(*args, **kwargs):
    raise NotImplementedError(
        'fleet.init_server/run_server start a parameter-server process; '
        'this collective-only stack has no PS runtime. Use collective '
        'training (fleet.init(is_collective=True)) instead.')


def run_server(*args, **kwargs):
    init_server()


def save_inference_model(executor, dirname, feeded_var_names, target_vars,
                         main_program=None, export_for_deployment=True):
    """The static serving export of the fetch targets, as the reference's
    (``static.save_inference_model``; the static graph is ROADMAP step
    L's)."""
    import os
    from ...static import save_inference_model as _sim
    return _sim(os.path.join(dirname, 'model'), feeded_var_names,
                target_vars, executor, program=main_program)


def save_persistables(executor, dirname, main_program=None, mode=0):
    """The Parameters created under ``main_program``'s guard, saved to
    ``dirname/persistables.pdparams`` (the static program is ROADMAP step
    L's)."""
    import os
    from ...framework_io import save as fsave
    from ...nn.layer_base import Parameter
    from ...static import default_main_program
    program = main_program or default_main_program()
    plist = [p for p in getattr(program, '_params', [])
             if isinstance(p, Parameter)]
    os.makedirs(dirname, exist_ok=True)
    params = {(p.name or f'param_{i}'): p.numpy()
              for i, p in enumerate(plist)}
    fsave(params, os.path.join(dirname, 'persistables.pdparams'))
    return params


def barrier_worker():
    from .. import collective
    collective.barrier()


def distributed_model(model):
    """``model`` itself, its gradients averaged over the data axes after
    each ``backward()`` (as ``DataParallel``)."""
    from ..parallel import DataParallel, attach_grad_sync
    if not isinstance(model, DataParallel):
        attach_grad_sync(model)
    object.__setattr__(model, '_fleet_mesh', get_mesh())
    return model


def _zero_axes(topo):
    """Mesh axes backing ZeRO: the partitioner's data axes, so fleet and
    the declarative path never disagree."""
    from ...parallel.partitioner import Partitioner
    return Partitioner(mesh=topo.mesh).data_axes()


def shard_opt_state(state, params=None):
    """ZeRO-1: this rank's block of every optimizer-state leaf over the
    data axes (``parallel.zero.place``)."""
    from ...parallel import zero
    topo = get_topology()
    return zero.place(state, topo.mesh, _zero_axes(topo))


class _DistributedOptimizer:
    """An optimizer with fleet's strategy behaviours (see the module
    docstring)."""

    def __init__(self, opt, strategy, mesh=None, axes=None):
        """``mesh`` / ``axes``: the mesh and its data axes the gradients
        are averaged over (default: the topology's, its data axes)."""
        if strategy is not None and strategy.lars:
            opt = self._wrap_lars(opt, strategy)
        if strategy is not None and getattr(strategy, 'asp', False):
            from ... import sparsity
            opt = sparsity.decorate(opt)
        self._inner = opt
        self._strategy = strategy
        if mesh is None:
            topo = get_topology()
            mesh, axes = topo.mesh, _zero_axes(topo)
        self._mesh = mesh
        self._axes = tuple(axes)
        grp = mesh.group(self._axes) if self._axes else None
        self._grp = grp if grp is not None and grp.nranks > 1 else None
        self._stage = 0
        if strategy is not None and strategy.sharding:
            self._stage = int(getattr(strategy.sharding_configs, 'stage', 1)
                              or 1)
        self._zstates = {}
        self._zspecs = None
        self._leaf_axes = {}
        self._asp_masks = None
        if self._stage:
            for p in getattr(opt, '_parameters', []):
                object.__setattr__(p, '_zero_owner', self)

    @staticmethod
    def _wrap_lars(opt, strategy):
        """strategy.lars swaps a Momentum / SGD inner optimizer for LARS
        (reference fleet/meta_optimizers/lars_optimizer.py)."""
        from ... import optimizer as opt_mod
        if not isinstance(opt, (opt_mod.Momentum, opt_mod.SGD)):
            return opt
        cfg = strategy.lars_configs
        return opt_mod.LarsMomentum(
            learning_rate=opt._lr,
            momentum=getattr(opt, '_momentum', 0.9),
            lars_coeff=cfg.lars_coeff or 0.001,
            lars_weight_decay=cfg.lars_weight_decay or 0.0005,
            epsilon=cfg.epsilon or 1e-9,
            exclude_from_weight_decay=cfg.exclude_from_weight_decay,
            parameters=opt._param_groups or opt._parameters,
            grad_clip=opt._grad_clip)

    def __getattr__(self, k):
        return getattr(self.__dict__['_inner'], k)

    # ---- ZeRO blocks ------------------------------------------------------
    def _spec(self, x):
        from ...parallel import zero
        deg = 1
        for a in self._axes:
            deg *= self._mesh.shape.get(a, 1)
        return zero.shard_spec(x, deg, self._axes)

    def _zero_update(self, ps, gs, states_of, infos, lr, clip, wd, stage3):
        """ZeRO over the data axes for one group: ``gs`` averaged (one
        all-reduce a bucket, the reduce-scatter's mean), each rank updates
        its blocks with its blocks' state, and the blocks are gathered
        back (one all-gather a bucket) unless ``stage3`` keeps them."""
        from ...parallel.partitioner import shard
        from ..parallel import average_grads
        mesh = self._mesh
        average_grads(gs, self._grp)
        specs = [p[1] if isinstance(p, tuple) else self._spec(p)
                 for p in ps]
        blocks = [p[0] if isinstance(p, tuple) else shard(p, s, mesh)
                  for p, s in zip(ps, specs)]
        g_blocks = [shard(g, s, mesh) for g, s in zip(gs, specs)]
        # a block's squares are summed over the data axes too; a whole
        # leaf's averaged gradient is the same on every data rank
        zinfos = [(tuple(self._axes) if any(e is not None for e in s)
                   else ()) + tuple(i) for s, i in zip(specs, infos)]
        states = [states_of(i, b) for i, b in enumerate(blocks)]
        self._inner._apply(g_blocks, blocks, states, lr, clip, wd, zinfos,
                           mesh)
        if not stage3:
            _gather_into([p for p in ps if not isinstance(p, tuple)],
                         [b for p, b in zip(ps, blocks)
                          if not isinstance(p, tuple)],
                         [s for p, s in zip(ps, specs)
                          if not isinstance(p, tuple)], self._grp, mesh)
        return blocks

    # ---- the eager path ---------------------------------------------------
    @torch.no_grad()
    def step(self):
        """The inner optimizer's step, its gradients averaged over the data
        axes (those no GradSync owns) and clipped by the global norm."""
        from ..parallel import average_grads
        inner = self._inner
        for params, lr, clip, wd in inner._step_groups():
            infos = [_mp_axes(p) for p in params]
            grads = [p.grad._value for p in params]
            if self._stage:
                def states_of(i, block, params=params):
                    key = id(params[i])
                    if key not in self._zstates:
                        self._zstates[key] = inner.init_state(block)
                    return self._zstates[key]
                self._zero_update([p._value for p in params], grads,
                                  states_of, infos, lr, clip, wd, False)
                continue
            average_grads([g for p, g in zip(params, grads)
                           if getattr(p, '_grad_owner', None) is None],
                          self._grp)
            inner._apply(grads, [p._value for p in params],
                         inner._states_of(params), lr, clip, wd, infos,
                         self._mesh)

    def clear_grad(self, *a, **k):
        return self._inner.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        if all(p.grad is None for p in self._inner._parameters):
            loss.backward()
        self.step()
        pg = [(p, p.grad) for p in self._inner._parameters]
        self.clear_grad()
        return None, pg

    # ---- the functional path ----------------------------------------------
    def set_shard_axes(self, axes_by_name):
        """The mesh axes each leaf (by its dotted path in the functional
        trees) is split over (``ShardInfo.axes``): what the global-norm
        clip sums over. Default: every leaf whole."""
        self._leaf_axes = dict(axes_by_name)

    def functional_init(self, params):
        """The inner optimizer's state; with ``strategy.sharding``, the
        state of this rank's ZeRO blocks (``shard_opt_state``)."""
        from ...optimizer.optimizer import tree_map
        from ...parallel.partitioner import shard
        if not self._stage:
            return self._inner.functional_init(params)
        self._zspecs = tree_map(self._spec, params)
        blocks = tree_map(lambda x, s: shard(x, s, self._mesh), params,
                          self._zspecs)
        return self._inner.functional_init(blocks)

    def set_asp_masks(self, mask_tree):
        """Register the mask tree of ``sparsity.prune_tree`` for the
        functional path. Masks are ROADMAP step M's: a registered tree
        raises at the next apply, as ``sparsity`` does."""
        self._asp_masks = mask_tree

    def _asp_post(self, new_p):
        if self._asp_masks is not None:
            from ... import sparsity
            return sparsity.apply_mask_tree(new_p, self._asp_masks)
        if self._strategy is not None and getattr(self._strategy, 'asp',
                                                  False):
            import warnings
            if not getattr(self, '_asp_warned', False):
                warnings.warn(
                    'strategy.asp is on but no mask tree is registered for '
                    'the functional path', stacklevel=3)
                self._asp_warned = True
        return new_p

    @torch.no_grad()
    def functional_apply(self, params, grads, opt_state, lr=None):
        """One update of ``params`` (nested dicts, in place) from this
        rank's gradients: averaged over the data axes once (in buckets),
        clipped by the global norm, then the inner update; with
        ``strategy.sharding`` the ZeRO stage's (stage 3: a leaf given as
        its block stays a block). -> (params, opt_state)."""
        from ...optimizer.optimizer import _MISSING, _f32_scalar, _zip_leaves
        from ..parallel import average_grads
        inner = self._inner
        lr = inner.get_lr() if lr is None else lr
        names = _leaf_names(params)
        infos = [tuple(self._leaf_axes.get(n, ())) for n in names]
        if not self._stage:
            average_grads([g for _, g in _zip_leaves(params, grads)],
                          self._grp)
            inner.functional_apply(params, grads, opt_state, lr, infos,
                                   self._mesh)
            return self._asp_post(params), opt_state
        ps, gs, ss = (list(t) for t in zip(*_zip_leaves(params, grads,
                                                         opt_state)))
        keep = [i for i, g in enumerate(gs) if g is not None]
        if not keep:
            return self._asp_post(params), opt_state
        lr_t = _f32_scalar(lr, ps[keep[0]].device)
        gs = [gs[i].to(ps[i].dtype) for i in keep]
        zspecs = [z for _, z in _zip_leaves(params, self._zspecs)]
        # a leaf whose shape is not its gradient's is its ZeRO block
        # (stage 3 keeps blocks between steps)
        given = [ps[i] if ps[i].shape == gs[j].shape
                 else (ps[i], zspecs[i]) for j, i in enumerate(keep)]
        self._zero_update(given, gs, lambda j, b: ss[keep[j]],
                          [infos[i] for i in keep], lr_t, inner._grad_clip,
                          _MISSING, self._stage >= 3)
        return self._asp_post(params), opt_state

    def make_localsgd_step(self, loss_fn, mesh=None):
        """strategy.localsgd: the k-local-steps-then-average train step
        (``parallel.localsgd``); ``loss_fn(params, batch)``."""
        from ...parallel.localsgd import make_localsgd_train_step
        mesh = mesh or get_mesh()
        k = self._strategy.localsgd_configs.k_steps or 4
        return make_localsgd_train_step(loss_fn, self._inner, mesh,
                                        k_steps=k, post_update=self._asp_post)


def _mp_axes(p):
    info = getattr(p, '_dist', None)
    return info.axes if info is not None else ()


def _leaf_names(tree, prefix=''):
    """Dotted names of a tree's leaves in ``_zip_leaves``' order."""
    if isinstance(tree, dict):
        return [n for k in tree for n in _leaf_names(
            tree[k], f'{prefix}.{k}' if prefix else str(k))]
    return [prefix]


def _gather_into(params, blocks, specs, grp, mesh):
    """Write the all-gathered blocks into each full tensor of ``params``
    (one all-gather a bucket of one dtype; a whole leaf was updated in
    place)."""
    from ..collective import gather_tensor
    from ..parallel import buckets
    cut = [(p, b, s) for p, b, s in zip(params, blocks, specs)
           if any(e is not None for e in s)]
    if not cut or grp is None:
        return
    by_block = {id(b): (p, s) for p, b, s in cut}
    for bucket in buckets([b for _, b, _ in cut], 25):
        flat = torch.cat([b.reshape(-1) for b in bucket])
        every = gather_tensor(flat, grp)           # [n, len]
        off = 0
        for b in bucket:
            p, s = by_block[id(b)]
            k = b.numel()
            d = next(i for i, e in enumerate(s) if e is not None)
            parts = [every[r, off:off + k].view(b.shape)
                     for r in range(every.shape[0])]
            p.copy_(torch.cat(parts, dim=d))
            off += k


class RoleMakerBase:
    """Reference fleet/base/role_maker.py: every process is a collective
    worker."""

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def worker_index(self):
        return worker_index()

    def worker_num(self):
        return worker_num()


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=True, **kwargs):
        self.is_collective = is_collective


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=None, worker_num=1,
                 server_endpoints=None, **kwargs):
        self.current_id = current_id


class UtilBase:
    """Reference fleet/base/util_factory.py: cross-worker helpers over the
    world's collectives."""

    def all_reduce(self, input, mode='sum', comm_world='worker'):
        import numpy as np
        from .metrics import _reduce
        return np.asarray(_reduce(input, mode))

    def all_gather(self, input, comm_world='worker'):
        import numpy as np
        from .. import collective
        arr = torch.as_tensor(np.asarray(input, dtype='float64'))
        got = collective.gather_tensor(arr, collective.world_group())
        return [g.numpy() for g in got]

    def barrier(self, comm_world='worker'):
        from .. import collective
        collective.barrier()


util = UtilBase()


class Fleet:
    """Reference fleet/base/fleet_base.py: the stateful facade over the
    module-level functions."""

    def init(self, role_maker=None, is_collective=False, strategy=None):
        return init(role_maker, is_collective, strategy)

    def is_first_worker(self):
        return is_first_worker()

    def worker_index(self):
        return worker_index()

    def worker_num(self):
        return worker_num()

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def barrier_worker(self):
        barrier_worker()

    def distributed_optimizer(self, optimizer, strategy=None):
        return distributed_optimizer(optimizer, strategy)

    def distributed_model(self, model):
        return distributed_model(model)

    @property
    def util(self):
        return util


def distributed_optimizer(optimizer, strategy=None):
    return _DistributedOptimizer(optimizer, strategy or get_strategy())


_deferred.install(
    globals(), 'is not ported yet (ROADMAP Queue 1 step K4b)',
    classes=('DatasetBase', 'BoxPSDataset', 'InMemoryDataset',
             'QueueDataset', 'FileInstantDataset', 'MultiSlotDataGenerator',
             'MultiSlotStringDataGenerator'))
