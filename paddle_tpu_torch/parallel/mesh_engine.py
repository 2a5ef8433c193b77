"""Mesh-sharded engine execution: one serving replica over an mp=N mesh.

Port of ``paddle_tpu/parallel/mesh_engine.py``. The reference's replica is
one controller driving N chips through one SPMD program: parameters placed
by the model's ``LOGICAL_AXES`` (Megatron's column/row layout from the
'heads' / 'mlp' / 'vocab' rules), the paged KV pool split on its heads
(``kv_heads -> mp``, ``kv_pages`` replicated), page tables and the decode
state replicated, and everything host-side (the scheduler, the page
allocator, the prefix cache) the mp=1 code.

The port keeps that shape in one process driving N shards. A port engine
runs as CUDA graphs, and a graph captures neither a gloo collective nor
two ranks of one NCCL communicator on one card, so K1's process-a-rank
world cannot carry a captured engine on one card. Here:

 - ``build_mesh(mp, devices=None)`` takes the first ``mp`` cards and raises
   as the reference does when fewer exist; ``devices=[d] * mp`` builds a
   *virtual* mesh whose shards share one device (the counterpart of the
   reference tests' virtual CPU devices);
 - ``MeshContext.place`` cuts a tree into ``Sharded`` leaves, one block a
   shard on the shard's device (a replicated leaf is the same tensor on a
   shared device, a copy on another); ``shards(tree)`` gives the N
   per-shard trees the forward reads;
 - the model's mesh forward (``models.gpt.mesh_forward_with_cache``) runs
   each layer shard by shard, each shard's heads through kernel 6 or 7
   over its own pool, and sums the row-parallel partials explicitly
   (``MeshContext.psum``: one add on one device, a peer copy and an add
   across devices), so on one card a shard's step is captured into the
   same graph as the others.

Placement falls back to replicated for a dim the degree does not divide
(recorded in ``ctx.fallbacks``), never raising. The engines stay uniform
across mesh sizes: two captures a GenerationEngine, unchanged labels (the
degree rides a gauge of its own), and the control planes read the mesh
only through ``mesh_of`` / ``mesh_size``.
"""
import dataclasses

import torch

from ..ops.paged_kv import POOL_LOGICAL_AXES  # noqa: F401  (re-export)
from .partitioner import (PartitionSpec, Partitioner, ShardingRuleError,
                          model_rules)

__all__ = ['DeviceMesh', 'MeshContext', 'Sharded', 'build_mesh',
           'serving_rules', 'model_logical_axes', 'resolve', 'mesh_of',
           'mesh_size', 'sharded_structs', 'POOL_LOGICAL_AXES']

_AXES = ('pp', 'dp', 'sharding', 'ep', 'sp', 'mp')


def serving_rules(mp=1):
    """The rules table of the serving path: the model rules, which carry
    the paged-KV axes (``kv_heads -> mp``; ``kv_pages`` pinned replicated:
    the +1 trash page makes the page count indivisible by any mp > 1).
    One table serves every mesh size."""
    return model_rules(mp=mp)


class DeviceMesh:
    """``mp`` shards laid on ``devices`` (one a shard; a device may repeat:
    a virtual mesh). Every hybrid axis is present, of size 1 but 'mp', so
    any rules table validates against it."""

    axis_names = _AXES

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError('a mesh needs at least one device')
        self.shape = {a: 1 for a in _AXES}
        self.shape['mp'] = len(self.devices)

    @property
    def size(self):
        return len(self.devices)

    @property
    def distinct(self):
        """The devices the shards use, in first-use order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self):
        return f'DeviceMesh(mp={self.size}, devices={self.devices})'


def _cards():
    if not torch.cuda.is_available():
        return []
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def build_mesh(mp, devices=None):
    """A mesh of exactly ``mp`` shards: on the first ``mp`` of ``devices``
    (default: this host's cards). Fewer devices than ``mp`` raise, as the
    reference's do; ``devices=[d] * mp`` is a virtual mesh on one
    device."""
    mp = int(mp)
    if mp < 1:
        raise ValueError(f'mesh size must be >= 1, got {mp}')
    devices = _cards() if devices is None else list(devices)
    if len(devices) < mp:
        raise ValueError(
            f'mesh of {mp} devices requested but only {len(devices)} '
            f'available (a virtual mesh on one device: devices=[d] * {mp})')
    return DeviceMesh(devices[:mp])


class Sharded:
    """A tensor laid out over a mesh: ``blocks[i]`` on ``mesh.devices[i]``,
    cut by ``spec`` (a replicated leaf holds the whole tensor in every
    block). ``shape`` and ``dtype`` are the global tensor's."""

    def __init__(self, blocks, spec, shape, mesh):
        self.blocks = list(blocks)
        self.spec = spec
        self.shape = tuple(shape)
        self.dtype = self.blocks[0].dtype
        self.mesh = mesh

    def __repr__(self):
        return (f'Sharded(shape={self.shape}, spec={tuple(self.spec)}, '
                f'shards={len(self.blocks)})')


def _block(x, spec, i, n):
    """Shard ``i`` of ``n``'s block of ``x`` under ``spec`` (only 'mp' has
    a size above 1 on a serving mesh)."""
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if 'mp' in axes and n > 1:
            x = x.chunk(n, dim=d)[i]
    return x


class MeshContext:
    """One replica's mesh, partitioner and placement bookkeeping.

    ``fallbacks`` records every leaf that resolved sharded but was placed
    replicated because a dim does not divide the mesh degree."""

    def __init__(self, mesh, rules=None):
        self.mesh = mesh
        self.mp = int(mesh.shape.get('mp', 1))
        self.partitioner = Partitioner(
            rules=rules if rules is not None else serving_rules(self.mp),
            mesh=mesh)
        self.fallbacks = []
        # which parts of a placed model are split over the shards
        # ('heads', 'mlp', 'vocab'; place_params sets them)
        self.split = {}

    @classmethod
    def build(cls, mp, devices=None, rules=None):
        return cls(build_mesh(mp, devices=devices), rules=rules)

    @property
    def size(self):
        return self.mesh.size

    @property
    def devices(self):
        return self.mesh.devices

    def describe(self):
        return {'mp': self.mp, 'devices': self.size,
                'axes': dict(self.mesh.shape),
                'fallbacks': list(self.fallbacks)}

    # ---- spec resolution (divisibility falls back to replicated) ---------
    def spec(self, logical_axes, shape=None, label=''):
        try:
            return self.partitioner.spec(logical_axes, shape)
        except ShardingRuleError as e:
            self.fallbacks.append({'tensor': label or str(logical_axes),
                                   'reason': str(e)})
            return PartitionSpec()

    def pool_spec(self, shape=None):
        return self.spec(POOL_LOGICAL_AXES, shape, label='kv_pool')

    # ---- placement --------------------------------------------------------
    def place_leaf(self, x, logical_axes, label=''):
        """One tensor -> ``Sharded`` (each block a contiguous copy on its
        shard's device; a replicated leaf's blocks are ``x`` itself on its
        own device)."""
        spec = self.spec(logical_axes, tuple(x.shape), label)
        n = self.size
        blocks = [_block(x, spec, i, n).to(d).contiguous()
                  for i, d in enumerate(self.devices)]
        return Sharded(blocks, spec, x.shape, self.mesh)

    def place(self, tree, logical_tree, prefix=''):
        """A tree of tensors -> the same tree of ``Sharded`` leaves, by its
        logical axes (indivisible leaves replicated, in ``fallbacks``)."""
        if isinstance(tree, dict):
            return {k: self.place(v, logical_tree[k],
                                  f'{prefix}.{k}' if prefix else k)
                    for k, v in tree.items()}
        return self.place_leaf(tree, logical_tree, prefix or 'param')

    def place_params(self, params, config):
        """A causal LM's parameter dict by its family's LOGICAL_AXES (GPT
        or MoE, told by the config's class). A Megatron split is all or
        nothing: the attention splits when the kv heads divide the degree,
        the FFN (each expert's) when its width does, the embedding when
        the vocab does; a part that does not stays whole on every shard
        (its leaves in ``fallbacks``) and one shard computes it."""
        n = self.mp
        self.split = {'heads': (config.kv_heads % n == 0
                                and config.num_heads % n == 0),
                      'mlp': config.ffn_size % n == 0,
                      'vocab': config.vocab_size % n == 0}
        dropped = {name for name, ok in self.split.items() if not ok}
        return self.place(params, self._without(
            model_logical_axes(config), dropped))

    def _without(self, logical, names, prefix=''):
        """``logical`` with the axis ``names`` unmapped (None), each leaf
        that loses one recorded as a fallback."""
        if isinstance(logical, dict):
            return {k: self._without(v, names, f'{prefix}.{k}' if prefix
                                     else k) for k, v in logical.items()}
        if logical is None or not set(logical) & names:
            return logical
        self.fallbacks.append({'tensor': prefix, 'reason': (
            f'{sorted(set(logical) & names)} does not divide mesh degree '
            f'{self.mp}: replicated')})
        return tuple(None if a in names else a for a in logical)

    def shards(self, tree):
        """A tree of ``Sharded`` leaves -> N plain trees, shard i's
        blocks."""
        def pick(t, i):
            if isinstance(t, dict):
                return {k: pick(v, i) for k, v in t.items()}
            return t.blocks[i] if isinstance(t, Sharded) else t
        return [pick(tree, i) for i in range(self.size)]

    def pool(self, config, num_pages, page_size):
        """The paged KV pool of ``config`` split on its heads: one pool a
        shard (``{'k', 'v'}`` planes, int8 banks with their scales split
        the same way), allocated on its device at its block's shape; heads
        that do not divide the degree give every shard the whole pool
        (a fallback)."""
        from ..models.gpt import torch_dtype
        from ..ops.paged_kv import init_paged_pool
        kvh = config.kv_heads
        spec = self.pool_spec((config.num_layers, num_pages, page_size, kvh,
                               config.head_dim))
        split = spec[3] is not None and self.split.get('heads', True)
        local = kvh // self.mp if split else kvh
        return [init_paged_pool(config.num_layers, num_pages, page_size,
                                local, config.head_dim,
                                torch_dtype(config.dtype), d,
                                int8=config.kv_cache_int8)
                for d in self.devices]

    def place_pool(self, pool):
        """An existing pool (``{'k', 'v'}``: planes [L, N, page, H_kv, D]
        or int8 banks) -> one pool a shard, split on the heads."""
        spec = self.pool_spec(tuple(_plane(pool['k']).shape))
        n = self.size

        def cut(plane, i, d):
            if isinstance(plane, dict):
                return {k: _block(v, spec[:v.dim()], i, n).to(d).contiguous()
                        for k, v in plane.items()}
            return _block(plane, spec, i, n).to(d).contiguous()
        return [{k: cut(pool[k], i, d) for k in ('k', 'v')}
                for i, d in enumerate(self.devices)]

    # ---- the row-parallel reduction ---------------------------------------
    def psum(self, parts):
        """The sum of the shards' partials (``parts[i]`` on shard i's
        device) on every device the mesh uses: ``{device: sum}``. Summed in
        shard order on the first shard's device (a peer copy for a block
        elsewhere), then copied to each other device."""
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device, non_blocking=True)
        return {d: total if d == total.device else total.to(d)
                for d in self.mesh.distinct}


def _plane(plane):
    return plane['int8'] if isinstance(plane, dict) else plane


def model_logical_axes(config):
    """The LOGICAL_AXES tree of a model config's family."""
    if 'moe' in type(config).__name__.lower():
        from ..models import moe_gpt
        return moe_gpt.LOGICAL_AXES
    from ..models import gpt
    return gpt.LOGICAL_AXES


def resolve(mesh, mp=None, devices=None):
    """An engine's ``mesh=`` argument: a MeshContext passes through, a
    ``DeviceMesh`` is wrapped, an int builds one (``mp=`` is the keyword
    twin). None when no mesh was asked for or its degree is 1: an mp=1
    replica takes the single-device path untouched."""
    if mesh is None and mp is not None:
        mesh = int(mp)
    if mesh is None:
        return None
    if isinstance(mesh, MeshContext):
        ctx = mesh
    elif isinstance(mesh, int):
        if mesh <= 1:
            return None
        ctx = MeshContext.build(mesh, devices=devices)
    elif isinstance(mesh, DeviceMesh):
        ctx = MeshContext(mesh)
    else:
        raise TypeError(f'mesh= takes a MeshContext, a DeviceMesh or an int, '
                        f'not {type(mesh).__name__}')
    return ctx if ctx.mp > 1 else None


@dataclasses.dataclass(frozen=True)
class ShardStruct:
    """The skeleton of a leaf: its global shape and dtype, and for a
    ``Sharded`` leaf its spec and the devices of its blocks (None for a
    plain tensor or array)."""
    shape: tuple
    dtype: object
    spec: tuple = None
    devices: tuple = None


def sharded_structs(tree):
    """The skeleton of a tree that keeps each ``Sharded`` leaf's placement
    (spec and devices): what a prebuild allocates its static buffers
    against, so a graph captured before traffic reads the blocks the live
    engine holds. Plain tensors and arrays give structs without one."""
    if isinstance(tree, dict):
        return {k: sharded_structs(v) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return ShardStruct(tree.shape, tree.dtype, tuple(tree.spec),
                           tuple(str(b.device) for b in tree.blocks))
    return ShardStruct(tuple(tree.shape), tree.dtype)


def mesh_of(engine):
    """The MeshContext an engine runs under, or None (one device): the one
    accessor the host, fleet and audit planes use."""
    return getattr(engine, '_mesh_ctx', None)


def mesh_size(engine):
    """The number of shards an engine's functions span (1 for a
    single-device engine)."""
    ctx = mesh_of(engine)
    return ctx.size if ctx is not None else 1
