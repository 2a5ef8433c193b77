"""Declarative logical-axis partitioner: one rules table for every layout.

Port of ``paddle_tpu/parallel/partitioner.py:39-284`` (the t5x technique):
parameters and activations carry *logical* axis names, and one ordered
rules table maps each name onto a mesh axis (or None = replicated). The
resolution is the reference's:

  - rules are scanned in order; the first rule whose name matches wins;
  - an explicit ``None`` rule stops the scan (replicated);
  - a mesh axis appears at most once a spec: a rule whose axis an earlier
    dim took falls through to later rules;
  - a name with no rule resolves to None;
  - with a mesh bound, rules must name its axes, and a ``shape`` whose dim
    does not divide its degree raises ``ShardingRuleError``.

A spec is the reference's ``PartitionSpec``: a tuple with one entry a dim
(a mesh-axis name, a tuple of them, or None). Where the reference's
``device_put`` places a global array by its spec, the port slices this
rank's block of it (``shard``) and all-gathers it back (``unshard``).
"""
import dataclasses

from ..distributed.collective import all_gather_axis
from ..optimizer.optimizer import tree_map


class ShardingRuleError(ValueError):
    """A rules-table entry cannot be applied: unknown mesh axis, or a
    tensor dim that does not divide the mesh-axis degree."""


class PartitionSpec(tuple):
    """One entry a dim: a mesh axis name, a tuple of names, or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f'PartitionSpec{tuple(self)!r}'


DEFAULT_RULES = (
    ('batch', 'dp'),
    ('length', 'sp'),
    ('vocab', 'mp'),
    ('heads', 'mp'),
    ('mlp', 'mp'),
    ('kv', None),
    ('kv_heads', 'mp'),
    ('kv_pages', None),
    ('expert', 'ep'),
    ('layers', 'pp'),
    ('embed', None),
    ('positions', None),
    ('router', None),
)


def _axes(entry):
    return entry if isinstance(entry, tuple) else (entry,)


def _degree(mesh, axes):
    d = 1
    for a in _axes(axes):
        d *= mesh.shape.get(a, 1)
    return d


def tree_leaves(tree):
    """The leaves of nested dicts in sorted-key order (the order
    ``jax.tree_util`` flattens a dict in)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_rebuild(tree, leaves):
    """``tree``'s structure over ``leaves`` (``tree_leaves``' order)."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(tree)


@dataclasses.dataclass(frozen=True)
class Partitioner:
    """An ordered logical -> mesh rules table, optionally bound to a mesh
    (``distributed.topology.Mesh``)."""
    rules: tuple = DEFAULT_RULES
    mesh: object = None

    def __post_init__(self):
        object.__setattr__(self, 'rules', tuple(
            (str(name), tuple(ax) if isinstance(ax, list) else ax)
            for name, ax in self.rules))
        if self.mesh is not None:
            names = set(self.mesh.axis_names)
            for name, ax in self.rules:
                for a in _axes(ax):
                    if a is not None and a not in names:
                        raise ShardingRuleError(
                            f"rule ({name!r} -> {ax!r}) names mesh axis "
                            f"{a!r} not in mesh axes {sorted(names)}")

    def spec(self, logical_axes, shape=None):
        """Resolve a tuple of logical axis names to a PartitionSpec; with
        ``shape`` (and a mesh) each sharded dim must divide its degree."""
        if logical_axes is None:
            return PartitionSpec()
        if isinstance(logical_axes, PartitionSpec):
            return logical_axes           # already-resolved escape hatch
        if shape is not None and len(shape) != len(logical_axes):
            raise ShardingRuleError(
                f'shape {tuple(shape)} has {len(shape)} dims but logical '
                f'axes {logical_axes} name {len(logical_axes)}')
        taken = set()
        out = []
        for d, name in enumerate(logical_axes):
            resolved = None
            if name is not None:
                for rname, ax in self.rules:
                    if rname != name:
                        continue
                    if ax is None:
                        break
                    axes = _axes(ax)
                    if any(a in taken for a in axes):
                        continue
                    if self.mesh is not None and shape is not None:
                        deg = _degree(self.mesh, axes)
                        if deg > 1 and shape[d] % deg != 0:
                            raise ShardingRuleError(
                                f'dim {d} ({name!r}) of shape '
                                f'{tuple(shape)} does not divide mesh '
                                f'degree {deg} for rule ({name!r} -> '
                                f'{ax!r})')
                    resolved = ax
                    taken.update(axes)
                    break
            out.append(resolved)
        return PartitionSpec(*out)

    def tree_specs(self, logical_tree, tree=None):
        """A tree (dicts) of logical-axis tuples -> PartitionSpecs; with
        ``tree`` (matching tensors) the shapes are checked."""
        if tree is None:
            return tree_map(self.spec, logical_tree)
        return tree_map(lambda la, x: self.spec(la, tuple(x.shape)),
                        logical_tree, tree)

    def _require_mesh(self):
        if self.mesh is None:
            raise ShardingRuleError(
                'this Partitioner has no mesh bound — build it with '
                'Partitioner(rules, mesh=...) or from_strategy()')
        return self.mesh

    def place(self, tree, logical_tree):
        """This rank's blocks of a tree of global tensors."""
        mesh = self._require_mesh()
        specs = self.tree_specs(logical_tree)
        return tree_map(lambda x, s: shard(x, s, mesh), tree, specs)

    def place_batch(self, arr, logical=None):
        """This rank's block of one batch tensor (dim 0 'batch')."""
        logical = logical or ('batch',) + (None,) * (arr.ndim - 1)
        return shard(arr, self.spec(logical), self._require_mesh())

    def data_axes(self):
        """Mesh axes backing gradient and optimizer (ZeRO) sharding:
        whatever 'batch' resolves to, plus 'sharding' when > 1."""
        axes = []
        for name, ax in self.rules:
            if name == 'batch' and ax is not None:
                axes += list(_axes(ax))
                break
        if self.mesh is not None:
            if (self.mesh.shape.get('sharding', 1) > 1
                    and 'sharding' not in axes):
                axes.append('sharding')
            axes = [a for a in axes if self.mesh.shape.get(a, 1) > 1]
        return tuple(axes) or ('dp',)

    def zero_specs(self, tree):
        from . import zero
        return zero.zero_specs(tree, self._require_mesh(), self.data_axes())

    def place_zero(self, tree):
        from . import zero
        return zero.place(tree, self._require_mesh(), self.data_axes())

    @classmethod
    def from_strategy(cls, strategy, mesh=None):
        """Compile a fleet DistributedStrategy into (rules, mesh),
        validating its degrees against the world first."""
        from ..distributed import get_world_size
        from ..distributed.topology import (HybridTopology, get_topology,
                                            set_topology)
        deg = strategy.validate_degrees(get_world_size())
        if mesh is None:
            topo = get_topology()
            if any(topo.axis_size(a) < d for a, d in deg.items() if d > 1):
                topo = set_topology(HybridTopology(**deg))
            mesh = topo.mesh
        rules = list(DEFAULT_RULES)
        if deg['sharding'] > 1:
            # the ZeRO 'sharding' axis also carries the batch
            rules[0] = ('batch', ('dp', 'sharding'))
        return cls(rules=tuple(rules), mesh=mesh)


def model_rules(mp=1, pp=1, sp=1, ep=1, explicit=False):
    """Rules table of the in-tree transformer models: the GSPMD table
    (``explicit=False``: vocab and heads over 'mp') or the explicit-
    collective one (vocab replicated, 'mp'/'pp'/'sp' only where > 1). The
    port's train step runs the explicit route for every layout."""
    if explicit:
        mp_ax = 'mp' if mp > 1 else None
        vocab_ax = None
    else:
        mp_ax = 'mp'
        vocab_ax = 'mp'
    return (
        ('batch', 'dp'),
        ('length', 'sp' if sp > 1 else None),
        ('vocab', vocab_ax),
        ('heads', mp_ax),
        ('mlp', mp_ax),
        ('expert', 'ep'),
        ('layers', 'pp' if pp > 1 else None),
        ('embed', None),
        ('kv_heads', mp_ax),
        ('kv_pages', None),
    )


def tree_specs(rules, logical_tree, mesh=None):
    """``Partitioner(rules, mesh).tree_specs(logical_tree)``."""
    return Partitioner(rules=rules, mesh=mesh).tree_specs(logical_tree)


def data_axes(rules, mesh=None):
    return Partitioner(rules=rules, mesh=mesh).data_axes()


def from_strategy(strategy, mesh=None):
    return Partitioner.from_strategy(strategy, mesh)


def _block(mesh, entry):
    """(number of blocks, this rank's block) of a dim sharded over the
    axes of ``entry`` (the first axis is the major one)."""
    n, idx = 1, 0
    for a in _axes(entry):
        size = mesh.shape.get(a, 1)
        idx = idx * size + mesh.axis_index(a)
        n *= size
    return n, idx


def shard(x, spec, mesh):
    """This rank's block of the global tensor ``x`` under ``spec`` (what
    the reference's ``device_put(x, NamedSharding(mesh, spec))`` holds on
    this rank's device), contiguous."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n, idx = _block(mesh, entry)
        if n > 1:
            if x.shape[d] % n:
                raise ShardingRuleError(
                    f'dim {d} of shape {tuple(x.shape)} does not divide '
                    f'mesh degree {n} for {entry!r}')
            x = x.chunk(n, dim=d)[idx]
    return x.contiguous()


def unshard(x, spec, mesh):
    """The global tensor from every rank's block (``shard``'s inverse),
    all-gathered over each sharded dim's axes."""
    for d, entry in reversed(list(enumerate(spec))):
        if entry is None:
            continue
        for a in reversed(_axes(entry)):
            if mesh.shape.get(a, 1) > 1:
                x = all_gather_axis(x, mesh.group(a), dim=d)
    return x


def shard_tree(tree, specs, mesh):
    return tree_map(lambda x, s: shard(x, s, mesh), tree, specs)


def unshard_tree(tree, specs, mesh):
    return tree_map(lambda x, s: unshard(x, s, mesh), tree, specs)

