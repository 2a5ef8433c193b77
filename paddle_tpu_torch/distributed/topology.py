"""Device-mesh topology for hybrid parallelism over torch.distributed.

Port of ``paddle_tpu/distributed/topology.py``. The reference is one
process driving a ``jax.sharding.Mesh`` whose named axes ``shard_map``
reduces over. The port is one process per rank, PyTorch's idiom: the
ranks of the default process group are laid out on the reference's axes
in its order, ``('pp', 'dp', 'sharding', 'ep', 'sp', 'mp')`` (mp and sp
innermost), and each axis gets one subgroup: the ranks that differ from
this one only along that axis. Every rank builds the same subgroups in
the same order (``torch.distributed.new_group`` must be called by all
ranks of the default group), so a ``HybridTopology`` is made by every rank
at the same point of its program.

With no process group initialized the world is this one process: every
axis has size 1 and every collective over it is the identity, as the
reference's are outside a parallel region.
"""
import numpy as np
import torch.distributed as dist

from .collective import Group

_AXIS_ORDER = ('pp', 'dp', 'sharding', 'ep', 'sp', 'mp')

_current = None


def _world():
    """(world size, this rank) of the default group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """The ranks laid out on named axes, with one ``Group`` an axis.

    ``shape``: axis name -> size (every name of the reference's order);
    ``axis_names``; ``rank`` (this process's global rank);
    ``axis_index(name)``, ``axis_size(name)``, ``group(name)`` (or a tuple
    of names: the ranks that differ along any of them). ``staged()``: the
    calls and bytes the one-card transport staged through the host over
    this mesh's groups (``collective.Group``)."""

    axis_names = _AXIS_ORDER

    def __init__(self, degrees, ranks=None):
        self.shape = {a: int(degrees.get(a, 1)) for a in _AXIS_ORDER}
        size = int(np.prod(list(self.shape.values())))
        world, self.rank = _world()
        ranks = list(range(size)) if ranks is None else list(ranks)
        if len(ranks) != size or size > world:
            raise ValueError(f'mesh {self.shape} needs {size} ranks, got '
                             f'{len(ranks)} of a world of {world}')
        self.ranks = np.asarray(ranks).reshape(
            [self.shape[a] for a in _AXIS_ORDER])
        where = np.argwhere(self.ranks == self.rank)
        self.coords = (dict(zip(_AXIS_ORDER, (int(c) for c in where[0])))
                       if len(where) else None)
        self._groups = {}
        for a in _AXIS_ORDER:
            self._groups[(a,)] = self._build((a,))

    def _build(self, axes):
        """Every rank creates every subgroup along ``axes`` (in one order
        on all ranks); this rank keeps its own."""
        moved = np.moveaxis(self.ranks, [_AXIS_ORDER.index(a) for a in axes],
                            list(range(len(axes))))
        n = int(np.prod([self.shape[a] for a in axes]))
        mine = None
        rows = moved.reshape(n, -1).T
        for members in rows:
            members = [int(r) for r in members]
            pg = dist.new_group(members) if n > 1 else None
            if self.rank in members:
                mine = Group(members, pg, self.rank)
        return mine

    @property
    def size(self):
        return int(self.ranks.size)

    def axis_size(self, name):
        return self.shape.get(name, 1)

    def axis_index(self, name):
        if self.coords is None:
            raise ValueError(f'rank {self.rank} is not in this mesh')
        return self.coords[name]

    def group(self, axes):
        """This rank's ``Group`` along one axis name or a tuple of them."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        if key not in self._groups:
            if any(a not in _AXIS_ORDER for a in key):
                raise ValueError(f'unknown mesh axes {key}')
            self._groups[key] = self._build(key)
        return self._groups[key]

    def staged(self):
        """{'calls', 'bytes'} the host staging moved over these groups."""
        seen = {id(g): g for g in self._groups.values() if g is not None}
        return {'calls': sum(g.staged_calls for g in seen.values()),
                'bytes': sum(g.staged_bytes for g in seen.values())}

    def reset_staged(self):
        for g in self._groups.values():
            if g is not None:
                g.staged_calls = g.staged_bytes = 0

    def __repr__(self):
        return (f'Mesh({ {a: s for a, s in self.shape.items() if s > 1} }, '
                f'rank={self.rank})')


class HybridTopology:
    """Hybrid-parallel degrees over the world's ranks (``ranks``: the
    global ranks to lay out, default all). The reference's rule: degrees
    whose product is smaller than the rank count and divides it grow dp to
    cover the ranks; a product larger than it raises."""

    def __init__(self, dp=1, mp=1, pp=1, sharding=1, sp=1, ep=1,
                 ranks=None):
        world, _ = _world()
        ranks = list(range(world)) if ranks is None else list(ranks)
        degrees = {'dp': dp, 'mp': mp, 'pp': pp, 'sharding': sharding,
                   'sp': sp, 'ep': ep}
        need = int(np.prod(list(degrees.values())))
        if need > len(ranks):
            raise ValueError(f'hybrid degrees {degrees} need {need} ranks, '
                             f'have {len(ranks)}')
        if need < len(ranks) and len(ranks) % need == 0:
            # grow dp to cover all ranks (paddle fleet default behavior)
            degrees['dp'] *= len(ranks) // need
            need = len(ranks)
        self.degrees = degrees
        self.mesh = Mesh(degrees, ranks[:need])

    def axis_size(self, name):
        return self.degrees.get(name, 1)

    def axis_index(self, name):
        return self.mesh.axis_index(name)


def set_topology(topo):
    global _current
    _current = topo
    return topo


def get_topology():
    global _current
    if _current is None:
        _current = HybridTopology()
    return _current


def get_mesh():
    return get_topology().mesh
