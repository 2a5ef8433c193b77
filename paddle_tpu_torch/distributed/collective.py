"""Collective communication over torch.distributed.

Port of ``paddle_tpu/distributed/collective.py``. The reference's
collectives are XLA's inside a ``shard_map`` region and identities outside
one. Here a collective runs over a ``Group`` (the ranks of one mesh axis,
``topology.Mesh.group``, or the world), and with no process group
initialized, or over a group of one rank, it is the identity over the full
tensor, as the reference's are outside a parallel region
(``test_collectives_eager_identity``).

Two layers:

 - Paddle's API (``all_reduce``, ``all_gather``, ``broadcast``, ``reduce``,
   ``scatter``, ``reduce_scatter``, ``alltoall``, ``send``, ``recv``,
   ``barrier``, ``new_group``, ``get_group``, ``wait``) over port Tensors
   or torch tensors, in place where Paddle's are;
 - the axis-level ops the hybrid-parallel train step runs (``psum``,
   ``pmean``, ``pmax``, ``all_gather_axis``, ``reduce_scatter_axis``,
   ``ppermute``; ``ppermute`` and the Megatron pair in
   ``parallel/tp_ad.py`` as ``torch.autograd.Function``s whose backward is
   the transpose ``shard_map`` gives: a permutation's is its inverse).

The one-card transport. NCCL refuses two ranks of one communicator on one
device, so two ranks that share a card talk over gloo, which carries only
``all_reduce``, ``broadcast`` and ``barrier`` on CUDA tensors. Every other
op of a gloo group on a CUDA tensor (point to point, all-gather,
all-to-all, reduce-scatter as an all-reduce and a slice) goes through
pinned host buffers: the tensor is copied to the host, the op runs on the
host copies, the result is copied back. The choice is made from (backend,
op) by ``_staged``, before any call, never after a failed one; a group
counts what it staged (``staged_calls``, ``staged_bytes``: both
directions). On NCCL nothing is staged.

Fault injection: ``all_reduce``, ``all_gather``, ``broadcast``,
``reduce_scatter``, ``alltoall`` and ``barrier`` fire the
``collective.entry`` point on entry, as the reference's do.
"""
import torch
import torch.distributed as dist

from ..core.tensor import Tensor
from ..fault.inject import inject


class ReduceOp:
    SUM = 'sum'
    MAX = 'max'
    MIN = 'min'
    PROD = 'prod'
    AVG = 'avg'


_TORCH_OP = {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX,
             'min': dist.ReduceOp.MIN, 'prod': dist.ReduceOp.PRODUCT}

# what gloo carries on CUDA tensors (PyTorch's backend table); the rest of
# a gloo group's ops on CUDA tensors go through the host
GLOO_CUDA_OPS = frozenset({'all_reduce', 'broadcast'})


class Group:
    """The ranks of one collective: ``ranks`` (global, in axis order),
    ``nranks``, ``index`` (this rank's position), the torch process group
    (None for one rank) and its backend; ``calls`` counts the collectives
    it ran, ``staged_calls`` / ``staged_bytes`` the host staging of the
    one-card transport."""

    def __init__(self, ranks, pg, rank):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.pg = pg
        self.index = self.ranks.index(rank)
        self.backend = (dist.get_backend(pg) if pg is not None else None)
        self.staged_calls = 0
        self.staged_bytes = 0
        self.calls = 0

    def __repr__(self):
        return f'Group(ranks={self.ranks}, backend={self.backend})'


def _staged(grp, op, device):
    """True where (backend, op) on a CUDA tensor has no gloo path: the op
    then runs on host copies (counted as one staged call)."""
    staged = (device.type == 'cuda' and grp.backend == 'gloo'
              and op not in GLOO_CUDA_OPS)
    grp.calls += 1
    grp.staged_calls += int(staged)
    return staged


def _to_host(grp, x):
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    grp.staged_bytes += x.numel() * x.element_size()
    return h


def _to_device(grp, h, like):
    grp.staged_bytes += h.numel() * h.element_size()
    return h.to(like.device)


def world_group():
    """The default group as a ``Group`` (None without one)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return Group(range(dist.get_world_size()), dist.group.WORLD,
                 dist.get_rank())


def _resolve(group):
    """A ``Group``, a mesh axis name (of the process topology's mesh),
    or None (the world)."""
    if isinstance(group, Group):
        return group
    if isinstance(group, (str, tuple)):
        from .topology import get_mesh
        return get_mesh().group(group)
    if group is None:
        return world_group()
    raise TypeError(f'not a group: {group!r}')


def _single(grp):
    return grp is None or grp.nranks == 1


# ---------------------------------------------------------------------------
# tensor-level primitives (new tensors; the inputs are not written)
# ---------------------------------------------------------------------------

def reduce_tensor(x, grp, op='sum'):
    """The elementwise reduction of ``x`` over the group (``op`` 'sum',
    'max', 'min', 'prod' or 'avg')."""
    if _single(grp):
        return x.clone()
    out = x.detach().clone().contiguous()
    red = 'sum' if op == 'avg' else op
    if _staged(grp, 'all_reduce', out.device):
        h = _to_host(grp, out)
        dist.all_reduce(h, op=_TORCH_OP[red], group=grp.pg)
        out = _to_device(grp, h, out)
    else:
        dist.all_reduce(out, op=_TORCH_OP[red], group=grp.pg)
    if op == 'avg':
        out = out / grp.nranks
    return out


def gather_tensor(x, grp):
    """[nranks, *x.shape]: every rank's ``x`` in axis order."""
    if _single(grp):
        return x[None].clone()
    x = x.detach().contiguous()
    src = _to_host(grp, x) if _staged(grp, 'all_gather', x.device) else x
    outs = [torch.empty_like(src) for _ in range(grp.nranks)]
    dist.all_gather(outs, src, group=grp.pg)
    out = torch.stack(outs)
    return _to_device(grp, out, x) if src is not x else out


def broadcast_tensor(x, grp, src=0):
    """Rank ``src`` (axis position)'s ``x`` on every rank."""
    if _single(grp):
        return x.clone()
    out = x.detach().clone().contiguous()
    if _staged(grp, 'broadcast', out.device):
        h = _to_host(grp, out)
        dist.broadcast(h, grp.ranks[src], group=grp.pg)
        return _to_device(grp, h, out)
    dist.broadcast(out, grp.ranks[src], group=grp.pg)
    return out


def exchange(grp, sends, recvs):
    """Point to point in one batch: ``sends`` [(tensor, dst position)],
    ``recvs`` [(shape, dtype, src position, device)] -> the received
    tensors, each on its ``device``. On gloo with CUDA tensors both sides
    go through pinned host buffers."""
    if not sends and not recvs:
        return []
    dev = sends[0][0].device if sends else recvs[0][3]
    staged = _staged(grp, 'p2p', dev)
    ops, bufs = [], []
    for t, dst in sends:
        t = t.detach().contiguous()
        t = _to_host(grp, t) if staged else t
        ops.append(dist.P2POp(dist.isend, t, grp.ranks[dst], group=grp.pg))
    for shape, dtype, src, device in recvs:
        b = (torch.empty(shape, dtype=dtype, pin_memory=True) if staged
             else torch.empty(shape, dtype=dtype, device=device))
        bufs.append((b, device))
        ops.append(dist.P2POp(dist.irecv, b, grp.ranks[src], group=grp.pg))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        out = []
        for b, device in bufs:
            grp.staged_bytes += b.numel() * b.element_size()
            out.append(b.to(device))
        return out
    return [b for b, _ in bufs]


def ppermute_tensors(xs, grp, perm):
    """The reference's ``lax.ppermute`` of each tensor in ``xs`` over the
    group: ``perm`` is [(src position, dst position)]; a position that
    receives nothing gets zeros. One batch of point-to-point ops."""
    if _single(grp):
        return [x.clone() if (0, 0) in perm else torch.zeros_like(x)
                for x in xs]
    me = grp.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    sends = [(x, dst[0]) for x in xs] if dst else []
    recvs = ([(x.shape, x.dtype, src[0], x.device) for x in xs] if src
             else [])
    got = exchange(grp, sends, recvs)
    return got if src else [torch.zeros_like(x) for x in xs]


def ring_perm(n, shift=1):
    """[(i, (i + shift) % n)]: the ring rotation by ``shift``."""
    return [(i, (i + shift) % n) for i in range(n)]


def inverse(perm):
    return [(d, s) for s, d in perm]


# ---------------------------------------------------------------------------
# axis-level ops of the train step: ``axis`` is a ``Group``, a mesh axis
# name of the process topology (``topology.get_mesh``), or None (one rank)
# ---------------------------------------------------------------------------

def _axis(axis):
    return _resolve(axis) if isinstance(axis, (str, tuple)) else axis


def psum(x, axis):
    return reduce_tensor(x, _axis(axis), 'sum')


def pmean(x, axis):
    return reduce_tensor(x, _axis(axis), 'avg')


def pmax(x, axis):
    return reduce_tensor(x, _axis(axis), 'max')


def all_gather_axis(x, axis, dim=0):
    """Every rank's ``x`` concatenated along ``dim`` in axis order (the
    reference's ``all_gather(..., tiled=True)``)."""
    g = gather_tensor(x, _axis(axis))
    return torch.cat(g.unbind(0), dim=dim)


def reduce_scatter_axis(x, axis, dim=0, op='sum'):
    """The reduction of ``x`` over the axis, this rank's block of ``dim``
    kept (the reference's ``psum_scatter(..., tiled=True)``)."""
    grp = _axis(axis)
    total = reduce_tensor(x, grp, op)
    if _single(grp):
        return total
    return total.chunk(grp.nranks, dim=dim)[grp.index].contiguous()


class _PPermute(torch.autograd.Function):
    """ppermute with the inverse permutation as its backward."""

    @staticmethod
    def forward(ctx, grp, perm, *xs):
        ctx.grp, ctx.perm = grp, perm
        return tuple(ppermute_tensors(list(xs), grp, perm))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        back = ppermute_tensors(gs, ctx.grp, inverse(ctx.perm))
        return (None, None, *back)


def ppermute(xs, axis, perm=None, shift=1):
    """Differentiable ppermute of a tensor or a tuple of tensors over
    ``axis`` (``perm`` [(src, dst)] positions, or the ring rotation by
    ``shift``)."""
    grp = _axis(axis)
    one = torch.is_tensor(xs)
    xs = (xs,) if one else tuple(xs)
    n = 1 if grp is None else grp.nranks
    perm = ring_perm(n, shift) if perm is None else perm
    out = _PPermute.apply(grp, perm, *xs)
    return out[0] if one else out


# ---------------------------------------------------------------------------
# Paddle's API
# ---------------------------------------------------------------------------

def _raw(t):
    return t._value if isinstance(t, Tensor) else torch.as_tensor(t)


def _put(tensor, value):
    """Paddle writes the result into ``tensor``; a port Tensor rebinds,
    a torch tensor is copied into."""
    if isinstance(tensor, Tensor):
        tensor._replace_value(value)
        return tensor
    if torch.is_tensor(tensor):
        with torch.no_grad():
            tensor.copy_(value)
        return tensor
    return value


def all_reduce(tensor, op=ReduceOp.SUM, group=None, use_calc_stream=True):
    inject('collective.entry')
    return _put(tensor, reduce_tensor(_raw(tensor), _resolve(group), op))


def all_gather(tensor_list, tensor, group=None, use_calc_stream=True,
               axis=0):
    inject('collective.entry')
    out = gather_tensor(_raw(tensor), _resolve(group))
    if tensor_list is not None:
        wrap = isinstance(tensor, Tensor)
        for i in range(out.shape[0]):
            tensor_list.append(Tensor(out[i]) if wrap else out[i])
        return tensor_list
    return Tensor(out) if isinstance(tensor, Tensor) else out


def broadcast(tensor, src=0, group=None, use_calc_stream=True):
    inject('collective.entry')
    grp = _resolve(group)
    pos = grp.ranks.index(src) if grp is not None and src in grp.ranks else 0
    return _put(tensor, broadcast_tensor(_raw(tensor), grp, pos))


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, use_calc_stream=True):
    """Every rank gets the reduction (as the reference's)."""
    return all_reduce(tensor, op, group, use_calc_stream)


def scatter(tensor, tensor_list=None, src=0, group=None,
            use_calc_stream=True):
    grp = _resolve(group)
    if _single(grp):
        if tensor_list:
            _put(tensor, _raw(tensor_list[0]))
        return tensor
    pos = grp.ranks.index(src)
    if grp.index == pos:
        stacked = torch.stack([_raw(t) for t in tensor_list])
    else:
        x = _raw(tensor)
        stacked = torch.zeros((grp.nranks,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device)
    full = broadcast_tensor(stacked, grp, pos)
    return _put(tensor, full[grp.index])


def reduce_scatter(output, input_list, op=ReduceOp.SUM, group=None):
    inject('collective.entry')
    grp = _resolve(group)
    stacked = torch.cat([_raw(t) for t in input_list])
    out = (stacked.clone() if _single(grp)
           else reduce_scatter_axis(stacked, grp, 0, op))
    if output is not None:
        return _put(output, out)
    return out


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             use_calc_stream=True):
    """Rank i's j-th tensor goes to rank j's i-th slot."""
    inject('collective.entry')
    grp = _resolve(group)
    xs = [_raw(t) for t in in_tensor_list]
    stacked = torch.stack(xs)
    if _single(grp):
        res = list(stacked.unbind(0))
    else:
        every = gather_tensor(stacked, grp)       # [n(src), n(dst), ...]
        res = list(every[:, grp.index].unbind(0))
    if in_tensor_list and isinstance(in_tensor_list[0], Tensor):
        res = [Tensor(r) for r in res]
    if out_tensor_list is not None:
        out_tensor_list.extend(res)
        return out_tensor_list
    return res


def send(tensor, dst=0, group=None, use_calc_stream=True):
    grp = _resolve(group)
    if _single(grp):
        return tensor
    exchange(grp, [(_raw(tensor), grp.ranks.index(dst))], [])
    return tensor


def recv(tensor, src=0, group=None, use_calc_stream=True):
    grp = _resolve(group)
    if _single(grp):
        return tensor
    x = _raw(tensor)
    (got,) = exchange(grp, [], [(x.shape, x.dtype, grp.ranks.index(src),
                                 x.device)])
    return _put(tensor, got)


def barrier(group=None):
    inject('collective.entry')
    grp = _resolve(group)
    if not _single(grp):
        dist.barrier(group=grp.pg)


def new_group(ranks=None, backend=None):
    """A ``Group`` over ``ranks`` (default: the world). Every rank of the
    world calls it, as ``torch.distributed.new_group`` asks; a rank not in
    ``ranks`` gets None. Without a process group: a group of this process."""
    if not (dist.is_available() and dist.is_initialized()):
        return Group([0], None, 0)
    ranks = list(range(dist.get_world_size())) if ranks is None else list(
        ranks)
    pg = dist.new_group(ranks, backend=backend) if len(ranks) > 1 else None
    me = dist.get_rank()
    return Group(ranks, pg, me) if me in ranks else None


def get_group(gid=0):
    return world_group() or Group([0], None, 0)


def wait(tensor, group=None, use_calc_stream=True):
    x = _raw(tensor)
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    return tensor
