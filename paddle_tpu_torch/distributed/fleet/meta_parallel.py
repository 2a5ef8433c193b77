"""Meta-parallel layers: tensor-parallel and pipeline building blocks.

Port of ``paddle_tpu/distributed/fleet/meta_parallel.py:1-222``
(reference: python/paddle/distributed/fleet/meta_parallel/parallel_layers/
mp_layers.py and pp_layers.py).

The reference keeps each layer's full logical weight and lets GSPMD split
it over 'mp' by its ``logical_axes``. Here a rank holds its block of each
annotated parameter over the process topology's mp group, the spec
resolved from the same ``logical_axes`` by the partitioner, and the
forward runs Megatron's collectives by hand:

 - ``ColumnParallelLinear``: weight [in, out/mp] ('embed', 'mlp'), bias
   [out/mp]; f (identity forward, all-reduce backward) on the input; with
   ``gather_output`` the columns are all-gathered (backward: this rank's
   slice), else the output is this rank's out/mp columns (upstream
   Paddle's ``output_size_per_partition``);
 - ``RowParallelLinear``: weight [in/mp, out] ('mlp', 'embed'); the input
   is this rank's columns (``input_is_parallel``) or is split to them; g
   (all-reduce forward, identity backward) on the product, then the bias
   once, after the sum;
 - ``VocabParallelEmbedding``: weight [V/mp, H] ('vocab', 'embed'); each
   rank looks up the ids in its range, zeroes the rest, all-reduces.

Low-precision partials are summed in f32 (gloo sums bf16 in bf16; the
reference's psum rounds once). At mp = 1 each layer is the reference's
layer exactly. Initialization draws the full logical weight (so the
fans, and the generator's draws, are the reference's) and keeps this
rank's block; ``Layer.state_dict`` all-gathers the full tensors and
``set_state_dict`` slices them (``parallel.parallelize.ShardInfo``).

The same forward serves a Layer on a serving mesh
(``serving.InferenceEngine(mesh=)``): one process drives the shards, a
split parameter is a ``parallel.mesh_engine.ShardTensor`` of its blocks
(every op on it runs block by block), and the collectives are the
mesh's: g sums the shards' partials with ``MeshContext.psum``, the
gather concatenates the blocks.

Pipeline layers (``LayerDesc``, ``PipelineLayer``) and the wrappers
(``TensorParallel``, ``ShardingParallel``, ``PipelineParallel``) are the
reference's: a PipelineLayer runs its stages in order in one process
(the port's pipeline schedules are ``parallel.pipeline``'s, step K1).
"""
import contextlib

import torch

from ...core.dispatch import apply_op
from ...nn.layer_base import Layer
from ...nn import initializer as I
from ...nn import functional as F
from ..topology import get_topology

_LOW = (torch.bfloat16, torch.float16)


# ---------------------------------------------------------------------------
# the collectives: the mp group's (autograd Functions) or a serving mesh's
# ---------------------------------------------------------------------------

def _wide(fn, x, grp):
    """``fn`` on ``x`` summed in f32 when it is bf16 / fp16."""
    if x.dtype in _LOW:
        return fn(x.float(), grp).to(x.dtype)
    return fn(x, grp)


class _GatherLast(torch.autograd.Function):
    """All-gather along the last dim; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, x, grp):
        from ..collective import all_gather_axis
        ctx.grp = grp
        return all_gather_axis(x.contiguous(), grp, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n, i = ctx.grp.nranks, ctx.grp.index
        return g.chunk(n, dim=-1)[i].contiguous(), None


class _SplitLast(torch.autograd.Function):
    """This rank's slice of the last dim; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.chunk(grp.nranks, dim=-1)[grp.index].contiguous()

    @staticmethod
    def backward(ctx, g):
        from ..collective import all_gather_axis
        return all_gather_axis(g.contiguous(), ctx.grp, dim=-1), None


class GroupComm:
    """Megatron's collectives over the mp ``Group`` (torch tensors in,
    torch tensors out, differentiable)."""

    def __init__(self, grp):
        self.grp = grp
        self.n = grp.nranks
        self.index = grp.index

    def f(self, x):
        from ...parallel.tp_ad import f_identity
        return _wide(f_identity, x, self.grp)

    def g(self, x):
        from ...parallel.tp_ad import g_allreduce
        return _wide(g_allreduce, x, self.grp)

    def gather_last(self, x):
        return _GatherLast.apply(x, self.grp)

    def split_last(self, x):
        return _SplitLast.apply(x, self.grp)

    def offset(self, per, like):
        return torch.full((), self.index * per, dtype=like.dtype,
                          device=like.device)


class MeshComm:
    """The same collectives over a serving mesh's shards: split tensors
    are ``ShardTensor``s, one block a shard."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.n = ctx.size

    def f(self, x):
        return x

    def g(self, x):
        total = self.ctx.psum([b.float() if b.dtype in _LOW else b
                               for b in x.blocks])
        return total[x.blocks[0].device].to(x.dtype)

    def gather_last(self, x):
        dev = x.blocks[0].device
        return torch.cat([b.to(dev) for b in x.blocks], dim=-1)

    def split_last(self, x):
        from ...parallel.mesh_engine import ShardTensor
        return ShardTensor([c.to(d).contiguous() for c, d in zip(
            x.chunk(self.n, dim=-1), self.ctx.devices)], self.ctx)

    def offset(self, per, like):
        from ...parallel.mesh_engine import ShardTensor
        return ShardTensor([torch.full((), i * per, dtype=like.dtype,
                                       device=d)
                            for i, d in enumerate(self.ctx.devices)],
                           self.ctx)


def _comm(weight):
    """The collectives a layer's forward takes from its weight: a serving
    mesh's (a ``ShardTensor`` value), the mp group's (a block of a
    ``ShardInfo``), or None (mp = 1: the reference's layer)."""
    from ...parallel.mesh_engine import ShardTensor
    v = weight._value
    if isinstance(v, ShardTensor):
        return MeshComm(v.ctx)
    info = getattr(weight, '_dist', None)
    grp = info.group('mp') if info is not None else None
    return GroupComm(grp) if grp is not None and grp.nranks > 1 else None


def _mp_block(layer, name, full, logical_axes):
    """The Parameter ``name`` made from a full logical tensor: annotated
    with ``logical_axes``, and cut to this rank's block over the process
    topology's mp group when its spec splits it."""
    from ...parallel.parallelize import place_param
    from ...parallel.partitioner import Partitioner
    full.logical_axes = logical_axes
    mesh = get_topology().mesh
    if mesh.shape.get('mp', 1) > 1:
        spec = Partitioner(mesh=mesh).spec(logical_axes,
                                           tuple(full._value.shape))
        place_param(full, spec, mesh)
    setattr(layer, name, full)
    return full


class ColumnParallelLinear(Layer):
    """Weight [in, out] split on its columns over mp ('embed', 'mlp')."""

    _mp_layer = True

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        _mp_block(self, 'weight', self.create_parameter(
            (in_features, out_features), weight_attr,
            default_initializer=I.XavierNormal()), ('embed', 'mlp'))
        if has_bias:
            _mp_block(self, 'bias', self.create_parameter(
                (out_features,), None, is_bias=True), ('mlp',))
        else:
            self.bias = None

    def forward(self, x):
        comm = _comm(self.weight)
        if comm is None:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(apply_op(comm.f, x), self.weight, self.bias)
        return apply_op(comm.gather_last, y) if self.gather_output else y


class RowParallelLinear(Layer):
    """Weight [in, out] split on its rows over mp ('mlp', 'embed')."""

    _mp_layer = True

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        _mp_block(self, 'weight', self.create_parameter(
            (in_features, out_features), weight_attr,
            default_initializer=I.XavierNormal()), ('mlp', 'embed'))
        self.bias = self.create_parameter((out_features,), None,
                                          is_bias=True) if has_bias else None

    def forward(self, x):
        comm = _comm(self.weight)
        if comm is None:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = apply_op(comm.split_last, x)
        y = apply_op(comm.g, F.linear(x, self.weight))
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(Layer):
    """Embedding table [V, H] split on the vocabulary over mp ('vocab',
    'embed')."""

    _mp_layer = True

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        _mp_block(self, 'weight', self.create_parameter(
            (num_embeddings, embedding_dim), weight_attr,
            default_initializer=I.Normal(0.0, 0.02)), ('vocab', 'embed'))

    def forward(self, x):
        comm = _comm(self.weight)
        if comm is None:
            return F.embedding(x, self.weight)

        def local(ids, w):
            per = w.shape[0]
            ids = ids.long()
            rel = ids - comm.offset(per, ids)
            inside = (rel >= 0) & (rel < per)
            rows = torch.nn.functional.embedding(
                torch.where(inside, rel, torch.zeros_like(rel)), w)
            return comm.g(rows * inside.unsqueeze(-1).to(rows.dtype))
        return apply_op(local, x, self.weight)


class ParallelCrossEntropy(Layer):
    """Cross entropy of full-width logits (a ``gather_output`` head), as
    the reference's."""

    def __init__(self, mp_group=None, name=None):
        super().__init__()

    def forward(self, input, label):
        return F.cross_entropy(input, label, reduction='mean')


# ---------------------------------------------------------------------------
# the serving mesh's collectives for a forward (InferenceEngine(mesh=))
# ---------------------------------------------------------------------------

def mesh_split(layer):
    """Parameter names of ``layer`` that a meta-parallel layer owns (the
    ones a serving mesh may split)."""
    names = set()
    for prefix, sub in layer.named_sublayers(include_self=True):
        if getattr(sub, '_mp_layer', False):
            for n in sub._parameters:
                names.add(f'{prefix}.{n}' if prefix else n)
    return names


# ---------------------------------------------------------------------------
# RNG tracking, pipeline descriptions, wrappers
# ---------------------------------------------------------------------------

class RNGStatesTracker:
    """Named seeds; ``rng_state`` is the reference's no-op context (the
    ranks of one mp group draw the same dropout masks from the one
    generator seed)."""

    def __init__(self):
        self._states = {}

    def add(self, name, seed):
        self._states[name] = int(seed)

    def rng_state(self, name='global_seed'):
        return contextlib.nullcontext()


_RNG_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_TRACKER


def model_parallel_random_seed(seed=None):
    from ...tensor.random import seed as set_seed
    set_seed(seed or 0)


class LayerDesc:
    """Declarative layer for PipelineLayer stages (reference
    pp_layers.py:LayerDesc)."""

    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr='weight', *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.key = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    """The full stack of LayerDescs cut into ``num_stages`` uniform
    stages (``stage_layers``); its forward runs them in order, as the
    reference's eager (pp = 1) form does."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method='uniform', recompute_interval=0, **kwargs):
        super().__init__()
        self.descs = list(layers)
        topo = get_topology()
        self.num_stages = num_stages or topo.axis_size('pp')
        self.loss_fn = loss_fn
        built = [d.build_layer() if isinstance(d, LayerDesc) else d
                 for d in self.descs]
        from ...nn.layer_container import LayerList
        self.run_function = LayerList(built)
        n = len(built)
        per = -(-n // self.num_stages)
        self.stage_bounds = [(i * per, min((i + 1) * per, n))
                             for i in range(self.num_stages)]

    def forward(self, x):
        for sub in self.run_function:
            x = sub(x)
        return x

    def stage_layers(self, stage):
        lo, hi = self.stage_bounds[stage]
        return list(self.run_function)[lo:hi]


class TensorParallel(Layer):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)


class ShardingParallel(TensorParallel):
    pass


class PipelineParallel(TensorParallel):
    pass
