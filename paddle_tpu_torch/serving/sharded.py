"""Mesh-sharded serving replicas: one engine over N shards.

Port of ``paddle_tpu/serving/sharded.py``. ``MeshReplica`` serves one
model over an mp=N mesh (``parallel/mesh_engine.py``):

 - the engine's two captured functions (the padded batch-1 prefill and
   the fixed-slot step; an ``InferenceEngine``'s buckets) run the model's
   mesh forward: each shard its heads and FFN columns, the partials
   summed;
 - the parameters are placed by the logical-axis rules table (Megatron's
   column/row layout from 'heads' / 'mlp' / 'vocab');
 - the paged KV pool is split on its heads (``kv_heads -> mp``) while the
   page tables and the refcounted allocator stay host-side: one logical
   page is N head shards, so admission, eviction, copy-on-write and the
   prefix cache are the mp=1 code.

An mp=N replica looks like an mp=1 one to every control plane: two
captures a GenerationEngine, streams that depend on (seed, position)
only (a failover between replicas of different degrees regenerates the
same tokens), ``ModelHost`` admission by the bytes each device holds, and
the engine's own labels unchanged (the degree is a gauge of its own).

One process drives the shards. ``devices=`` places them (default: the
first N cards; ``[d] * N`` is a virtual mesh on one device, the only
form one card can run).

Usage::

    from paddle_tpu_torch.serving import MeshReplica
    rep = MeshReplica(params, cfg, mp=2, devices=['cuda:0'] * 2,
                      num_slots=8, page_size=128)
    rep.warmup()
    fut = rep.submit(prompt, max_new_tokens=64, seed=7)

or, for fleet and host factories that want a plain engine::

    engine = sharded_generation_engine(params, cfg, mp=2, num_slots=8)
"""
from ..parallel import mesh_engine as _mesh
from .engine import InferenceEngine
from .generation import GenerationEngine

__all__ = ['MeshReplica', 'sharded_generation_engine',
           'sharded_inference_engine']


def sharded_generation_engine(net, config=None, *, mp, devices=None,
                              rules=None, **kwargs):
    """A GenerationEngine whose prefill and step span an mp-way mesh (mp=1
    gives a plain single-device engine, same API)."""
    ctx = _context(mp, devices, rules)
    return GenerationEngine(net, config, mesh=ctx, **kwargs)


def sharded_inference_engine(net, *, mp, devices=None, rules=None,
                             **kwargs):
    """An InferenceEngine whose buckets span an mp-way mesh."""
    ctx = _context(mp, devices, rules)
    return InferenceEngine(net, mesh=ctx, **kwargs)


def _context(mp, devices, rules):
    mp = int(mp)
    if mp <= 1:
        return None
    return _mesh.MeshContext.build(mp, devices=devices, rules=rules)


class MeshReplica:
    """One serving replica over ``mp`` shards, answering as the engine it
    wraps (attribute access delegates), plus the mesh surface:
    ``.mesh_ctx``, ``.mp`` and per-shard figures in ``stats()``.

    ``kind='generation'`` (default) wraps a continuous-batching
    GenerationEngine, ``kind='inference'`` a dynamic-batching
    InferenceEngine. The other keyword arguments go to the engine."""

    def __init__(self, net, config=None, *, mp=1, kind='generation',
                 devices=None, rules=None, **kwargs):
        if kind not in ('generation', 'inference'):
            raise ValueError(
                f"MeshReplica kind must be 'generation' or 'inference', "
                f"got {kind!r}")
        self.kind = kind
        if kind == 'generation':
            self.engine = sharded_generation_engine(
                net, config, mp=mp, devices=devices, rules=rules, **kwargs)
        else:
            if config is not None:
                raise TypeError(
                    'inference MeshReplica takes a Layer/Model/Predictor, '
                    'not a (params, config) pair')
            self.engine = sharded_inference_engine(
                net, mp=mp, devices=devices, rules=rules, **kwargs)

    # ---- mesh surface ----------------------------------------------------
    @property
    def mesh_ctx(self):
        return _mesh.mesh_of(self.engine)

    @property
    def mp(self):
        ctx = self.mesh_ctx
        return ctx.mp if ctx is not None else 1

    def stats(self):
        """The engine's stats and ``per_chip_tokens_per_sec``: one stream
        of tokens comes out of the whole mesh, so the per-shard rate is
        the comparison across mesh sizes."""
        out = self.engine.stats()
        n = max(1, _mesh.mesh_size(self.engine))
        tps = out.get('tokens_per_sec')
        if tps is not None:
            out['per_chip_tokens_per_sec'] = round(tps / n, 2)
        return out

    # ---- engine delegation ----------------------------------------------
    def __getattr__(self, name):
        return getattr(self.engine, name)

    def __enter__(self):
        self.engine.start()
        return self

    def __exit__(self, *exc):
        self.engine.shutdown()
        return False
