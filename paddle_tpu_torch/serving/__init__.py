"""paddle_tpu_torch.serving: dynamic-batching inference and
continuous-batching LLM serving on the card (port of
``paddle_tpu/serving``).

The batch path: an ``InferenceEngine`` in front of a bucketed cache of
captured CUDA graphs. Requests of uneven size (``submit()`` returns a
future) are coalesced on a background dispatch thread into padded
power-of-two buckets, so the whole request stream is served by at most
``ceil(log2(max_batch)) + 1`` graphs per input signature::

    from paddle_tpu_torch import serving
    engine = serving.InferenceEngine(net, max_batch_size=16, max_delay_ms=2)
    engine.warmup('all_buckets', input_spec=[((128,), 'int64')])
    fut = engine.submit(x)            # x: [n, ...], n >= 1
    y = fut.result(timeout=1.0)
    print(engine.stats())             # p50/p99, pad waste, occupancy, ...
    engine.shutdown()

The LLM path: ``GenerationEngine`` (continuous batching over the paged KV
pool)::

    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig(vocab_size=32768, hidden_size=1024, num_layers=24,
                        num_heads=16, max_seq_len=1024, dtype='bfloat16')
    gen = torch.Generator(device='cuda').manual_seed(0)
    params = gpt.init_params(cfg, gen, 'cuda')
    with serving.GenerationEngine(params, cfg, num_slots=8,
                                  page_size=128) as eng:
        eng.warmup()
        toks = eng.submit(prompt_ids, max_new_tokens=32).result()

``GenerationEngine(..., precision='int8_wo')`` serves weight-only int8
matrices; ``prefix_cache=True`` reuses the KV pages of earlier requests
(``PrefixCache``).

The control planes: ``ReplicaSet`` / ``FleetRouter`` / ``Autoscaler``
(``fleet.py``: replicas of one model behind one front door, failover,
shedding, warm scale-up) and ``ModelHost`` (``host.py``: several models
under one device-memory watermark, LRU eviction and swap-in, lanes and
tenant quotas, ``model@host`` targets)::

    rs = serving.ReplicaSet(lambda: serving.GenerationEngine(
        params, cfg, num_slots=8, page_size=128), initial=2)
    router = serving.FleetRouter(rs)
    toks = router.submit(prompt_ids, max_new_tokens=32).result()

Mesh-sharded serving (``sharded.py``): ``MeshReplica``,
``sharded_generation_engine`` and ``sharded_inference_engine`` serve one
model over an mp=N mesh of shards that one process drives
(``parallel/mesh_engine.py``)::

    eng = serving.sharded_generation_engine(
        params, cfg, mp=2, devices=['cuda:0'] * 2, num_slots=8)
"""
from .bucketing import (bucket_for, bucket_sizes, input_signature,  # noqa: F401
                        pad_rows)
from .bucket_cache import BucketCompileCache  # noqa: F401
from .errors import (DeadlineExceededError, EngineClosedError,  # noqa: F401
                     HBMAdmissionError, QueueFullError)
from .metrics import ServingStats  # noqa: F401
from .engine import InferenceEngine  # noqa: F401
from .generation import GenerationEngine, GenerationFuture  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401
from .host import (HostedModel, ModelHost, get_host,  # noqa: F401
                   resolve_target)
from .fleet import (Autoscaler, FleetRouter, Replica,  # noqa: F401
                    ReplicaSet)
from .sharded import (MeshReplica, sharded_generation_engine,  # noqa: F401
                      sharded_inference_engine)

__all__ = [
    'InferenceEngine', 'ServingStats', 'BucketCompileCache',
    'GenerationEngine', 'GenerationFuture', 'PrefixCache',
    'ReplicaSet', 'FleetRouter', 'Autoscaler', 'Replica',
    'ModelHost', 'HostedModel', 'get_host', 'resolve_target',
    'MeshReplica', 'sharded_generation_engine', 'sharded_inference_engine',
    'bucket_for', 'bucket_sizes', 'pad_rows', 'input_signature',
    'QueueFullError', 'DeadlineExceededError', 'EngineClosedError',
    'HBMAdmissionError',
]
