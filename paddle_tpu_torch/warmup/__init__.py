"""paddle_tpu_torch.warmup: warmup manifests and prebuild (port of
``paddle_tpu/warmup``).

- **Warmup manifests** (``manifest.py``): ``capture()`` records every
  distinct captured signature of a run (serving bucket keys, Predictor
  feed keys, the GenerationEngine's prefill and step) into a JSON manifest,
  the same JSON as the reference's.
- **Prebuild** (``prebuild.py``): ``prebuild(manifest, ...)`` captures each
  entry's CUDA graph ahead of traffic into the caches the live path reads.

Recipe::

    from paddle_tpu_torch import warmup, serving

    with warmup.capture() as man:          # once, e.g. in staging
        engine = serving.InferenceEngine(net, max_batch_size=64)
        ... live or synthetic traffic ...
    man.save('warmup.json')

    # every later process: the first request replays a captured graph
    engine = serving.InferenceEngine(net, max_batch_size=64,
                                     warmup='warmup.json')

Not ported: the persistent compile cache (``persistent.py``). A CUDA graph
cannot outlive its process, and the kernels' nvcc builds already persist
under ``paddle_tpu_torch/_build/``; its names exist and raise citing
ROADMAP Queue 1 step E (persistent cache), and the engine does not read
``PADDLE_TPU_COMPILE_CACHE``.
"""
from .. import _deferred
from .manifest import (Manifest, array_sig, capture, capture_start,  # noqa: F401
                       capture_stop, capturing, eval_step_entry,
                       generation_entry, predictor_entry, record,
                       serving_bucket_entry, train_step_entry)
from .prebuild import all_buckets_manifest, prebuild  # noqa: F401

ENV_CACHE_DIR = 'PADDLE_TPU_COMPILE_CACHE'

_deferred.install(
    globals(), 'is not ported yet (ROADMAP Queue 1 step E (persistent '
    'cache): a CUDA graph cannot outlive its process)',
    functions=('cache_key_component', 'cache_stats',
               'disable_persistent_cache', 'enable_persistent_cache',
               'ensure_persistent_cache', 'persistent_cache_dir'))

__all__ = [
    'Manifest', 'capture', 'capture_start', 'capture_stop', 'capturing',
    'record', 'array_sig', 'serving_bucket_entry', 'train_step_entry',
    'eval_step_entry', 'predictor_entry', 'generation_entry',
    'enable_persistent_cache', 'disable_persistent_cache',
    'ensure_persistent_cache', 'persistent_cache_dir', 'cache_stats',
    'cache_key_component', 'ENV_CACHE_DIR',
    'prebuild', 'all_buckets_manifest',
]
