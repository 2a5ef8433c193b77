"""Prebuild: replay a warmup manifest ahead of traffic. Port of
``paddle_tpu/warmup/prebuild.py``.

Where the reference AOT-compiles each entry over abstract
``ShapeDtypeStruct`` arguments, the port captures the entry's CUDA graph
(``models.decode_cache.CapturedFn``) into the same cache the live path
reads, so live traffic reports zero captures:

- ``serving_bucket`` -> ``engine=``: capture the bucket's forward and
  ``put()`` it into the engine's ``BucketCompileCache``;
- ``predictor`` -> ``predictor=``: capture the padded-feed forward into
  ``Predictor._compiled`` (needs an attached Layer);
- ``gen_prefill`` / ``gen_decode`` -> ``generation=``: check that the
  manifest's slot/page geometry matches the live GenerationEngine, then
  capture that function and replay it once into the trash page, as
  ``GenerationEngine.warmup()`` does.

hapi's train and eval steps run eagerly in the port: there is nothing to
build for ``train_step`` / ``accum_step`` / ``eval_step``, so ``model=``
registers no handler and those entries count as ``untargeted`` (ROADMAP
known differences). Entries with no matching target are counted
``untargeted`` and skipped; stale entries (shapes the current network can
no longer run) are warned about and skipped: a manifest from last week
must never crash today's deploy. Telemetry: ``warmup.prebuild_ms``
histogram, ``warmup.prebuilt_total`` / ``warmup.prebuild_skipped``
counters.
"""
import os
import time
import warnings

import numpy as np
import torch

from .. import observability as _obs
from ..core import dtype as dtypes
from .manifest import Manifest, _sig_from_json, serving_bucket_entry


# ---- per-kind prebuilders --------------------------------------------------

def _prebuild_bucket(engine, entry):
    bucket = int(entry['bucket'])
    sig = _sig_from_json(entry['inputs'])
    # The live path only ever queries at the engine's own precision; a
    # manifest captured at another precision still warms this engine's key.
    precision = engine._precision
    if engine._cache.peek(bucket, sig, precision) is not None:
        return False
    if bucket > engine.max_batch_size:
        raise ValueError(f'bucket {bucket} exceeds engine max_batch_size '
                         f'{engine.max_batch_size}')
    fn = engine._build(bucket, sig, precision)
    # one run from the zeroed buffers: a stale signature fails here, on
    # the CPU too (where nothing is captured)
    fn.replay()
    return engine._cache.put(bucket, sig, precision, fn)


_GEN_KINDS = {'gen_prefill': 'prefill', 'gen_decode': 'step'}


def _prebuild_generation(engine, entry):
    """Capture one GenerationEngine function (gen_prefill/gen_decode). The
    manifest's geometry must match the live engine: a mismatched entry is
    stale (caught by the strict/skip machinery), never silently captured
    at the wrong shapes."""
    geom = {'slots': engine.num_slots, 'page_size': engine.page_size,
            'num_pages': engine.num_pages,
            'prefill_width': engine.prefill_width,
            'table_width': engine.p_max}
    for k, v in geom.items():
        got = int(entry.get(k, v))
        if got != v:
            raise ValueError(
                f'generation entry {k}={got} does not match the live '
                f'engine ({k}={v})')
    return engine._warm(_GEN_KINDS[entry['kind']])


def _prebuild_predictor(predictor, entry):
    key = _sig_from_json(entry['inputs'])
    if key in predictor._compiled:
        return False
    try:
        predictor._get_compiled(key).replay()
    except Exception:
        predictor._compiled.pop(key, None)   # a stale entry leaves nothing
        raise
    return True


# ---- driver ----------------------------------------------------------------

def prebuild(manifest, *, engine=None, model=None, predictor=None,
             generation=None, strict=False):
    """Replay ``manifest`` (a Manifest or a path to one) against the given
    targets. Returns a report dict: entries / prebuilt / already_cached /
    skipped / untargeted / total_ms (+ ``skips`` reasons).

    ``model`` (a hapi Model) is accepted and targets nothing: its steps
    are eager. With ``strict=False`` (default) a stale entry is warned
    about and skipped; with ``strict=True`` it raises."""
    if isinstance(manifest, (str, os.PathLike)):
        manifest = Manifest.load(manifest)
    handlers = {}
    if engine is not None:
        handlers['serving_bucket'] = lambda e: _prebuild_bucket(engine, e)
    if predictor is not None:
        handlers['predictor'] = lambda e: _prebuild_predictor(predictor, e)
    if generation is not None:
        handlers['gen_prefill'] = \
            lambda e: _prebuild_generation(generation, e)
        handlers['gen_decode'] = \
            lambda e: _prebuild_generation(generation, e)

    report = {'entries': len(manifest), 'prebuilt': 0, 'already_cached': 0,
              'skipped': 0, 'untargeted': 0, 'skips': []}
    t_start = time.perf_counter()
    for entry in manifest:
        kind = entry.get('kind')
        handler = handlers.get(kind)
        if handler is None:
            report['untargeted'] += 1
            continue
        t0 = time.perf_counter()
        try:
            built = handler(entry)
        except Exception as e:
            if strict:
                raise
            warnings.warn(
                f'paddle_tpu_torch.warmup: skipping stale manifest entry '
                f'({kind}): {e!r}', RuntimeWarning, stacklevel=2)
            _obs.counter('warmup.prebuild_skipped',
                         {'kind': str(kind)}).inc()
            report['skipped'] += 1
            report['skips'].append(f'{kind}: {e}')
            continue
        if built:
            elapsed_ms = 1e3 * (time.perf_counter() - t0)
            _obs.histogram('warmup.prebuild_ms').observe(elapsed_ms)
            _obs.counter('warmup.prebuilt_total', {'kind': str(kind)}).inc()
            report['prebuilt'] += 1
        else:
            report['already_cached'] += 1
    # mark the targets warm for their readiness probes
    for target in (engine, generation):
        if target is not None and hasattr(target, '_warmed'):
            target._warmed = True
    report['total_ms'] = round(1e3 * (time.perf_counter() - t_start), 3)
    return report


# ---- manifest synthesis ----------------------------------------------------

def _dtype_name(dtype):
    if isinstance(dtype, torch.dtype):
        return dtypes.dtype_name(dtype)
    return np.dtype(dtype).name


def _normalize_example_spec(spec):
    """Normalize a per-example input spec into ((shape, dtype), ...).

    Accepts: ``(shape, dtype)`` pairs (per-example, no batch dim),
    ``static.InputSpec`` objects or ``{'shape': .., 'dtype': ..}`` dicts
    (batched: the leading dim is stripped). Any remaining dynamic dim is
    an error: warmup needs concrete per-example shapes."""
    if spec is None:
        return None
    out = []
    for s in spec:
        if isinstance(s, dict):
            shape, dtype = tuple(s['shape'])[1:], s.get('dtype', 'float32')
        elif hasattr(s, 'shape') and hasattr(s, 'dtype') and \
                not isinstance(s, (tuple, list)):
            shape, dtype = tuple(s.shape)[1:], s.dtype
        else:
            shape, dtype = s
            shape = tuple(shape)
        if any(d is None or int(d) < 0 for d in shape):
            raise ValueError(
                f'input spec {s!r} has dynamic non-batch dims; warmup '
                'needs concrete per-example shapes')
        out.append((tuple(int(d) for d in shape), _dtype_name(dtype)))
    return tuple(out)


def all_buckets_manifest(engine, input_spec=None):
    """Synthesize a manifest covering the engine's whole bucket ladder for
    one input signature: warmup without a prior capture run. The spec
    comes from ``input_spec`` or from what the engine inferred from its
    backend (hapi ``Model._inputs`` / ``Predictor`` metadata)."""
    from ..serving.bucketing import bucket_sizes
    sig = _normalize_example_spec(
        input_spec if input_spec is not None
        else getattr(engine, '_example_spec', None))
    if sig is None:
        raise ValueError(
            "warmup='all_buckets' needs an input signature: pass "
            "input_spec= (e.g. [((8,), 'float32')] per example) or build "
            'the engine from a hapi Model / Predictor with input specs')
    manifest = Manifest()
    for bucket in bucket_sizes(engine.max_batch_size):
        manifest.add(serving_bucket_entry(bucket, sig, engine._precision,
                                          max_batch=engine.max_batch_size))
    return manifest
