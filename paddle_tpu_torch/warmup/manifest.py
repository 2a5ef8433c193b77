"""Warmup manifests: the recorded capture-signature set of one run. Port
of ``paddle_tpu/warmup/manifest.py``; the JSON is the same, so a manifest
either package saves loads in the other.

A production process runs a small closed set of shape-stable captured
functions, which makes that set a finite, enumerable artifact.
``capture()`` records every distinct signature the process captures
(serving bucket keys, Predictor shape keys, the GenerationEngine's two
functions) into a JSON manifest; ``warmup.prebuild(manifest)`` replays it
ahead of traffic in the next process so the first request runs an
already-captured graph. hapi's train and eval steps run eagerly in the
port, so a manifest's ``train_step`` / ``accum_step`` / ``eval_step``
entries (the reference's captures record them) have nothing to build here.

Entries are plain JSON dicts keyed by ``kind``:

- ``serving_bucket``: per-example input signature + padded bucket size
- ``train_step`` / ``accum_step``: full input/label shapes of a hapi step
- ``eval_step``: full input/label shapes of a hapi eval/predict step
- ``predictor``: the padded feed key of an inference.Predictor.run

Capture is process-global (one active manifest at a time) and thread-safe;
hooks in the serving engines and the Predictor call ``record()`` only
while a capture is active, so the disabled-mode cost on hot paths is one
``sys.modules`` lookup at the call site.
"""
import contextlib
import json
import os
import threading

MANIFEST_VERSION = 1

ENTRY_KINDS = ('serving_bucket', 'train_step', 'accum_step', 'eval_step',
               'predictor', 'gen_prefill', 'gen_decode')


def _sig_to_json(sig):
    return [[list(int(d) for d in shape), str(dtype)]
            for shape, dtype in sig]


def _sig_from_json(doc):
    return tuple((tuple(int(d) for d in shape), str(dtype))
                 for shape, dtype in doc)


def array_sig(arrays):
    """(full shape, dtype) signature of a concrete argument list — the same
    tuples the hapi eval-step cache keys on."""
    return tuple((tuple(int(d) for d in getattr(a, 'shape', ())),
                  str(getattr(a, 'dtype', ''))) for a in arrays)


def serving_bucket_entry(bucket, sig, precision, max_batch=None):
    """One serving executable: ``sig`` is the per-example input signature
    (``serving.input_signature``), ``bucket`` the padded batch size."""
    entry = {'kind': 'serving_bucket', 'bucket': int(bucket),
             'inputs': _sig_to_json(sig), 'precision': str(precision)}
    if max_batch is not None:
        entry['max_batch'] = int(max_batch)
    return entry


def train_step_entry(inputs_sig, labels_sig, accumulate=False):
    """One hapi train-step signature (full batch shapes). ``accumulate``
    marks the gradient-merge path (accum micro-step + apply)."""
    return {'kind': 'accum_step' if accumulate else 'train_step',
            'inputs': _sig_to_json(inputs_sig),
            'labels': _sig_to_json(labels_sig)}


def eval_step_entry(inputs_sig, labels_sig):
    return {'kind': 'eval_step', 'inputs': _sig_to_json(inputs_sig),
            'labels': _sig_to_json(labels_sig)}


def predictor_entry(shapes_key, precision='float32'):
    """One Predictor executable: ``shapes_key`` is the padded feed key
    Predictor.run compiles for (full shapes incl. batch dim)."""
    return {'kind': 'predictor', 'inputs': _sig_to_json(shapes_key),
            'precision': str(precision)}


def generation_entry(kind, *, slots, page_size, num_pages, prefill_width,
                     table_width):
    """One GenerationEngine executable (``gen_prefill`` or ``gen_decode``):
    the geometry fields pin the batch-independent shapes of the continuous-
    batching prefill/step programs, so prebuild can verify the replaying
    engine was built with the same slot/page layout."""
    if kind not in ('gen_prefill', 'gen_decode'):
        raise ValueError(f'kind must be gen_prefill or gen_decode, '
                         f'got {kind!r}')
    return {'kind': kind, 'slots': int(slots), 'page_size': int(page_size),
            'num_pages': int(num_pages),
            'prefill_width': int(prefill_width),
            'table_width': int(table_width)}


class Manifest:
    """Deduplicated, insertion-ordered set of warmup entries with atomic
    JSON persistence. Safe to ``add`` from several threads (the serving
    dispatch thread records while user threads train)."""

    def __init__(self, entries=None, meta=None):
        self._lock = threading.Lock()
        self.meta = dict(meta or {})
        self.entries = []
        self._keys = set()
        for e in entries or ():
            self.add(e)

    def add(self, entry):
        """Add one entry; returns False (and keeps the first copy) when an
        identical entry was already recorded."""
        key = json.dumps(entry, sort_keys=True)
        with self._lock:
            if key in self._keys:
                return False
            self._keys.add(key)
            self.entries.append(dict(entry))
            return True

    def __len__(self):
        with self._lock:
            return len(self.entries)

    def __iter__(self):
        with self._lock:
            return iter(list(self.entries))

    def counts(self):
        """Per-kind entry counts (manifest forensics, warmup reports)."""
        out = {}
        for e in self:
            k = e.get('kind', '?')
            out[k] = out.get(k, 0) + 1
        return out

    def to_json(self):
        import torch
        from .. import __version__
        meta = dict(self.meta)
        meta.setdefault('framework', f'paddle_tpu_torch {__version__}')
        meta.setdefault('torch', torch.__version__)
        with self._lock:
            entries = list(self.entries)
        return {'version': MANIFEST_VERSION, 'meta': meta,
                'entries': entries}

    def save(self, path):
        """Atomic write (tmp -> fsync -> replace): a crash mid-save never
        leaves a truncated manifest for the next process to choke on."""
        doc = self.to_json()
        tmp = f'{path}.tmp.{os.getpid()}'
        with open(tmp, 'w') as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path):
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or not isinstance(doc.get('entries'),
                                                       list):
            raise ValueError(f'{path!r} is not a warmup manifest')
        return cls(entries=doc['entries'], meta=doc.get('meta'))


# ---- process-global capture state -----------------------------------------

_capture_lock = threading.Lock()
_active = None


def capturing():
    """True while a capture is active (the hooks' fast guard)."""
    return _active is not None


def capture_start(manifest=None):
    """Begin recording compile signatures into ``manifest`` (a fresh one by
    default). Re-entrant: a second start joins the active capture."""
    global _active
    with _capture_lock:
        if _active is None:
            _active = manifest if manifest is not None else Manifest()
        return _active


def capture_stop():
    """Stop recording; returns the captured manifest (None if inactive)."""
    global _active
    with _capture_lock:
        manifest, _active = _active, None
        return manifest


@contextlib.contextmanager
def capture(manifest=None):
    """``with warmup.capture() as man:`` — record every signature compiled
    in the block, then ``man.save(path)`` it for the next process."""
    manifest = capture_start(manifest)
    try:
        yield manifest
    finally:
        capture_stop()


def record(entry):
    """Record one entry into the active capture; no-op when inactive."""
    manifest = _active
    if manifest is not None:
        manifest.add(entry)
