"""paddle.save / paddle.load — state dicts and nested trees of tensors,
stored as a pickle of numpy arrays (port of ``paddle_tpu/framework_io.py``;
the file format is the JAX package's, so each package reads the other's
``.pdparams`` / ``.pdopt``).

- ``save`` is atomic and durable: payload is written to a temp file,
  fsync'd, then ``os.replace``'d over the target, so a SIGKILL mid-save
  can never truncate an existing checkpoint. A sidecar JSON manifest
  (``<path>.manifest``) records the format version, payload size/CRC32 and
  per-array CRC32/dtype/shape.
- ``load`` verifies the manifest and raises a typed
  ``fault.CheckpointCorruptError`` on any mismatch instead of unpickling
  garbage. Given a *directory*, it falls back to the newest intact
  checkpoint inside it.
- unpickling admits only the exact globals that pickled numpy arrays
  name (and a few builtins), so loading an untrusted ``.pdparams`` cannot
  execute arbitrary code (``fault.UnsafePayloadError``).

What goes into the pickle: a port ``Tensor`` as ``('__tensor__',
ndarray)`` and a bare torch tensor as an ndarray, copied to the host
first, as the reference writes its Tensors and device arrays; nothing of
torch. bfloat16 has no numpy dtype without ``ml_dtypes``, which the card's
machine lacks, so a bfloat16 entry is always written as a tagged uint16
view of its bits: ``('__tensor_bf16__', uint16)`` for a Tensor,
``('__bf16__', uint16)`` for a bare tensor. The port reads those back as
bfloat16, bit for bit, and also reads the reference's ``ml_dtypes``
bfloat16 arrays where ``ml_dtypes`` imports. ``load`` gives Tensors on the
current place (``paddle.set_device``).
"""
import io
import json
import os
import pickle
import re
import zlib

import numpy as np
import torch

from . import observability as _obs
from .core.nest import map_nested
from .core.tensor import Tensor, wrap
from .fault import CheckpointCorruptError, UnsafePayloadError
from .fault.inject import inject

FORMAT_VERSION = 1
MANIFEST_SUFFIX = '.manifest'
TENSOR_TAG, TENSOR_BF16_TAG, BF16_TAG = '__tensor__', '__tensor_bf16__', \
    '__bf16__'


def _host(t):
    """A torch tensor's values as a host ndarray (a bfloat16 tensor as the
    uint16 view of its bits)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.cpu().view(torch.int16).numpy().view(np.uint16)
    return t.cpu().numpy()


def _to_numpy(obj):
    def leaf(x):
        if isinstance(x, Tensor):
            v = x._value
            return (TENSOR_BF16_TAG if v.dtype == torch.bfloat16
                    else TENSOR_TAG, _host(v))
        if isinstance(x, torch.Tensor):
            return (BF16_TAG, _host(x)) if x.dtype == torch.bfloat16 \
                else _host(x)
        return x
    return map_nested(leaf, obj)


def _bf16(bits):
    """A torch bfloat16 tensor over a uint16 ndarray's bits."""
    return torch.from_numpy(np.asarray(bits, order='C').view(np.int16)) \
        .view(torch.bfloat16)


def _torch_of(arr):
    """A host ndarray as a torch tensor (an ``ml_dtypes`` bfloat16 array of
    the reference's by its bits)."""
    if arr.dtype.name == 'bfloat16':
        return _bf16(arr.view(np.uint16))
    return None


def _tensor_of(value):
    """A port Tensor on the current place over a loaded torch tensor or
    ndarray (64-bit types canonicalized, as ``to_tensor`` does)."""
    from .device import current_device
    if isinstance(value, np.ndarray):
        t = _torch_of(value)
        if t is None:
            return Tensor(value)
        value = t
    return wrap(value.to(current_device()))


_READ_TAGS = {TENSOR_TAG: _tensor_of,
              TENSOR_BF16_TAG: lambda a: _tensor_of(_bf16(a)),
              BF16_TAG: _bf16}


def _tagged(obj):
    return isinstance(obj, tuple) and len(obj) == 2 and \
        isinstance(obj[0], str) and obj[0] in _READ_TAGS


def _from_numpy(obj):
    def leaf(x):
        if _tagged(x):
            return _READ_TAGS[x[0]](x[1])
        if isinstance(x, np.ndarray):
            t = _torch_of(x)
            return x if t is None else t
        return x
    return map_nested(leaf, obj, is_leaf=_tagged)


# ---- integrity manifest -----------------------------------------------------

def _walk_arrays(obj, prefix, out):
    """Deterministic (path, ndarray) walk — identical on save and load."""
    if isinstance(obj, np.ndarray):
        out.append((prefix, obj))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _walk_arrays(v, f'{prefix}.{k}' if prefix else str(k), out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _walk_arrays(v, f'{prefix}[{i}]', out)


def _array_crc(a):
    if a.dtype == object:
        return None
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _build_manifest(payload_obj, payload):
    leaves = []
    _walk_arrays(payload_obj, '', leaves)
    return {
        'format_version': FORMAT_VERSION,
        'payload_size': len(payload),
        'payload_crc32': zlib.crc32(payload) & 0xFFFFFFFF,
        'arrays': [{'key': k,
                    'crc32': _array_crc(a),
                    'dtype': str(a.dtype),
                    'shape': list(a.shape)} for k, a in leaves],
    }


def _write_fsync(path, data):
    with open(path, 'wb') as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(d):
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _sweep_stale_tmps(path):
    """Remove torn ``{path}*.tmp.<pid>`` debris left by a process that was
    killed mid-save (its finally-block never ran). Safe: tmp names are
    pid-scoped and a new save of the same path supersedes any older
    in-flight write."""
    d = os.path.dirname(path) or '.'
    base = os.path.basename(path)
    try:
        names = os.listdir(d)
    except OSError:
        return
    for name in names:
        if name.startswith(base) and '.tmp.' in name:
            try:
                os.remove(os.path.join(d, name))
            except OSError:
                pass


def save(obj, path, protocol=4, **configs):
    """Atomic durable save: tmp file -> fsync -> os.replace, with a sidecar
    integrity manifest. A crash at any instant leaves either the previous
    complete checkpoint or the new complete one — never a truncated mix."""
    with _obs.span('ckpt.save', path=os.path.basename(path)) as sp:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        payload_obj = _to_numpy(obj)
        payload = pickle.dumps(payload_obj, protocol=protocol)
        manifest = json.dumps(_build_manifest(payload_obj, payload),
                              sort_keys=True).encode()
        tmp = f'{path}.tmp.{os.getpid()}'
        mtmp = f'{path}{MANIFEST_SUFFIX}.tmp.{os.getpid()}'
        _sweep_stale_tmps(path)
        try:
            _write_fsync(tmp, payload)
            _write_fsync(mtmp, manifest)
            inject('ckpt.write')
            os.replace(tmp, path)
            inject('ckpt.commit')
            os.replace(mtmp, path + MANIFEST_SUFFIX)
            _fsync_dir(d or '.')
        finally:
            for t in (tmp, mtmp):
                try:
                    os.remove(t)
                except OSError:
                    pass
    _obs.counter('ckpt.saves').inc()
    _obs.counter('ckpt.bytes_written').inc(len(payload) + len(manifest))
    _obs.histogram('ckpt.save_ms').observe(1e3 * sp.duration)
    # every blocking save steals training wall-clock: checkpoint badput on
    # the goodput ledger (counts toward the ratio only while fit() runs)
    _obs.goodput.note_badput('checkpoint', sp.duration)


# ---- restricted unpickling --------------------------------------------------

# The globals a pickle of numpy arrays names, as exact (module, name)
# pairs: an array (``_reconstruct``, ``ndarray``, ``dtype``; protocol 5's
# ``_frombuffer``), a numpy scalar (``scalar``) and the ml_dtypes scalar
# types that carry the reference's bfloat16 and fp8 arrays. numpy moved its
# core modules across versions, so both spellings are listed. A name is
# matched whole and never followed through dots: from protocol 4 on,
# ``find_class`` resolves ('numpy', 'lib.format.os.system') to os.system,
# and ('numpy', 'load') would unpickle another file without restriction.
_ML_DTYPES = ('bfloat16', 'float4_e2m1fn', 'float6_e2m3fn', 'float6_e3m2fn',
              'float8_e3m4', 'float8_e4m3', 'float8_e4m3b11fnuz',
              'float8_e4m3fn', 'float8_e4m3fnuz', 'float8_e5m2',
              'float8_e5m2fnuz', 'float8_e8m0fnu', 'int2', 'int4', 'uint2',
              'uint4')
_SAFE_GLOBALS = frozenset(
    [('numpy', 'ndarray'), ('numpy', 'dtype')]
    + [(m, n) for core in ('numpy.core', 'numpy._core')
       for m, n in ((f'{core}.multiarray', '_reconstruct'),
                    (f'{core}.multiarray', 'scalar'),
                    (f'{core}.numeric', '_frombuffer'))]
    + [('ml_dtypes', n) for n in _ML_DTYPES]
    + [('builtins', n) for n in ('complex', 'set', 'frozenset', 'slice',
                                 'range', 'bytearray')])


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        raise UnsafePayloadError(
            f'refusing to unpickle global {module}.{name} — checkpoints may '
            f'only contain numpy data (untrusted pickles can execute code)')


def _restricted_loads(data):
    return _RestrictedUnpickler(io.BytesIO(data)).load()


# ---- verified load ----------------------------------------------------------

def _read_manifest(path):
    mpath = path + MANIFEST_SUFFIX
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath, 'rb') as f:
            return json.loads(f.read().decode())
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(path, f'unreadable manifest: {e!r}') \
            from e


def _payload_matches(m, data):
    """The manifest's size and CRC32 agree with the payload bytes."""
    return (m.get('payload_size') == len(data)
            and m.get('payload_crc32') == (zlib.crc32(data) & 0xFFFFFFFF))


def _load_file(path):
    with open(path, 'rb') as f:
        data = f.read()
    m = _read_manifest(path)
    if m is not None:
        if m.get('format_version', 0) > FORMAT_VERSION:
            raise CheckpointCorruptError(
                path, f"format_version {m.get('format_version')} is newer "
                      f'than supported {FORMAT_VERSION}')
        if m.get('payload_size') != len(data):
            raise CheckpointCorruptError(
                path, f"size mismatch: manifest says {m.get('payload_size')} "
                      f'bytes, file has {len(data)}')
        if not _payload_matches(m, data):
            raise CheckpointCorruptError(path, 'payload CRC32 mismatch')
    try:
        obj = _restricted_loads(data)
    except UnsafePayloadError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(path, f'undecodable payload: {e!r}') \
            from e
    if m is not None:
        leaves = []
        _walk_arrays(obj, '', leaves)
        want = m.get('arrays', [])
        if len(leaves) != len(want):
            raise CheckpointCorruptError(
                path, f'array count mismatch: manifest {len(want)}, '
                      f'payload {len(leaves)}')
        for (key, a), w in zip(leaves, want):
            if key != w['key'] or str(a.dtype) != w['dtype'] \
                    or list(a.shape) != w['shape']:
                raise CheckpointCorruptError(
                    path, f'array {key!r} does not match manifest entry '
                          f"{w['key']!r} ({w['dtype']}, {w['shape']})")
            crc = _array_crc(a)
            if w['crc32'] is not None and crc != w['crc32']:
                raise CheckpointCorruptError(
                    path, f'array {key!r} CRC32 mismatch')
    return _from_numpy(obj)


def _checkpoint_candidates(dirpath):
    """Checkpoint files in ``dirpath``, newest first (step number when the
    name carries one, else mtime)."""
    out = []
    for name in os.listdir(dirpath):
        p = os.path.join(dirpath, name)
        if not os.path.isfile(p) or name.endswith(MANIFEST_SUFFIX) \
                or '.tmp.' in name:
            continue
        m = re.search(r'(\d+)', name)
        step = int(m.group(1)) if m else -1
        try:
            mtime = os.path.getmtime(p)
        except OSError:
            continue
        out.append((step, mtime, p))
    out.sort(key=lambda t: (t[0], t[1]), reverse=True)
    return [p for _, _, p in out]


def _load_newest(dirpath):
    errors = []
    for p in _checkpoint_candidates(dirpath):
        try:
            return _load_file(p)
        except (CheckpointCorruptError, UnsafePayloadError, OSError) as e:
            errors.append(f'{os.path.basename(p)}: {e}')
    raise CheckpointCorruptError(
        dirpath, 'no intact checkpoint found'
                 + (f' (tried: {"; ".join(errors[:4])})' if errors else ''))


def load(path, **configs):
    """Verified load. ``path`` may be a checkpoint file (manifest-checked
    when a sidecar exists; legacy manifest-less files still load, through
    the restricted unpickler) or a directory of checkpoints (falls back to
    the newest intact one)."""
    with _obs.span('ckpt.load', path=os.path.basename(path)) as sp:
        try:
            if os.path.isdir(path):
                out = _load_newest(path)
            else:
                out = _load_file(path)
        except CheckpointCorruptError:
            _obs.counter('ckpt.corrupt_total').inc()
            raise
    _obs.counter('ckpt.loads').inc()
    _obs.histogram('ckpt.load_ms').observe(1e3 * sp.duration)
    return out
