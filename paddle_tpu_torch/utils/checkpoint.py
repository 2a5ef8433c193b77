"""Checkpoint/resume with crash-safe persistence (port of
``paddle_tpu/utils/checkpoint.py``, the local backend).

Every step is ONE atomic, manifest-verified file (``ckpt-<step>.pdckpt``)
written through framework_io.save (tmp -> fsync -> os.replace + CRC32
sidecar). ``latest_step()`` only reports steps that pass verification, so a
checkpoint truncated by a crash is never chosen as the resume point. Saves
are retried via fault.retry.

Keep policy: ``max_to_keep`` newest steps survive garbage collection; steps
divisible by ``keep_period`` are kept forever (durable milestones an
operator can always roll back to).

``backend='orbax'`` (the reference's sharding-aware JAX checkpointer)
raises ValueError: the port has the local backend only.
"""
import os
import re

from .. import framework_io as fio
from .. import observability as _obs
from ..fault import CheckpointCorruptError, retry

_STEP_RE = re.compile(r'^ckpt-(\d+)\.pdckpt$')


def _step_path(directory, step):
    return os.path.join(directory, f'ckpt-{int(step)}.pdckpt')


def _verify_file(path):
    """Cheap integrity check: manifest size+CRC when a sidecar exists,
    full restricted load otherwise. -> bool."""
    try:
        with open(path, 'rb') as f:
            data = f.read()
        m = fio._read_manifest(path)
        if m is not None:
            return fio._payload_matches(m, data)
        fio._load_file(path)
        return True
    except Exception:
        return False


def list_steps(directory):
    """All step numbers present on disk (verified or not), ascending."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    steps = []
    for n in names:
        m = _STEP_RE.match(n)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_verified_step(directory):
    """Newest step whose checkpoint passes integrity verification, or None
    (the restore point a relaunched job agrees on)."""
    for step in reversed(list_steps(directory)):
        if _verify_file(_step_path(directory, step)):
            return step
    return None


class CheckpointManager:
    def __init__(self, directory, max_to_keep=3, keep_period=None,
                 save_retries=3, backend='local'):
        if backend != 'local':
            raise ValueError(
                f"CheckpointManager backend {backend!r}: the port has the "
                "'local' backend only (orbax is a JAX library)")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        self.save_retries = max(1, save_retries)

    def _save_once(self, step, state):
        fio.save(state, _step_path(self.directory, step))
        self._gc()

    def _gc(self):
        steps = list_steps(self.directory)
        if self.max_to_keep is None or len(steps) <= self.max_to_keep:
            return
        drop = steps[:-self.max_to_keep] if self.max_to_keep else steps
        for s in drop:
            if self.keep_period and s % self.keep_period == 0:
                continue
            for suffix in ('', fio.MANIFEST_SUFFIX):
                try:
                    os.remove(_step_path(self.directory, s) + suffix)
                except OSError:
                    pass

    def save(self, step, state, wait=False):
        """state: a tree of tensors and arrays (params/opt_state/meta).
        Retried on transient write errors; atomic either way (a crash
        mid-save never clobbers the previous step). Saves are synchronous,
        so ``wait`` changes nothing."""
        with _obs.span('ckpt.manager_save', step=step):
            retry(lambda: self._save_once(step, state),
                  retries=self.save_retries, backoff=0.1, jitter=0.25)
        _obs.counter('ckpt.manager_saves').inc()

    def latest_step(self):
        """Newest VERIFIED step (CRC manifests)."""
        return latest_verified_step(self.directory)

    def all_steps(self):
        return list_steps(self.directory)

    def restore(self, step=None, template=None):
        """The state saved at ``step`` (default: the newest verified one),
        or None when there is none. ``template`` is accepted for the
        reference's signature; arrays come back as framework_io.load
        gives them."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        with _obs.span('ckpt.restore', step=step):
            out = fio.load(_step_path(self.directory, step))
        _obs.counter('ckpt.restores').inc()
        return out

    def wait(self):
        pass

    def close(self):
        pass


def save_checkpoint(path, state, step=0):
    mgr = CheckpointManager(path)
    mgr.save(step, state, wait=True)
    mgr.close()


def load_checkpoint(path, template=None):
    mgr = CheckpointManager(path)
    out = mgr.restore(template=template)
    mgr.close()
    return out


def auto_resume(path, init_fn, template=None):
    """Elastic-recovery entry: restore the newest INTACT checkpoint if one
    exists, else build fresh state with init_fn(). Returns
    (state, start_step). A corrupt newest checkpoint falls back to the next
    older intact one rather than failing the job."""
    try:
        mgr = CheckpointManager(path)
        for step in reversed(mgr.all_steps()):
            try:
                state = mgr.restore(step, template=template)
                mgr.close()
                return state, step + 1
            except (CheckpointCorruptError, OSError):
                continue
        mgr.close()
    except Exception:
        pass
    return init_fn(), 0
