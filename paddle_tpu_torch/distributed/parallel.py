"""The process world: ``init_parallel_env`` and ``spawn``.

Port of ``paddle_tpu/distributed/parallel.py:18-35`` and
``distributed/__init__.py:70-162``. The reference is one controller a
host, so ``spawn`` with ``nprocs`` > 1 is its multi-host emulation on the
CPU. The port is one process per rank: ``spawn`` starts ``nprocs``
workers (multiprocessing's ``spawn`` method), each with the reference's
trainer env contract (``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ID``,
``PADDLE_LOCAL_RANK``, ``PADDLE_MASTER``) and a ``torch.distributed``
store of its own: a ``FileStore`` in a fresh temp directory, so that
workers of several spawns at once (pytest-xdist) never meet on a port
(``master_port=`` is accepted and handed to the workers as
``MASTER_PORT``; the meeting stays on the FileStore). The backend is the
caller's ``'gloo'`` or ``'nccl'``; without one, ``spawn`` picks it before
any worker starts (``default_backend``): NCCL when each rank has a card
of its own, else gloo (NCCL refuses two ranks of a communicator on one
card).
"""
import datetime
import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ('gloo', 'nccl')
_STORE_ENV = 'PADDLE_TPU_TORCH_STORE'       # FileStore path set by spawn
_BACKEND_ENV = 'PADDLE_DISTRI_BACKEND'
TIMEOUT_S = 600


def init_parallel_env(backend=None):
    """Initialize the default process group from the reference's env
    contract: ``PADDLE_TRAINERS_NUM`` ranks, this one
    ``PADDLE_TRAINER_ID``, met at ``PADDLE_MASTER`` (or ``MASTER_ADDR``)
    and ``MASTER_PORT``, or at the FileStore ``spawn`` made. ``backend``
    ('gloo' or 'nccl', else ``PADDLE_DISTRI_BACKEND``) must be given when
    there is more than one rank. One rank, or a group already up: nothing
    to do. Returns the world's ``ParallelEnv``."""
    from . import ParallelEnv
    nprocs = int(os.environ.get('PADDLE_TRAINERS_NUM', '1'))
    rank = int(os.environ.get('PADDLE_TRAINER_ID', '0'))
    if nprocs <= 1 or dist.is_initialized():
        return ParallelEnv()
    backend = backend or os.environ.get(_BACKEND_ENV)
    if backend not in BACKENDS:
        raise ValueError(f"init_parallel_env: backend must be one of "
                         f"{BACKENDS} (the caller's choice), got {backend!r}")
    store = os.environ.get(_STORE_ENV)
    if store:
        init = f'file://{store}'
    else:
        addr = os.environ.get('PADDLE_MASTER') or os.environ.get(
            'MASTER_ADDR')
        if not addr:
            raise ValueError('init_parallel_env: set PADDLE_MASTER or '
                             'MASTER_ADDR (and MASTER_PORT)')
        addr = addr.split(':')[0]
        init = f"tcp://{addr}:{os.environ.get('MASTER_PORT', '8476')}"
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=nprocs,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return ParallelEnv()


def default_backend(nprocs):
    """The backend ``spawn`` picks for ``nprocs`` workers on this host:
    'nccl' when every rank has a card of its own, 'gloo' when the ranks
    would share one or there is none."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 'nccl' if cards >= nprocs else 'gloo'


def _spawn_target(func, args, rank, nprocs, store, backend, errq,
                  master_port=None):
    """Worker body (top level, so that it pickles): the env contract,
    then ``func(*args)``; its traceback goes to the parent on failure.
    The process group, if ``func`` made one, is torn down either way."""
    os.environ['PADDLE_TRAINERS_NUM'] = str(nprocs)
    os.environ['PADDLE_TRAINER_ID'] = str(rank)
    os.environ['PADDLE_LOCAL_RANK'] = str(rank)
    os.environ['PADDLE_MASTER'] = '127.0.0.1'
    os.environ[_STORE_ENV] = store
    os.environ[_BACKEND_ENV] = backend
    if master_port is not None:
        os.environ['MASTER_PORT'] = str(master_port)
    if backend == 'nccl':
        torch.cuda.set_device(rank)
    try:
        func(*args)
        errq.put((rank, None))
    except BaseException:
        errq.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class MultiprocessContext:
    """Handle of ``spawn(join=False)``: ``join()`` waits for the workers
    and re-raises the first failure (the reference's context). A worker
    that fails ends the others: a rank left waiting in a collective for a
    dead peer would never return."""

    def __init__(self, procs, errq, tmpdir):
        self.processes = procs
        self._errq = errq
        self._tmpdir = tmpdir
        self._fails = []

    def _drain(self):
        while not self._errq.empty():
            rank, tb = self._errq.get_nowait()
            if tb is not None:
                self._fails.append((rank, tb))

    def join(self, timeout=None):
        deadline = None if timeout is None else time.time() + timeout
        while any(p.is_alive() for p in self.processes):
            self._drain()
            failed = self._fails or any(
                p.exitcode not in (0, None) for p in self.processes)
            if failed:
                for p in self.processes:
                    if p.is_alive():
                        p.terminate()
                for p in self.processes:
                    p.join(10)
                break
            if deadline is not None and time.time() > deadline:
                return False
            time.sleep(0.05)
        self._drain()
        for p in self.processes:
            p.join()
        self._drain()
        shutil.rmtree(self._tmpdir, ignore_errors=True)
        fails = list(self._fails)
        for p in self.processes:
            if p.exitcode not in (0, None) and not fails:
                fails.append((p.pid, f'exitcode {p.exitcode}'))
        if fails:
            rank, tb = fails[0]
            raise RuntimeError(
                f'spawn: worker {rank} failed:\n{tb}' +
                (f'\n({len(fails) - 1} more worker(s) also failed)'
                 if len(fails) > 1 else ''))
        return True


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, backend=None,
          **options):
    """Reference: python/paddle/distributed/spawn.py. ``nprocs`` in
    (-1, 1) runs ``func(*args)`` in this process, as the reference does;
    ``nprocs`` > 1 starts that many workers, each calling ``func(*args)``
    with the env contract set (``func`` calls ``init_parallel_env()``,
    which reads it), over a FileStore in a fresh temp directory with
    ``backend`` ('gloo' or 'nccl'; None: ``default_backend(nprocs)``, an
    NCCL rank on card ``rank``). ``master_port=`` reaches the workers as
    ``MASTER_PORT``. With ``join`` it waits and re-raises the first
    worker's failure; else it returns the ``MultiprocessContext``."""
    if nprocs is not None and (nprocs == 0 or nprocs < -1):
        raise ValueError(f'spawn: nprocs must be -1 (all local devices) or '
                         f'a positive worker count, got {nprocs}')
    if nprocs is None or nprocs in (-1, 1):
        func(*args)
        return None
    if backend is None:
        backend = default_backend(nprocs)
    if backend not in BACKENDS:
        raise ValueError(f"spawn: backend must be one of {BACKENDS} for "
                         f"{nprocs} workers, got {backend!r}")
    master_port = options.get('master_port')
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    errq = ctx.Queue()
    tmpdir = tempfile.mkdtemp(prefix='paddle_spawn_')
    store = os.path.join(tmpdir, 'store')
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_spawn_target,
                        args=(func, args, rank, nprocs, store, backend,
                              errq, master_port),
                        daemon=daemon)
        p.start()
        procs.append(p)
    context = MultiprocessContext(procs, errq, tmpdir)
    if join:
        context.join()
        return None
    return context
