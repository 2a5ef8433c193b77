"""The process world: ``init_parallel_env``, ``spawn`` and ``DataParallel``.

Port of ``paddle_tpu/distributed/parallel.py:18-58`` and
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

``DataParallel`` (reference ``parallel.py:38-58``). The reference's is an
identity wrapper: its one controller runs the global batch, so the
gradient is the global batch's. Here each rank runs its block of the
batch, and the gradients are averaged over the data axes (dp x sharding,
``data_group``) at the end of every backward through the layer's call,
in buckets of ``comm_buffer_size`` MB, one all-reduce a bucket
(``average_grads``; ``GradSync``, as torch's DDP: the call's outputs
carry a gradient hook that queues the averaging at the end of the
backward). A gradient is averaged once: the first ``GradSync`` of a
Parameter owns it (``_grad_owner``, set when it is attached), and
``fleet.distributed_optimizer``'s step averages only the Parameters no
``GradSync`` owns, as a ZeRO optimizer's owned ones are left to it
(``_zero_owner``). Averaging the
ranks' gradients is Paddle's DataParallel: a loss normalized by a count
that differs between the ranks' blocks (cross entropy with
``ignore_index``) weighs each block by its own count, where the
reference's one controller takes the global count (ROADMAP Known
differences).
"""
import contextlib
import datetime
import os
import shutil
import tempfile
import time
import traceback
import weakref

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


# ---------------------------------------------------------------------------
# gradient averaging over the data axes
# ---------------------------------------------------------------------------

_LOW = (torch.bfloat16, torch.float16)


def data_group(mesh=None):
    """The group of the data axes (dp x sharding) of ``mesh`` (default:
    the process topology's); None when they span one rank."""
    from ..parallel.partitioner import Partitioner
    from .topology import get_mesh
    mesh = mesh or get_mesh()
    axes = Partitioner(mesh=mesh).data_axes()
    grp = mesh.group(axes)
    return grp if grp is not None and grp.nranks > 1 else None


def buckets(tensors, buffer_mb):
    """``tensors`` grouped in order into lists of at most ``buffer_mb``
    MB (a larger tensor alone), one dtype a list."""
    limit = max(1, int(buffer_mb * (1 << 20)))
    out, cur, size, dt = [], [], 0, None
    for t in tensors:
        nb = t.numel() * t.element_size()
        if cur and (t.dtype != dt or size + nb > limit):
            out.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nb
        dt = t.dtype
    if cur:
        out.append(cur)
    return out


def average_grads(grads, grp, buffer_mb=25):
    """Replace each torch tensor of ``grads`` by its mean over ``grp``, in
    place: one all-reduce a bucket of ``buffer_mb`` MB (bf16 / fp16 are
    summed in f32: gloo sums them in their own type). -> the buckets
    reduced."""
    from .collective import reduce_tensor
    if grp is None or grp.nranks == 1:
        return 0
    todo = [g for g in grads if g is not None]
    n = 0
    for bucket in buckets(todo, buffer_mb):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        if flat.dtype in _LOW:
            flat = flat.float()
        red = reduce_tensor(flat, grp, 'avg')
        off = 0
        with torch.no_grad():
            for g in bucket:
                k = g.numel()
                g.copy_(red[off:off + k].view_as(g))
                off += k
        n += 1
    return n


def _out_tensors(out):
    """The torch tensors of a layer's output (nested lists, tuples and
    dicts of Tensors)."""
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for o in out:
            yield from _out_tensors(o)
        return
    t = getattr(out, '_value', out)
    if isinstance(t, torch.Tensor):
        yield t


class GradSync:
    """A Layer's gradient averaging at the end of every backward through
    its call: the call's outputs get a gradient hook that queues
    ``sync`` on the autograd engine for the end of that backward.
    ``enabled`` (off under ``no_sync``) is read at the call. It averages
    the Parameters it owns (those of the layer no other GradSync owned
    when it was attached), apart from those an eager ZeRO optimizer owns
    (stage >= 1: it reduces their gradients itself)."""

    def __init__(self, layer, group=None, buffer_mb=25):
        self._layer = weakref.ref(layer)
        self.group = group if group is not None else data_group()
        self.buffer_mb = buffer_mb
        self.enabled = True
        self._queued = False
        for p in layer.parameters():
            if getattr(p, '_grad_owner', None) is None:
                p._grad_owner = self
        layer.register_forward_post_hook(self._on_call)

    def sync(self):
        layer = self._layer()
        if layer is None:
            return 0
        return average_grads(
            [p._value.grad for p in layer.parameters()
             if getattr(p, '_grad_owner', None) is self
             and getattr(p, '_zero_owner', None) is None],
            self.group, self.buffer_mb)

    def _on_call(self, layer, inputs, out):
        if self.enabled and torch.is_grad_enabled():
            for t in _out_tensors(out):
                if t.requires_grad:
                    t.register_hook(self._on_grad)
        return None

    def _on_grad(self, grad):
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._end_of_backward)

    def _end_of_backward(self):
        self._queued = False
        self.sync()


def attach_grad_sync(layer, group=None, buffer_mb=25):
    """``layer``'s ``GradSync`` (made once, kept on the layer)."""
    gs = getattr(layer, '_grad_sync', None)
    if gs is None:
        gs = GradSync(layer, group, buffer_mb)
        object.__setattr__(layer, '_grad_sync', gs)
    return gs


def _layer_base():
    from ..nn.layer_base import Layer
    return Layer


class DataParallel(_layer_base()):
    """Reference ``paddle.DataParallel``: the wrapped layer's forward,
    with its gradients averaged over the data axes after each backward
    through it (``comm_buffer_size`` MB buckets). ``state_dict`` /
    ``set_state_dict`` are the layer's (no ``_layers.`` prefix);
    ``scale_loss`` is the identity and ``apply_collective_grads``
    averages the gradients now (after backwards under ``no_sync``);
    ``no_sync()`` skips the averaging of the calls made inside it and
    their backwards (gradient accumulation)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        object.__setattr__(self, '_sync', attach_grad_sync(
            layers, group, comm_buffer_size))

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    load_dict = set_state_dict

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        self._sync.sync()

    @contextlib.contextmanager
    def no_sync(self):
        prev, self._sync.enabled = self._sync.enabled, False
        try:
            yield
        finally:
            self._sync.enabled = prev
