"""paddle.distributed over torch.distributed.

Port of ``paddle_tpu/distributed/__init__.py``. The reference is one
controller a host (a rank is ``jax.process_index()``, parallelism inside a
host is a device mesh); the port is one process per rank over a
``torch.distributed`` process group (``init_parallel_env``, ``spawn``),
with the mesh's axes as subgroups (``topology.HybridTopology``). Without a
process group everything here is the one-process world: rank 0 of 1,
collectives the identity.

Ported (step K1): the topology, the collectives (``collective.py``, with
the one-card host staging for gloo on CUDA tensors), ``spawn`` /
``init_parallel_env``, ``fleet.init`` and ``DistributedStrategy``, the
quantized gradient all-reduce (``quant_collectives.py``). Step K4a:
``DataParallel`` (``parallel.py``) and the rest of ``fleet``. The
launcher, ``auto_parallel``'s annotations, the ``gloo_*`` functions, the
PS datasets and the entry filters raise citing ROADMAP Queue 1 step K4b.
"""
import torch.distributed as _dist

from .. import _deferred
from .collective import (  # noqa: F401
    Group, ReduceOp, all_gather, all_reduce, alltoall, barrier, broadcast,
    get_group, new_group, recv, reduce, reduce_scatter, scatter, send, wait)
from .topology import (  # noqa: F401
    HybridTopology, get_mesh, get_topology, set_topology)
from .parallel import (  # noqa: F401
    DataParallel, MultiprocessContext, default_backend, init_parallel_env,
    spawn)
from . import fleet  # noqa: F401
from . import quant_collectives  # noqa: F401


def get_rank(group=None):
    if not (_dist.is_available() and _dist.is_initialized()):
        return 0
    if isinstance(group, Group):
        return group.index
    return _dist.get_rank()


def get_world_size(group=None):
    if not (_dist.is_available() and _dist.is_initialized()):
        return 1
    if isinstance(group, Group):
        return group.nranks
    return _dist.get_world_size()


class ParallelEnv:
    """This process's place in the world (reference ``ParallelEnv``)."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        import os
        return int(os.environ.get('PADDLE_LOCAL_RANK', '0'))

    @property
    def local_rank(self):
        return get_rank()

    @property
    def nranks(self):
        return get_world_size()


def init_process_group(*args, **kwargs):
    return init_parallel_env(*args, **kwargs)


_deferred.install(
    globals(), 'is not ported yet (ROADMAP Queue 1 step K4b)',
    functions=('launch', 'gloo_init_parallel_env', 'gloo_barrier',
               'gloo_release', 'shard_tensor', 'shard_op', 'set_shard_mask',
               'set_offload_device', 'set_pipeline_stage', 'split'),
    classes=('ProcessMesh', 'CountFilterEntry', 'ProbabilityEntry',
             'BoxPSDataset', 'InMemoryDataset', 'QueueDataset'))
