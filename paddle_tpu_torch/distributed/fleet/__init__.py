"""Fleet: the distributed training entry. Port of
``paddle_tpu/distributed/fleet/__init__.py:59-105``: ``fleet.init``
builds the hybrid topology (one subgroup a mesh axis) from
``strategy.hybrid_configs`` over the world's ranks and installs it as the
process topology. ``distributed_model``, ``distributed_optimizer``,
``meta_parallel``'s layers and the rest of fleet raise citing ROADMAP
Queue 1 step K4."""
from ... import _deferred
from .strategy import DistributedStrategy  # noqa: F401
from ..topology import HybridTopology, set_topology

# the reference's names for the topology (fleet/base/topology.py)
CommunicateTopology = HybridTopology
HybridCommunicateGroup = HybridTopology

_fleet_state = {'initialized': False, 'strategy': None}


def init(role_maker=None, is_collective=False, strategy=None):
    """Validate the strategy's degrees against the world, build the
    ``HybridTopology`` and install it; -> the topology."""
    from .. import get_world_size
    strategy = strategy or DistributedStrategy()
    deg = strategy.validate_degrees(get_world_size())
    topo = HybridTopology(**deg)
    set_topology(topo)
    _fleet_state['initialized'] = True
    _fleet_state['strategy'] = strategy
    return topo


def is_initialized():
    return _fleet_state['initialized']


def get_strategy():
    return _fleet_state['strategy'] or DistributedStrategy()


def worker_index():
    from .. import get_rank
    return get_rank()


def worker_num():
    from .. import get_world_size
    return get_world_size()


def is_first_worker():
    return worker_index() == 0


_deferred.install(
    globals(), 'is not ported yet (ROADMAP Queue 1 step K4)',
    functions=('distributed_model', 'distributed_optimizer', 'recompute',
               'get_rng_state_tracker', 'is_worker', 'is_server',
               'init_worker', 'stop_worker', 'init_server', 'run_server',
               'save_inference_model', 'save_persistables', 'barrier_worker',
               'shard_opt_state'),
    classes=('ColumnParallelLinear', 'RowParallelLinear',
             'VocabParallelEmbedding', 'PipelineLayer', 'LayerDesc', 'Role',
             'Fleet', 'UtilBase', 'RoleMakerBase', 'PaddleCloudRoleMaker',
             'UserDefinedRoleMaker', 'DatasetBase', 'BoxPSDataset',
             'InMemoryDataset', 'QueueDataset', 'FileInstantDataset',
             'MultiSlotDataGenerator', 'MultiSlotStringDataGenerator'))
