"""Parallelism of the port: the rules-table partitioner, Megatron's f/g
pair, ring (flash) attention over the sp axis, the GPipe and 1F1B
pipelines, ZeRO 1-3 (step K1) and the single-device Mixture-of-Experts
layer (``moe``). Mesh-sharded serving (``mesh_engine``) and
``parallelize``'s sharded train step raise citing ROADMAP Queue 1 steps
K3 and K4."""
from .. import _deferred
from . import moe  # noqa: F401
from .moe import moe_ffn, top2_gating  # noqa: F401
from .ring_attention import (  # noqa: F401
    ring_attention, ring_flash_attention, sequence_parallel_attention)
from .pipeline import (  # noqa: F401
    last_stage_mask, pipeline_apply, pipeline_train_1f1b,
    stack_stage_params)
from . import zero  # noqa: F401
from .zero import make_zero_train_step  # noqa: F401
from .partitioner import (  # noqa: F401
    DEFAULT_RULES, PartitionSpec, Partitioner, ShardingRuleError,
    model_rules)
from . import tp_ad  # noqa: F401

_deferred.install(globals(), 'is not ported yet (ROADMAP Queue 1 step K3)',
                  functions=('build_mesh', 'serving_rules'),
                  classes=('MeshContext',))
_deferred.install(globals(), 'is not ported yet (ROADMAP Queue 1 step K4)',
                  functions=('make_sharded_train_step', 'shard_params'))
