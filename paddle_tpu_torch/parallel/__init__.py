"""Parallelism of the port: the rules-table partitioner, Megatron's f/g
pair, ring (flash) attention over the sp axis, the GPipe and 1F1B
pipelines, ZeRO 1-3 (step K1), the Mixture-of-Experts layer on one device
and over dp / ep / mp (``moe``, step K2) and mesh-sharded serving
(``mesh_engine``, step K3), and the Layer path's sharded train step
(``parallelize``: ``shard_params``, ``make_sharded_train_step``) and
LocalSGD (``localsgd``, step K4a)."""
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

from . import mesh_engine  # noqa: F401
from .mesh_engine import MeshContext, build_mesh, serving_rules  # noqa: F401
from . import localsgd  # noqa: F401
from . import parallelize  # noqa: F401
from .parallelize import (  # noqa: F401
    make_sharded_train_step, param_spec, shard_params)
