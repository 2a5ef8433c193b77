"""paddle.static (port of ``paddle_tpu/static``): ``InputSpec``, which
``jit.save`` and the serving warmup take. The static graph mode itself
(Program, Executor, the static layers and the inference-model files) waits
for ROADMAP Queue 1 item 12, step L: every other name of the reference's
package exists here and raises ``NotImplementedError`` citing that step."""
from .. import _deferred
from .input_spec import InputSpec  # noqa: F401
from . import amp, nn  # noqa: F401

WHY = 'is not ported yet (ROADMAP Queue 1 item 12, step L)'

_deferred.install(
    globals(), WHY,
    functions=(
        'default_main_program', 'default_startup_program', 'data',
        'global_scope', 'name_scope', 'iter_replay_inputs', 'walk_program',
        'accuracy', 'append_backward', 'auc', 'cpu_places',
        'create_global_var', 'create_parameter', 'cuda_places',
        'tpu_places', 'xpu_places', 'deserialize_persistables',
        'deserialize_program', 'device_guard', 'gradients', 'load',
        'load_from_file', 'load_inference_model', 'load_program_state',
        'load_vars', 'normalize_program', 'py_func', 'save',
        'save_inference_model', 'save_to_file', 'save_vars',
        'serialize_persistables', 'serialize_program', 'set_program_state',
        'Print'),
    classes=('Variable', 'Program', 'program_guard', 'Executor',
             'scope_guard', 'CompiledProgram', 'BuildStrategy',
             'ExecutionStrategy', 'Scope', 'WeightNormParamAttr',
             'ExponentialMovingAverage', 'ParallelExecutor'))
