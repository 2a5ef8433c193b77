"""Quantization. Port of ``paddle_tpu/quantization/__init__.py``.

Ported: ``fp8``, the e4m3/e5m2 delayed-scaling matmul of the GPT and MoE
train steps (``matmul_precision='fp8'``). The rest of the reference's
names are Layer wrappers and calibration passes over ``nn`` layers, which
wait with ``nn.quant`` for ROADMAP Queue 1 step J3: each one raises.
"""
from . import fp8  # noqa: F401

__all__ = ['ImperativeQuantAware', 'PostTrainingQuantization',
           'quant_post_dynamic', 'quantize_weights', 'weight_only_quantize',
           'convert_calibrated', 'WeightOnlyLinear', 'WeightOnlyConv2D',
           'WeightOnlyEmbedding', 'fp8']

_TODO = 'is not ported yet (ROADMAP Queue 1 item 7, step J3: the rest of nn)'


def _deferred(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(f'paddle.quantization.{name} {_TODO}')
    fn.__name__ = fn.__qualname__ = name
    return fn


for _name in __all__[:-1]:
    globals()[_name] = _deferred(_name)
