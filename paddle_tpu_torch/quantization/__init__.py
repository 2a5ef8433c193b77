"""Quantization: dygraph quantization-aware training, post-training
calibration, weight-only int8 layers and fp8 training. Port of
``paddle_tpu/quantization/__init__.py``.

``ImperativeQuantAware`` wraps a model's Linear / Conv2D layers in the
fake-quant wrappers of ``nn/quant.py``; ``quant_post_dynamic`` /
``PostTrainingQuantization`` observe activation scales over sample
batches and convert the wrappers into weight-only int8 layers;
``quantize_weights`` snapshots any Layer's Linear / Conv2D / Embedding
weights to int8. ``fp8`` is the e4m3/e5m2 delayed-scaling matmul of the
GPT and MoE train steps (``matmul_precision='fp8'``).

Not ported: ``save_quantized_model`` exports through ``jit.save``, which
waits for ROADMAP Queue 1 step L, and raises.
"""
import numpy as np

from ..nn import quant as _q
from ..nn.quant import (  # noqa: F401
    WeightOnlyConv2D, WeightOnlyEmbedding, WeightOnlyLinear,
    convert_calibrated, weight_only_quantize)
from . import fp8  # noqa: F401

__all__ = ['ImperativeQuantAware', 'PostTrainingQuantization',
           'quant_post_dynamic', 'quantize_weights', 'weight_only_quantize',
           'convert_calibrated', 'WeightOnlyLinear', 'WeightOnlyConv2D',
           'WeightOnlyEmbedding', 'fp8']


def _jit_save_deferred(what):
    return NotImplementedError(
        f'{what} exports through jit.save, which is not ported yet '
        '(ROADMAP Queue 1 step L)')


def quantize_weights(layer):
    """Weight-only int8 snapshot of any Layer for serving: every Linear,
    Conv2D and Embedding sublayer swapped for its int8 form in place."""
    from ..nn.layer_common import Embedding, Linear
    from ..nn.layer_conv import Conv2D
    return weight_only_quantize(layer,
                                layer_types=(Linear, Conv2D, Embedding))


class ImperativeQuantAware:
    """Dygraph quantization-aware training::

        quanter = ImperativeQuantAware()
        quanter.quantize(model)           # QAT wrappers in place
        ... train as usual ...
    """

    def __init__(self, quantizable_layer_type=('Conv2D', 'Linear'),
                 weight_quantize_type='abs_max',
                 activation_quantize_type='moving_average_abs_max',
                 weight_bits=8, activation_bits=8, moving_rate=0.9,
                 weight_preprocess_layer=None, act_preprocess_layer=None,
                 weight_quantize_layer=None, act_quantize_layer=None):
        if weight_quantize_type not in ('abs_max', 'channel_wise_abs_max'):
            raise ValueError(f'weight_quantize_type {weight_quantize_type!r} '
                             "not in ('abs_max', 'channel_wise_abs_max')")
        if activation_quantize_type not in ('abs_max',
                                            'moving_average_abs_max'):
            raise ValueError(
                f'activation_quantize_type {activation_quantize_type!r} '
                "not in ('abs_max', 'moving_average_abs_max')")
        unknown = [t for t in quantizable_layer_type
                   if t not in ('Linear', 'Conv2D')]
        if unknown:
            raise ValueError(f'quantizable_layer_type {unknown} not '
                             "supported: this stack quantizes ('Linear', "
                             "'Conv2D')")
        for name, val in (('weight_preprocess_layer', weight_preprocess_layer),
                          ('act_preprocess_layer', act_preprocess_layer),
                          ('weight_quantize_layer', weight_quantize_layer),
                          ('act_quantize_layer', act_quantize_layer)):
            if val is not None:
                raise TypeError(
                    f'{name} is not supported: custom quantizer layers would '
                    'be silently ignored; use the built-in abs_max / '
                    'moving_average_abs_max observers')
        self._types = tuple(quantizable_layer_type)
        self._kw = dict(weight_quantize_type=weight_quantize_type,
                        activation_quantize_type=activation_quantize_type,
                        moving_rate=moving_rate)
        self._wb = weight_bits
        self._ab = activation_bits

    def quantize(self, model):
        """Swap quantizable sublayers for QAT wrappers in place."""
        from ..nn.layer_common import Linear
        from ..nn.layer_conv import Conv2D
        typemap = {'Linear': Linear, 'Conv2D': Conv2D}
        want = tuple(typemap[t] for t in self._types)
        return _q.quantize_model(model, self._wb, self._ab,
                                 layer_types=want, **self._kw)

    def save_quantized_model(self, layer, path, input_spec=None, **config):
        raise _jit_save_deferred('ImperativeQuantAware.save_quantized_model')


def quant_post_dynamic(model, sample_inputs=None, batch_nums=8,
                       weight_bits=8, activation_bits=8,
                       weight_quantize_type='channel_wise_abs_max',
                       moving_rate=0.9):
    """Post-training quantization of a Layer: wrap the quantizable layers
    in observe mode, feed up to ``batch_nums`` batches of
    ``sample_inputs`` (an iterable of model inputs, or a reader creator)
    to record moving-average activation scales, then convert the wrappers
    into weight-only int8 layers carrying those scales. Returns the
    model."""
    _q.quantize_model(model, weight_bits, activation_bits,
                      weight_quantize_type=weight_quantize_type,
                      activation_quantize_type='moving_average_abs_max',
                      moving_rate=moving_rate, observe_only=True)
    model.eval()
    seen = 0
    if callable(sample_inputs):
        sample_inputs = sample_inputs()
    if sample_inputs is not None:
        from ..core.tensor import Tensor, to_tensor

        def _as_input(v):
            return v if isinstance(v, Tensor) else to_tensor(np.asarray(v))

        for i, batch in enumerate(sample_inputs):
            if i >= batch_nums:
                break
            args = batch if isinstance(batch, (tuple, list)) else (batch,)
            model(*[_as_input(a) for a in args])
            seen += 1
    if seen == 0:
        raise ValueError(
            'quant_post_dynamic: no calibration batches were consumed, so '
            'the activation scales would stay 0 and quantized outputs '
            'collapse to ~0. Pass sample_inputs (an iterable of model input '
            'batches).')
    return _q.convert_calibrated(model)


class PostTrainingQuantization:
    """The object form of ``quant_post_dynamic`` over a Layer."""

    def __init__(self, model, sample_generator=None, batch_nums=8,
                 weight_bits=8, activation_bits=8,
                 weight_quantize_type='channel_wise_abs_max',
                 moving_rate=0.9, **kw):
        if kw:
            raise TypeError(
                f'PostTrainingQuantization: unsupported arguments {sorted(kw)}'
                ': the static-graph knobs (executor, model_dir, mkldnn '
                'passes) do not exist in the dygraph stack, see MIGRATING.md')
        self._model = model
        self._gen = sample_generator
        self._args = (batch_nums, weight_bits, activation_bits,
                      weight_quantize_type, moving_rate)

    def quantize(self):
        bn, wb, ab, wt, mr = self._args
        return quant_post_dynamic(self._model, self._gen, batch_nums=bn,
                                  weight_bits=wb, activation_bits=ab,
                                  weight_quantize_type=wt, moving_rate=mr)

    def save_quantized_model(self, save_model_path, input_spec=None):
        raise _jit_save_deferred(
            'PostTrainingQuantization.save_quantized_model')
