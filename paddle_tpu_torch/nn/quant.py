"""Quantized layers and passes (``paddle_tpu/nn/quant.py``): step J3,
each name raises (``nn/_deferred.py``)."""
from ._deferred import install

install(globals(), functions=(
    'convert_calibrated', 'fake_channel_wise_quantize_abs_max',
    'fake_quantize_abs_max', 'fake_quantize_moving_average_abs_max',
    'quantize_model', 'weight_only_quantize'),
    layers=('FakeQuantAbsMax', 'QuantizedConv2D', 'QuantizedLinear',
            'WeightOnlyConv2D', 'WeightOnlyEmbedding', 'WeightOnlyLinear'))
