"""Pooling layers (``paddle_tpu/nn/layer_pooling.py``): step J3, each
name raises (``nn/_deferred.py``)."""
from ._deferred import install

install(globals(), layers=(
    'AdaptiveAvgPool1D', 'AdaptiveAvgPool2D', 'AdaptiveAvgPool3D',
    'AdaptiveMaxPool1D', 'AdaptiveMaxPool2D', 'AdaptiveMaxPool3D',
    'AvgPool1D', 'AvgPool2D', 'AvgPool3D', 'MaxPool1D', 'MaxPool2D',
    'MaxPool3D'))
