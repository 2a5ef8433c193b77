"""Convolution layers (``paddle_tpu/nn/layer_conv.py``): step J3, each
name raises (``nn/_deferred.py``)."""
from ._deferred import install

install(globals(), layers=('Conv1D', 'Conv1DTranspose', 'Conv2D',
                           'Conv2DTranspose', 'Conv3D', 'Conv3DTranspose'))
