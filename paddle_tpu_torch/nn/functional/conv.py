"""Convolutions (``paddle_tpu/nn/functional/conv.py``): step J3, each
name raises (``nn/_deferred.py``)."""
from .._deferred import install

install(globals(), functions=('conv1d', 'conv1d_transpose', 'conv2d',
                              'conv2d_transpose', 'conv3d',
                              'conv3d_transpose'))
