"""Pooling (``paddle_tpu/nn/functional/pooling.py``): step J3, each name
raises (``nn/_deferred.py``)."""
from .._deferred import install

__all__ = ['adaptive_avg_pool1d', 'adaptive_avg_pool2d',
           'adaptive_avg_pool3d', 'adaptive_max_pool1d',
           'adaptive_max_pool2d', 'adaptive_max_pool3d', 'avg_pool1d',
           'avg_pool2d', 'avg_pool3d', 'max_pool1d', 'max_pool2d',
           'max_pool3d']
install(globals(), functions=__all__)
