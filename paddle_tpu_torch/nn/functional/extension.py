"""Functional extensions (``paddle_tpu/nn/functional/extension.py``):
step J3, each name raises (``nn/_deferred.py``)."""
from .._deferred import install

install(globals(), functions=(
    'class_center_sample', 'diag_embed', 'elu_', 'gather_tree',
    'hsigmoid_loss', 'margin_cross_entropy', 'max_unpool2d',
    'sequence_mask', 'tanh_'))
