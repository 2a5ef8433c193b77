"""paddle.nn.functional. Port of ``paddle_tpu/nn/functional/__init__.py``."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import (  # noqa: F401
    conv1d, conv2d, conv3d, conv1d_transpose, conv2d_transpose,
    conv3d_transpose)
from .pooling import *  # noqa: F401,F403
from .norm import (  # noqa: F401
    batch_norm, instance_norm, layer_norm, local_response_norm, normalize,
    group_norm_fn, instance_norm_fn)
from .loss import *  # noqa: F401,F403
from .sparse_attention import scaled_dot_product_attention  # noqa: F401
from .extension import (  # noqa: F401
    class_center_sample, diag_embed, elu_, gather_tree, hsigmoid_loss,
    margin_cross_entropy, max_unpool2d, sequence_mask, tanh_)
