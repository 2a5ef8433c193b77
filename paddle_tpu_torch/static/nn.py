"""paddle.static.nn (port of ``paddle_tpu/static/nn.py``): the static
layers wait for ROADMAP Queue 1 item 12, step L; each name raises."""
from .. import _deferred

_deferred.install(
    globals(), 'is not ported yet (ROADMAP Queue 1 item 12, step L)',
    functions=(
        'fc', 'conv2d', 'batch_norm', 'embedding', 'layer_norm',
        'group_norm', 'instance_norm', 'prelu', 'conv2d_transpose', 'conv3d',
        'conv3d_transpose', 'deform_conv2d', 'bilinear_tensor_product',
        'spectral_norm', 'data_norm', 'cond', 'case', 'switch_case',
        'while_loop', 'py_func', 'crf_decoding', 'sequence_concat',
        'sequence_conv', 'sequence_enumerate', 'sequence_expand',
        'sequence_expand_as', 'sequence_first_step', 'sequence_last_step',
        'sequence_pad', 'sequence_pool', 'sequence_reshape',
        'sequence_reverse', 'sequence_scatter', 'sequence_slice',
        'sequence_softmax', 'sequence_unpad', 'nce', 'row_conv',
        'multi_box_head', 'sparse_embedding'))
