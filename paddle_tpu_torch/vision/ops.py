"""Vision ops (``paddle_tpu/vision/ops.py``): ROADMAP Queue 1 item 9, step
H (rest); each name raises (``vision/_deferred.py``)."""
from ._deferred import install

install(globals(), classes=('DeformConv2D',),
        functions=('box_coder', 'decode_jpeg', 'deform_conv2d', 'nms',
                   'nms_static', 'psroi_pool', 'read_file', 'roi_align',
                   'yolo_box', 'yolo_loss'))
