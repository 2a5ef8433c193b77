"""Detection heads' math (``paddle_tpu/vision/detection.py``): ROADMAP
Queue 1 item 9, step H (rest); each name raises
(``vision/_deferred.py``)."""
from ._deferred import install

install(globals(), functions=(
    'anchor_points', 'dfl_decode', 'distribution_focal_loss', 'giou_loss',
    'pairwise_iou', 'task_aligned_assign', 'varifocal_loss'))
