"""paddle.vision. Port of ``paddle_tpu/vision/__init__.py``: the models
(LeNet, ResNet, VGG, MobileNetV1/V2), datasets, transforms (tensor, PIL and
cv2 backends), ops (NMS as one operator, ROI align and pooling, YOLO box
and loss, deformable conv), the detection losses and the image backend.
Pillow and OpenCV are imported only when an input takes their backend.
"""
from . import datasets  # noqa: F401
from . import detection  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401
from .image import (  # noqa: F401
    set_image_backend, get_image_backend, image_load)
from .transforms import *  # noqa: F401,F403
from .datasets import (  # noqa: F401
    Cifar10, Cifar100, DatasetFolder, FashionMNIST, Flowers, ImageFolder,
    MNIST, VOC2012)
from .models import *  # noqa: F401,F403
