"""paddle.vision. Port of ``paddle_tpu/vision/__init__.py``.

Ported: ``models`` (LeNet, ResNet, VGG, MobileNetV1/V2). ``datasets``,
``transforms``, ``ops``, ``detection`` and the image backend wait for
ROADMAP Queue 1 item 9, step H (rest): each name exists and raises.
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
