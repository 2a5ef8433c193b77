"""Vision models. Port of ``paddle_tpu/vision/models``."""
from .lenet import LeNet  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
    wide_resnet50_2, wide_resnet101_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenet import (  # noqa: F401
    MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2)
