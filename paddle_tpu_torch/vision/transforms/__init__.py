"""paddle.vision.transforms. Port of
``paddle_tpu/vision/transforms/__init__.py``."""
from .transforms import (  # noqa: F401
    BaseTransform, BrightnessTransform, CenterCrop, ColorJitter, Compose,
    ContrastTransform, Grayscale, HueTransform, Normalize, Pad, RandomCrop,
    RandomHorizontalFlip, RandomResizedCrop, RandomRotation, RandomVerticalFlip,
    Resize, SaturationTransform, ToTensor, Transpose)
from . import functional  # noqa: F401
# the functional API at this level too, as the reference exports it
from .functional import (  # noqa: F401
    adjust_brightness, adjust_contrast, adjust_hue, adjust_saturation,
    center_crop, crop, hflip, normalize, pad, resize, rotate, to_grayscale,
    to_tensor, vflip)

# explicit __all__: without it, `from .transforms import *` in
# vision/__init__ would re-export the SUBMODULE attribute named
# 'transforms' and rebind paddle.vision.transforms to the inner module
__all__ = [
    'BaseTransform', 'BrightnessTransform', 'CenterCrop', 'ColorJitter',
    'Compose', 'ContrastTransform', 'Grayscale', 'HueTransform', 'Normalize',
    'Pad', 'RandomCrop', 'RandomHorizontalFlip', 'RandomResizedCrop',
    'RandomRotation', 'RandomVerticalFlip', 'Resize', 'SaturationTransform',
    'ToTensor', 'Transpose',
    'adjust_brightness', 'adjust_contrast', 'adjust_hue',
    'adjust_saturation', 'center_crop', 'crop', 'hflip', 'normalize', 'pad',
    'resize', 'rotate', 'to_grayscale', 'to_tensor', 'vflip',
]
