"""Vision transforms (``paddle_tpu/vision/transforms``): ROADMAP Queue 1
item 9, step H (rest); each name raises (``vision/_deferred.py``)."""
from ._deferred import install

__all__ = [
    'BaseTransform', 'BrightnessTransform', 'CenterCrop', 'ColorJitter',
    'Compose', 'ContrastTransform', 'Grayscale', 'HueTransform', 'Normalize',
    'Pad', 'RandomCrop', 'RandomHorizontalFlip', 'RandomResizedCrop',
    'RandomRotation', 'RandomVerticalFlip', 'Resize', 'SaturationTransform',
    'ToTensor', 'Transpose', 'adjust_brightness', 'adjust_contrast',
    'adjust_hue', 'adjust_saturation', 'center_crop', 'crop', 'hflip',
    'normalize', 'pad', 'resize', 'rotate', 'to_grayscale', 'to_tensor',
    'vflip']
install(globals(), classes=[n for n in __all__ if n[0].isupper()],
        functions=[n for n in __all__ if n[0].islower()])
