"""PIL-backend transform functionals. Port of
``paddle_tpu/vision/transforms/functional_pil.py``: PIL Images through
PIL's own resampling and enhancement kernels (which differ from the
'tensor' backend's), taken and returned as PIL Images unless stated.
Imported only for a PIL input, so Pillow is needed only then.
"""
import numpy as np

from PIL import Image, ImageEnhance, ImageOps

_RESAMPLE = {
    'nearest': Image.NEAREST,
    'bilinear': Image.BILINEAR,
    'bicubic': Image.BICUBIC,
    'lanczos': Image.LANCZOS,
    'box': Image.BOX,
    'hamming': Image.HAMMING,
}


def _resample(interpolation):
    try:
        return _RESAMPLE[interpolation]
    except KeyError:
        raise ValueError(
            f'unsupported PIL interpolation {interpolation!r}') from None


def to_tensor(pic, data_format='CHW'):
    from ...core.tensor import Tensor
    arr = np.asarray(pic, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    arr = arr / 255.0
    if data_format == 'CHW':
        arr = arr.transpose(2, 0, 1)
    return Tensor(arr)


def resize(img, size, interpolation='bilinear'):
    if isinstance(size, int):
        w, h = img.size
        if h < w:
            nh, nw = size, int(size * w / h)
        else:
            nh, nw = int(size * h / w), size
    else:
        nh, nw = size
    return img.resize((nw, nh), _resample(interpolation))


def crop(img, top, left, height, width):
    return img.crop((left, top, left + width, top + height))


def center_crop(img, output_size):
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    w, h = img.size
    th, tw = output_size
    i = max((h - th) // 2, 0)
    j = max((w - tw) // 2, 0)
    return crop(img, i, j, th, tw)


def hflip(img):
    return img.transpose(Image.FLIP_LEFT_RIGHT)


def vflip(img):
    return img.transpose(Image.FLIP_TOP_BOTTOM)


def pad(img, padding, fill=0, padding_mode='constant'):
    if isinstance(padding, int):
        padding = (padding,) * 4
    elif len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    left, top, right, bottom = padding
    if padding_mode == 'constant':
        return ImageOps.expand(img, (left, top, right, bottom), fill=fill)
    # reflect/edge/symmetric ride the numpy path then convert back
    arr = np.asarray(img)
    mode = {'reflect': 'reflect', 'edge': 'edge',
            'symmetric': 'symmetric'}[padding_mode]
    width = [(top, bottom), (left, right)] + [(0, 0)] * (arr.ndim - 2)
    return Image.fromarray(np.pad(arr, width, mode=mode))


def rotate(img, angle, interpolation='nearest', expand=False, center=None,
           fill=0):
    return img.rotate(angle, resample=_resample(interpolation),
                      expand=expand, center=center, fillcolor=fill)


def adjust_brightness(img, brightness_factor):
    return ImageEnhance.Brightness(img).enhance(brightness_factor)


def adjust_contrast(img, contrast_factor):
    return ImageEnhance.Contrast(img).enhance(contrast_factor)


def adjust_saturation(img, saturation_factor):
    return ImageEnhance.Color(img).enhance(saturation_factor)


def adjust_hue(img, hue_factor):
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError('hue_factor must be in [-0.5, 0.5]')
    mode = img.mode
    if mode in ('L', '1', 'I', 'F'):
        return img
    h, s, v = img.convert('HSV').split()
    h_arr = np.asarray(h, dtype=np.uint8)
    h_arr = (h_arr.astype(np.int16)
             + int(hue_factor * 255)).astype(np.uint8)   # wraps mod 256
    h = Image.fromarray(h_arr, 'L')
    return Image.merge('HSV', (h, s, v)).convert(mode)


def to_grayscale(img, num_output_channels=1):
    gray = img.convert('L')
    if num_output_channels == 3:
        return Image.merge('RGB', (gray, gray, gray))
    return gray


def normalize(img, mean, std, data_format='CHW', to_rgb=False):
    """PIL input -> normalized float ndarray (PIL cannot hold floats; the
    reference converts too)."""
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if to_rgb:
        arr = arr[..., ::-1]
    if data_format == 'CHW':
        arr = arr.transpose(2, 0, 1)
        shape = (-1, 1, 1)
    else:
        shape = (1, 1, -1)
    mean = np.asarray(mean, np.float32).reshape(shape)
    std = np.asarray(std, np.float32).reshape(shape)
    return (arr - mean) / std
