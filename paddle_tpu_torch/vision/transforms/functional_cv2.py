"""cv2-backend transform functionals. Port of
``paddle_tpu/vision/transforms/functional_cv2.py``: ndarray (HWC, BGR as
cv2 loads it) transforms through OpenCV's kernels, which differ from the
PIL and 'tensor' backends'. Selected by ``set_image_backend('cv2')`` for
ndarray inputs, and imported only then.
"""
import numpy as np

import cv2

def _fill_value(img, fill):
    """cv2 converts a numeric border value to Scalar(v,0,0,0): only
    channel 0 filled (a blue border on BGR). Broadcast scalars to every
    channel."""
    if np.isscalar(fill) and img.ndim == 3:
        return (float(fill),) * img.shape[-1]
    return fill


def _is_single_channel(img):
    return img.ndim == 2 or img.shape[-1] == 1


_INTER = {
    'nearest': cv2.INTER_NEAREST,
    'bilinear': cv2.INTER_LINEAR,
    'bicubic': cv2.INTER_CUBIC,
    'area': cv2.INTER_AREA,
    'lanczos': cv2.INTER_LANCZOS4,
}


def resize(img, size, interpolation='bilinear'):
    img = np.asarray(img)
    if isinstance(size, int):
        h, w = img.shape[:2]
        if h < w:
            nh, nw = size, int(size * w / h)
        else:
            nh, nw = int(size * h / w), size
    else:
        nh, nw = size
    return cv2.resize(img, (nw, nh), interpolation=_INTER[interpolation])


def hflip(img):
    return cv2.flip(np.asarray(img), 1)


def vflip(img):
    return cv2.flip(np.asarray(img), 0)


def pad(img, padding, fill=0, padding_mode='constant'):
    if isinstance(padding, int):
        padding = (padding,) * 4
    elif len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    left, top, right, bottom = padding
    mode = {'constant': cv2.BORDER_CONSTANT, 'edge': cv2.BORDER_REPLICATE,
            'reflect': cv2.BORDER_REFLECT_101,
            'symmetric': cv2.BORDER_REFLECT}[padding_mode]
    img = np.asarray(img)
    return cv2.copyMakeBorder(img, top, bottom, left, right, mode,
                              value=_fill_value(img, fill))


def rotate(img, angle, interpolation='nearest', expand=False, center=None,
           fill=0):
    img = np.asarray(img)
    h, w = img.shape[:2]
    if center is None:
        center = (w / 2.0, h / 2.0)
    m = cv2.getRotationMatrix2D(center, angle, 1.0)
    if expand:
        cos, sin = abs(m[0, 0]), abs(m[0, 1])
        nw = int(h * sin + w * cos)
        nh = int(h * cos + w * sin)
        m[0, 2] += nw / 2.0 - center[0]
        m[1, 2] += nh / 2.0 - center[1]
        w, h = nw, nh
    return cv2.warpAffine(img, m, (w, h), flags=_INTER[interpolation],
                          borderValue=_fill_value(img, fill))


def adjust_brightness(img, brightness_factor):
    img = np.asarray(img)
    return cv2.convertScaleAbs(img, alpha=brightness_factor, beta=0)


def adjust_contrast(img, contrast_factor):
    img = np.asarray(img)
    mean = (round(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).mean())
            if not _is_single_channel(img) else round(img.mean()))
    return cv2.convertScaleAbs(img, alpha=contrast_factor,
                               beta=(1 - contrast_factor) * mean)


def adjust_saturation(img, saturation_factor):
    img = np.asarray(img)
    if _is_single_channel(img):
        return img.copy()        # grayscale has no chroma (PIL 'L' parity)
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)[:, :, None]
    out = (img.astype(np.float32) * saturation_factor
           + gray.astype(np.float32) * (1 - saturation_factor))
    return np.clip(out, 0, 255).astype(img.dtype)


def adjust_hue(img, hue_factor):
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError('hue_factor must be in [-0.5, 0.5]')
    img = np.asarray(img)
    if _is_single_channel(img):
        return img.copy()        # grayscale has no hue
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    h = hsv[..., 0].astype(np.int16)
    hsv[..., 0] = ((h + int(hue_factor * 180)) % 180).astype(hsv.dtype)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)


def to_grayscale(img, num_output_channels=1):
    img = np.asarray(img)
    if _is_single_channel(img):
        gray = img.reshape(img.shape[:2])
    else:
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    if num_output_channels == 3:
        return cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
    return gray[:, :, None]
