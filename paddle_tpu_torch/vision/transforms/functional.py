"""Transform functionals: the numpy 'tensor' backend, with per-type
dispatch to the PIL and cv2 backends. Port of
``paddle_tpu/vision/transforms/functional.py``.

Dispatch rule: a PIL.Image input always takes the PIL kernels (and returns
a PIL Image); an ndarray input takes the cv2 kernels when
``paddle.vision.set_image_backend('cv2')`` is active; everything else
(ndarray or Tensor under the default 'tensor' backend) runs the numpy
bodies below. The three backends' interpolation and enhancement kernels
differ, as in the reference. Pillow and OpenCV are imported only when an
input takes their backend.

``resize`` on the 'tensor' backend is the reference's ``jax.image.resize``
(half-pixel sampling; antialiased triangle and Keys-cubic kernels scaled
when downsampling; nearest by a floor of the half-pixel offsets), kept as
numpy: a float32 weight matrix an axis, contracted in turn.
"""
import sys

import numpy as np

from ...core.tensor import Tensor


def _backend_dispatch(fn):
    """Route the first argument through the PIL/cv2 backends when they
    claim it (see _route); otherwise run the tensor-path body below."""
    import functools

    @functools.wraps(fn)
    def wrapper(img, *args, **kwargs):
        r = _route(img, fn.__name__, *args, **kwargs)
        if r is not None:
            return r
        return fn(img, *args, **kwargs)
    return wrapper


def _is_pil(img):
    """A PIL Image? Pillow is consulted only once something imported it:
    an object cannot be a PIL Image before then."""
    pil = sys.modules.get('PIL.Image')
    return pil is not None and isinstance(img, pil.Image)


def _route(img, name, *args, **kwargs):
    """-> backend result, or None to continue on the tensor path."""
    is_pil = _is_pil(img)
    if is_pil:
        from . import functional_pil as _F
        if hasattr(_F, name):
            return getattr(_F, name)(img, *args, **kwargs)
        raise TypeError(f'{name} does not accept PIL Images')
    from ..image import get_image_backend
    if get_image_backend() == 'cv2' and isinstance(img, np.ndarray):
        try:
            from . import functional_cv2 as _F
        except ImportError as e:
            raise ImportError(
                'set_image_backend(\'cv2\') is active but OpenCV is not '
                'installed — install cv2 or switch backends (a silent '
                'tensor-path fallback would change pixel semantics)') from e
        if hasattr(_F, name):
            return getattr(_F, name)(img, *args, **kwargs)
    return None


def _np(img):
    if isinstance(img, Tensor):
        return img._value.detach().cpu().numpy()
    return np.asarray(img)


def _triangle(x):
    return np.maximum(0, 1 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., 0., out)


def _weight_mat(m, n, kernel):
    """[m, n] float32 weights of output pixel j over input pixel i
    (``jax.image``'s ``compute_weight_mat`` at scale n / m, no
    translation, antialiased)."""
    f32 = np.float32
    inv_scale = 1. / (n / m)            # in double, as jax computes it
    kernel_scale = f32(max(inv_scale, 1.))
    sample_f = ((np.arange(n, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None])
         / kernel_scale)
    weights = kernel(x).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > f32(1000. * float(np.finfo(np.float32).eps)),
        weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(m) - f32(0.5))
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def _resize_array(arr, shape, method):
    """``jax.image.resize(arr, shape, method)`` in numpy."""
    if method == 'nearest':
        for d, (m, n) in enumerate(zip(arr.shape, shape)):
            if m == n:
                continue
            offsets = ((np.arange(n, dtype=np.float32) + np.float32(0.5))
                       * np.float32(m) / np.float32(n))
            idx = np.floor(offsets.astype(np.float32)).astype(np.int32)
            arr = np.take(arr, idx, axis=d)
        return arr
    kernel = _keys_cubic if method == 'bicubic' else _triangle
    out = np.asarray(arr, np.float32)
    for d, (m, n) in enumerate(zip(arr.shape, shape)):
        if m == n:
            continue
        w = _weight_mat(m, n, kernel)
        out = np.moveaxis(np.tensordot(out, w, axes=([d], [0])), -1, d)
    return out.astype(np.float32)


@_backend_dispatch
def to_tensor(pic, data_format='CHW'):
    arr = _np(pic).astype('float32')
    if arr.max() > 1.5:
        arr = arr / 255.0
    if data_format == 'CHW' and arr.ndim == 3:
        arr = arr.transpose(2, 0, 1)
    return Tensor(arr)


@_backend_dispatch
def resize(img, size, interpolation='bilinear'):
    arr = _np(img)
    if isinstance(size, int):
        h, w = arr.shape[:2]
        if h < w:
            nh, nw = size, int(size * w / h)
        else:
            nh, nw = int(size * h / w), size
    else:
        nh, nw = size
    method = {'bilinear': 'bilinear', 'nearest': 'nearest',
              'bicubic': 'bicubic'}.get(interpolation, 'bilinear')
    out_shape = (nh, nw) + arr.shape[2:]
    return _resize_array(arr, out_shape, method)


@_backend_dispatch
def crop(img, top, left, height, width):
    return _np(img)[top:top + height, left:left + width]


@_backend_dispatch
def center_crop(img, output_size):
    arr = _np(img)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    h, w = arr.shape[:2]
    th, tw = output_size
    i = max((h - th) // 2, 0)
    j = max((w - tw) // 2, 0)
    return crop(arr, i, j, th, tw)


@_backend_dispatch
def hflip(img):
    return _np(img)[:, ::-1]


@_backend_dispatch
def vflip(img):
    return _np(img)[::-1]


@_backend_dispatch
def pad(img, padding, fill=0, padding_mode='constant'):
    arr = _np(img)
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)
    if len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    l, t, r, b = padding
    cfg = [(t, b), (l, r)] + [(0, 0)] * (arr.ndim - 2)
    mode = {'constant': 'constant', 'edge': 'edge', 'reflect': 'reflect',
            'symmetric': 'symmetric'}[padding_mode]
    if mode == 'constant':
        return np.pad(arr, cfg, mode=mode, constant_values=fill)
    return np.pad(arr, cfg, mode=mode)


@_backend_dispatch
def rotate(img, angle, interpolation='nearest', expand=False, center=None,
           fill=0):
    arr = _np(img)
    k = int(round(angle / 90.0)) % 4
    if abs(angle - 90 * round(angle / 90.0)) < 1e-6:
        return np.rot90(arr, k).copy()
    # arbitrary-angle nearest rotation
    h, w = arr.shape[:2]
    cy, cx = (h - 1) / 2, (w - 1) / 2
    theta = np.deg2rad(angle)
    yy, xx = np.mgrid[0:h, 0:w]
    ys = cy + (yy - cy) * np.cos(theta) - (xx - cx) * np.sin(theta)
    xs = cx + (yy - cy) * np.sin(theta) + (xx - cx) * np.cos(theta)
    ysc = np.clip(np.round(ys).astype(int), 0, h - 1)
    xsc = np.clip(np.round(xs).astype(int), 0, w - 1)
    out = arr[ysc, xsc]
    mask = (ys < 0) | (ys > h - 1) | (xs < 0) | (xs > w - 1)
    out[mask] = fill
    return out


@_backend_dispatch
def adjust_brightness(img, brightness_factor):
    arr = _np(img).astype('float32')
    hi = 255.0 if arr.max() > 1.5 else 1.0
    return np.clip(arr * brightness_factor, 0, hi).astype(_np(img).dtype)


@_backend_dispatch
def adjust_contrast(img, contrast_factor):
    arr = _np(img).astype('float32')
    hi = 255.0 if arr.max() > 1.5 else 1.0
    mean = arr.mean()
    return np.clip(mean + contrast_factor * (arr - mean), 0, hi).astype(_np(img).dtype)


@_backend_dispatch
def adjust_saturation(img, saturation_factor):
    arr = _np(img).astype('float32')
    hi = 255.0 if arr.max() > 1.5 else 1.0
    gray = arr.mean(axis=-1, keepdims=True)
    return np.clip(gray + saturation_factor * (arr - gray), 0, hi).astype(_np(img).dtype)


@_backend_dispatch
def adjust_hue(img, hue_factor):
    arr = _np(img).astype('float32')
    scale = 255.0 if arr.max() > 1.5 else 1.0
    x = arr / scale
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.max(-1)
    minc = x.min(-1)
    v = maxc
    deltac = maxc - minc
    s = np.where(maxc > 0, deltac / np.maximum(maxc, 1e-12), 0)
    dc = np.maximum(deltac, 1e-12)
    rc, gc, bc = (maxc - r) / dc, (maxc - g) / dc, (maxc - b) / dc
    h = np.where(r == maxc, bc - gc, np.where(g == maxc, 2 + rc - bc, 4 + gc - rc))
    h = (h / 6.0) % 1.0
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6).astype(int)
    f = h * 6 - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = i % 6
    out = np.select(
        # conditions lifted to [..., 1] so they broadcast against the
        # [..., 3] RGB choices
        [(i == k)[..., None] for k in range(6)],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return (out * scale).astype(_np(img).dtype)


@_backend_dispatch
def normalize(img, mean, std, data_format='CHW', to_rgb=False):
    arr = _np(img).astype('float32')
    mean = np.asarray(mean, 'float32')
    std = np.asarray(std, 'float32')
    if data_format == 'CHW':
        mean = mean.reshape(-1, 1, 1)
        std = std.reshape(-1, 1, 1)
    return (arr - mean) / std


@_backend_dispatch
def to_grayscale(img, num_output_channels=1):
    arr = _np(img).astype('float32')
    gray = (0.2989 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2])
    gray = gray[..., None]
    if num_output_channels == 3:
        gray = np.repeat(gray, 3, axis=-1)
    return gray.astype(_np(img).dtype)
