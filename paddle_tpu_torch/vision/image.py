"""The image backend. Port of ``paddle_tpu/vision/image.py``.

Pillow and OpenCV are imported only when an image is loaded through them:
``import paddle_tpu_torch.vision`` and the 'tensor' backend need neither.
"""
import numpy as np

_backend = 'tensor'


def set_image_backend(backend):
    global _backend
    if backend not in ('pil', 'cv2', 'tensor'):
        raise ValueError(f'unsupported backend {backend}')
    _backend = backend


def get_image_backend():
    return _backend


def image_load(path, backend=None):
    """Load an image as the active backend's native type: a PIL Image
    ('pil' and 'tensor') or a 3-channel BGR ndarray ('cv2'); ``.npy`` files
    as their array."""
    if path.endswith('.npy'):
        return np.load(path)
    backend = backend or _backend
    if backend == 'cv2':
        try:
            import cv2
        except ImportError as e:
            raise ImportError('cv2 backend selected but OpenCV is not '
                              'installed') from e
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f'cv2 could not read image: {path!r}')
        return img
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError('Pillow required for non-.npy images') from e
    return Image.open(path)
