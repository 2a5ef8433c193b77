"""paddle_tpu_torch.vision's transforms, datasets, image backend and file
ops against the JAX package's, on the CPU.

- every transform functional on all three backends ('tensor': numpy
  arrays and Tensors; PIL Images, which stay PIL; ndarrays under
  ``set_image_backend('cv2')``), and the transform classes under one
  ``random`` seed, equal to the reference's outputs: integer images
  exactly, float32 within 1e-6 of the image's largest value;
- the vision datasets over the files ``tests/test_datasets.py`` writes
  (MNIST idx, a CIFAR-10 tar, the Flowers archive and .mat files, a
  VOC2012 tar, a folder tree of .npy images) and their synthetic
  fallbacks, item for item;
- ``image_load``, ``read_file`` and ``decode_jpeg``;
- ``import paddle_tpu_torch.vision``, the tensor backend, a synthetic
  dataset and NMS in a process where Pillow and OpenCV cannot be imported.
"""
import gzip
import io
import os
import pickle
import random
import struct
import subprocess
import sys
import tarfile

import numpy as np
import pytest
from PIL import Image

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device

F32_TOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu_and_tensor_backend():
    prev = port_device._current
    port.set_device('cpu')
    yield
    for P in (ref, port):
        P.vision.set_image_backend('tensor')
    port_device._current = prev


def _arr(x):
    if isinstance(x, Image.Image):
        return np.asarray(x)
    if hasattr(x, 'numpy'):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _equal(got, want):
    """Integer images exactly, floats within 1e-6 of the largest value;
    the same type (PIL stays PIL, arrays stay arrays)."""
    assert type(got).__name__ == type(want).__name__ or (
        isinstance(got, Image.Image) and isinstance(want, Image.Image)), (
        type(got), type(want))
    g, w = _arr(got), _arr(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape,
                                                      g.dtype, w.dtype)
    if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
        np.testing.assert_array_equal(g, w)
    else:
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= F32_TOL * scale


def _images():
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (20, 26, 3), dtype=np.uint8)
    return {'u8': u8, 'f32': (rng.rand(20, 26, 3) * 255).astype('f4'),
            'unit': rng.rand(17, 15, 3).astype('f4'),
            'pil': Image.fromarray(u8)}


FUNCTIONALS = [      # (functional, args, kwargs)
    ('resize', ((12, 30),), {}), ('resize', (10,), {}),
    ('resize', ((40, 13),), dict(interpolation='nearest')),
    ('resize', ((9, 31),), dict(interpolation='bicubic')),
    ('crop', (2, 3, 10, 12), {}), ('center_crop', (11,), {}),
    ('hflip', (), {}), ('vflip', (), {}),
    ('pad', ((1, 2, 3, 4),), dict(fill=7)),
    ('pad', (2,), dict(padding_mode='reflect')),
    ('pad', ((2, 3),), dict(padding_mode='edge')),
    ('rotate', (90,), {}), ('rotate', (33,), dict(fill=0)),
    ('adjust_brightness', (1.3,), {}), ('adjust_contrast', (0.7,), {}),
    ('adjust_saturation', (1.4,), {}), ('adjust_hue', (0.2,), {}),
    ('normalize', ([0.5 * 255] * 3, [0.2 * 255] * 3), dict(
        data_format='HWC')),
    ('to_grayscale', (), {}), ('to_grayscale', (3,), {}),
    ('to_tensor', (), {}),
]


@pytest.mark.parametrize('backend', ['tensor', 'pil', 'cv2'])
def test_functionals_match_the_reference(backend):
    imgs = _images()
    ran = 0
    for name, args, kw in FUNCTIONALS:
        if backend == 'pil':
            inputs = [imgs['pil']]
        elif backend == 'cv2':
            inputs = [imgs['u8']]
        else:
            inputs = [imgs['u8'], imgs['f32'], imgs['unit']]
        for img in inputs:
            outs = []
            for P in (ref, port):
                P.vision.set_image_backend(backend if backend == 'cv2'
                                           else 'tensor')
                try:
                    outs.append(getattr(P.vision.transforms.functional,
                                        name)(img, *args, **kw))
                except (TypeError, AttributeError, KeyError) as e:
                    outs.append(e)
            want, got = outs
            if isinstance(want, Exception):
                assert type(got) is type(want), (name, got, want)
                continue
            _equal(got, want)
            ran += 1
    assert ran >= len(FUNCTIONALS) - 4


def test_tensor_inputs_and_transform_classes_match_the_reference():
    imgs = _images()
    pipes = {
        'compose': lambda T: T.Compose([
            T.Resize((16, 18)), T.RandomHorizontalFlip(0.5),
            T.ToTensor(), T.Normalize([0.5] * 3, [0.25] * 3)]),
        'random_crop': lambda T: T.RandomCrop(12, padding=2),
        'random_crop_pad': lambda T: T.RandomCrop((24, 30),
                                                  pad_if_needed=True),
        'resized_crop': lambda T: T.RandomResizedCrop(10),
        'jitter': lambda T: T.ColorJitter(0.4, 0.4, 0.4, 0.1),
        'rotation': lambda T: T.RandomRotation(20),
        'vflip': lambda T: T.RandomVerticalFlip(1.0),
        'gray': lambda T: T.Grayscale(3),
        'pad': lambda T: T.Pad(3, fill=1, padding_mode='constant'),
        'transpose': lambda T: T.Transpose(),
        'center': lambda T: T.CenterCrop((8, 10)),
        'brightness': lambda T: T.BrightnessTransform(0.5),
        'contrast': lambda T: T.ContrastTransform(0.5),
        'saturation': lambda T: T.SaturationTransform(0.5),
        'hue': lambda T: T.HueTransform(0.3),
    }
    for name, make in pipes.items():
        for key in ('u8', 'f32', 'pil'):
            outs = []
            for P in (ref, port):
                random.seed(7)
                outs.append(make(P.vision.transforms)(imgs[key]))
            _equal(outs[1], outs[0])
    # a Tensor input takes the tensor backend
    t = [F.to_tensor(imgs['unit']) for F in (
        ref.vision.transforms.functional, port.vision.transforms.functional)]
    got = port.vision.transforms.functional.hflip(t[1])
    want = ref.vision.transforms.functional.hflip(t[0])
    _equal(got, want)


def _write_mnist(tmp_path):
    imgs = (np.arange(3 * 28 * 28) % 255).astype('uint8').reshape(3, 28, 28)
    labels = np.asarray([1, 2, 3], 'uint8')
    ip, lp = tmp_path / 'imgs.gz', tmp_path / 'labels.gz'
    with gzip.open(ip, 'wb') as f:
        f.write(struct.pack('>IIII', 2051, 3, 28, 28) + imgs.tobytes())
    with gzip.open(lp, 'wb') as f:
        f.write(struct.pack('>II', 2049, 3) + labels.tobytes())
    return dict(image_path=str(ip), label_path=str(lp), mode='train')


def _write_cifar(tmp_path):
    data = (np.random.RandomState(0).rand(4, 3072) * 255).astype('uint8')
    p = tmp_path / 'cifar-10-python.tar.gz'
    with tarfile.open(p, 'w:gz') as tf:
        raw = pickle.dumps({b'data': data, b'labels': [0, 1, 2, 3]})
        info = tarfile.TarInfo('cifar-10-batches-py/data_batch_1')
        info.size = len(raw)
        tf.addfile(info, io.BytesIO(raw))
    return dict(data_file=str(p), mode='train')


def _add(tf, name, raw):
    info = tarfile.TarInfo(name)
    info.size = len(raw)
    tf.addfile(info, io.BytesIO(raw))


def _png(arr, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format='PNG')
    return buf.getvalue()


def _write_flowers(tmp_path):
    import scipy.io as sio
    tgz = tmp_path / '102flowers.tgz'
    with tarfile.open(tgz, 'w:gz') as tf:
        for i in (1, 2, 3):
            buf = io.BytesIO()
            Image.fromarray(np.full((8, 8, 3), i * 40).astype('uint8')).save(
                buf, format='JPEG')
            _add(tf, 'jpg/image_%05d.jpg' % i, buf.getvalue())
    sio.savemat(tmp_path / 'imagelabels.mat',
                {'labels': np.asarray([[5, 6, 7]])})
    sio.savemat(tmp_path / 'setid.mat',
                {'trnid': np.asarray([[1, 2]]), 'valid': np.asarray([[3]]),
                 'tstid': np.asarray([[3]])})
    return dict(data_file=str(tgz),
                label_file=str(tmp_path / 'imagelabels.mat'),
                setid_file=str(tmp_path / 'setid.mat'), mode='train')


def _write_voc(tmp_path):
    p = tmp_path / 'VOCtrainval_11-May-2012.tar'
    pre = 'VOCdevkit/VOC2012'
    with tarfile.open(p, 'w') as tf:
        _add(tf, f'{pre}/ImageSets/Segmentation/train.txt', b'img1\nimg2\n')
        for i, iid in enumerate(('img1', 'img2')):
            _add(tf, f'{pre}/JPEGImages/{iid}.jpg',
                 _png(np.full((6, 6, 3), 30 * i, 'uint8')))
            _add(tf, f'{pre}/SegmentationClass/{iid}.png',
                 _png(np.full((6, 6), 7 + i, 'uint8'), mode='L'))
    return dict(data_file=str(p), mode='train')


def _write_folder(tmp_path):
    root = tmp_path / 'folder'
    rng = np.random.RandomState(1)
    for c in ('cat', 'dog'):
        os.makedirs(root / c)
        for i in range(2):
            np.save(root / c / f'{i}.npy', rng.rand(4, 5, 3).astype('f4'))
    Image.fromarray(rng.randint(0, 255, (5, 4, 3), dtype=np.uint8)).save(
        root / 'dog' / 'x.png')
    return dict(root=str(root))


def _items(ds):
    out = []
    for i in range(len(ds)):
        item = ds[i]
        out.append([np.asarray(v) for v in (item if isinstance(
            item, (list, tuple)) else [item])])
    return out


DATASETS = {
    'mnist': ('MNIST', _write_mnist),
    'cifar10': ('Cifar10', _write_cifar),
    'flowers': ('Flowers', _write_flowers),
    'voc2012': ('VOC2012', _write_voc),
    'folder': ('DatasetFolder', _write_folder),
    'image_folder': ('ImageFolder', lambda t: dict(
        root=os.path.join(_write_folder(t)['root'], 'dog'))),
}


@pytest.mark.parametrize('name', list(DATASETS))
def test_dataset_files_read_as_the_reference_reads_them(name, tmp_path):
    cls, write = DATASETS[name]
    kw = write(tmp_path)
    want = _items(getattr(ref.vision.datasets, cls)(**kw))
    got = _items(getattr(port.vision.datasets, cls)(**kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            _equal(a, b)


def test_synthetic_datasets_and_a_transform_match_the_reference(tmp_path):
    """The synthetic fallbacks (no file at the default places) and a
    transform pipeline over them."""
    def make(P, cls, **kw):
        return getattr(P.vision.datasets, cls)(**kw)
    nope = str(tmp_path / 'nope')
    specs = [('MNIST', dict(mode='test', image_path=nope, label_path=nope)),
             ('FashionMNIST', dict(mode='test', image_path=nope,
                                   label_path=nope)),
             ('Cifar100', dict(mode='test', data_file=nope)),
             ('Flowers', dict(mode='test', data_file=nope, label_file=nope,
                              setid_file=nope)),
             ('VOC2012', dict(data_file=nope))]
    for cls, kw in specs:
        rd, pd = make(ref, cls, **kw), make(port, cls, **kw)
        assert len(pd) == len(rd)
        for i in (0, len(rd) - 1):
            for a, b in zip(pd[i], rd[i]):
                _equal(np.asarray(a), np.asarray(b))
    tf = [P.vision.transforms.Compose([P.vision.transforms.Normalize(
        [127.5], [127.5], data_format='HWC')]) for P in (ref, port)]
    rd = ref.vision.datasets.MNIST(mode='test', image_path=nope,
                                   label_path=nope, transform=tf[0])
    pd = port.vision.datasets.MNIST(mode='test', image_path=nope,
                                    label_path=nope, transform=tf[1])
    _equal(pd[3][0], rd[3][0])


def test_image_load_read_file_and_decode_jpeg(tmp_path):
    rng = np.random.RandomState(2)
    png = str(tmp_path / 'x.png')
    Image.fromarray(rng.randint(0, 255, (10, 12, 3), dtype=np.uint8)).save(
        png)
    jpg = str(tmp_path / 'x.jpg')
    Image.fromarray(rng.randint(0, 255, (9, 7, 3), dtype=np.uint8)).save(jpg)
    npy = str(tmp_path / 'x.npy')
    np.save(npy, rng.rand(3, 4).astype('f4'))
    for backend in ('tensor', 'pil', 'cv2'):
        outs = []
        for P in (ref, port):
            P.vision.set_image_backend(backend)
            assert P.vision.get_image_backend() == backend
            outs.append([P.vision.image_load(p) for p in (png, npy)])
        for g, w in zip(outs[1], outs[0]):
            _equal(g, w)
    with pytest.raises(ValueError):
        port.vision.set_image_backend('opencv')
    raw = [P.vision.ops.read_file(jpg) for P in (ref, port)]
    _equal(raw[1], raw[0])
    for mode in ('unchanged', 'gray', 'rgb'):
        _equal(port.vision.ops.decode_jpeg(raw[1], mode),
               ref.vision.ops.decode_jpeg(raw[0], mode))


NO_PIL = r'''
import sys
sys.modules['PIL'] = None
sys.modules['cv2'] = None
import numpy as np
import paddle_tpu_torch as paddle
paddle.set_device('cpu')
import paddle_tpu_torch.vision as V
from paddle_tpu_torch.vision import transforms as T
img = (np.random.RandomState(0).rand(20, 24, 3) * 255).astype('uint8')
out = T.Compose([T.Resize((16, 16)), T.RandomHorizontalFlip(),
                 T.ColorJitter(0.2, 0.2, 0.2, 0.05), T.ToTensor()])(img)
assert list(out.shape) == [3, 16, 16], out.shape
x, y = V.datasets.MNIST(mode='test', image_path='/nonexistent',
                        label_path='/nonexistent')[0]
assert x.shape == (28, 28, 1)
keep = V.ops.nms(np.asarray([[0, 0, 4, 4], [0, 0, 4, 5], [9, 9, 12, 12]],
                            'float32'), 0.5,
                 np.asarray([0.9, 0.8, 0.7], 'float32'))
assert keep.numpy().tolist() == [0, 2], keep
import paddle_tpu_torch.models
assert sys.modules['PIL'] is None and sys.modules['cv2'] is None
print('ok')
'''


@pytest.fixture(autouse=True, scope='module')
def no_pil_process():
    """The process of ``NO_PIL``, started with the module's first test so
    that it runs beside the others; killed at the module's end."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, '-c', NO_PIL], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_vision_imports_and_runs_without_pil_or_cv2(no_pil_process):
    out, err = no_pil_process.communicate(timeout=300)
    assert no_pil_process.returncode == 0 and out.strip() == 'ok', err
