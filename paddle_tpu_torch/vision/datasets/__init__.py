"""Vision datasets. Port of ``paddle_tpu/vision/datasets/__init__.py``.

Loaders read local files when present (the reference's formats and
places: MNIST idx, CIFAR pickle tars, the Flowers and VOC archives, folder
trees) and otherwise synthesize deterministic data from a fixed numpy
seed, so a pipeline runs anywhere. Samples are numpy arrays, as the
reference's; Pillow is imported only to read a JPEG or PNG.
"""
import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ...io import Dataset

DATA_HOME = os.path.expanduser(os.environ.get('PADDLE_TPU_DATA_HOME',
                                              '~/.cache/paddle_tpu/datasets'))


def _synthetic_images(n, shape, n_classes, seed):
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(n, *shape) * 255).astype('uint8')
    labels = rng.randint(0, n_classes, (n,)).astype('int64')
    return imgs, labels


class MNIST(Dataset):
    """MNIST idx files if available, else synthetic."""

    def __init__(self, image_path=None, label_path=None, mode='train',
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        images = labels = None
        base = os.path.join(DATA_HOME, 'mnist')
        prefix = 'train' if mode == 'train' else 't10k'
        ip = image_path or os.path.join(base, f'{prefix}-images-idx3-ubyte.gz')
        lp = label_path or os.path.join(base, f'{prefix}-labels-idx1-ubyte.gz')
        if os.path.exists(ip) and os.path.exists(lp):
            with gzip.open(ip, 'rb') as f:
                magic, n, rows, cols = struct.unpack('>IIII', f.read(16))
                images = np.frombuffer(f.read(), 'uint8').reshape(n, rows, cols)
            with gzip.open(lp, 'rb') as f:
                struct.unpack('>II', f.read(8))
                labels = np.frombuffer(f.read(), 'uint8').astype('int64')
        else:
            n = 1024 if mode == 'train' else 256
            images, labels = _synthetic_images(n, (28, 28), 10, 0)
        self.images = images
        self.labels = labels

    def __getitem__(self, idx):
        img = self.images[idx].astype('float32')[..., None]
        label = np.asarray([self.labels[idx]], 'int64')
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    N_CLASSES = 10

    def __init__(self, data_file=None, mode='train', transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        data_file = data_file or os.path.join(
            DATA_HOME, f'cifar-{self.N_CLASSES}-python.tar.gz')
        if os.path.exists(data_file):
            self.data = self._load_tar(data_file, mode)
        else:
            n = 1024 if mode == 'train' else 256
            imgs, labels = _synthetic_images(n, (3, 32, 32), self.N_CLASSES, 1)
            self.data = list(zip(imgs.reshape(n, -1), labels))

    def _load_tar(self, path, mode):
        out = []
        want = 'data_batch' if mode == 'train' else 'test_batch'
        if self.N_CLASSES == 100:
            want = 'train' if mode == 'train' else 'test'
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if want in m.name:
                    d = pickle.load(tf.extractfile(m), encoding='bytes')
                    key = b'labels' if b'labels' in d else b'fine_labels'
                    out.extend(zip(d[b'data'], d[key]))
        return out

    def __getitem__(self, idx):
        img, label = self.data[idx]
        img = np.asarray(img).reshape(3, 32, 32).transpose(1, 2, 0).astype('float32')
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(label, 'int64')

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    N_CLASSES = 100


class Flowers(Dataset):
    """Oxford 102 Flowers. Real files: 102flowers.tgz (jpg/image_%05d.jpg) +
    imagelabels.mat + setid.mat (reference:
    python/paddle/vision/datasets/flowers.py)."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode='train', transform=None, download=True, backend=None):
        self.transform = transform
        base = os.path.join(DATA_HOME, 'flowers')
        data_file = data_file or os.path.join(base, '102flowers.tgz')
        label_file = label_file or os.path.join(base, 'imagelabels.mat')
        setid_file = setid_file or os.path.join(base, 'setid.mat')
        if (os.path.exists(data_file) and os.path.exists(label_file)
                and os.path.exists(setid_file)):
            import scipy.io as sio
            split_key = {'train': 'trnid', 'valid': 'valid',
                         'test': 'tstid'}[mode]
            self.indexes = sio.loadmat(setid_file)[split_key][0].tolist()
            self.flower_labels = sio.loadmat(label_file)['labels'][0]
            # extract once (reference behaviour): random access through a
            # gzip tar would re-decompress from the start on every backward
            # seek, making a shuffled epoch O(archive) per item
            self._data_path = data_file[:-4] if data_file.endswith('.tgz') \
                else data_file + '.d'
            if not os.path.isdir(os.path.join(self._data_path, 'jpg')):
                os.makedirs(self._data_path, exist_ok=True)
                with tarfile.open(data_file) as tf:
                    # filter='data' rejects absolute paths / .. traversal /
                    # special members from an untrusted archive
                    try:
                        tf.extractall(self._data_path, filter='data')
                    except TypeError:   # pre-3.10.12/3.11.4: no filter kwarg
                        tf.extractall(self._data_path)
            self.images = None
        else:
            n = 256 if mode == 'train' else 64
            self.images, self.labels = _synthetic_images(n, (64, 64, 3), 102, 2)
            # real Flowers-102 labels are 1-based (1..102); keep the
            # synthetic fallback consistent so downstream label-1 indexing
            # behaves identically either way
            self.labels = self.labels + 1

    def _read_jpg(self, index):
        from PIL import Image
        p = os.path.join(self._data_path, 'jpg', 'image_%05d.jpg' % index)
        return np.asarray(Image.open(p).convert('RGB'))

    def __getitem__(self, idx):
        if self.images is not None:
            img = self.images[idx].astype('float32')
            label = np.asarray([self.labels[idx]], 'int64')
        else:
            index = self.indexes[idx]
            img = self._read_jpg(index).astype('float32')
            label = np.asarray([self.flower_labels[index - 1]], 'int64')
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images) if self.images is not None \
            else len(self.indexes)


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation. Real file: VOCtrainval tar with
    ImageSets/Segmentation/{train,val,trainval}.txt listing ids, JPEGImages
    + SegmentationClass (reference: python/paddle/vision/datasets/voc2012.py)."""

    _PRE = 'VOCdevkit/VOC2012'

    def __init__(self, data_file=None, mode='train', transform=None,
                 download=True, backend=None):
        self.transform = transform
        data_file = data_file or os.path.join(DATA_HOME, 'voc2012',
                                              'VOCtrainval_11-May-2012.tar')
        if os.path.exists(data_file):
            self._data_file = data_file
            name = {'train': 'train', 'valid': 'val', 'test': 'val',
                    'trainval': 'trainval'}[mode]
            with tarfile.open(data_file) as tf:
                lst = tf.extractfile(
                    f'{self._PRE}/ImageSets/Segmentation/{name}.txt')
                self.ids = [l.decode().strip() for l in lst if l.strip()]
            self.images = None
        else:
            n = 64
            rng = np.random.RandomState(3)
            self.images = (rng.rand(n, 3, 64, 64) * 255).astype('uint8')
            self.masks = rng.randint(0, 21, (n, 64, 64)).astype('int64')

    def _read(self, member):
        import io as _io
        import threading
        from PIL import Image
        # one tar handle per (process, thread): TarFile seeks are stateful,
        # so a handle shared across DataLoader workers (fork) or threads
        # interleaves reads and returns corrupt members
        if getattr(self, '_tls', None) is None \
                or getattr(self, '_tls_pid', None) != os.getpid():
            self._tls = threading.local()
            self._tls_pid = os.getpid()
        tar = getattr(self._tls, 'tar', None)
        if tar is None:
            tar = self._tls.tar = tarfile.open(self._data_file)
        f = tar.extractfile(member)
        return Image.open(_io.BytesIO(f.read()))

    def __getitem__(self, idx):
        if self.images is not None:
            img = self.images[idx].astype('float32')
            mask = self.masks[idx]
        else:
            iid = self.ids[idx]
            img = np.asarray(self._read(
                f'{self._PRE}/JPEGImages/{iid}.jpg').convert('RGB'),
                'float32')
            mask = np.asarray(self._read(
                f'{self._PRE}/SegmentationClass/{iid}.png'), 'int64')
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return len(self.images) if self.images is not None else len(self.ids)


IMG_EXTENSIONS = ('.jpg', '.jpeg', '.png', '.ppm', '.bmp', '.npy')


class DatasetFolder(Dataset):
    """Folder-of-class-folders loader (reference: vision/datasets/folder.py).
    Supports .npy images natively; PIL formats when Pillow is installed."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            d = os.path.join(root, c)
            for fname in sorted(os.listdir(d)):
                if fname.lower().endswith(tuple(extensions)):
                    self.samples.append((os.path.join(d, fname),
                                         self.class_to_idx[c]))
        self.loader = loader or self._default_loader

    @staticmethod
    def _default_loader(path):
        if path.endswith('.npy'):
            return np.load(path)
        try:
            from PIL import Image
            return np.asarray(Image.open(path).convert('RGB'))
        except ImportError as e:
            raise ImportError('Pillow needed for non-.npy images') from e

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS
        self.samples = [os.path.join(root, f) for f in sorted(os.listdir(root))
                        if f.lower().endswith(tuple(extensions))]
        self.loader = loader or DatasetFolder._default_loader

    def __getitem__(self, idx):
        sample = self.loader(self.samples[idx])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)
