"""Transform classes. Port of
``paddle_tpu/vision/transforms/transforms.py``."""
import numbers
import random

import numpy as np

from . import functional as F


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class ToTensor(BaseTransform):
    def __init__(self, data_format='CHW', keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return F.to_tensor(img, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation='bilinear', keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return F.resize(img, self.size, self.interpolation)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3),
                 interpolation='bilinear', keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        import math
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = random.uniform(*self.scale) * area
            ar = math.exp(random.uniform(math.log(self.ratio[0]),
                                         math.log(self.ratio[1])))
            tw = int(round(math.sqrt(target_area * ar)))
            th = int(round(math.sqrt(target_area / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = random.randint(0, h - th)
                j = random.randint(0, w - tw)
                return F.resize(F.crop(arr, i, j, th, tw), self.size,
                                self.interpolation)
        return F.resize(F.center_crop(arr, min(h, w)), self.size,
                        self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return F.center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode='constant', keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else size
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        arr = np.asarray(img)
        if self.padding is not None:
            arr = F.pad(arr, self.padding, self.fill, self.padding_mode)
        h, w = arr.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and (h < th or w < tw):
            arr = F.pad(arr, (max(tw - w, 0), max(th - h, 0)), self.fill,
                        self.padding_mode)
            h, w = arr.shape[:2]
        i = random.randint(0, h - th)
        j = random.randint(0, w - tw)
        return F.crop(arr, i, j, th, tw)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return F.hflip(img)
        return np.asarray(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return F.vflip(img)
        return np.asarray(img)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation='nearest', expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return F.rotate(img, angle, fill=self.fill)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format='CHW', to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def _apply_image(self, img):
        return F.normalize(img, self.mean, self.std, self.data_format)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        return np.asarray(img).transpose(self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode='constant', keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_brightness(img, factor)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_contrast(img, factor)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_saturation(img, factor)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        factor = random.uniform(-self.value, self.value)
        return F.adjust_hue(img, factor)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, keys=None):
        super().__init__(keys)
        self.transforms = []
        if brightness:
            self.transforms.append(BrightnessTransform(brightness))
        if contrast:
            self.transforms.append(ContrastTransform(contrast))
        if saturation:
            self.transforms.append(SaturationTransform(saturation))
        if hue:
            self.transforms.append(HueTransform(hue))

    def _apply_image(self, img):
        ts = list(self.transforms)
        random.shuffle(ts)
        for t in ts:
            img = t(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)
