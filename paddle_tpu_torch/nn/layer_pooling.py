"""Pooling layers. Port of ``paddle_tpu/nn/layer_pooling.py``."""
from .layer_base import Layer
from . import functional as F


class _Pool(Layer):
    fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = {k: v for k, v in kwargs.items() if k != 'name'}

    def forward(self, x):
        return type(self).fn(x, self.kernel_size, self.stride, self.padding,
                             **self.kwargs)


class MaxPool1D(_Pool):
    fn = staticmethod(F.max_pool1d)


class MaxPool2D(_Pool):
    fn = staticmethod(F.max_pool2d)


class MaxPool3D(_Pool):
    fn = staticmethod(F.max_pool3d)


class AvgPool1D(_Pool):
    fn = staticmethod(F.avg_pool1d)


class AvgPool2D(_Pool):
    fn = staticmethod(F.avg_pool2d)


class AvgPool3D(_Pool):
    fn = staticmethod(F.avg_pool3d)


class _AdaptivePool(Layer):
    fn = None

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return type(self).fn(x, self.output_size)


class AdaptiveAvgPool1D(_AdaptivePool):
    fn = staticmethod(F.adaptive_avg_pool1d)


class AdaptiveAvgPool2D(_AdaptivePool):
    fn = staticmethod(F.adaptive_avg_pool2d)


class AdaptiveAvgPool3D(_AdaptivePool):
    fn = staticmethod(F.adaptive_avg_pool3d)


class AdaptiveMaxPool1D(_AdaptivePool):
    fn = staticmethod(F.adaptive_max_pool1d)


class AdaptiveMaxPool2D(_AdaptivePool):
    fn = staticmethod(F.adaptive_max_pool2d)


class AdaptiveMaxPool3D(_AdaptivePool):
    fn = staticmethod(F.adaptive_max_pool3d)
