"""Conv layers. Port of ``paddle_tpu/nn/layer_conv.py``: the reference's
parameter names, shapes and initializers (``KaimingUniform`` over
``in_channels / groups · prod(kernel)``, a zero bias unless
``bias_attr=False``)."""
from .layer_base import Layer
from . import functional as F
from . import initializer as I


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd,
                 transpose=False, stride=1, padding=0, output_padding=0,
                 dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCHW'):
        super().__init__()
        ks = ((kernel_size,) * nd if isinstance(kernel_size, int)
              else tuple(kernel_size))
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = ks
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._transpose = transpose
        if transpose:
            wshape = (in_channels, out_channels // groups) + ks
        else:
            wshape = (out_channels, in_channels // groups) + ks
        fan_in = in_channels // groups
        for k in ks:
            fan_in *= k
        self.weight = self.create_parameter(
            wshape, weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in))
        self.bias = self.create_parameter((out_channels,), bias_attr,
                                          is_bias=True)

    def extra_repr(self):
        return (f'{self._in_channels}, {self._out_channels}, '
                f'kernel_size={self._kernel_size}, stride={self._stride}')


class _Conv(_ConvNd):
    ND, FORMAT, fn = 2, 'NCHW', None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__(in_channels, out_channels, kernel_size, self.ND,
                         False, stride, padding, 0, dilation, groups,
                         padding_mode, weight_attr, bias_attr,
                         data_format or self.FORMAT)

    def forward(self, x):
        return type(self).fn(x, self.weight, self.bias, self._stride,
                             self._padding, self._dilation, self._groups,
                             self._data_format)


class _ConvTranspose(_ConvNd):
    ND, FORMAT, fn = 2, 'NCHW', None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__(in_channels, out_channels, kernel_size, self.ND,
                         True, stride, padding, output_padding, dilation,
                         groups, 'zeros', weight_attr, bias_attr,
                         data_format or self.FORMAT)

    def forward(self, x, output_size=None):
        return type(self).fn(x, self.weight, self.bias, self._stride,
                             self._padding, self._output_padding,
                             self._groups, self._dilation, output_size,
                             self._data_format)


class Conv1D(_Conv):
    ND, FORMAT, fn = 1, 'NCL', staticmethod(F.conv1d)


class Conv2D(_Conv):
    ND, FORMAT, fn = 2, 'NCHW', staticmethod(F.conv2d)


class Conv3D(_Conv):
    ND, FORMAT, fn = 3, 'NCDHW', staticmethod(F.conv3d)


class Conv1DTranspose(_ConvTranspose):
    ND, FORMAT, fn = 1, 'NCL', staticmethod(F.conv1d_transpose)


class Conv2DTranspose(_ConvTranspose):
    ND, FORMAT, fn = 2, 'NCHW', staticmethod(F.conv2d_transpose)


class Conv3DTranspose(_ConvTranspose):
    ND, FORMAT, fn = 3, 'NCDHW', staticmethod(F.conv3d_transpose)
