"""Quantization-aware training layers and the weight-only int8 layers.
Port of ``paddle_tpu/nn/quant.py``.

Fake quantization is a straight-through estimator: the forward rounds to
the int grid, the backward passes the gradient as it is. The weight-only
layers keep an int8 bank and f32 scales per output channel (per row for
embeddings) as buffers, quantized by ``ops/weight_only.quantize_weight``
(the GPT snapshot's quantizer), and multiply the scale after the product,
as the reference does.
"""
import torch

from ..core.dispatch import apply_op, op
from ..core.tensor import Tensor
from ..ops.weight_only import quantize_weight
from .functional.conv import _conv
from .layer_base import Layer
from .layer_common import Embedding, Linear
from .layer_conv import Conv2D


def _ste(x, q):
    """Straight-through: forward q, backward identity."""
    return x + (q - x).detach()


@op
def fake_quantize_abs_max(x, bits=8, name=None):
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp_min(torch.max(torch.abs(x)) / qmax, 1e-8)
    return _ste(x, torch.round(x / scale) * scale)


@op
def fake_channel_wise_quantize_abs_max(x, bits=8, axis=0, name=None):
    qmax = 2.0 ** (bits - 1) - 1
    red = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    scale = torch.clamp_min(torch.amax(torch.abs(x), dim=red, keepdim=True)
                            / qmax, 1e-8)
    return _ste(x, torch.round(x / scale) * scale)


@op
def fake_quantize_moving_average_abs_max(x, state_scale, bits=8, name=None):
    qmax = 2.0 ** (bits - 1) - 1
    s = torch.as_tensor(state_scale, device=x.device)
    scale = torch.clamp_min(s / qmax, 1e-8)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax) * scale
    return _ste(x, q)


class FakeQuantAbsMax(Layer):
    def __init__(self, quant_bits=8, dtype='float32', name=None):
        super().__init__()
        self.bits = quant_bits

    def forward(self, x):
        return fake_quantize_abs_max(x, self.bits)


def _f32_buffer(value, like):
    return Tensor(torch.tensor(value, dtype=torch.float32,
                               device=like._value.device))


class _QuantWrapperBase(Layer):
    """QAT wrapper: weight fake-quant (per tensor or per channel abs-max)
    and activation fake-quant (abs-max of the batch, or a moving average
    kept in the ``_act_scale`` buffer). ``observe_only`` (post-training
    calibration) records the scale and passes values through."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 weight_quantize_type='channel_wise_abs_max',
                 activation_quantize_type='abs_max', moving_rate=0.9,
                 observe_only=False):
        super().__init__()
        self.inner = layer
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self._w_type = weight_quantize_type
        self._a_type = activation_quantize_type
        self._rate = moving_rate
        self._observe_only = observe_only
        if activation_quantize_type == 'moving_average_abs_max' or \
                observe_only:
            self.register_buffer('_act_scale',
                                 _f32_buffer(0.0, layer.weight))

    def _quant_act(self, x):
        if self._a_type == 'moving_average_abs_max' or self._observe_only:
            if self.training or self._observe_only:
                cur = x._value.detach().abs().max()
                old = self._act_scale._value
                # the first observation seeds the scale
                new = torch.where(old > 0,
                                  self._rate * old + (1 - self._rate) * cur,
                                  cur)
                self._act_scale._replace_value(new.to(torch.float32))
            if self._observe_only:
                return x
            return fake_quantize_moving_average_abs_max(
                x, self._act_scale._value, self.activation_bits)
        return fake_quantize_abs_max(x, self.activation_bits)

    def _quant_weight(self, w, channel_axis):
        if self._observe_only:
            return w
        if self._w_type == 'abs_max':
            return fake_quantize_abs_max(w, self.weight_bits)
        return fake_channel_wise_quantize_abs_max(w, self.weight_bits,
                                                  axis=channel_axis)


class QuantizedLinear(_QuantWrapperBase):
    """Linear with fake-quantized weights and activations (QAT)."""

    def forward(self, x):
        from . import functional as F
        xq = self._quant_act(x)
        wq = self._quant_weight(self.inner.weight, channel_axis=1)
        return F.linear(xq, wq, self.inner.bias)


class QuantizedConv2D(_QuantWrapperBase):
    def forward(self, x):
        from . import functional as F
        xq = self._quant_act(x)
        wq = self._quant_weight(self.inner.weight, channel_axis=0)
        return F.conv2d(xq, wq, self.inner.bias, self.inner._stride,
                        self.inner._padding, self.inner._dilation,
                        self.inner._groups, self.inner._data_format)


def _wo_buffers(self, weight, reduce_axis):
    q = quantize_weight(weight._value.detach(), reduce_axis)
    self.register_buffer('weight_int8', Tensor(q['int8']))
    self.register_buffer('weight_scale', Tensor(q['scale']))


def _act_buffer(self, act_scale, act_bits, like):
    self.act_bits = act_bits
    if act_scale is not None:
        self.register_buffer('act_scale', _f32_buffer(act_scale, like))
    else:
        self.act_scale = None


def _calibrated(self, x):
    """Inputs fake-quantized against a calibrated activation scale."""
    if self.act_scale is None:
        return x
    return fake_quantize_moving_average_abs_max(x, self.act_scale._value,
                                                self.act_bits)


class WeightOnlyLinear(Layer):
    """Serving-time Linear: an int8 weight with one f32 scale an output
    channel (buffers), ``(x @ q) * s`` (+ bias); an observed activation
    scale fake-quantizes the inputs first."""

    def __init__(self, layer, act_scale=None, act_bits=8):
        super().__init__()
        _wo_buffers(self, layer.weight, 0)
        self.bias = layer.bias
        self.in_features = layer.in_features
        self.out_features = layer.out_features
        _act_buffer(self, act_scale, act_bits, layer.weight)

    def forward(self, x):
        x = _calibrated(self, x)

        def pure(xv, qv, sv, bv=None):
            y = (xv @ qv.to(xv.dtype)) * sv.to(xv.dtype)
            return y if bv is None else y + bv.to(xv.dtype)
        args = [x, self.weight_int8, self.weight_scale]
        if self.bias is not None:
            args.append(self.bias)
        return apply_op(pure, *args)

    def extra_repr(self):
        return (f'in_features={self.in_features}, '
                f'out_features={self.out_features}, weight=int8')


class WeightOnlyConv2D(Layer):
    """Serving-time Conv2D: an int8 kernel with one f32 scale an output
    channel (amax over in, kh, kw), applied to the product's channel
    before the bias."""

    def __init__(self, layer, act_scale=None, act_bits=8):
        super().__init__()
        _wo_buffers(self, layer.weight, (1, 2, 3))
        self.bias = layer.bias
        for a in ('_stride', '_padding', '_dilation', '_groups',
                  '_data_format'):
            setattr(self, a, getattr(layer, a))
        _act_buffer(self, act_scale, act_bits, layer.weight)

    def forward(self, x):
        x = _calibrated(self, x)
        st, pd, dl, gp, df = (self._stride, self._padding, self._dilation,
                              self._groups, self._data_format)
        channels_last = df.endswith('C')

        def pure(xv, qv, sv, bv=None):
            y = _conv(xv, qv.to(xv.dtype), None, st, pd, dl, gp, df, 2)
            shape = ((1,) * (y.dim() - 1) + (-1,) if channels_last
                     else (1, -1) + (1,) * (y.dim() - 2))
            y = y * sv.reshape(shape).to(y.dtype)
            if bv is not None:
                y = y + bv.reshape(shape).to(y.dtype)
            return y
        args = [x, self.weight_int8, self.weight_scale]
        if self.bias is not None:
            args.append(self.bias)
        return apply_op(pure, *args)


class WeightOnlyEmbedding(Layer):
    """Serving-time Embedding: an int8 table with one f32 scale a row;
    ``padding_idx`` rows are zero."""

    def __init__(self, layer):
        super().__init__()
        _wo_buffers(self, layer.weight, 1)
        self._padding_idx = layer._padding_idx

    def forward(self, x):
        pad = self._padding_idx

        def pure(idx, qv, sv):
            idx = idx.to(device=qv.device, dtype=torch.int64)
            rows = qv[idx].to(sv.dtype) * sv[idx][..., None]
            if pad is not None:
                rows = torch.where((idx == pad)[..., None],
                                   torch.zeros((), dtype=rows.dtype,
                                               device=rows.device), rows)
            return rows
        return apply_op(pure, x, self.weight_int8, self.weight_scale)

    def extra_repr(self):
        v, h = self.weight_int8.shape
        return f'num_embeddings={v}, embedding_dim={h}, weight=int8'


_WO_WRAPPERS = ((Linear, WeightOnlyLinear), (Conv2D, WeightOnlyConv2D),
                (Embedding, WeightOnlyEmbedding))
_WO_TYPES = (WeightOnlyLinear, WeightOnlyConv2D, WeightOnlyEmbedding)


def weight_only_quantize(model, layer_types=(Linear, Conv2D)):
    """Swap the Linear / Conv2D (and, if asked, Embedding) sublayers of
    ``layer_types`` for their weight-only int8 forms in place; QAT and PTQ
    wrappers are left alone. Returns the model (for serving: training
    through the int8 weights is not defined)."""
    bad = [t for t in layer_types
           if not issubclass(t, tuple(b for b, _ in _WO_WRAPPERS))]
    if bad:
        raise TypeError(
            f'weight_only_quantize: {[t.__name__ for t in bad]} are not '
            'Linear/Conv2D/Embedding subclasses: only those weight layouts '
            'have a weight-only int8 form')
    types = tuple(layer_types)
    for name, sub in list(model._sub_layers.items()):
        if isinstance(sub, _WO_TYPES + (_QuantWrapperBase,)):
            continue
        if isinstance(sub, types):
            for base, wrapper in _WO_WRAPPERS:
                if isinstance(sub, base):
                    model._sub_layers[name] = wrapper(sub)
                    break
        else:
            weight_only_quantize(sub, layer_types=layer_types)
    return model


def convert_calibrated(model):
    """Swap calibrated QAT / PTQ wrappers for weight-only int8 layers in
    place, carrying an observed activation scale (> 0) along; a wrapper
    over any other layer gives its inner layer back."""
    for name, sub in list(model._sub_layers.items()):
        if isinstance(sub, _QuantWrapperBase):
            act_scale = None
            if '_act_scale' in sub._buffers:
                s = float(sub._act_scale._value)
                if s > 0:
                    act_scale = s
            inner = sub.inner
            if isinstance(inner, Linear):
                model._sub_layers[name] = WeightOnlyLinear(
                    inner, act_scale=act_scale, act_bits=sub.activation_bits)
            elif isinstance(inner, Conv2D):
                model._sub_layers[name] = WeightOnlyConv2D(
                    inner, act_scale=act_scale, act_bits=sub.activation_bits)
            else:
                model._sub_layers[name] = inner
        else:
            convert_calibrated(sub)
    return model


def quantize_model(model, weight_bits=8, activation_bits=8,
                   layer_types=(Linear, Conv2D), **quant_kw):
    """Swap the quantizable sublayers for QAT wrappers in place; wrapped
    layers are left alone, so a second pass never wraps twice."""
    for name, sub in list(model._sub_layers.items()):
        if isinstance(sub, _QuantWrapperBase):
            continue
        if isinstance(sub, layer_types) and isinstance(sub, Linear):
            model._sub_layers[name] = QuantizedLinear(
                sub, weight_bits, activation_bits, **quant_kw)
        elif isinstance(sub, layer_types) and isinstance(sub, Conv2D):
            model._sub_layers[name] = QuantizedConv2D(
                sub, weight_bits, activation_bits, **quant_kw)
        else:
            quantize_model(sub, weight_bits, activation_bits,
                           layer_types=layer_types, **quant_kw)
    return model
