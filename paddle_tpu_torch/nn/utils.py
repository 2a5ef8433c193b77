"""nn.utils: the weight_norm / spectral_norm reparameterizations. Port of
``paddle_tpu/nn/utils.py``."""
import torch

from ..core.dispatch import apply_op
from .layer_base import Parameter


def _norm_except(v, dim):
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(torch.square(v), dim=axes, keepdim=True))


def weight_norm(layer, name='weight', dim=0):
    w = layer._parameters.pop(name)
    dim = dim if dim is not None else 0
    v0 = w._value.detach()
    layer.add_parameter(name + '_g', Parameter(_norm_except(v0, dim)))
    layer.add_parameter(name + '_v', Parameter(v0.clone()))

    def hook(lyr, inputs):
        g = lyr._parameters[name + '_g']
        v = lyr._parameters[name + '_v']
        w_t = apply_op(lambda gv, vv: vv * (gv / _norm_except(vv, dim)), g, v)
        object.__setattr__(lyr, name, w_t)
        return None

    handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_handle = handle
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name='weight'):
    g = layer._parameters.pop(name + '_g')._value.detach()
    v = layer._parameters.pop(name + '_v')._value.detach()
    w = v * (g / _norm_except(v, 0))
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter(w))
    if getattr(layer, '_weight_norm_handle', None) is not None:
        layer._weight_norm_handle.remove()
    return layer


def spectral_norm(layer, name='weight', n_power_iterations=1, eps=1e-12,
                  dim=None):
    from .layer_norm_layers import SpectralNorm
    w = layer._parameters.pop(name)
    if dim is None:
        dim = 0
    sn = SpectralNorm(w.shape, dim=dim, power_iters=n_power_iterations,
                      eps=eps)
    layer.add_sublayer(name + '_sn', sn)
    layer.add_parameter(name + '_orig', w)

    def hook(lyr, inputs):
        w_t = lyr._sub_layers[name + '_sn'](lyr._parameters[name + '_orig'])
        object.__setattr__(lyr, name, w_t)
        return None

    layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer
