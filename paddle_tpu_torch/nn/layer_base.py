"""Layer (module) system. Port of ``paddle_tpu/nn/layer_base.py``.

``Layer`` is its own class, not a ``torch.nn.Module``: its parameters are
port ``Tensor``s (``Parameter``: a Tensor over one leaf torch tensor that
requires grad when trainable), which a Module's ``_parameters`` cannot
hold, and Paddle's structured names, ``ParamAttr``, hook signatures and
``create_parameter`` differ from torch's. Parameters are made on the
current device (``paddle.set_device``; the card by default, so without
one a layer raises unless the CPU was chosen).

``functional_call`` rebinds the parameters and buffers to given torch
tensors for one call. Unlike the reference, which runs the forward under
``no_grad`` because ``jax.grad`` differentiates the pure function from
outside (``paddle_tpu/nn/layer_base.py:397``), autograd stays on: the
port's caller differentiates the rebound values with torch autograd.
"""
from __future__ import annotations

import collections
import contextlib

import torch

from ..core import dtype as dtypes
from ..core.tensor import Tensor, _host_to_torch, wrap


class Parameter(Tensor):
    def __init__(self, value, trainable=True, name=None):
        # the eager optimizer updates a Parameter's storage in place, so
        # a Parameter never shares the tensor it was made from
        if isinstance(value, Tensor):
            value = value._value
        if isinstance(value, torch.Tensor):
            value = value.detach().clone()
        super().__init__(value, stop_gradient=not trainable, name=name)
        self.trainable = trainable
        self.optimize_attr = {'learning_rate': 1.0}
        self.regularizer = None
        self.do_model_average = None
        self.need_clip = True

    def __repr__(self):
        return 'Parameter containing:\n' + super().__repr__()


class ParamAttr:
    """Reference: python/paddle/fluid/param_attr.py."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        from .initializer import Initializer
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        return ParamAttr()


class Layer:
    def __init__(self, name_scope=None, dtype='float32'):
        self.training = True
        self._dtype = dtype
        self._parameters = collections.OrderedDict()
        self._sub_layers = collections.OrderedDict()
        self._buffers = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()
        self._name_scope = name_scope or type(self).__name__.lower()

    # -- attribute routing ----------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get('_parameters')
        subs = self.__dict__.get('_sub_layers')
        bufs = self.__dict__.get('_buffers')
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError('call super().__init__() first')
            params[name] = value
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if subs is None:
                raise RuntimeError('call super().__init__() first')
            subs[name] = value
            self.__dict__.pop(name, None)
        elif bufs is not None and name in bufs:
            bufs[name] = (value if isinstance(value, Tensor) or value is None
                          else Tensor(value))
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ('_parameters', '_sub_layers', '_buffers'):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f'{type(self).__name__!r} has no attribute {name!r}')

    def __delattr__(self, name):
        for store in ('_parameters', '_sub_layers', '_buffers'):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    # -- parameter/buffer creation ---------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from . import initializer as I
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtype or self._dtype
        # an explicit ParamAttr initializer wins, then the global
        # initializer, then the layer's default, then the fallback
        ginit = getattr(I.set_global_initializer,
                        'bias' if is_bias else 'weight', None)
        init = attr.initializer or ginit or default_initializer or \
            (I.Constant(0.0) if is_bias else I.XavierNormal())
        value = init(shape, dtypes.convert_dtype(dtype))
        p = Parameter(value, trainable=attr.trainable, name=attr.name)
        p.optimize_attr['learning_rate'] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        self.__dict__.pop(name, None)

    # -- traversal --------------------------------------------------------
    def named_sublayers(self, prefix='', include_self=False, layers_set=None):
        layers_set = layers_set if layers_set is not None else set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, sub in self._sub_layers.items():
            if sub is None:
                continue
            p = prefix + ('.' if prefix else '') + name
            if id(sub) not in layers_set:
                layers_set.add(id(sub))
                yield p, sub
                yield from sub.named_sublayers(prefix=p,
                                               layers_set=layers_set)

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def _named_stores(self, store, prefix, include_sublayers):
        seen = set()
        layers = [(prefix, self)]
        if include_sublayers:
            layers += [(prefix + ('.' if prefix else '') + n, l)
                       for n, l in self.named_sublayers()]
        for lp, layer in layers:
            for name, t in getattr(layer, store).items():
                if t is None or id(t) in seen:
                    continue
                seen.add(id(t))
                yield lp + ('.' if lp else '') + name, t

    def named_parameters(self, prefix='', include_sublayers=True):
        return self._named_stores('_parameters', prefix, include_sublayers)

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix='', include_sublayers=True):
        return self._named_stores('_buffers', prefix, include_sublayers)

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def children(self):
        return iter(self._sub_layers.values())

    def named_children(self):
        return iter(self._sub_layers.items())

    def apply(self, fn):
        for l in self.sublayers(include_self=True):
            fn(l)
        return self

    # -- modes ------------------------------------------------------------
    def train(self):
        for l in self.sublayers(include_self=True):
            l.training = True
        return self

    def eval(self):
        for l in self.sublayers(include_self=True):
            l.training = False
        return self

    def to(self, device=None, dtype=None, blocking=None):
        """Floating parameters to ``dtype``; parameters and buffers to
        ``device`` (a place, a string or a torch device). Each parameter
        stays a leaf with its trainability."""
        dev = None
        if device is not None:
            from ..device import to_torch_device
            dev = to_torch_device(device)
        dt = dtypes.convert_dtype(dtype) if dtype is not None else None
        for p in self.parameters():
            v = p._value
            if dt is not None and dtypes.is_floating(v.dtype):
                v = v.to(dt)
            if dev is not None:
                v = v.to(dev)
            if v is not p._value:
                p._replace_value(v)
        if dev is not None:
            for b in self.buffers():
                b._replace_value(b._value.to(dev))
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- state dict -------------------------------------------------------
    def _state_entries(self, prefix=''):
        out = collections.OrderedDict()
        for n, p in self.named_parameters(prefix=prefix):
            out[n] = p
        for n, b in self.named_buffers(prefix=prefix):
            if n.rsplit('.', 1)[-1] not in self._non_persistable_buffer_names:
                out[n] = b
        return out

    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix=''):
        """Parameters and persistable buffers by structured name. A
        Parameter that holds this rank's block of a tensor split over
        ranks (``meta_parallel``'s layers, ``parallel.shard_params``) is
        given whole: its blocks all-gathered into a new Tensor."""
        out = (destination if destination is not None
               else collections.OrderedDict())
        for n, t in self._state_entries(structured_name_prefix).items():
            info = getattr(t, '_dist', None)
            out[n] = (t if info is None
                      else Tensor(info.gather(t._value.detach())))
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy values in by structured name (Tensors, torch tensors or
        numpy arrays, cast to each entry's dtype, on its device). Every
        entry gets storage of its own (the eager optimizer writes it in
        place, so two models loaded from one state dict stay apart), and
        every parameter stays a leaf that keeps its trainability; a split
        Parameter given the whole tensor keeps its block. -> (missing,
        unexpected) names."""
        own = self._state_entries()
        unexpected = []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            t = own[k]._value
            if isinstance(v, Tensor):
                v = v._value
            if isinstance(v, torch.Tensor):
                new = v.detach().to(device=t.device, dtype=t.dtype,
                                    copy=True)
            else:
                new = _host_to_torch(v, dtype=t.dtype, device=t.device)
            info = getattr(own[k], '_dist', None)
            if info is not None and tuple(new.shape) == info.full_shape:
                # a whole tensor for a split Parameter: keep this rank's
                # block of it
                new = info.slice(new)
            own[k]._replace_value(new)
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict

    # -- hooks ------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        h = _HookRemover(self._forward_pre_hooks,
                         len(self._forward_pre_hooks))
        self._forward_pre_hooks[h.idx] = hook
        return h

    def register_forward_post_hook(self, hook):
        h = _HookRemover(self._forward_post_hooks,
                         len(self._forward_post_hooks))
        self._forward_post_hooks[h.idx] = hook
        return h

    # -- call -------------------------------------------------------------
    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            res = hook(self, inputs)
            if res is not None:
                inputs = res if isinstance(res, tuple) else (res,)
        out = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            res = hook(self, inputs, out)
            if res is not None:
                out = res
        return out

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def extra_repr(self):
        return ''

    def __repr__(self):
        lines = [type(self).__name__ + '(' + self.extra_repr()]
        for name, sub in self._sub_layers.items():
            sub_repr = repr(sub).split('\n')
            lines.append(f'  ({name}): ' + '\n  '.join(sub_repr))
        lines.append(')')
        return '\n'.join(lines)

    def full_name(self):
        return self._name_scope


class _HookRemover:
    def __init__(self, store, idx):
        self.store = store
        self.idx = idx

    def remove(self):
        self.store.pop(self.idx, None)


# -- functional bridge ----------------------------------------------------

def param_arrays(layer: Layer):
    """name -> torch tensor of every parameter, in ``named_parameters``
    order."""
    return {n: p._value for n, p in layer.named_parameters()}


def buffer_arrays(layer: Layer):
    return {n: b._value for n, b in layer.named_buffers() if b is not None}


@contextlib.contextmanager
def _bind(layer: Layer, params=None, buffers=None):
    saved = []
    if params:
        for n, p in layer.named_parameters():
            if n in params:
                saved.append((p, p._value))
                p._value = params[n]
    # every buffer slot: a forward may replace buffer objects (BatchNorm's
    # running statistics), and the bound values must not leak out
    buf_saves = []
    for _, l in [('', layer)] + list(layer.named_sublayers()):
        for bn, obj in list(l._buffers.items()):
            buf_saves.append((l, bn, obj,
                              obj._value if obj is not None else None))
    if buffers is not None:
        for n, b in layer.named_buffers():
            if n in buffers and b is not None:
                b._value = buffers[n]
    try:
        yield
    finally:
        for p, v in saved:
            p._value = v
        for l, bn, obj, val in buf_saves:
            l._buffers[bn] = obj
            if obj is not None:
                obj._value = val


def _unwrap_tree(x):
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap_tree(o) for o in x)
    if isinstance(x, dict):
        return {k: _unwrap_tree(v) for k, v in x.items()}
    return x


def functional_call(layer: Layer, params, buffers, *args, **kwargs):
    """Run ``layer`` as a function of (params, buffers, args): the
    parameters and buffers named in ``params`` / ``buffers`` (dicts of
    torch tensors by structured name) stand in for the layer's own during
    the call. -> (outputs with every Tensor unwrapped to its torch tensor,
    the new buffer values). Autograd stays on, so gradients reach the
    rebound tensors."""
    return functional_call_method(layer, layer, params, buffers, *args,
                                  **kwargs)


def functional_call_method(layer: Layer, fn, params, buffers, *args,
                           **kwargs):
    """``functional_call`` invoking ``fn`` (a forward method, say) instead
    of ``layer.__call__``."""
    targs = [a if isinstance(a, Tensor)
             else wrap(a) if isinstance(a, torch.Tensor) else Tensor(a)
             for a in args]
    with _bind(layer, params, buffers):
        out = fn(*targs, **kwargs)
        new_buffers = buffer_arrays(layer)
        if buffers is not None:
            new_buffers = {k: v for k, v in new_buffers.items()
                           if k in buffers}
    return _unwrap_tree(out), new_buffers
