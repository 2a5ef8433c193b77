"""Eager Tensor over torch autograd. Port of ``paddle_tpu/core/tensor.py``.

A ``Tensor`` wraps one ``torch.Tensor`` (``_value``); it does not subclass
it, so Paddle's meanings of ``shape`` (a list), ``size`` (an int),
``t()``, ``dim()``, ``numel()``, ``astype`` and ``T`` are not shadowed by
torch's methods of the same names. Torch's autograd records the graph
(the reference keeps a tape of ``jax.vjp`` closures): ``stop_gradient`` is
a property over ``requires_grad``, True by default as in Paddle, and only
floating or complex tensors can require grad.

Values are never mutated in place: in-place Paddle ops (``add_``,
``x[i] = v``, ``set_value``, ``zero_``, ...) compute a new value and
rebind ``_value``, as the reference rebinds its immutable arrays, so a
view another Tensor holds (``reshape``, a slice, ``detach``) keeps its
values. The one exception is torch's own: a later backward adds into a
leaf's gradient buffer in place, so a ``.grad`` read earlier sees it.

Left out (ROADMAP Queue 1): ``DeviceResidentRef``, hapi's async executor
(item 7), and the static replay stamping (item 12).
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as dtypes

_CONSUMED = 'paddle_tpu_torch.backward_done'


def _host_to_torch(data, dtype=None, device=None):
    """A new torch tensor holding a copy of host data (numpy array, list,
    Python or numpy scalar), 64-bit types canonicalized."""
    arr = np.asarray(data)
    if arr.dtype == object:
        raise TypeError(f'cannot make a tensor of {type(data).__name__} '
                        f'with dtype object')
    want = dtypes.convert_dtype(dtype if dtype is not None else arr.dtype)
    if arr.dtype.name == 'bfloat16':     # ml_dtypes: torch cannot read it
        arr = arr.astype(np.float32)
    return torch.tensor(arr, dtype=want, device=device)


def wrap(value):
    """A Tensor over a torch value (an op's result), without copying."""
    t = Tensor.__new__(Tensor)
    t._value = value
    t.name = None
    return t


class Tensor:
    """Eager tensor. ``stop_gradient`` defaults to True (Paddle semantics);
    parameters set it False. Holds a ``torch.Tensor``."""

    __array_priority__ = 100

    def __init__(self, value, stop_gradient=True, name=None):
        if isinstance(value, Tensor):
            value = value._value
        elif not isinstance(value, torch.Tensor):
            from ..device import current_device
            value = _host_to_torch(value, device=current_device())
        if value.requires_grad:
            value = value.detach()          # a new leaf, as the reference's
        if not stop_gradient and dtypes.is_floating(value.dtype):
            value = value.detach().requires_grad_()
        self._value = value
        self.name = name

    # -- basic properties ------------------------------------------------
    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self):
        return self._value.dim()

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def size(self):
        return self._value.numel()

    @property
    def T(self):
        from ..tensor.linalg import transpose_last2
        return transpose_last2(self)

    @property
    def place(self):
        from ..device import place_of
        return place_of(self._value.device)

    @property
    def is_leaf(self):
        return self._value.grad_fn is None

    is_leaf_hint = is_leaf

    @property
    def stop_gradient(self):
        return not self._value.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, flag):
        v = self._value
        if flag:
            if v.requires_grad:          # later uses see a constant
                d = v.detach()
                if v.is_leaf:
                    d.grad = v.grad
                self._value = d
        elif not v.requires_grad and dtypes.is_floating(v.dtype):
            self._value = v.detach().requires_grad_()

    @property
    def grad(self):
        """The accumulated gradient (a Tensor), or None."""
        v = self._value
        if not (v.is_leaf or v.retains_grad) or v.grad is None:
            return None
        return wrap(v.grad)

    @grad.setter
    def grad(self, g):
        self._value.grad = None if g is None else (
            g._value if isinstance(g, Tensor) else g)

    def numpy(self):
        """A host copy. bfloat16 comes back as float32 (exact): numpy has no
        bfloat16 without ml_dtypes, which the card's machine may lack."""
        v = self._value.detach().resolve_conj().resolve_neg()
        if v.dtype == torch.bfloat16:
            v = v.float()
        elif v.device.type == 'cpu':
            return v.numpy().copy()
        return v.cpu().numpy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._value.item()

    def tolist(self):
        return self.numpy().tolist()

    def __len__(self):
        return self._value.shape[0]

    def __repr__(self):
        body = np.array2string(self.numpy(), precision=4, separator=', ')
        return (f'Tensor(shape={self.shape}, dtype='
                f'{dtypes.dtype_name(self.dtype)}, stop_gradient='
                f'{self.stop_gradient},\n       {body})')

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __bool__(self):
        return bool(self._value.item())

    def __int__(self):
        return int(self._value.item())

    def __float__(self):
        return float(self._value.item())

    def __hash__(self):
        return id(self)

    def __iter__(self):
        for i in range(self._value.shape[0]):
            yield self[i]

    # -- grad machinery --------------------------------------------------
    def retain_grads(self):
        v = self._value
        if v.requires_grad and not v.is_leaf:
            v.retain_grad()

    def clear_grad(self):
        self._value.grad = None

    clear_gradient = clear_grad

    def detach(self):
        return wrap(self._value.detach())

    def clone(self):
        return wrap(self._value.clone())

    def _replace_value(self, new_value):
        """Rebind to a new value (in-place ops, optimizer updates,
        set_value). The tensor stays a leaf: the new value carries no graph,
        keeps ``stop_gradient`` and the gradient accumulated so far."""
        old = self._value
        if isinstance(new_value, Tensor):
            new = new_value._value.detach()
        elif isinstance(new_value, torch.Tensor):
            new = new_value.detach()
        else:
            new = _host_to_torch(new_value, device=old.device)
        if old.requires_grad and dtypes.is_floating(new.dtype):
            new.requires_grad_()
            g = old.grad if old.is_leaf else None
            if (g is not None and g.shape == new.shape
                    and g.dtype == new.dtype and g.device == new.device):
                new.grad = g
        self._value = new

    def set_value(self, value):
        """Copy ``value`` in, as Paddle's ``set_value`` does: the eager
        optimizer updates a Parameter's storage in place, so no Tensor
        takes another's storage here."""
        if isinstance(value, Tensor):
            value = value._value
        if isinstance(value, torch.Tensor):
            value = value.detach().clone()
        self._replace_value(value)

    def backward(self, grad_tensor=None, retain_graph=False):
        run_backward(self, grad_tensor, retain_graph)

    # -- python operators: filled in by paddle_tpu_torch.tensor.register --


def _graph_nodes(root_fn):
    """Every node of the graph behind ``root_fn`` but the leaves'
    gradient accumulators, which outlive any one graph."""
    seen, out, stack = set(), [], [root_fn]
    while stack:
        n = stack.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        if type(n).__name__ == 'AccumulateGrad':
            continue
        out.append(n)
        stack.extend(f for f, _ in n.next_functions)
    return out


def as_seed(g, like):
    """A gradient seed for ``like``: ones where ``g`` is None."""
    if g is None:
        return torch.ones_like(like)
    if isinstance(g, Tensor):
        return g._value
    if isinstance(g, torch.Tensor):
        return g
    return _host_to_torch(g, dtype=like.dtype, device=like.device)


def check_not_consumed(nodes):
    for n in nodes:
        if n.metadata.get(_CONSUMED):
            raise RuntimeError(
                'Trying to backward through the graph a second time; call '
                'backward(retain_graph=True) the first time.')


def run_backward(root, grad_tensor=None, retain_graph=False):
    """``root.backward()``: seed a non-scalar root with ones (as the
    reference does), accumulate into the leaves' ``.grad``. Without
    ``retain_graph`` the graph is consumed: a second backward through any
    of its nodes raises, as the reference's does, even where torch saved
    nothing it would miss."""
    v = root._value
    if not v.requires_grad:
        return                     # a constant root: nothing to do
    nodes = _graph_nodes(v.grad_fn)
    check_not_consumed(nodes)
    torch.autograd.backward(v, as_seed(grad_tensor, v),
                            retain_graph=retain_graph)
    if not retain_graph:
        for n in nodes:
            n.metadata[_CONSUMED] = True


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a new leaf holding ``data`` on ``place`` (default:
    the current device, ``set_device``). float64 host data becomes
    float32 and int64 int32 (``core/dtype.py``)."""
    from ..device import to_torch_device
    if isinstance(data, Tensor):
        data = data._value
    if isinstance(data, torch.Tensor):
        v = data.detach()
        v = v.to(dtypes.convert_dtype(dtype if dtype is not None
                                      else v.dtype))
        if place is not None:
            v = v.to(to_torch_device(place))
    else:
        v = _host_to_torch(data, dtype, to_torch_device(place))
    return Tensor(v, stop_gradient=stop_gradient)
