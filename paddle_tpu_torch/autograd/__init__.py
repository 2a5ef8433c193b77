"""Autograd utilities over torch's autograd. Port of
``paddle_tpu/autograd/__init__.py``.

``paddle.grad`` returns the gradients of outputs with respect to inputs and
leaves every leaf's ``.grad`` untouched (``torch.autograd.grad``); an input
the outputs do not reach gets zeros unless ``allow_unused``. ``PyLayer``
runs the user's static ``forward(ctx, ...)`` / ``backward(ctx, *grads)``
as a ``torch.autograd.Function``; ``ctx.saved_tensor()`` is a method, as
in the reference.
"""
import torch

from ..core.dispatch import wrap_out
from ..core.tensor import (Tensor, _CONSUMED, _graph_nodes, as_seed,
                           check_not_consumed, run_backward, wrap)

no_grad = torch.no_grad
enable_grad = torch.enable_grad


def backward(tensors, grad_tensors=None, retain_graph=False):
    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    for t, g in zip(tensors, grad_tensors):
        run_backward(t, g, retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of ``outputs`` with respect to
    ``inputs``, as a list. The graph is kept unless ``retain_graph`` is
    False (the reference's default keeps it); with ``create_graph`` the
    gradients are differentiable."""
    outs = [outputs] if isinstance(outputs, Tensor) else list(outputs)
    ins = [inputs] if isinstance(inputs, Tensor) else list(inputs)
    if grad_outputs is None:
        grad_outputs = [None] * len(outs)
    elif isinstance(grad_outputs, Tensor):
        grad_outputs = [grad_outputs]
    roots = [(o._value, g) for o, g in zip(outs, grad_outputs)
             if o._value.requires_grad]
    wrt = [i for i, t in enumerate(ins) if t._value.requires_grad]
    retain = True if retain_graph is None else bool(retain_graph)
    nodes = [n for v, _ in roots for n in _graph_nodes(v.grad_fn)]
    check_not_consumed(nodes)
    found = [None] * len(ins)
    if roots and wrt:
        gs = torch.autograd.grad(
            [v for v, _ in roots], [ins[i]._value for i in wrt],
            grad_outputs=[as_seed(g, v) for v, g in roots],
            retain_graph=retain or create_graph, create_graph=create_graph,
            allow_unused=True)
        for i, g in zip(wrt, gs):
            found[i] = g
    if not (retain or create_graph):
        for n in nodes:
            n.metadata[_CONSUMED] = True
    result = []
    for t, g in zip(ins, found):
        if g is None:
            result.append(None if allow_unused
                          else wrap(torch.zeros_like(t._value.detach())))
        else:
            result.append(wrap(g))
    return result


class PyLayerContext:
    """Context object passed to PyLayer.forward/backward. ``saved_tensor()``
    is a METHOD, as in the reference (``paddle_tpu/autograd/__init__.py:
    106-117``)."""

    def save_for_backward(self, *tensors):
        self.container = tensors

    def saved_tensor(self):
        return self.container


def _values(out):
    if isinstance(out, Tensor):
        return out._value
    if isinstance(out, (list, tuple)):
        return tuple(_values(o) for o in out)
    return out


class _PyLayerFunction(torch.autograd.Function):
    """Runs a PyLayer subclass's forward and backward inside torch's
    autograd. Inputs: (layer class, its ctx, args, kwargs, tensor values);
    the values are the Tensor arguments' own, so torch routes their
    gradients."""

    @staticmethod
    def forward(fctx, layer, ctx, args, kwargs, *values):
        fctx.layer, fctx.ctx = layer, ctx
        out = layer.forward(ctx, *args, **kwargs)
        fctx.multi = isinstance(out, (tuple, list))
        return _values(tuple(out) if fctx.multi else out)

    @staticmethod
    def backward(fctx, *grads):
        gs = fctx.layer.backward(fctx.ctx, *(wrap(g) for g in grads))
        if not isinstance(gs, (tuple, list)):
            gs = (gs,)
        return (None, None, None, None) + tuple(
            g._value if isinstance(g, Tensor) else g for g in gs)


class PyLayer:
    """Custom autograd op: subclass with static forward(ctx, ...) /
    backward(ctx, *grads); call ``Sub.apply(...)``. backward returns one
    gradient per Tensor argument, in order."""

    @classmethod
    def apply(cls, *args, **kwargs):
        values = [a._value for a in args if isinstance(a, Tensor)]
        out = _PyLayerFunction.apply(cls, PyLayerContext(), args, kwargs,
                                     *values)
        return wrap_out(out)


def set_grad_enabled(mode):
    """Turn gradient recording on or off for this thread."""
    torch.set_grad_enabled(bool(mode))


def is_grad_enabled():
    return torch.is_grad_enabled()


def backward_mode():
    return True


no_grad_ = no_grad
