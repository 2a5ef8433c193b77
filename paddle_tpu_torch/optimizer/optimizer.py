"""Optimizer base. Port of ``paddle_tpu/optimizer/optimizer.py``.

Each optimizer defines ``init_state(p)`` and ``_update(g, p, state, lr)``,
which updates ``p`` and ``state`` IN PLACE; the arithmetic is the
reference's op for op, each op rounding once in the parameter's dtype.

Two paths share them:
- the eager ``step()`` over ``Parameter``s: one parameter group at a time,
  under ``torch.no_grad()``, the group's ``grad_clip`` over its gradients,
  then per parameter decoupled decay (AdamW) or the L1/L2 regularizer
  folded into the gradient, then the update. Where the reference jits one
  fused apply (``optimizer.py:169-190``), the port launches the update's
  ops for each parameter in turn (no ``torch.optim``, no ``_foreach_*``).
  The update is in place on each Parameter's leaf, as torch.optim and
  Paddle update: a graph the caller still holds (a kept ``loss``) refers
  to that same leaf, so it keeps no copy of the old weights, and a tensor
  sharing the storage (``detach()``) sees the update, where the
  reference rebinds the Parameter to a new array. No Parameter shares
  another's storage: a Parameter made from a tensor, ``set_value`` and
  ``Layer.set_state_dict`` copy, as Paddle's do;
- ``functional_init`` / ``functional_apply`` over nested dicts of
  tensors, which the GPT and MoE train steps call; the parameters and
  state are updated in place (the reference's jitted step donates them).

Parameter groups keep the reference's key-presence semantics: a group's
``learning_rate`` scales the base rate, and an explicit ``weight_decay``
of 0, 0.0 or None overrides the optimizer's (None exempts the group),
where an absent key inherits it.
"""
import torch

from ..core.tensor import Tensor, wrap
from . import lr as lr_mod

# 'key absent from the param group': a group that inherits the
# optimizer's weight decay, as against one that overrides it with None
_MISSING = object()


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (all of one structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _zip_leaves(params, *trees):
    """(param, leaf of each tree) for every leaf of ``params``, walking
    the trees by the params' keys."""
    if isinstance(params, dict):
        return [t for k in params
                for t in _zip_leaves(params[k], *(x[k] for x in trees))]
    return [(params,) + trees]


def _f32_scalar(lr, device):
    """The learning rate as a 0-d f32 tensor on ``device``: a tensor is
    moved there; a Python number is written by a fill kernel (no host to
    device copy, so no sync)."""
    if isinstance(lr, Tensor):
        lr = lr._value
    if isinstance(lr, torch.Tensor):
        return lr.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(lr), dtype=torch.float32, device=device)


def _clip(clip, grads, shard_axes, mesh):
    """``clip`` over ``grads``; with ``shard_axes``, over the global
    gradient that they are blocks of."""
    if shard_axes is None:
        return clip.clip_arrays(grads)
    return clip.clip_arrays(grads, shard_axes, mesh)


class Optimizer:
    _decoupled = False       # AdamW-style weight decay (set by subclasses)

    def _decoupled_coeff(self, wd):   # pragma: no cover — decoupled only
        raise NotImplementedError

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        from ..regularizer import L2Decay
        self._lr = learning_rate
        self._grad_clip = grad_clip
        if isinstance(weight_decay, float):
            weight_decay = L2Decay(weight_decay)
        self._weight_decay = weight_decay
        params_in = list(parameters) if parameters is not None else []
        self._param_groups = []
        if params_in and isinstance(params_in[0], dict):
            flat = []
            for g in params_in:
                gp = list(g['params'])
                flat += gp
                entry = {'params': gp}
                if 'learning_rate' in g:
                    entry['learning_rate'] = g['learning_rate']
                if 'weight_decay' in g:
                    gwd = g['weight_decay']
                    if isinstance(gwd, (int, float)) and not isinstance(
                            gwd, bool):
                        gwd = L2Decay(float(gwd))
                    entry['weight_decay'] = gwd
                if 'grad_clip' in g:
                    entry['grad_clip'] = g['grad_clip']
                self._param_groups.append(entry)
            self._parameters = flat
        else:
            self._parameters = params_in
        self._states = {}           # id(param) -> state dict of tensors

    # ---- hyper-params -------------------------------------------------
    def get_lr(self):
        if isinstance(self._lr, lr_mod.LRScheduler):
            return self._lr()
        return self._lr

    def set_lr(self, value):
        self._lr = value

    # ---- functional core ----------------------------------------------
    def init_state(self, p):
        """State dict for one parameter tensor."""
        return {}

    def _update(self, g, p, state, lr):
        raise NotImplementedError

    def _apply_decay(self, g, p, wd=_MISSING):
        """The regularizer folded into the gradient: L2 adds coeff * p, L1
        coeff * sign(p). ``wd``: _MISSING inherits the optimizer's, None
        exempts."""
        from ..regularizer import L1Decay, L2Decay
        if wd is _MISSING:
            wd = self._weight_decay
        if isinstance(wd, L2Decay):
            return g + wd._coeff * p
        if isinstance(wd, L1Decay):
            return g + wd._coeff * torch.sign(p)
        return g

    def _apply(self, grads, vals, states, lr, clip, wd, shard_axes=None,
               mesh=None):
        """One group's update, in place on ``vals`` and ``states``:
        ``clip`` over the gradients, then per parameter the decay and the
        update (the reference's fused apply, op for op). ``shard_axes``
        (each gradient's mesh axes of ``mesh`` it is a block over) makes
        the clip's norm the global gradient's (``nn.clip``)."""
        if clip is not None:
            grads = _clip(clip, grads, shard_axes, mesh)
        for g, p, s in zip(grads, vals, states):
            if g is None:
                continue
            if self._decoupled:
                # AdamW: decay the weights before the update, with the
                # group's coefficient
                p.mul_(1 - lr.to(p.dtype) * self._decoupled_coeff(wd))
            else:
                g = self._apply_decay(g, p, wd)
            self._update(g, p, s, lr)

    # ---- eager step -----------------------------------------------------
    def _iter_groups(self):
        if self._param_groups:
            for g in self._param_groups:
                yield g['params'], g
        else:
            yield self._parameters, None

    def _step_groups(self):
        """Each parameter group the eager step updates: (its trainable
        Parameters that have a gradient, the f32 learning rate, the clip,
        the weight decay)."""
        from ..nn.layer_base import Parameter
        for plist, group in self._iter_groups():
            params = [p for p in plist
                      if isinstance(p, Parameter) and p.grad is not None
                      and p.trainable]
            if not params:
                continue

            def _of(key, default):
                return group[key] if group and key in group else default
            # a group's learning_rate scales the base rate, so a scheduler
            # on the base drives every group
            scale = _of('learning_rate', 1.0)
            lr = _f32_scalar(self.get_lr() * (1.0 if scale is None
                                              else float(scale)),
                             params[0]._value.device)
            yield (params, lr, _of('grad_clip', self._grad_clip),
                   _of('weight_decay', _MISSING))

    def _states_of(self, params):
        """The eager state of each Parameter, made at its first step."""
        for p in params:
            if id(p) not in self._states:
                self._states[id(p)] = self.init_state(p._value)
        return [self._states[id(p)] for p in params]

    @torch.no_grad()
    def step(self):
        for params, lr, clip, wd in self._step_groups():
            self._apply([p.grad._value for p in params],
                        [p._value for p in params], self._states_of(params),
                        lr, clip, wd)

    def clear_grad(self, set_to_zero=True):
        for p in self._parameters:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` has produced the gradients (the GradScaler
        flow): apply them, then clear them; with no gradient at all, run
        the backward first. -> (None, [(param, grad)])."""
        if all(p.grad is None for p in self._parameters):
            loss.backward()
        self.step()
        params_grads = [(p, p.grad) for p in self._parameters]
        self.clear_grad()
        return None, params_grads

    # ---- state dict ------------------------------------------------------
    def state_dict(self):
        out = {}
        for i, p in enumerate(self._parameters):
            st = self._states.get(id(p))
            if st:
                key = p.name or f'param_{i}'
                for k, v in st.items():
                    out[f'{key}.{k}'] = wrap(v)
        if isinstance(self._lr, lr_mod.LRScheduler):
            out['LR_Scheduler'] = self._lr.state_dict()
        return out

    def set_state_dict(self, state):
        if ('LR_Scheduler' in state
                and isinstance(self._lr, lr_mod.LRScheduler)):
            self._lr.set_state_dict(state['LR_Scheduler'])
        for i, p in enumerate(self._parameters):
            key = p.name or f'param_{i}'
            st = {}
            for k, v in state.items():
                if k.startswith(key + '.'):
                    v = v._value if isinstance(v, Tensor) else v
                    st[k[len(key) + 1:]] = torch.as_tensor(
                        v, device=p._value.device).detach().clone()
            if st:
                self._states[id(p)] = st

    # ---- functional API for train steps ----------------------------------
    def functional_init(self, params):
        """params: nested dicts of tensors -> matching dicts of state."""
        return tree_map(self.init_state, params)

    @torch.no_grad()
    def functional_apply(self, params, grads, opt_state, lr=None,
                         shard_axes=None, mesh=None):
        """One update of every parameter with a gradient (a None gradient
        leaves its parameter and state alone), in place: ``grad_clip``
        over all the gradients first, then each gradient cast to its
        parameter's dtype, decoupled decay ``p * (1 - lr * coeff)`` before
        the update or the regularizer folded into the gradient. ``lr``: a
        number or a 0-d tensor (default ``get_lr()``), used as f32.
        ``shard_axes``: each leaf's mesh axes of ``mesh`` it is a block
        over, in leaf order (see ``_apply``). -> (params, opt_state), the
        same dicts."""
        lr = self.get_lr() if lr is None else lr
        ps, gs, ss = zip(*_zip_leaves(params, grads, opt_state))
        if self._grad_clip is not None:
            gs = _clip(self._grad_clip, gs, shard_axes, mesh)
        lr_on = {}
        for p, g, s in zip(ps, gs, ss):
            if g is None:
                continue
            if p.device not in lr_on:
                lr_on[p.device] = _f32_scalar(lr, p.device)
            self._apply([g.to(p.dtype)], [p], [s], lr_on[p.device], None,
                        _MISSING)
        return params, opt_state

