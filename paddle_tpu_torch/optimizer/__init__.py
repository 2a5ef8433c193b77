"""Optimizers. Port of ``paddle_tpu/optimizer/__init__.py``: the ten
optimizers' updates, in place, op for op as the reference's pure ones
(``torch.optim`` is not used).

AdamW's ``lr_ratio`` and ``apply_decay_param_fun``, Lamb's
``exclude_from_weight_decay_fn`` and LarsMomentum's
``exclude_from_weight_decay`` are accepted and stored and change nothing,
as in the reference (ROADMAP Known differences).
"""
import torch

from .optimizer import Optimizer, _MISSING
from . import lr  # noqa: F401

__all__ = ['Optimizer', 'SGD', 'Momentum', 'Adam', 'AdamW', 'Adamax',
           'Adagrad', 'Adadelta', 'RMSProp', 'Lamb', 'LarsMomentum', 'lr']


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update(self, g, p, state, lr):
        p.sub_(lr.to(p.dtype) * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_state(self, p):
        return {'velocity': torch.zeros_like(p)}

    def _update(self, g, p, state, lr):
        lr = lr.to(p.dtype)
        v = state['velocity']
        v.mul_(self._momentum).add_(g)
        if self._nesterov:
            p.sub_(lr * (g + self._momentum * v))
        else:
            p.sub_(lr * v)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon

    def init_state(self, p):
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {'moment1': torch.zeros_like(p),
                'moment2': torch.zeros_like(p),
                'beta1_pow': one, 'beta2_pow': one.clone()}

    def _update(self, g, p, state, lr):
        """m = b1*m + (1-b1)*g, v = b2*v + (1-b2)*g^2, the f32 beta powers
        advance, p -= lr * mhat / (sqrt(vhat) + eps) with mhat = m / (1 -
        b1^t), vhat = v / (1 - b2^t)."""
        b1, b2, eps = self._beta1, self._beta2, self._eps
        state['beta1_pow'].mul_(b1)
        state['beta2_pow'].mul_(b2)
        m, v = state['moment1'], state['moment2']
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = m / (1 - state['beta1_pow']).to(p.dtype)
        vhat = v / (1 - state['beta2_pow']).to(p.dtype)
        p.sub_(lr.to(p.dtype) * mhat / (torch.sqrt(vhat) + eps))


class AdamW(Adam):
    """Decoupled weight decay, applied to the weights before the update
    with the group's coefficient (``Optimizer._apply``)."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 grad_clip=None, lr_ratio=None, apply_decay_param_fun=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, name=name)
        # the reference's rule: a non-float weight_decay means 0.01
        self._coeff = weight_decay if isinstance(weight_decay, float) else 0.01
        # stored and not read, as in the reference
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_coeff(self, wd):
        if wd is _MISSING:          # no group override: the optimizer's
            return self._coeff
        if wd is None:              # explicit None: the group is exempt
            return 0.0
        from ..regularizer import L2Decay
        if isinstance(wd, L2Decay):
            return wd._coeff
        return float(wd)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_state(self, p):
        return {'moment': torch.zeros_like(p),
                'inf_norm': torch.zeros_like(p),
                'beta1_pow': torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _update(self, g, p, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        b1p = state['beta1_pow'].mul_(b1)
        m = state['moment'].mul_(b1).add_((1 - b1) * g)
        u = state['inf_norm']
        torch.maximum(b2 * u, torch.abs(g) + eps, out=u)
        p.sub_((lr / (1 - b1p)).to(p.dtype) * m / u)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def init_state(self, p):
        return {'moment': torch.full_like(p, self._init_acc)}

    def _update(self, g, p, state, lr):
        acc = state['moment'].add_(torch.square(g))
        p.sub_(lr.to(p.dtype) * g / (torch.sqrt(acc) + self._eps))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def init_state(self, p):
        return {'avg_squared_grad': torch.zeros_like(p),
                'avg_squared_update': torch.zeros_like(p)}

    def _update(self, g, p, state, lr):
        rho, eps = self._rho, self._eps
        asg = state['avg_squared_grad'].mul_(rho).add_(
            (1 - rho) * torch.square(g))
        asu = state['avg_squared_update']
        update = -torch.sqrt((asu + eps) / (asg + eps)) * g
        asu.mul_(rho).add_((1 - rho) * torch.square(update))
        p.add_(lr.to(p.dtype) * update)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_state(self, p):
        s = {'mean_square': torch.zeros_like(p),
             'momentum': torch.zeros_like(p)}
        if self._centered:
            s['mean_grad'] = torch.zeros_like(p)
        return s

    def _update(self, g, p, state, lr):
        rho, eps = self._rho, self._eps
        ms = state['mean_square'].mul_(rho).add_((1 - rho) * torch.square(g))
        if self._centered:
            mg = state['mean_grad'].mul_(rho).add_((1 - rho) * g)
            denom = torch.sqrt(ms - torch.square(mg) + eps)
        else:
            denom = torch.sqrt(ms + eps)
        mom = state['momentum'].mul_(self._momentum).add_(
            lr.to(p.dtype) * g / denom)
        p.sub_(mom)


class Lamb(Optimizer):
    """Layer-wise adaptive moments for large-batch training."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        # stored and not read, as in the reference
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_state(self, p):
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {'moment1': torch.zeros_like(p),
                'moment2': torch.zeros_like(p),
                'beta1_pow': one, 'beta2_pow': one.clone()}

    def _update(self, g, p, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        b1p = state['beta1_pow'].mul_(b1)
        b2p = state['beta2_pow'].mul_(b2)
        m = state['moment1'].mul_(b1).add_((1 - b1) * g)
        v = state['moment2'].mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = m / (1 - b1p).to(p.dtype)
        vhat = v / (1 - b2p).to(p.dtype)
        r = mhat / (torch.sqrt(vhat) + eps) + self._wd * p
        w_norm = torch.sqrt(torch.sum(torch.square(p)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones((), dtype=w_norm.dtype,
                                       device=w_norm.device))
        p.sub_(lr.to(p.dtype) * trust * r)


class LarsMomentum(Momentum):
    """LARS: velocity = mu * velocity + local_lr * (g + wd * p); p -=
    velocity, with local_lr = lr * lars_coeff * ||p|| / (||g|| + wd *
    ||p|| + eps) (lr where either norm is 0)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=1e-9, exclude_from_weight_decay=None, name=None):
        # weight decay is applied inside the LARS update
        super().__init__(learning_rate, momentum, parameters,
                         use_nesterov=False, weight_decay=None,
                         grad_clip=grad_clip, name=name)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._lars_eps = epsilon
        # stored and not read, as in the reference
        self._exclude = tuple(exclude_from_weight_decay or ())

    def _update(self, g, p, state, lr):
        lr = lr.to(torch.float32)
        w_norm = torch.sqrt(torch.sum(torch.square(p.float())))
        g_norm = torch.sqrt(torch.sum(torch.square(g.float())))
        wd = torch.full((), self._lars_wd, dtype=torch.float32,
                        device=p.device)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            lr * self._lars_coeff * w_norm
            / (g_norm + wd * w_norm + self._lars_eps), lr)
        v = state['velocity'].mul_(self._momentum).add_(
            local_lr.to(p.dtype) * (g + wd.to(p.dtype) * p))
        p.sub_(v)
