"""Optimizers: Adam and AdamW, port of ``paddle_tpu/optimizer/
__init__.py:37-90`` (the functional core the train step uses; see
``optimizer.py`` for what is not ported yet). ``torch.optim`` is not
used: the update is the reference's arithmetic op for op."""
import torch

from .optimizer import Optimizer

__all__ = ['Optimizer', 'Adam', 'AdamW']


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
        """In place: m = b1*m + (1-b1)*g, v = b2*v + (1-b2)*g^2, the f32
        beta powers advance, p -= lr * mhat / (sqrt(vhat) + eps) with the
        bias corrections mhat = m / (1 - b1^t), vhat = v / (1 - b2^t)."""
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
    """Decoupled weight decay, applied to the weights before the update."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 grad_clip=None, lr_ratio=None, apply_decay_param_fun=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, name=name)
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                'lr_ratio / apply_decay_param_fun are not ported yet '
                '(ROADMAP Queue 1 item 7: nn, optimizer, amp, hapi)')
        # the reference's rule: a non-float weight_decay means 0.01
        self._coeff = weight_decay if isinstance(weight_decay, float) else 0.01

    def _decoupled_coeff(self):
        return self._coeff
