"""Optimizer base: the functional core of ``paddle_tpu/optimizer/
optimizer.py`` (``functional_init`` / ``functional_apply``, lines
248-278), over nested dicts of tensors.

Each optimizer defines ``init_state(p)`` and ``_update(g, p, state, lr)``.
Where the reference's pure functions return new arrays, the port updates
the parameters and the state IN PLACE under ``torch.no_grad()`` (the
reference's jitted step donates the old buffers, so no caller sees the
difference) and returns the same dicts. The arithmetic is the
reference's op for op, each op rounding once in the parameter's dtype.

Not ported yet (ROADMAP Queue 1 item 7: nn, optimizer, amp, hapi): the
eager ``step()`` over ``Parameter``s, parameter groups, gradient clipping
(``grad_clip``), learning-rate schedulers and L1 decay. Each raises.
"""
import torch

_TODO = ('is not ported yet (ROADMAP Queue 1 item 7: nn, optimizer, amp, '
         'hapi)')


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (all of one structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


class Optimizer:
    _decoupled = False       # AdamW-style weight decay (set by subclasses)

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if grad_clip is not None:
            raise NotImplementedError(f'grad_clip {_TODO}')
        if parameters is not None:
            raise NotImplementedError(f'the eager optimizer over Parameters '
                                      f'{_TODO}; use functional_init / '
                                      'functional_apply')
        if weight_decay is not None and not isinstance(weight_decay, float):
            raise NotImplementedError(f'weight_decay {weight_decay!r} (a '
                                      f'regularizer object) {_TODO}')
        self._lr = learning_rate
        self._weight_decay = weight_decay    # L2 coefficient, or None

    def get_lr(self):
        if not isinstance(self._lr, (int, float)):
            raise NotImplementedError(f'learning-rate schedulers {_TODO}')
        return float(self._lr)

    def step(self):
        raise NotImplementedError(f'the eager step() {_TODO}; use '
                                  'functional_apply')

    # ---- functional core ----------------------------------------------
    def init_state(self, p):
        """State dict for one parameter tensor."""
        return {}

    def _update(self, g, p, state, lr):
        raise NotImplementedError

    def _decoupled_coeff(self):      # pragma: no cover — decoupled only
        raise NotImplementedError

    def functional_init(self, params):
        """params: nested dicts of tensors -> matching dicts of state."""
        return tree_map(self.init_state, params)

    @torch.no_grad()
    def functional_apply(self, params, grads, opt_state, lr=None):
        """One update of every parameter with a gradient (a None gradient
        leaves its parameter and state alone), in place. The gradient is
        cast to the parameter's dtype; decoupled decay ``p * (1 - lr *
        coeff)`` comes before the update, L2 decay adds ``coeff * p`` to
        the gradient. ``lr``: a float or a 0-d tensor (default
        ``get_lr()``), used as f32. -> (params, opt_state), the same
        dicts."""
        lr = self.get_lr() if lr is None else lr

        def one(p, g, s):
            if g is None:
                return p
            lr_t = torch.as_tensor(lr, dtype=torch.float32, device=p.device)
            g = g.to(p.dtype)
            if self._decoupled:
                p.mul_(1 - lr_t.to(p.dtype) * self._decoupled_coeff())
            elif self._weight_decay is not None:
                g = g + self._weight_decay * p
            self._update(g, p, s, lr_t)
            return p

        tree_map(one, params, grads, opt_state)
        return params, opt_state
