"""fleet.utils: recompute (activation checkpointing) and helpers.

Port of ``paddle_tpu/distributed/fleet/utils.py:1-105`` (reference:
python/paddle/distributed/fleet/utils/recompute.py). ``recompute`` runs
the function without keeping its activations and runs it again in the
backward (a ``torch.autograd.Function``). The second run must draw what
the first drew: kernel 1 takes its dropout seed from the port's CPU
generator on the host, and ``Dropout`` its mask from the device's, so the
generators' states are taken before the first run, put back for the
second, and restored after it (``preserve_rng_state``).

A Layer's own Parameters get their gradients; a plain callable's are its
arguments' only, as the reference's (its callable runs under
``no_grad``: what it closes over is a constant).
"""
import os
import shutil

import torch

from ...core.tensor import Tensor, wrap
from ...nn.layer_base import Layer, functional_call


def _rng_states():
    from ...device import current_device
    from ...tensor import random as trandom
    trandom.generator(torch.device('cpu'))
    trandom.generator(torch.device(current_device()))
    with trandom._lock:
        gens = dict(trandom._generators)
    return {k: (g, g.get_state()) for k, g in gens.items()}


def _set_rng_states(states):
    for g, st in states.values():
        g.set_state(st)


def _flat_out(out):
    """(torch tensors of ``out``, a function rebuilding ``out``'s
    structure of Tensors from them)."""
    if isinstance(out, (list, tuple)):
        vals = [o._value if isinstance(o, Tensor) else o for o in out]
        return vals, lambda ts: type(out)(wrap(t) for t in ts)
    v = out._value if isinstance(out, Tensor) else out
    return [v], lambda ts: wrap(ts[0])


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, preserve, *vals):
        ctx.run = run
        ctx.rng = _rng_states() if preserve else None
        ctx.save_for_backward(*vals)
        with torch.no_grad():
            outs = run(*vals)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        vals = ctx.saved_tensors
        live = [v.detach().requires_grad_(v.requires_grad)
                if torch.is_tensor(v) and v.is_floating_point() else v
                for v in vals]
        after = _rng_states() if ctx.rng is not None else None
        if ctx.rng is not None:
            _set_rng_states(ctx.rng)
        try:
            with torch.enable_grad():
                outs = ctx.run(*live)
        finally:
            if after is not None:
                _set_rng_states(after)
        want = [i for i, v in enumerate(live)
                if torch.is_tensor(v) and v.requires_grad]
        pairs = [(o, g) for o, g in zip(outs, gouts)
                 if g is not None and o.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  [live[i] for i in want],
                                  [g for _, g in pairs], allow_unused=True)
        grads = [None] * len(live)
        for i, g in zip(want, got):
            grads[i] = g
        return (None, None, *grads)


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` keeping only its inputs; the
    backward runs it again (with the first run's generator states) for
    the gradients. ``function``: a Layer (its Parameters get gradients)
    or a callable over Tensors. ``preserve_rng_state`` (default True)."""
    preserve = kwargs.pop('preserve_rng_state', True)
    targs = [a if isinstance(a, Tensor) else wrap(torch.as_tensor(a))
             for a in args]
    xs = [t._value for t in targs]
    shape = {}
    if isinstance(function, Layer):
        named = list(function.named_parameters())
        names = [n for n, _ in named]
        ps = [p._value for _, p in named]

        def run(*vals):
            p_vals = dict(zip(names, vals[len(xs):]))
            out, _ = functional_call(function, p_vals, None,
                                     *vals[:len(xs)], **kwargs)
            flat, shape['rebuild'] = _flat_out(
                [wrap(o) for o in out] if isinstance(out, (list, tuple))
                else wrap(out))
            return flat
        vals = xs + ps
    else:
        def run(*vals):
            out = function(*[wrap(v) for v in vals], **kwargs)
            flat, shape['rebuild'] = _flat_out(out)
            return flat
        vals = xs
    outs = _Recompute.apply(run, preserve, *vals)
    return shape['rebuild'](list(outs))


class LocalFS:
    """Local filesystem helper (reference fleet/utils/fs.py:LocalFS)."""

    def ls_dir(self, path):
        dirs, files = [], []
        for e in os.listdir(path):
            full = os.path.join(path, e)
            (dirs if os.path.isdir(full) else files).append(e)
        return dirs, files

    def is_exist(self, path):
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def touch(self, path, exist_ok=True):
        open(path, 'a').close()

    def mv(self, src, dst, overwrite=False):
        shutil.move(src, dst)


class HDFSClient(LocalFS):
    def __init__(self, hadoop_home=None, configs=None):
        raise RuntimeError('HDFS unavailable offline; use LocalFS')


class DistributedInfer:
    """Parameter-server distributed-infer utility (reference
    fleet/utils/ps_util.py). The collective-only stack has no PS runtime:
    the class is accepted for program portability and raises when its
    PS environment is initialized, as the reference's does."""

    def __init__(self, main_program=None, startup_program=None):
        self.origin_main_program = main_program
        self.origin_startup_program = startup_program

    def init_distributed_infer_env(self, exe, loss, role_maker=None,
                                   dirname=None):
        raise NotImplementedError(
            'DistributedInfer targets parameter-server deployments, which '
            'this collective-only stack does not implement. Serve with '
            'paddle.inference.create_predictor instead.')

    def get_dist_infer_program(self):
        return self.origin_main_program
