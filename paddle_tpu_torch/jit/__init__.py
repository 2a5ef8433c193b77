"""paddle.jit: saving a Layer with its program, and loading it back. Port of
the save/load half of ``paddle_tpu/jit/__init__.py``.

``save(layer, path, input_spec=...)`` writes, as the reference does:

- ``path.pdparams``: ``{'params': {name: array}, 'buffers': {...}}`` in
  the reference's format (``paddle.save``), so either package reads the
  other's with the same parameter names;
- ``path.pdmodel``: the JSON metadata (class, input spec, whether a
  program was exported and how);
- ``path.pt2``: the standalone program, a ``torch.export``
  ``ExportedProgram`` of the forward as a function of (params, buffers,
  *inputs), saved with ``torch.export.save``. The reference writes a
  ``jax.export`` program to ``.pdexec`` and StableHLO text to
  ``.stablehlo``; the port writes neither (ROADMAP known differences). So
  each package's loader finds no program of its own in the other's save,
  and takes the reference's degraded paths: the Predictor asks for
  ``attach_layer``, ``jit.load`` returns the raw state dict.

The program is traced with ``torch.export`` in non-strict mode, in eval
mode, trying the reference's shape modes in order: one dynamic
``torch.export.Dim`` per -1 dim of the spec, then one ``Dim`` shared by
all of them (programs that need the dynamic dims equal, such as ERNIE
adding token and type embeddings), then the example's concrete shapes.
``torch.export`` specializes sizes 0 and 1, so the example of a dynamic
dim is 2 (the reference's is 1). On total failure the cause lands in
``meta['export_error']`` and a stale ``.pt2`` from an earlier save is
deleted. Attention runs as the operator ``torch.ops.paddle_tpu_torch.
flash_attention`` (``ops.flash_attention.flash_op``), one node of the
program: where the program runs on the card it launches kernel 1, and its
registered backward kernels 2 and 3, so a loaded program can be
fine-tuned (``TranslatedLayer``; ``meta['vjp_exported']``).

The program remembers the device it was traced on; loading it onto
another device moves its device constants there
(``torch.export.passes.move_to_device_pass``), so a program saved on the
card runs on the CPU and the other way.

``to_static`` and the rest of dy2static wait for ROADMAP Queue 1 item 12,
step L, and raise.
"""
import json
import os
import warnings

import numpy as np
import torch

from .. import _deferred
from ..core import dtype as dtypes
from ..core.nest import map_nested
from ..core.tensor import Tensor, _host_to_torch, wrap
from ..nn.layer_base import Layer, Parameter, _unwrap_tree, functional_call
from ..static.input_spec import InputSpec

PROGRAM = 'torch.export'           # meta['program'] of a port save
_EXAMPLE_DYN = 2                   # example size of a dynamic dim


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: ``fn(params, buffers, *xs)``."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, params, buffers, *xs):
        return self._fn(params, buffers, *xs)


def _spec_dict(s):
    return {'shape': [(-1 if d is None else int(d)) for d in s.shape],
            'dtype': dtypes.dtype_name(s.dtype)}


def _specs(input_spec):
    return [s if isinstance(s, InputSpec) else InputSpec.from_tensor(s)
            for s in input_spec]


def _dynamic(d):
    return d is None or d == -1


def _spec_to_example(spec, device):
    shape = [_EXAMPLE_DYN if _dynamic(s) else int(s) for s in spec.shape]
    return torch.zeros(shape, dtype=spec.dtype, device=device)


def _device_of_tree(*trees):
    for t in trees:
        for v in t.values():
            return v.device
    from ..device import current_device
    return current_device()


def save(layer, path, input_spec=None, **configs):
    """Persist params + buffers (``.pdparams``), the metadata
    (``.pdmodel``) and, given an input spec, the exported program of the
    forward (``.pt2``). Mirrors the reference's jit.save."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    from ..framework_io import save as fsave
    if not isinstance(layer, Layer):
        # jit.save also takes a function: a param-less program
        return _save_function(layer, path, input_spec)
    pd = {n: p._value.detach() for n, p in layer.named_parameters()}
    bd = {n: b._value.detach() for n, b in layer.named_buffers()
          if b is not None}
    fsave({'params': pd, 'buffers': bd}, path + '.pdparams')
    if input_spec is None:
        input_spec = (getattr(layer.forward, '_input_spec', None)
                      or getattr(layer, '_input_spec', None))
    meta = {'class': type(layer).__name__}
    if input_spec is not None:
        specs = _specs(input_spec)
        meta['input_spec'] = [_spec_dict(s) for s in specs]
        dev = _device_of_tree(pd, bd)
        examples = [_spec_to_example(s, dev) for s in specs]
        was_training = layer.training
        layer.eval()

        def infer_fn(params, buffers, *xs):
            out, _ = functional_call(layer, params, buffers, *xs)
            return out
        try:
            _export_artifacts(infer_fn, pd, bd, specs, examples, path, meta)
        finally:
            if was_training:
                layer.train()
    with open(path + '.pdmodel', 'w') as f:
        json.dump(meta, f)


def _export_artifacts(fn, pd, bd, specs, examples, path, meta):
    """Export ``fn(params, buffers, *xs)`` to ``path.pt2``, trying one
    ``Dim`` per dynamic dim, then one shared ``Dim``, then the example's
    concrete shapes; record the outcome in ``meta``."""
    meta['exported'] = False
    meta['poly_batch'] = False
    n_dyn = sum(1 for s in specs for d in s.shape if _dynamic(d))

    def dyn_shapes(shared):
        shared_dim = torch.export.Dim('b', min=1)
        it = iter(range(n_dyn))
        per = []
        for s in specs:
            dims = {i: (shared_dim if shared
                        else torch.export.Dim(f'b{next(it)}', min=1))
                    for i, d in enumerate(s.shape) if _dynamic(d)}
            per.append(dims or None)
        return ({k: None for k in pd}, {k: None for k in bd}, tuple(per))

    attempts = []
    if n_dyn:
        attempts.append((dyn_shapes(False), True))
        if n_dyn > 1:
            attempts.append((dyn_shapes(True), True))
    attempts.append((None, False))
    program = _Program(fn)
    chosen = None
    for shapes, poly in attempts:
        try:
            ep = torch.export.export(program, (pd, bd, *examples),
                                     dynamic_shapes=shapes, strict=False)
        except Exception as e:   # noqa: BLE001: try the next shape mode
            meta['export_error'] = f'{e.__class__.__name__}: {e}'[:300]
            continue
        chosen = (ep, poly)
        break
    if chosen is not None:
        ep, poly = chosen
        torch.export.save(ep, path + '.pt2')
        meta.update(exported=True, poly_batch=poly, vjp_exported=True,
                    program=PROGRAM,
                    program_device=examples[0].device.type if examples
                    else 'cpu')
        meta.pop('export_error', None)
    elif os.path.exists(path + '.pt2'):
        os.unlink(path + '.pt2')   # drop a stale program of a prior save


def _save_function(fn, path, input_spec):
    """jit.save for a function: ``.pdparams`` carries empty state; the
    ``.pt2`` program takes only the inputs."""
    from ..framework_io import save as fsave
    spec = input_spec or getattr(fn, '_input_spec', None)
    if spec is None:
        raise ValueError('jit.save of a function requires input_spec')
    specs = _specs(spec)
    fsave({'params': {}, 'buffers': {}}, path + '.pdparams')
    meta = {'class': getattr(fn, '__name__', 'function'), 'function': True,
            'input_spec': [_spec_dict(s) for s in specs]}

    def infer_fn(params, buffers, *xs):
        with torch.no_grad():
            res = fn(*[wrap(x) for x in xs])
        return _unwrap_tree(res)

    from ..device import current_device
    examples = [_spec_to_example(s, current_device()) for s in specs]
    _export_artifacts(infer_fn, {}, {}, specs, examples, path, meta)
    with open(path + '.pdmodel', 'w') as f:
        json.dump(meta, f)


def _as_tensor(v, device):
    if isinstance(v, Tensor):
        v = v._value
    if isinstance(v, torch.Tensor):
        return v.detach().to(device)
    return _host_to_torch(np.asarray(v), device=device)


def program_on(ep, device):
    """``ep`` runnable on ``device``: its device constants (an arange's
    device, a metadata assertion's) moved there when it was traced
    elsewhere."""
    from torch.export.passes import move_to_device_pass
    return move_to_device_pass(ep, str(device))


def load_saved_artifacts(path, device=None):
    """Load a jit.save'd prefix onto ``device`` (default: the current
    place): (params, buffers, meta, program or None). The program is
    loaded only when the metadata says the port exported one: a
    reference save (or a stale ``.pt2`` beside one) yields None. Shared by
    jit.load and inference.Predictor."""
    from ..device import current_device
    from ..framework_io import load as fload
    dev = torch.device(device) if device is not None else current_device()
    state = fload(path + '.pdparams')
    params = {k: _as_tensor(v, dev) for k, v in state['params'].items()}
    buffers = {k: _as_tensor(v, dev) for k, v in state['buffers'].items()}
    with open(path + '.pdmodel') as f:
        meta = json.load(f)
    program = None
    if (meta.get('exported') and meta.get('program') == PROGRAM
            and os.path.exists(path + '.pt2')):
        # the operators a program may hold must be registered first
        from ..ops import flash_attention  # noqa: F401
        ep = torch.export.load(path + '.pt2')
        if meta.get('program_device', dev.type) != dev.type:
            ep = program_on(ep, dev)
        program = ep.module()
    return params, buffers, meta, program


def _flat_name(n):
    """Injective flattening of dotted program names into single-level
    attribute names ('_' escaped first, so 'a__weight' and 'a.weight'
    cannot collide)."""
    return n.replace('_', '_u').replace('.', '_d')


class TranslatedLayer(Layer):
    """A jit.save'd program reloaded WITHOUT its Python class.

    Reference: fluid/dygraph/io.py TranslatedLayer. Here the program is the
    ``.pt2`` ``torch.export`` program; params and buffers come from the
    ``.pdparams`` archive and are passed as its leading arguments. Like
    the reference, the result is a real Layer whose parameters train
    (``meta['vjp_exported']``): autograd runs through the program's
    operators, kernels 2 and 3 on the card for its attention. The program
    was traced in eval mode, so dropout stays off and norm statistics stay
    frozen while fine-tuning (feature-extractor semantics)."""

    def __init__(self, path):
        super().__init__()
        params, buffers, self._meta, self._program = \
            load_saved_artifacts(path)
        if self._program is None:
            raise RuntimeError(
                f'{path}.pt2 missing or export failed at save time; '
                f'reconstruct the Layer and set_state_dict(jit.load raw '
                f'dict)')
        self._tl_pnames = list(params)
        self._tl_bnames = list(buffers)
        trainable = bool(self._meta.get('vjp_exported'))
        for n, v in params.items():
            self.add_parameter(_flat_name(n), Parameter(v,
                                                        trainable=trainable))
        for n, v in buffers.items():
            self.register_buffer(_flat_name(n), wrap(v))
        self.eval()

    def train(self):
        if not self._meta.get('vjp_exported'):
            raise RuntimeError(
                'this artifact was saved without a differentiable program '
                '(vjp_exported=false): TranslatedLayer is inference-only')
        return super().train()

    def forward(self, *inputs):
        dev = (self._parameters[_flat_name(self._tl_pnames[0])]._value.device
               if self._tl_pnames else None)
        xs = [_as_tensor(a, dev) if dev is not None else
              (a._value if isinstance(a, Tensor) else torch.as_tensor(a))
              for a in inputs]
        pvals = {n: self._parameters[_flat_name(n)]._value
                 for n in self._tl_pnames}
        bvals = {n: self._buffers[_flat_name(n)]._value
                 for n in self._tl_bnames}
        return map_nested(
            lambda x: wrap(x) if isinstance(x, torch.Tensor) else x,
            self._program(pvals, bvals, *xs))

    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix=''):
        # the program-side (dotted) names, as the reference's
        d = destination if destination is not None else {}
        for n in self._tl_pnames:
            d[structured_name_prefix + n] = self._parameters[_flat_name(n)]
        for n in self._tl_bnames:
            d[structured_name_prefix + n] = self._buffers[_flat_name(n)]
        return d


def load(path, **configs):
    """Reload a jit.save'd model. Returns a callable TranslatedLayer when
    the port's standalone program (``.pt2``) exists; otherwise the raw
    state dict {params, buffers} for manual ``set_state_dict``."""
    if os.path.exists(path + '.pt2') and os.path.exists(path + '.pdmodel'):
        try:
            return TranslatedLayer(path)
        except Exception as e:   # noqa: BLE001: any load failure degrades
            warnings.warn(f'jit.load: standalone program at {path}.pt2 '
                          f'unusable ({e.__class__.__name__}: {e}); '
                          f'returning raw state dict')
    from ..framework_io import load as fload
    return fload(path + '.pdparams')


_deferred.install(
    globals(), 'is not ported yet (ROADMAP Queue 1 item 12, step L)',
    functions=('to_static', 'not_to_static', 'declarative',
               'enable_to_static', 'set_code_level', 'set_verbosity'),
    classes=('ProgramTranslator', 'StaticFunction', 'TracedLayer',
             'dy2static'))
