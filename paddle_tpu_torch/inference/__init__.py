"""Paddle Inference: serve a ``jit.save``'d model. Port of
``paddle_tpu/inference/__init__.py``.

A ``Predictor`` loads the saved prefix (``jit.load_saved_artifacts``) onto
its device (the card unless the Config or ``paddle.set_device`` chose the
CPU) and serves host arrays in and out, on one of two paths:

- **layer-free**: ``run`` calls the ``.pt2`` program that ``jit.save``
  exported (``torch.export``), with the loaded parameters, the way the
  reference's AnalysisPredictor runs its ``__model__`` without the Python
  class. Its attention is the operator ``torch.ops.paddle_tpu_torch.
  flash_attention``, which launches kernel 1 on the card. A program
  exported at fixed shapes (``meta['poly_batch']`` false) takes only those
  shapes, as the reference checks.
- **attach_layer(layer)**: the Layer's forward over the loaded weights,
  one captured CUDA graph (``models.decode_cache.CapturedFn``) per feed
  shape key (on the CPU, eager from the same buffers); ``_trace_count``
  counts captures as the reference counts traces. With
  ``Config.switch_batch_dim_dynamic()`` the batch is padded (edge rows) to
  the next power of two and outputs sliced back where their leading dim is
  the bucket. ``Config.set_precision`` / a ``convert_to_mixed_precision``'d
  model lower the floating parameters, buffers and inputs.

Outputs are numpy arrays (a bfloat16 output as float32: numpy has no
bfloat16).
"""
import os
import sys
import warnings

import numpy as np
import torch

from .. import __version__
from ..core import dtype as dtypes
from ..core.tensor import _host_to_torch


class PrecisionType:
    Float32 = 'float32'
    Bfloat16 = 'bfloat16'
    Half = 'float16'
    Int8 = 'int8'


class PlaceType:
    CPU = 'cpu'
    TPU = 'tpu'
    GPU = 'gpu'


class Config:
    """Reference: paddle.inference.Config. The device is the current place
    (``paddle.set_device``) unless ``enable_use_gpu`` / ``disable_gpu``
    picks one."""

    def __init__(self, prog_file=None, params_file=None):
        self.model_path = prog_file
        self.params_path = params_file
        self._precision = PrecisionType.Float32
        self._device = None
        self._device_id = 0
        self._enable_memory_optim = True
        self._batch_dim_dynamic = False

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = 'gpu'
        self._device_id = int(device_id)

    def enable_tpu(self):
        raise ValueError('paddle_tpu_torch serves on NVIDIA GPUs: use '
                         'enable_use_gpu() or disable_gpu(); there is no '
                         'TPU place')

    def disable_gpu(self):
        self._device = 'cpu'

    def enable_memory_optim(self):
        self._enable_memory_optim = True

    def switch_batch_dim_dynamic(self, flag=True):
        """Serve variable batch sizes through bucketed captures: inputs are
        padded up to the next power-of-two batch and outputs sliced back,
        so N distinct request sizes cost O(log N) captures."""
        self._batch_dim_dynamic = bool(flag)

    def set_precision(self, precision):
        self._precision = precision

    def enable_mkldnn(self):
        pass

    def switch_ir_optim(self, flag=True):
        pass

    def set_cpu_math_library_num_threads(self, n):
        pass

    def model_dir(self):
        return self.model_path

    def torch_device(self):
        from .. import resolve_device
        from ..device import current_device
        if self._device is None:
            return current_device()
        if self._device == 'cpu':
            return resolve_device('cpu')
        return resolve_device(f'cuda:{self._device_id}')


class Tensor_:
    """Handle for named input/output bindings."""

    def __init__(self, predictor, name, is_input):
        self._p = predictor
        self.name = name
        self._is_input = is_input

    def copy_from_cpu(self, arr):
        self._p._feed[self.name] = np.ascontiguousarray(arr)

    def reshape(self, shape):
        pass

    def copy_to_cpu(self):
        return self._p._results[self.name]


_LOW = {PrecisionType.Bfloat16: torch.bfloat16,
        PrecisionType.Half: torch.float16}


def _feed_key(feed):
    """The shape key of a feed: full shapes and the canonical dtype names
    (an int64 feed runs as int32, as in the reference)."""
    return tuple((tuple(int(d) for d in f.shape),
                  dtypes.dtype_name(dtypes.convert_dtype(f.dtype)))
                 for f in feed)


class Predictor:
    """Serves a jit.save'd model: its exported program, or an attached
    Layer on captured graphs."""

    def __init__(self, config):
        self.config = config
        path = config.model_path
        if path.endswith('.pdmodel'):
            path = path[:-len('.pdmodel')]
        from ..jit import load_saved_artifacts
        self.device = config.torch_device()
        self._params, self._buffers, self._meta, self._exec = \
            load_saved_artifacts(path, self.device)
        self._input_names = [f'x{i}' for i in range(
            len(self._meta.get('input_spec', [])) or 1)]
        self._feed = {}
        self._results = {}
        self._layer = None
        self._compiled = {}
        self._lowered = None
        self._trace_count = 0     # captures (tests assert one per bucket)
        self._output_names = ['out0']

    def attach_layer(self, layer):
        """Bind the Layer whose forward defines the program (the reference
        rebuilds it from the ProgramDesc; the port re-binds the module)."""
        layer.set_state_dict({**self._params, **self._buffers})
        layer.eval()
        self._layer = layer
        return self

    def get_input_names(self):
        return self._input_names

    def get_output_names(self):
        return self._output_names

    def get_input_handle(self, name):
        return Tensor_(self, name, True)

    def get_output_handle(self, name):
        return Tensor_(self, name, False)

    def _precision(self):
        prec = self.config._precision
        if prec == PrecisionType.Float32 and \
                self._meta.get('precision') in _LOW:
            # an offline-converted model (convert_to_mixed_precision): its
            # stored precision lowers the inputs to match
            prec = self._meta['precision']
        return _LOW.get(prec)

    def _weights(self, low):
        """The served parameters and buffers, lowered once."""
        if self._lowered is None:
            from ..serving.engine import lower_tree
            self._lowered = (lower_tree(self._params, low),
                             lower_tree(self._buffers, low))
        return self._lowered

    def _get_compiled(self, shapes_key):
        """The captured forward of one feed shape key (captured now if it
        is not yet)."""
        fn = self._compiled.get(shapes_key)
        if fn is not None:
            return fn
        from ..models.decode_cache import CapturedFn
        from ..nn.layer_base import functional_call
        layer, low = self._layer, self._precision()
        params, buffers = self._weights(low)
        names = [f'x{i}' for i in range(len(shapes_key))]
        bufs = {n: torch.zeros(shape, dtype=dtypes.convert_dtype(dt),
                               device=self.device)
                for n, (shape, dt) in zip(names, shapes_key)}

        def forward(xs):
            if low is not None:
                # inputs match the lowered parameters' dtype
                xs = [x.to(low) if dtypes.is_floating(x.dtype) else x
                      for x in xs]
            with torch.no_grad():
                out, _ = functional_call(layer, params, buffers, *xs)
            return tuple(out) if isinstance(out, (list, tuple)) else (out,)

        from .. import observability as _obs
        label = 'predictor.' + ';'.join(
            'x'.join(map(str, shape)) or 'scalar'
            for shape, _ in shapes_key)

        def infer(**b):
            # this feed key's first eager run (before its capture) is
            # counted: perf.flops{fn=predictor.<shapes>}
            with _obs.perf.measure(label, pyname='infer') as m:
                out = forward([b[n] for n in names])
                m.set_outputs(out)
            return out
        fn = CapturedFn(infer, bufs, self.device)
        self._trace_count += 1
        self._compiled[shapes_key] = fn
        return fn

    def run(self, inputs=None):
        if inputs is not None:
            feed = [np.asarray(x) for x in inputs]
        else:
            feed = [np.asarray(self._feed[n]) for n in self._input_names]
        n_rows = None    # set when dynamic batching is on for this run
        bucket = None    # the padded size actually captured for
        if self._layer is None:
            if self._exec is None:
                raise RuntimeError(
                    'model was saved without a standalone program (.pt2); '
                    'call attach_layer(model) or re-export with jit.save')
            if self.config._precision != PrecisionType.Float32:
                warnings.warn(
                    'Config precision is ignored when serving the exported '
                    'program (dtypes are pinned at jit.save); attach_layer() '
                    'to serve at a different precision', stacklevel=2)
            if not self._meta.get('poly_batch', False):
                spec = self._meta.get('input_spec', [])
                for f, s in zip(feed, spec):
                    want = [2 if d == -1 else d for d in s['shape']]
                    if list(f.shape) != want:
                        raise ValueError(
                            f'saved program was exported with fixed input '
                            f'shape {want} (dynamic shapes unavailable for '
                            f'this model); got {list(f.shape)}. '
                            f'attach_layer(model) for dynamic shapes.')
            xs = [_host_to_torch(f, device=self.device) for f in feed]
            with torch.no_grad():
                out = self._exec(self._params, self._buffers, *xs)
        else:
            if self.config._batch_dim_dynamic and feed and \
                    feed[0].ndim >= 1:
                # bucketed dynamic batching: pad every input whose leading
                # dim matches the batch up to the next power-of-two bucket
                from ..serving.bucketing import bucket_for, pad_rows
                n_rows = feed[0].shape[0]
                bucket = bucket_for(n_rows)
                if bucket != n_rows:
                    feed = [pad_rows(f, bucket)
                            if f.ndim >= 1 and f.shape[0] == n_rows else f
                            for f in feed]
            key = _feed_key(feed)
            wm = sys.modules.get('paddle_tpu_torch.warmup.manifest')
            if wm is not None and wm.capturing():
                wm.record(wm.predictor_entry(
                    key, precision=str(self.config._precision)))
            fn = self._get_compiled(key)
            out = fn.replay(**{f'x{i}': f for i, f in enumerate(feed)})
        from ..serving.engine import host_outputs
        outs = host_outputs(list(out) if isinstance(out, (list, tuple))
                            else [out])
        if bucket is not None and bucket != n_rows:
            # slice ONLY outputs whose leading dim is the padded batch;
            # auxiliary outputs whose shape[0] merely differs from n_rows
            # pass through intact
            outs = [o[:n_rows] if (getattr(o, 'ndim', 0) >= 1
                                   and o.shape[0] == bucket) else o
                    for o in outs]
        self._output_names = [f'out{i}' for i in range(len(outs))]
        self._results = dict(zip(self._output_names, outs))
        return outs

    def warmup(self, manifest):
        """Capture the ``run()`` feed signatures recorded in a warmup
        manifest before traffic. Requires an attached Layer (the exported
        program has nothing to capture). Returns the prebuild report."""
        if self._layer is None:
            raise RuntimeError('warmup needs an attached Layer; the exported '
                               'program has nothing to capture')
        from .. import warmup as _warmup_mod
        return _warmup_mod.prebuild(manifest, predictor=self)


def create_predictor(config):
    return Predictor(config)


def convert_to_mixed_precision(model_file, params_file=None,
                               save_model_path=None, save_params_path=None,
                               mixed_precision='bfloat16', backend=None,
                               black_list=None, **kwargs):
    """Offline-convert a jit.save'd model's weights to a mixed-precision
    copy: floating params and buffers cast to the target dtype and re-saved
    under the new prefix. The program is NOT carried over (its dtypes are
    pinned), so the converted model serves through ``attach_layer()``,
    where the Predictor captures at the stored precision.

    ``model_file``: path to the source '.pdmodel' (or its prefix);
    ``save_model_path``: destination prefix (or '.pdmodel' path)."""
    import json

    from ..framework_io import save as fsave
    from ..jit import load_saved_artifacts

    def _prefix(p):
        return p[:-len('.pdmodel')] if p.endswith('.pdmodel') else p

    src = _prefix(model_file)
    if save_model_path is None:
        raise ValueError('save_model_path is required')
    dst = _prefix(save_model_path)
    params, buffers, meta, _ = load_saved_artifacts(src, 'cpu')
    name = {'fp16': 'float16', 'bf16': 'bfloat16'}.get(
        str(mixed_precision), str(mixed_precision))
    dtype = dtypes.convert_dtype(name)
    skip = set(black_list or ())

    def cast(k, v):
        if k in skip or not dtypes.is_floating(v.dtype):
            return v
        return v.to(dtype)

    state = {'params': {k: cast(k, v) for k, v in params.items()},
             'buffers': {k: cast(k, v) for k, v in buffers.items()}}
    os.makedirs(os.path.dirname(dst) or '.', exist_ok=True)
    fsave(state, dst + '.pdparams')
    meta = dict(meta, exported=False, poly_batch=False,
                precision=dtypes.dtype_name(dtype),
                converted_from=os.path.basename(src))
    meta.pop('program', None)
    with open(dst + '.pdmodel', 'w') as f:
        json.dump(meta, f)
    return dst


Tensor = Tensor_     # reference name (fluid/inference Tensor binding)


class DataType:
    """Reference: paddle_infer::DataType enum."""
    FLOAT32 = 'float32'
    FLOAT16 = 'float16'
    INT64 = 'int64'
    INT32 = 'int32'
    UINT8 = 'uint8'
    INT8 = 'int8'
    BOOL = 'bool'


_DTYPE_NBYTES = {DataType.FLOAT32: 4, DataType.FLOAT16: 2,
                 DataType.INT64: 8, DataType.INT32: 4,
                 DataType.UINT8: 1, DataType.INT8: 1, DataType.BOOL: 1}


def get_num_bytes_of_data_type(dtype):
    """Reference: paddle_infer::GetNumBytesOfDataType."""
    return _DTYPE_NBYTES.get(dtype, np.dtype(dtype).itemsize)


def get_version():
    return (f'paddle_tpu_torch inference {__version__} '
            f'(PyTorch {torch.__version__})')


class PredictorPool:
    """size-N pool of Predictors over one Config. The clones share ONE
    loaded model and its captured graphs and hand out independent
    feed/fetch binding contexts."""

    def __init__(self, config, size=1):
        self._main = Predictor(config)
        self._predictors = [self._main]
        for _ in range(max(0, int(size) - 1)):
            clone = Predictor.__new__(Predictor)
            clone.__dict__.update(self._main.__dict__)
            clone._feed = {}
            clone._results = {}
            self._predictors.append(clone)

    def retrive(self, idx):      # reference spells it 'retrive'
        return self._predictors[idx]

    retrieve = retrive
