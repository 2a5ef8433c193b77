"""InferenceEngine: dynamic-batching serving front-end for a model. Port of
``paddle_tpu/serving/engine.py``.

``submit()`` returns a future immediately; a background dispatch thread
coalesces same-signature requests into power-of-two padded buckets
(``bucketing``), runs them through a ``BucketCompileCache`` (one captured
function per (bucket, signature, precision): steady-state traffic never
captures again), and slices each request's rows back out of the batched
output.

The reference's per-bucket XLA executable is a CUDA graph here
(``models.decode_cache.CapturedFn``): the model's forward over static
input buffers of the bucket's shape, captured at warmup or at first use
(two eager runs on a side stream, then the capture). Every graph reads the
same device copy of the weights (six buckets are not six copies); each has
its own input buffers, which the host fills from the padded batch
(``pad_rows``) through pinned staging. Outputs come back to the host once
per batch, as numpy arrays (a bfloat16 output widened to float32 on the
device first: numpy has no bfloat16). On the CPU the same function runs
eagerly from the same buffers. ``_trace_count`` counts captures, as the
reference's counts traces.

Precisions: 'bfloat16' / 'float16' lower the floating parameters, buffers
and inputs once, at construction; 'int8_wo' stores the weights of Linear,
Conv2D and Embedding sublayers as int8 with per-channel scales
(``ops/weight_only.py``) and dequantizes them inside the captured forward.

Robustness is built from the fault primitives:
 - bounded queue with explicit backpressure (``QueueFullError``),
 - per-request deadlines (``DeadlineExceededError``: a RetryError),
 - a ``fault.CircuitBreaker`` around the device call,
 - a ``serving.dispatch`` fault-injection point for the chaos harness.

Observability: every admission/flush/latency event lands in
``ServingStats``; ``engine.stats()`` is the one-stop snapshot.

Telemetry: ``telemetry_port=N`` starts the HTTP plane
(``observability.serve_telemetry``; 0 picks a free port, read back from
``engine.telemetry.port``) and ``shutdown`` stops it. Each bucket's
forward is counted once by ``perf.measure`` on its first eager run (the
first warm-up run before its capture; a graph's replay cannot be
counted) into ``perf.flops{fn=serving.bucketN}``; steady-state batches
feed ``perf.note_step`` and run inside a ``record_function`` range named
after the label (``perf.program_range``), which ``/debug/profile`` counts.

A mesh-sharded replica (``mesh=`` / ``mp=N``, ``parallel/mesh_engine.py``)
places each parameter by its ``logical_axes`` annotation, as the
reference does; a Layer's parameters carry none (the annotated layers are
``meta_parallel``'s, ROADMAP Queue 1 step K4), so every one lands
replicated and each bucket runs the Layer's forward on the mesh's first
device, one graph a bucket (the other shards of a virtual mesh share its
tensors). A parameter whose annotation would split it raises, naming step
K4. The degree is published as ``serve.mesh_devices{engine=...,
mesh="mpN"}``; ``stats()['mesh']`` describes the mesh.
``PADDLE_TPU_COMPILE_CACHE`` is not read: a CUDA graph cannot outlive its
process (ROADMAP known differences).

Env knobs: ``PADDLE_TPU_SERVE_MAX_BATCH`` (default 16),
``PADDLE_TPU_SERVE_MAX_DELAY_MS`` (default 2.0).
"""
import os
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from .. import fault
from .. import observability as _obs
from ..core import dtype as dtypes
from ..models.decode_cache import CapturedFn
from .batcher import (PendingQueues, Request, SplitJoin, normalize_request)
from .bucket_cache import BucketCompileCache
from .bucketing import bucket_for, bucket_sizes, pad_rows
from .errors import DeadlineExceededError, EngineClosedError, QueueFullError
from .metrics import ServingStats

ENV_MAX_BATCH = 'PADDLE_TPU_SERVE_MAX_BATCH'
ENV_MAX_DELAY = 'PADDLE_TPU_SERVE_MAX_DELAY_MS'

_LOW_DTYPES = {'bfloat16': torch.bfloat16, 'float16': torch.float16}

# sentinel distinguishing "deadline not supplied" from "no deadline" on
# resubmission (see submit()'s underscore params)
_UNSET = object()
# int8_wo: weights stored int8 (per-output-channel scales), dequantized
# inside each bucket's captured forward; activations stay full width
_PRECISIONS = ('float32', 'bfloat16', 'float16', 'int8_wo')


def _mesh_place(ctx, layer, params, device):
    """The parameters a mesh engine computes with, on ``device``: each
    placed by its Parameter's ``logical_axes`` (none: replicated). A split
    would need the Layer's own sharded forward (``meta_parallel``'s
    layers), which is not ported."""
    annot = {n: getattr(p, 'logical_axes', None)
             for n, p in layer.named_parameters()}
    for k, v in params.items():
        spec = ctx.spec(annot.get(k), tuple(v.shape), label=k)
        if any(e is not None for e in spec):
            raise NotImplementedError(
                f'InferenceEngine over a mesh: parameter {k!r} splits as '
                f'{tuple(spec)}; a Layer sharded over mp runs through '
                "meta_parallel's layers, not ported yet (ROADMAP Queue 1 "
                'step K4)')
    return {k: v.to(device) for k, v in params.items()}


def _wo_param_axes(layer):
    """Dotted param name -> reduction axes for every parameter with a
    weight-only int8 layout: Linear [in, out] per-output-channel, Conv2D
    [out, in, kh, kw] per-filter, Embedding [V, H] per-row. Anything not
    listed here (biases, norms, raw parameters such as ``ErnieModel``'s)
    stays full precision."""
    from ..nn.layer_common import Embedding, Linear
    from ..nn.layer_conv import Conv2D
    axes = {}
    for prefix, sub in layer.named_sublayers(include_self=True):
        name = f'{prefix}.weight' if prefix else 'weight'
        if isinstance(sub, Linear):
            axes[name] = (0,)
        elif isinstance(sub, Conv2D):
            axes[name] = (1, 2, 3)
        elif isinstance(sub, Embedding):
            axes[name] = (1,)
    return axes


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def lower_tree(tree, low):
    """Floating tensors of a name -> tensor dict cast to ``low`` (None:
    the dict as it is)."""
    if low is None:
        return dict(tree)
    return {k: (v.to(low) if dtypes.is_floating(v.dtype) else v)
            for k, v in tree.items()}


def owned_tree(tree, low):
    """``lower_tree`` that never shares a floating tensor's storage:
    floating tensors cast to ``low``, or cloned when ``low`` is None or
    already their dtype (quantized banks, already new, pass through)."""
    return {k: ((v.to(low, copy=True) if low is not None else v.clone())
                if isinstance(v, torch.Tensor) and dtypes.is_floating(v.dtype)
                else v)
            for k, v in tree.items()}


def host_outputs(outs):
    """Outputs as host numpy arrays (a bfloat16 tensor as float32, numpy
    having no bfloat16). Device outputs are copied into pinned host
    memory on the current stream, then the stream is synchronized once
    for all of them."""
    res, streams = [], set()
    for o in outs:
        if isinstance(o, torch.Tensor):
            if o.dtype == torch.bfloat16:
                o = o.float()
            if o.device.type == 'cuda':
                h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                h.copy_(o, non_blocking=True)
                streams.add(torch.cuda.current_stream(o.device))
                o = h
        res.append(o)
    for st in streams:
        st.synchronize()
    return [o.numpy() if isinstance(o, torch.Tensor) else o for o in res]


def _resolve_backend(net, precision):
    """Accepts a Layer, a hapi Model, or an inference Predictor and returns
    (layer, params, buffers, precision, example_spec) where example_spec is
    the backend's declared input spec (hapi InputSpecs / Predictor meta) for
    ``warmup='all_buckets'``, or None when the backend declares none."""
    from ..nn.layer_base import Layer, buffer_arrays, param_arrays
    example_spec = None
    if not isinstance(net, Layer) and \
            isinstance(getattr(net, 'network', None), Layer):
        # hapi Model: let its in-flight steps finish, and flip to eval
        # through the Model's own mode tracker (a raw layer.eval() would
        # leave _net_mode stale, and the next train_batch would keep
        # training with dropout off)
        net._drain_inflight()
        net._enter_mode(False)
        example_spec = list(net._inputs) if getattr(net, '_inputs', None) \
            else None
        net = net.network
    if isinstance(net, Layer):
        return (net, param_arrays(net), buffer_arrays(net),
                precision or 'float32', example_spec)
    if hasattr(net, 'attach_layer') and hasattr(net, 'config'):
        # inference.Predictor
        pred = net
        layer = pred._layer
        if layer is None:
            raise ValueError(
                'Predictor has no attached Layer; the serving engine batches '
                'through the Layer\'s forward: call attach_layer(model) '
                '(the exported .pt2 program is served by the Predictor)')
        if precision is None:
            precision = pred.config._precision
            stored = pred._meta.get('precision')
            if precision == 'float32' and stored in _LOW_DTYPES:
                precision = stored   # offline-converted model: honor it
        example_spec = pred._meta.get('input_spec') or None
        return (layer, dict(pred._params), dict(pred._buffers),
                precision or 'float32', example_spec)
    raise TypeError(f'cannot serve a {type(net).__name__}; expected a '
                    f'Layer, hapi Model, or inference Predictor')


def _device_of(layer, params, buffers):
    for v in list(params.values()) + list(buffers.values()):
        return v.device
    from ..device import current_device
    return current_device()


class InferenceEngine:
    """Dynamic-batching inference engine over one model.

    ``submit(*inputs)`` takes one request: every input batch-major with a
    shared leading row count (1 row is the single-query case; oversized
    requests are split across buckets transparently). Returns a
    ``concurrent.futures.Future`` resolving to the sliced outputs (a single
    array, or a list when the model has several outputs). The engine runs
    where the model's parameters live.
    """

    def __init__(self, net=None, *, max_batch_size=None, max_delay_ms=None,
                 queue_capacity=256, precision=None, default_deadline_ms=None,
                 breaker=None, autostart=True, clock=None, warmup=None,
                 input_spec=None, telemetry_port=None, mesh=None, mp=None):
        from ..parallel import mesh_engine as _mesh
        self._mesh_ctx = ctx = _mesh.resolve(mesh, mp=mp)
        layer, params, buffers, precision, example_spec = \
            _resolve_backend(net, precision)
        if precision not in _PRECISIONS:
            raise ValueError(f'precision must be one of {_PRECISIONS}, '
                             f'got {precision!r}')
        layer.eval()    # serving is per-sample: BN/dropout must be frozen
        self._layer = layer
        self._precision = precision
        self.device = (ctx.devices[0] if ctx is not None
                       else _device_of(layer, params, buffers))
        if ctx is not None:
            params = _mesh_place(ctx, layer, params, self.device)
            buffers = {k: v.to(self.device) for k, v in buffers.items()}
        low = _LOW_DTYPES.get(precision)
        self._low = low
        self._wo_dtypes = {}    # quantized param name -> original dtype
        params = {k: v.detach() for k, v in params.items()}
        if precision == 'int8_wo':
            from ..ops.weight_only import quantize_param
            axes = _wo_param_axes(layer)
            for k, v in list(params.items()):
                if k in axes and dtypes.is_floating(v.dtype):
                    params[k] = quantize_param(v, axes[k])
                    self._wo_dtypes[k] = v.dtype
        # buffers too: an f32 BN running stat would re-promote activations
        # back to f32 mid-network (same rule as the Predictor)
        # the engine keeps the weights it was built with, as the
        # reference's arrays: an in-place step on the Layer after
        # construction must not reach what the graphs read
        self._params = owned_tree(params, low)
        self._buffers = owned_tree({k: v.detach()
                                    for k, v in buffers.items()}, low)

        self.max_batch_size = int(max_batch_size if max_batch_size is not None
                                  else _env_int(ENV_MAX_BATCH, 16))
        delay_ms = (max_delay_ms if max_delay_ms is not None
                    else _env_float(ENV_MAX_DELAY, 2.0))
        self.max_delay_s = max(0.0, float(delay_ms) / 1e3)
        self.queue_capacity = int(queue_capacity)
        self.default_deadline_ms = default_deadline_ms
        self._breaker = breaker if breaker is not None else \
            fault.CircuitBreaker(failure_threshold=5, recovery_timeout=5.0)
        self._clock = clock or time.monotonic
        self._autostart = autostart

        self._cache = BucketCompileCache(self._build)
        self._trace_count = 0        # captures (the reference's traces)
        self._stats = ServingStats(clock=self._clock)
        if ctx is not None and _obs.enabled():
            # the degree rides a gauge of its own: the engine's label set
            # stays {'engine': ...} at every mesh size
            _obs.registry().gauge(
                'serve.mesh_devices',
                {**self._stats.labels, 'mesh': f'mp{ctx.mp}'}).set(ctx.size)
        self._queues = PendingQueues()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._thread = None
        self._closed = False
        self._draining = False
        self._example_spec = input_spec if input_spec is not None \
            else example_spec
        # readiness + optional telemetry plane: the engine advertises one
        # /readyz probe (warm AND breaker closed AND queue below capacity);
        # telemetry_port=N additionally starts the HTTP server (0 = pick a
        # free port, read it back from engine.telemetry.port)
        self._warmed = False
        self._probe_name = f'serving.{self._stats.labels["engine"]}'
        _obs.add_readiness(self._probe_name, self._readiness_probe)
        self.telemetry = (_obs.serve_telemetry(port=telemetry_port)
                          if telemetry_port is not None else _obs.NULL_SERVER)
        if warmup is not None:
            # capture before submit() is ever accepted: the first real
            # request must find its graph already in the bucket cache
            self.warmup(warmup)

    # ---- capture path ----------------------------------------------------
    def _forward(self, *xs):
        """The model's forward over one padded batch, under no_grad, with
        the engine's weights: -> a tuple of output tensors."""
        from ..nn.layer_base import functional_call
        from ..ops.weight_only import dequantize_param
        low = self._low
        if low is not None:
            xs = [x.to(low) if dtypes.is_floating(x.dtype) else x
                  for x in xs]
        params = self._params
        if self._wo_dtypes:
            # the dequantize runs inside the captured forward: the weights
            # stay int8 in device memory between batches
            params = dict(params)
            for k, dt in self._wo_dtypes.items():
                params[k] = dequantize_param(params[k], dt)
        with torch.no_grad():
            out, _ = functional_call(self._layer, params, self._buffers,
                                     *xs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        return tuple(o.float() if isinstance(o, torch.Tensor)
                     and o.dtype == torch.bfloat16 else o for o in outs)

    def _build(self, bucket, sig, precision):
        """One captured forward per cache key, over zeroed static input
        buffers of the bucket's shape. The weights are the engine's one
        device copy, read in place by every bucket's graph."""
        names = [f'x{i}' for i in range(len(sig))]
        bufs = {n: torch.zeros((bucket,) + tuple(shape),
                               dtype=dtypes.convert_dtype(dt),
                               device=self.device)
                for n, (shape, dt) in zip(names, sig)}

        label = f'serving.bucket{bucket}'

        def fn(**b):
            # the bucket's first eager run (a warm-up run before the
            # capture, or the CPU's run) is counted: perf.flops{fn}
            with _obs.perf.measure(label, precision=self._precision,
                                   pyname='forward') as m:
                out = self._forward(*[b[n] for n in names])
                m.set_outputs(out)
            return out
        wm = sys.modules.get('paddle_tpu_torch.warmup.manifest')
        if wm is not None and wm.capturing():
            wm.record(wm.serving_bucket_entry(
                bucket, sig, precision, max_batch=self.max_batch_size))
        cap = CapturedFn(fn, bufs, self.device)
        self._trace_count += 1
        return cap

    def warmup(self, manifest='all_buckets', input_spec=None):
        """Capture serving graphs before traffic.

        ``manifest`` is a ``warmup.Manifest``, a path to a saved one, or
        the string ``'all_buckets'`` to synthesize the whole bucket ladder
        for one input signature (``input_spec=`` per-example
        ``(shape, dtype)`` pairs, or the spec inferred from a hapi Model /
        Predictor backend). Returns the prebuild report dict."""
        from .. import warmup as _warmup_mod
        if isinstance(manifest, str) and manifest == 'all_buckets':
            manifest = _warmup_mod.all_buckets_manifest(
                self, input_spec=input_spec)
        report = _warmup_mod.prebuild(manifest, engine=self)
        self._warmed = True
        return report

    # ---- readiness -------------------------------------------------------
    def _readiness_probe(self):
        """The engine's readiness: warm (explicit warmup ran, or traffic
        has already captured at least one bucket) AND circuit breaker
        closed AND queue below capacity AND not shut down."""
        with self._lock:
            depth = self._queues.depth
            closed = self._closed
        warm = self._warmed or len(self._cache) > 0
        breaker = self._breaker.state
        ready = (warm and breaker == 'closed'
                 and depth < self.queue_capacity and not closed)
        return {'ready': ready, 'warm': warm, 'breaker': breaker,
                'queue_depth': depth, 'queue_capacity': self.queue_capacity,
                'closed': closed}

    # ---- lifecycle -------------------------------------------------------
    def start(self):
        with self._lock:
            if self._closed:
                raise EngineClosedError('engine already shut down')
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._dispatch_loop,
                    name='paddle-tpu-torch-serving-dispatch', daemon=True)
                self._thread.start()
        return self

    def shutdown(self, drain=True, timeout=None):
        """Stop the dispatch thread. ``drain=True`` executes everything
        already admitted first; otherwise pending futures fail with
        EngineClosedError."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._draining = drain
            # no dispatch thread (autostart=False, never started): nobody
            # else will execute the admitted work, so drain it inline
            inline = drain and self._thread is None
            failed = [] if drain else self._queues.drain_all()
            self._cv.notify_all()
        for r in failed:
            err = EngineClosedError('engine shut down')
            r.rec.note('cancel')
            r.rec.finish('cancelled', err)
            r.future.set_exception(err)
        if inline:
            self._drain_inline()
        if self._thread is not None:
            self._thread.join(timeout)
        _obs.remove_readiness(self._probe_name)
        self.telemetry.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # ---- admission -------------------------------------------------------
    def submit(self, *inputs, deadline_ms=None,
               _record=None, _enqueue_t=None, _deadline_t=_UNSET):
        """Enqueue one request. The underscore params are the resubmission
        hooks of a router: a failed-over request keeps its original
        ``RequestRecord``, submit-time enqueue timestamp, and absolute
        deadline."""
        arrays, n, sig = normalize_request(inputs)
        deadline_ms = (deadline_ms if deadline_ms is not None
                       else self.default_deadline_ms)
        now = self._clock()
        enqueue_t = _enqueue_t if _enqueue_t is not None else now
        if _deadline_t is not _UNSET:
            deadline_t = _deadline_t
        else:
            deadline_t = (now + deadline_ms / 1e3
                          if deadline_ms is not None else None)
        future = Future()
        # request-scoped trace: one record per submit(), shared by every
        # chunk of a split request (NULL_RECORD when obs is disabled)
        if _record is not None:
            rec = _record
        else:
            rec = _obs.start_request(
                'serve', engine=self._stats.labels['engine'], rows=n)
        future.request_id = rec.rid
        if deadline_t is not None and now >= deadline_t:
            # already unmeetable: fail fast instead of queueing a request
            # that would only burn a dispatch slot before expiring
            waited = (now - enqueue_t) * 1e3
            limit = (deadline_t - enqueue_t) * 1e3
            err = DeadlineExceededError(waited, limit)
            self._stats.note_expired()
            rec.note('expire', waited_ms=round(waited, 3), fast_fail=True)
            rec.finish('expired', err)
            raise err
        max_b = self.max_batch_size
        if n <= max_b:
            chunks = [(arrays, future)]
        else:
            # split an oversized request into bucket-sized chunks joined
            # back into the caller's single future
            bounds = list(range(0, n, max_b)) + [n]
            join = SplitJoin(future, len(bounds) - 1)
            chunks = [([a[lo:hi] for a in arrays], join.part(i))
                      for i, (lo, hi) in enumerate(zip(bounds, bounds[1:]))]
            rec.expect_parts(len(chunks))
        try:
            with self._cv:
                if self._closed:
                    raise EngineClosedError('engine already shut down')
                depth = self._queues.depth
                if depth + len(chunks) > self.queue_capacity:
                    self._stats.note_rejected()
                    raise QueueFullError(self.queue_capacity, depth)
                rec.note('enqueue', depth=depth, chunks=len(chunks))
                for arrs, fut in chunks:
                    self._queues.push(
                        Request(arrs, sig, fut, enqueue_t, deadline_t,
                                rec=rec))
                # split requests are accounted per admitted chunk so
                # submitted/completed/occupancy all measure the same unit
                self._stats.note_submitted(len(chunks))
                if len(chunks) > 1:
                    self._stats.note_split()
                self._cv.notify_all()
        except Exception as e:
            rec.finish('rejected', e)
            raise
        if self._autostart and self._thread is None:
            self.start()
        return future

    # ---- dispatch --------------------------------------------------------
    def _dispatch_loop(self):
        while True:
            group = None
            with self._cv:
                while True:
                    now = self._clock()
                    force = self._closed
                    group = self._queues.take_ready(
                        now, self.max_batch_size, self.max_delay_s,
                        force=force)
                    if group is not None:
                        break
                    if self._closed:
                        return
                    wait = self._queues.time_until_ready(now,
                                                         self.max_delay_s)
                    # a fake test clock never advances real time: cap the
                    # sleep so aged groups are still noticed promptly
                    self._cv.wait(wait if wait is None
                                  else min(max(wait, 1e-4), 0.05))
            self._run_group(group)

    def _run_group(self, group):
        try:
            self._execute(*group)
        except BaseException as e:     # never kill the dispatch thread
            for r in group[1]:
                r.rec.finish('error', e)
                if not _future_done(r.future):
                    r.future.set_exception(e)
            self._stats.note_failed(len(group[1]))

    def _drain_inline(self):
        """Execute everything already admitted on the caller's thread (used
        by shutdown(drain=True) when no dispatch thread ever started)."""
        while True:
            with self._cv:
                group = self._queues.take_ready(
                    self._clock(), self.max_batch_size, self.max_delay_s,
                    force=True)
            if group is None:
                return
            self._run_group(group)

    def _execute(self, sig, reqs):
        now = self._clock()
        live = []
        for r in reqs:
            if r.deadline_t is not None and now > r.deadline_t:
                waited = (now - r.enqueue_t) * 1e3
                limit = (r.deadline_t - r.enqueue_t) * 1e3
                err = DeadlineExceededError(waited, limit)
                r.rec.note('expire', waited_ms=round(waited, 3))
                r.rec.finish('expired', err)
                r.future.set_exception(err)
                self._stats.note_expired()
            else:
                live.append(r)
                self._stats.note_queue_wait(now - r.enqueue_t)
        if not live:
            return
        rows = sum(r.n for r in live)
        bucket = bucket_for(rows, self.max_batch_size)
        for r in live:
            r.rec.note('admit', bucket=bucket, batch_rows=rows)
        n_in = len(live[0].arrays)
        cols = [np.concatenate([r.arrays[i] for r in live], axis=0)
                if len(live) > 1 else live[0].arrays[i]
                for i in range(n_in)]
        padded = [pad_rows(c, bucket) for c in cols]
        t0 = time.perf_counter()
        misses_before = self._cache.misses
        perf_label = f'serving.bucket{bucket}'

        def device_call():
            fault.inject('serving.dispatch')
            fn = self._cache.get(bucket, sig, self._precision)
            with _obs.perf.program_range(perf_label):
                outs = fn.replay(**{f'x{i}': p
                                    for i, p in enumerate(padded)})
                # ONE host readback for the whole batch, then host-side
                # slicing
                return host_outputs(outs)

        span_kw = {'bucket': bucket, 'rows': rows, 'requests': len(live)}
        if _obs.enabled():
            span_kw['req_ids'] = [r.rec.rid for r in live if r.rec.rid]
        try:
            with _obs.span('serve.batch', **span_kw):
                outs = self._breaker.call(device_call)
        except Exception as e:
            for r in live:
                r.rec.finish('error', e)
                r.future.set_exception(e)
            self._stats.note_failed(len(live))
            return
        exec_s = time.perf_counter() - t0
        blbl = {'bucket': str(bucket)}
        if self._cache.misses > misses_before:
            # first execution at this bucket: includes the capture
            _obs.histogram('serve.first_exec_ms', blbl).observe(1e3 * exec_s)
        else:
            _obs.histogram('serve.bucket_exec_ms', blbl).observe(1e3 * exec_s)
            # steady-state wall time only: a capture-inclusive first
            # execution would poison the live MFU join
            _obs.perf.note_step(perf_label, exec_s,
                                precision=self._precision)
        _obs.counter('serve.bucket_rows', blbl).inc(rows)
        _obs.counter('serve.bucket_padded_rows', blbl).inc(bucket)
        done_t = self._clock()
        off = 0
        for r in live:
            res = [o[off:off + r.n] if (getattr(o, 'ndim', 0) >= 1
                                        and o.shape[0] == bucket) else o
                   for o in outs]
            off += r.n
            r.future.set_result(res[0] if len(res) == 1 else res)
            r.rec.note('retire', rows=r.n, bucket=bucket)
            if r.rec.part_retired():
                r.rec.finish('ok')
            self._stats.note_completed(done_t - r.enqueue_t)
        self._stats.note_batch(rows=rows, bucket=bucket, exec_s=exec_s)

    # ---- observability ---------------------------------------------------
    def stats(self):
        out = self._stats.snapshot()
        with self._lock:
            out['queue_depth'] = self._queues.depth
        out['compiles'] = len(self._cache)
        out['cache_misses'] = self._cache.misses
        out['prebuilt'] = self._cache.prebuilt
        out['traces'] = self._trace_count
        out['buckets'] = list(bucket_sizes(self.max_batch_size))
        out['max_batch_size'] = self.max_batch_size
        out['max_delay_ms'] = self.max_delay_s * 1e3
        out['precision'] = self._precision
        out['circuit_state'] = self._breaker.state
        out['warmed'] = self._warmed
        out['mesh'] = (self._mesh_ctx.describe()
                       if self._mesh_ctx is not None else None)
        return out


def _future_done(fut):
    done = getattr(fut, 'done', None)
    return done() if callable(done) else False
