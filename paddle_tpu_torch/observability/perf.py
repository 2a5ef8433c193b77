"""Performance explainability: counted FLOPs and bytes, MFU, roofline (port
of ``paddle_tpu/observability/perf.py``).

The reference reads XLA's cost and memory analysis of a compiled program.
The port has no compiled program to ask, so it counts what one execution
dispatches:

- ``analyze(label, fn, args, kwargs)`` RUNS ``fn`` once under
  ``measure(label)``: FLOPs by ``torch.utils.flop_counter.
  FlopCounterMode`` (matmuls, convolutions, attention, and kernel 1 and its
  backward through the formulas ``ops/flash_attention.py`` registers),
  bytes accessed as the inputs and outputs of every dispatched op that is
  not a view (a ``TorchDispatchMode``). It publishes the reference's
  series: ``perf.flops{fn}``, ``perf.bytes_accessed{fn}``,
  ``perf.arithmetic_intensity{fn}``, ``perf.hbm_bytes{fn,kind}`` and the
  compute-vs-memory verdict against the card's ridge. Since it executes,
  callers count an execution that happens anyway (``measure``: a train
  step's first run, a serving bucket's warm-up run before its capture):
  an extra run of a step that updates state in place is never added.
- ``hbm_bytes`` kinds as the port measures them: ``argument`` the bytes
  of the distinct tensors the ops read that existed before the run
  (weights and inputs, however they were passed), ``output`` the bytes of
  what ``fn`` returned, ``temp`` the bytes the ops wrote besides those
  outputs (a sum over the run, not XLA's peak), ``code`` 0.
- ``note_step(label, seconds)`` joins the counted FLOPs with a measured
  wall time into ``perf.mfu{fn}`` / ``perf.mfu`` and ``perf.step_ms{fn}``.
- ``sweep_hbm()`` samples ``torch.cuda.memory_stats(d)
  ['allocated_bytes.all.current']`` on the card (the process's resident
  set on the CPU) into ``perf.hbm_used_bytes{device}``, with the reference's
  leak-streak detector (``perf.hbm_leak_suspect``).

Kernels 4-7 are called through ctypes, not through a dispatched
operator, so a run that reaches them counts none of their FLOPs; no
caller that ``analyze`` counts reaches them.

Peaks come from a per-device-kind table (``torch.cuda.get_device_name``;
no TPU rows); ``PADDLE_TPU_PEAK_FLOPS`` / ``PADDLE_TPU_PEAK_BW`` (and the
``_FP8`` / ``_INT8`` FLOPs knobs) override it, read per call.

Disabled mode (``PADDLE_TPU_OBS=0``): every entry point is a no-op
returning ``None`` (``measure`` runs the block uncounted).
"""
import collections
import contextlib
import os
import threading

from .registry import cfg, registry as _registry
from .trace import _capturing, _torch_profiler, record_event

ENV_PEAK_FLOPS = 'PADDLE_TPU_PEAK_FLOPS'
ENV_PEAK_BW = 'PADDLE_TPU_PEAK_BW'
ENV_PEAK_FLOPS_FP8 = 'PADDLE_TPU_PEAK_FLOPS_FP8'
ENV_PEAK_FLOPS_INT8 = 'PADDLE_TPU_PEAK_FLOPS_INT8'

# (peak_flops/s, peak_HBM_bytes/s) by device-kind substring, checked in
# order: the H100 SXM's dense bf16 tensor-core rate and HBM3 bandwidth.
# 'cpu' is nominal so ratios stay comparable across runs, not a physical
# claim.
PEAKS = (
    ('h100', (989e12, 3.35e12)),
    ('cpu', (1e12, 100e9)),
)
_DEFAULT_PEAKS = (989e12, 3.35e12)      # unknown card: the H100's

# Per-precision peak FLOPs by device-kind substring (fp8 and int8 tensor
# cores run at twice the bf16 rate on Hopper). Kinds absent here fall back
# to the base peak (MFU can only read lower, never inflated).
PRECISION_PEAKS = (
    ('h100', {'fp8': 1979e12, 'int8': 1979e12}),
)
_PRECISION_ENV = {'fp8': ENV_PEAK_FLOPS_FP8, 'int8': ENV_PEAK_FLOPS_INT8}


def _norm_precision(precision):
    """Collapse precision spellings onto the peak-table keys: fp8 training
    and int8 weight-only serving map to 'fp8'/'int8'; full/half-width
    precisions use the base (bf16) peak -> None."""
    if precision in (None, 'none', 'float32', 'bfloat16', 'float16'):
        return None
    if precision in ('fp8', 'float8'):
        return 'fp8'
    if precision in ('int8', 'int8_wo'):
        return 'int8'
    return None


_lock = threading.Lock()
_records = {}            # label -> roofline record dict
_hbm_history = {}        # device key -> deque of recent used-bytes samples
_mfu_handles = {}        # label -> (mfu_gauge, ...) hot-path cache
_kind_cache = {}         # torch device -> kind string


def _current_device():
    """The torch device ``paddle.set_device`` chose (the CPU when no card
    is there and none was chosen)."""
    import torch
    try:
        from ..device import current_device
        return current_device()
    except RuntimeError:
        return torch.device('cpu')


def _device_kind(device=None):
    import torch
    dev = torch.device(device) if device is not None else _current_device()
    kind = _kind_cache.get(dev)
    if kind is None:
        try:
            kind = (torch.cuda.get_device_name(dev).lower()
                    if dev.type == 'cuda' else 'cpu')
        except Exception:
            kind = 'unknown'
        _kind_cache[dev] = kind
    return kind


def peaks(kind=None, precision=None):
    """-> ``(peak_flops_per_s, peak_bw_bytes_per_s, source)`` for a device
    kind (default: the current device's). Env overrides win over the
    table; source is 'env', 'table', or 'default'. ``precision``
    ('fp8'/'float8', 'int8'/'int8_wo') swaps in that precision's peak
    FLOPs where the part has one."""
    env_f = os.environ.get(ENV_PEAK_FLOPS)
    env_b = os.environ.get(ENV_PEAK_BW)
    kind = (kind or _device_kind()).lower()
    flops = bw = None
    source = 'default'
    for sub, (f, b) in PEAKS:
        if sub in kind:
            flops, bw, source = f, b, 'table'
            break
    if flops is None:
        flops, bw = _DEFAULT_PEAKS
    if env_f:
        flops, source = float(env_f), 'env'
    if env_b:
        bw, source = float(env_b), 'env'
    prec = _norm_precision(precision)
    if prec is not None:
        env_p = os.environ.get(_PRECISION_ENV[prec])
        if env_p:
            flops, source = float(env_p), 'env'
        else:
            for sub, table in PRECISION_PEAKS:
                if sub in kind and prec in table:
                    flops, source = table[prec], 'table'
                    break
    return flops, bw, source


# ---------------------------------------------------------------------------
# counting one execution
# ---------------------------------------------------------------------------

# ops that move no bytes of their own (allocation, autograd plumbing, the
# profiler's ranges)
_NO_TRAFFIC = frozenset(('empty', 'empty_strided', 'empty_like', 'detach',
                         'lift_fresh', 'alias', 'set_',
                         'resize_', '_record_function_enter_new',
                         '_record_function_exit'))


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t):
    return t.numel() * t.element_size()


def _storage_key(t):
    try:
        return (t.device, t.untyped_storage().data_ptr())
    except Exception:
        return (t.device, id(t))


def _byte_counter():
    """A TorchDispatchMode summing the bytes each non-view op reads and
    writes, and telling the tensors that existed before the run
    (arguments) from those its ops made (temporaries)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.accessed = 0
            self.written = 0
            self.made = set()        # storages an op of the run wrote
            self.args = {}           # storage -> bytes, read before made

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if getattr(func, 'is_view', False) or name in _NO_TRAFFIC:
                return out
            for t in _tensors((args, kwargs)):
                n = _nbytes(t)
                self.accessed += n
                key = _storage_key(t)
                if key not in self.made:
                    self.args[key] = max(self.args.get(key, 0), n)
            for t in _tensors(out):
                n = _nbytes(t)
                self.accessed += n
                self.written += n
                self.made.add(_storage_key(t))
            return out

    return _Bytes()


class Measure:
    """Counts the FLOPs and bytes of the dispatched ops run inside the
    block (one execution that happens anyway) and publishes them under
    ``fn=label`` on exit; ``set_outputs`` names what the block returned
    (the ``output`` kind). Made by :func:`measure`."""

    def __init__(self, label, precision=None, pyname=None):
        self.label = label
        self.precision = precision
        self.pyname = pyname
        self.record = None
        self._outputs = ()
        self._flops = None
        self._bytes = None

    def set_outputs(self, out):
        self._outputs = out

    def __enter__(self):
        try:
            from torch.utils.flop_counter import FlopCounterMode
            from ..ops import flash_attention   # noqa: F401  (its formulas)
            self._flops = FlopCounterMode(display=False)
            self._flops.__enter__()
            self._bytes = _byte_counter()
            self._bytes.__enter__()
        except Exception:
            self._close()
            _registry().counter('perf.analyze_errors',
                                {'fn': self.label}).inc()
        return self

    def _close(self, exc=(None, None, None)):
        ok = True
        for mode in (self._bytes, self._flops):
            if mode is None:
                continue
            try:
                mode.__exit__(*exc)
            except Exception:
                ok = False
        return ok

    def __exit__(self, etype, evalue, tb):
        flops_mode, bytes_mode = self._flops, self._bytes
        if flops_mode is None or bytes_mode is None:
            return False
        ok = self._close((etype, evalue, tb))
        if etype is not None or not ok:
            if etype is None:
                _registry().counter('perf.analyze_errors',
                                    {'fn': self.label}).inc()
            return False
        out_bytes = sum(_nbytes(t) for t in _tensors(self._outputs))
        mem = {'argument': int(sum(bytes_mode.args.values())),
               'output': int(out_bytes),
               'temp': int(max(0, bytes_mode.written - out_bytes)),
               'code': 0}
        self.record = _publish(self.label,
                               float(flops_mode.get_total_flops()),
                               float(bytes_mode.accessed), mem,
                               self.precision, self.pyname)
        return False


class _NullMeasure:
    record = None

    def set_outputs(self, out):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_MEASURE = _NullMeasure()


def measure(label, precision=None, pyname=None):
    """``with perf.measure('hapi.train_step') as m: out = step(...)`` —
    count that execution (see the module docstring) when ``label`` has no
    record yet: each program is counted once, on an execution that runs
    anyway, and later runs cost one dict lookup. ``m.record`` is the
    roofline record afterwards. ``NULL_MEASURE`` (a no-op block) when
    observability is disabled or the label is counted already."""
    if not cfg.enabled or analyzed(label) is not None:
        return NULL_MEASURE
    return Measure(label, precision=precision, pyname=pyname)


def _publish(label, flops, nbytes, mem, precision, pyname):
    prec = _norm_precision(precision)
    peak_f, peak_bw, _ = peaks(precision=prec)
    ridge = peak_f / peak_bw
    intensity = flops / nbytes if nbytes else 0.0
    bound_by = 'compute' if intensity >= ridge else 'memory'
    lbl = {'fn': label}
    if prec is not None:
        lbl['precision'] = prec
    reg = _registry()
    reg.gauge('perf.flops', lbl).set(flops)
    reg.gauge('perf.devices', lbl).set(1)
    reg.gauge('perf.bytes_accessed', lbl).set(nbytes)
    reg.gauge('perf.arithmetic_intensity', lbl).set(round(intensity, 4))
    reg.gauge('perf.compute_bound', lbl).set(
        1.0 if bound_by == 'compute' else 0.0)
    for kind, v in mem.items():
        mlbl = dict(lbl)
        mlbl['kind'] = kind
        reg.gauge('perf.hbm_bytes', mlbl).set(v)
    reg.gauge('perf.peak_flops').set(peak_f)
    reg.gauge('perf.peak_bw').set(peak_bw)
    reg.gauge('perf.ridge').set(round(ridge, 4))
    # the program's executions show in a capture as the outermost
    # record_function ranges named after the label (``program_range``)
    rec = {'fn': label, 'flops': flops, 'bytes_accessed': nbytes,
           'n_devices': 1, 'intensity': round(intensity, 4),
           'bound_by': bound_by, 'hbm': mem, 'mfu': None,
           'step_ms_p50': None, 'precision': prec,
           'module': label, 'pyname': pyname}
    with _lock:
        _records[label] = rec
        _mfu_handles.pop(label, None)
    return rec


def analyze(label, fn, args=(), kwargs=None, precision=None):
    """Run ``fn(*args, **kwargs)`` once, counted (``measure``), and return
    the roofline record (None when disabled or when counting failed:
    failures are counted on ``perf.analyze_errors{fn}``, never raised into
    the caller, but an error of ``fn`` itself propagates). The run is
    real: pass only a function whose run is wanted anyway, or one
    without side effects."""
    if not cfg.enabled:
        return None
    with Measure(label, precision=precision,
                 pyname=getattr(fn, '__name__', None)) as m:
        m.set_outputs(fn(*args, **(kwargs or {})))
    return m.record


def program_range(label):
    """The ``record_function`` range one execution of an analyzed program
    runs inside, so a capture can count its executions
    (``devtime._mfu_join``). A null context when disabled or when no
    capture runs."""
    if cfg.enabled and _capturing():
        mod = _torch_profiler()
        if mod is not None:
            try:
                return mod.record_function(label)
            except Exception:
                pass
    return contextlib.nullcontext()


def analyzed(label):
    """The stored roofline record for ``label`` (or None) — cheap probe the
    wiring sites use to analyze each program exactly once."""
    with _lock:
        return _records.get(label)


def records():
    """Copies of every stored roofline record, keyed by label — the join
    source for ``devtime.attribute``'s measured-MFU computation."""
    with _lock:
        return {k: dict(v) for k, v in _records.items()}


def note_step(label, seconds, precision=None):
    """Join a measured wall-time with ``label``'s counted FLOPs: observes
    ``perf.step_ms{fn}`` and sets ``perf.mfu{fn}`` + the headline
    ``perf.mfu`` gauge. No-op (still timing-safe) before ``analyze``."""
    if not cfg.enabled or seconds <= 0:
        return None
    with _lock:
        rec = _records.get(label)
        handles = _mfu_handles.get(label)
    if rec is None:
        return None
    prec = _norm_precision(precision) or rec.get('precision')
    if handles is None:
        reg = _registry()
        lbl = {'fn': label}
        if prec is not None:
            lbl['precision'] = prec
        handles = (reg.gauge('perf.mfu', lbl), reg.gauge('perf.mfu'),
                   reg.histogram('perf.step_ms', lbl),
                   reg.gauge('perf.achieved_flops', lbl))
        with _lock:
            _mfu_handles[label] = handles
    mfu_g, mfu_top, step_h, ach_g = handles
    peak_f, _, _ = peaks(precision=prec)
    achieved = rec['flops'] / seconds
    mfu = achieved / peak_f
    step_h.observe(1e3 * seconds)
    mfu_g.set(round(mfu, 6))
    mfu_top.set(round(mfu, 6))
    ach_g.set(achieved)
    with _lock:
        rec['mfu'] = round(mfu, 6)
    return mfu


# ---------------------------------------------------------------------------
# device memory
# ---------------------------------------------------------------------------

def _sweep_devices():
    import torch
    dev = _current_device()
    if dev.type == 'cuda':
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [torch.device('cpu')]


def _host_resident_bytes():
    """The process's resident set (the host's stand-in for an allocator's
    statistics: torch keeps none for CPU tensors), 0 where ``/proc`` is
    not there."""
    try:
        with open('/proc/self/statm') as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf('SC_PAGE_SIZE')
    except (OSError, ValueError, IndexError):
        return 0


def _used_bytes(d):
    import torch
    if d.type == 'cuda':
        return int(torch.cuda.memory_stats(d).get(
            'allocated_bytes.all.current', 0))
    return int(_host_resident_bytes())


def sweep_hbm(devices=None, streak=3):
    """Sample per-device memory into ``perf.hbm_used_bytes{device}``
    (``cuda:N`` / ``cpu:0``). A device whose usage grows strictly for
    ``streak`` consecutive sweeps increments
    ``perf.hbm_leak_suspect{device}`` and emits a trace event; the history
    then resets so one leak fires once per streak. Returns
    ``{device_key: used_bytes}``."""
    if not cfg.enabled:
        return None
    import torch
    devices = ([torch.device(d) for d in devices] if devices is not None
               else _sweep_devices())
    reg = _registry()
    out = {}
    for d in devices:
        used = _used_bytes(d)
        key = f'{d.type}:{d.index or 0}'
        out[key] = used
        reg.gauge('perf.hbm_used_bytes', {'device': key}).set(used)
        with _lock:
            hist = _hbm_history.get(key)
            if hist is None or hist.maxlen != streak + 1:
                hist = collections.deque(maxlen=streak + 1)
                _hbm_history[key] = hist
            hist.append(used)
            growing = (len(hist) == streak + 1 and
                       all(b > a for a, b in zip(hist, list(hist)[1:])))
            if growing:
                hist.clear()
                hist.append(used)
        if growing:
            reg.counter('perf.hbm_leak_suspect', {'device': key}).inc()
            record_event('perf.hbm_leak_suspect', device=key, bytes=used)
    return out


def report():
    """Roofline records joined with peaks — the dict behind
    ``tools/perf_report.py``."""
    if not cfg.enabled:
        return None
    peak_f, peak_bw, source = peaks()
    reg = _registry()
    with _lock:
        rows = [dict(r) for r in _records.values()]
    for r in rows:
        h = reg.find('perf.step_ms', {'fn': r['fn']})
        if h is not None:
            r['step_ms_p50'] = h.percentile(50)
        ach = (r['flops'] * 1e3 / r['step_ms_p50']
               if r.get('step_ms_p50') else None)
        r['achieved_flops_per_s'] = ach
        r['frac_of_peak'] = round(ach / peak_f, 4) if ach else None
    rows.sort(key=lambda r: -r['flops'])
    return {'device_kind': _device_kind(), 'peak_flops': peak_f,
            'peak_bw': peak_bw, 'peak_source': source,
            'ridge': round(peak_f / peak_bw, 4), 'executables': rows}


def reset_perf():
    """Drop stored records + HBM histories (tests, run restarts)."""
    with _lock:
        _records.clear()
        _hbm_history.clear()
        _mfu_handles.clear()
