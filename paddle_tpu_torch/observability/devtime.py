"""Device-time attribution from captured profiler artifacts (port of
``paddle_tpu/observability/devtime.py``).

``capture_profile()`` writes a ``torch.profiler`` capture of live traffic
(Kineto's Chrome trace); this module is the pure-stdlib parser that
buckets every device event of such a trace into {matmul, other compute,
collective, copy, infeed, idle-gap}, then joins the busy timeline against
the ``perf.flops{fn}`` records to publish **measured** MFU.

Design points (the reference's):

- **Versioned classifier table.** Classification goes through an ordered
  regex-rule table keyed by version (``classifier(v)``). Version 1 is the
  reference's table for XLA's traces, kept as it is so the reference's
  golden traces classify the same in both packages. Version 2
  (``CLASSIFIER_VERSION``, the default) reads Kineto's Chrome traces: the
  device events are those of ``cat`` ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``; cuBLAS / CUTLASS / ``*gemm*`` / ``*xmma*`` / ``nvjet``
  / ``_scaled_mm`` kernels and the port's own attention kernels (the
  ``__global__`` functions of ``csrc/*.cu``, all tensor-core or
  attention-tile work) are matmul, ``nccl*`` is collective, memcpy and
  memset are copy. An event no rule knows falls back to ``compute`` (and
  is counted in ``unknown_events``).
- **Exclusive attribution by priority sweep.** Every instant of the
  capture window goes to the highest-priority *active* category
  (collective > matmul > copy > infeed > compute) or to ``idle``, so
  ``sum(categories) + idle == window`` holds by construction.
- **Overlap fraction**: collective time hidden under compute over all
  collective time.
- **Measured MFU.** Executions of each ``perf``-analyzed program are the
  outermost host ranges named after its label (``perf.program_range``, a
  ``record_function``; the reference counts XLA modules ``jit_<fn>``), and
  ``mfu_measured = flops × execs / (window × peak)`` lands on
  ``perf.mfu_measured{fn}`` plus the headline ``perf.mfu_measured``.
- **Straggler skew** between device lanes (pids).

Everything here is host-side post-processing of an already-written
artifact: no profiler interaction, no device work.
"""
import gzip
import io
import json
import os
import re

from .registry import cfg, registry as _registry

CLASSIFIER_VERSION = 2

# Kineto's device event categories (version 2)
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
_COPY_CATS = ('gpu_memcpy', 'gpu_memset')

# the port's kernels (``__global__`` functions of ``csrc/*.cu`` and
# ``csrc/*.cuh``): attention on the tensor cores (the ``_tc`` and split-K
# instances) or its CUDA-core tiles
PORT_KERNELS = ('flash_fwd_tc_kernel', 'flash_bwd_dq_kernel',
                'flash_bwd_dkv_kernel', 'flash_bwd_dq_tc_kernel',
                'flash_bwd_dkv_tc_kernel', 'paged_decode_kernel',
                'attn_tile_kernel', 'split_kernel', 'prefill_tc_kernel')
# the port's kernels that multiply no matrices: NMS's IoU bitmask and sweep
# (``csrc/nms.cu``), elementwise work and a reduction
PORT_COMPUTE_KERNELS = ('nms_mask_kernel', 'nms_sweep_kernel')

# Device-time categories, in attribution priority order (highest first).
# 'idle' is derived (window minus busy union), never matched.
PRIORITY = ('collective', 'matmul', 'copy', 'infeed', 'compute')
CATEGORIES = PRIORITY + ('idle',)

_V1_OP_RULES = (
    # ICI/DCN traffic first: a collective fused under compute must still
    # count as communication for the overlap math.
    ('collective', re.compile(
        r'all-reduce|all-gather|all-to-all|reduce-scatter'
        r'|collective-permute|collective-broadcast|ragged-all-to-all'
        r'|cross-replica|megascale|\bppermute\b|\bpsum\b', re.I)),
    ('matmul', re.compile(
        r'\bdot\b|\bdot[.\d]|convolution|\bconv[.\d]|\bgemm\b|matmul'
        r'|einsum|\bmxu\b|cublas|triton_gemm', re.I)),
    ('copy', re.compile(
        r'copy-start|copy-done|\bcopy\b|\bcopy[.\d]|memcpy|memset'
        r'|\bd2h\b|\bh2d\b|\bd2d\b|device-to-|host-to-', re.I)),
    ('infeed', re.compile(
        r'infeed|outfeed|host-transfer|host-compute|buffer-load', re.I)),
)
# Known compute: common HLO ops + executable envelopes (device lanes name
# them 'jit_<fn>'; the CPU backend wraps execution in TfrtCpuExecutable).
_V1_COMPUTE = re.compile(
    r'fusion|reduce\b|reduce[.\d]|broadcast|\biota\b|transpose|reshape'
    r'|select|compare|scatter|gather|\bpad\b|slice|concatenate|convert'
    r'|bitcast|\brng\b|\bsort\b|while|conditional|tanh|\bexp\b|\blog\b'
    r'|\badd\b|add[.\d]|multiply|subtract|divide|maximum|minimum|rsqrt'
    r'|softmax|attention|^jit_|TfrtCpuExecutable::Execute|XlaModule', re.I)
# Host-side infrastructure that must NOT count as device time: dispatch
# plumbing, python frames ('$file:line fn'), buffer waits, thread pools.
_V1_HOST = re.compile(
    r'^PjitFunction|^\$|^Thread|ThreadpoolListener|TfrtCpuBuffer'
    r'|ParseArguments|ThunkExecutor|^python|^EventCount|RunReady'
    r'|^Schedule|^Await|CopyToHostAsync|^process_|^thread_', re.I)

_V2_OP_RULES = (
    ('collective', re.compile(
        r'nccl|all_?reduce|all_?gather|reduce_?scatter|all_?to_?all'
        r'|sendrecv', re.I)),
    ('matmul', re.compile(
        r'gemm|gemv|cublas|cutlass|xmma|nvjet|_scaled_mm|wgmma|sm90_'
        r'|implicit_convolve|conv2d|dgrad|wgrad|fprop'
        r'|\b(?:' + '|'.join(PORT_KERNELS) + r')\b', re.I)),
    ('copy', re.compile(r'^Memcpy|^Memset|memcpy|memset', re.I)),
)
# the kernels PyTorch's own operators launch (elementwise, reductions,
# norms, indexing, RNG, sort, cat, cuDNN's non-GEMM work), and the port's
# kernels that multiply no matrices
_V2_COMPUTE = re.compile(
    r'at::native|^void at::|elementwise|vectorized|reduce|norm|softmax'
    r'|gelu|index|gather|scatter|embedding|fill|copy|cat_|CatArray'
    r'|distribution|philox|sort|radix|scan|topk|cudnn|cunn_|triton_'
    r'|\b(?:' + '|'.join(PORT_COMPUTE_KERNELS) + r')\b',
    re.I)
# in a Kineto trace every event off the device categories is host work
_V2_HOST = re.compile(r'^$')

_CLASSIFIERS = {
    1: {'ops': _V1_OP_RULES, 'compute': _V1_COMPUTE, 'host': _V1_HOST},
    2: {'ops': _V2_OP_RULES, 'compute': _V2_COMPUTE, 'host': _V2_HOST},
}


class Classifier:
    """One published version of the event-classification table: the
    capture path classifies through it, so categories cannot drift
    between tools."""

    __slots__ = ('version', '_ops', '_compute', '_host')

    def __init__(self, version):
        t = _CLASSIFIERS[version]
        self.version = version
        self._ops = t['ops']
        self._compute = t['compute']
        self._host = t['host']

    def classify(self, name, device_lane=True, cat=None):
        """-> (category, known). Unknown names fall back to 'compute' on a
        device lane (a device only runs programs) and to 'host' off one.
        ``cat`` is the event's Kineto category (version 2: memcpy and
        memset events are copy whatever their name)."""
        if self.version >= 2 and cat in _COPY_CATS:
            return 'copy', True
        for cat, rx in self._ops:
            if rx.search(name):
                return cat, True
        if self._host.search(name):
            # dispatch plumbing — even when a backend tags it onto the
            # device pid, it is host work, not device time
            return 'host', True
        if self._compute.search(name):
            return 'compute', True
        if device_lane:
            return 'compute', False
        return 'host', True

    def is_host_infra(self, name):
        return bool(self._host.search(name))


def classifier(version=None):
    """The classifier table for ``version`` (default: newest)."""
    v = CLASSIFIER_VERSION if version is None else int(version)
    if v not in _CLASSIFIERS:
        raise ValueError(f'unknown classifier version {v!r}; '
                         f'have {sorted(_CLASSIFIERS)}')
    return Classifier(v)


# ---------------------------------------------------------------------------
# artifact loading
# ---------------------------------------------------------------------------

def find_trace_files(root):
    """Every Chrome-trace artifact under ``root`` (a capture_profile
    artifact dir): ``*.trace.json.gz`` and ``*.trace.json``, sorted
    (``capture_profile`` writes Kineto's trace as ``*.pt.trace.json``)."""
    out = []
    for base, _, names in os.walk(root):
        for n in names:
            if n.endswith('.trace.json.gz') or n.endswith('.trace.json'):
                out.append(os.path.join(base, n))
    return sorted(out)


def load_trace(path):
    """Parse one trace file (gzip or plain JSON) into its document dict.
    Tolerates a bare event list (older dump shapes) by wrapping it."""
    with open(path, 'rb') as f:
        raw = f.read()
    if raw[:2] == b'\x1f\x8b':
        raw = gzip.GzipFile(fileobj=io.BytesIO(raw)).read()
    doc = json.loads(raw.decode('utf-8', 'replace'))
    if isinstance(doc, list):
        doc = {'traceEvents': doc}
    return doc


def _events_of(source):
    """Normalize any accepted source — artifact dir, trace file path,
    parsed doc, or bare event list — into one merged event list."""
    if isinstance(source, dict):
        return list(source.get('traceEvents', ()))
    if isinstance(source, (list, tuple)):
        return list(source)
    if os.path.isdir(source):
        events = []
        for p in find_trace_files(source):
            events.extend(load_trace(p).get('traceEvents', ()))
        return events
    return list(load_trace(source).get('traceEvents', ()))


# ---------------------------------------------------------------------------
# interval extraction
# ---------------------------------------------------------------------------

def _device_pids(events):
    """pids whose process_name metadata names a device lane. Empty on the
    CPU backend (everything runs on '/host:CPU' pids)."""
    dev = set()
    for e in events:
        if e.get('ph') == 'M' and e.get('name') == 'process_name':
            pname = str((e.get('args') or {}).get('name', ''))
            if '/device:' in pname or pname.startswith('device'):
                dev.add(e.get('pid'))
    return dev


def _complete_events(events):
    """ph:'X' complete events, with ph:'B'/'E' pairs folded into synthetic
    completes (per pid/tid/name stack) — more schema-drift tolerance."""
    out = []
    stacks = {}
    for e in events:
        ph = e.get('ph')
        if ph == 'X':
            out.append(e)
        elif ph == 'B':
            stacks.setdefault(
                (e.get('pid'), e.get('tid'), e.get('name')), []).append(
                    float(e.get('ts', 0.0)))
        elif ph == 'E':
            st = stacks.get((e.get('pid'), e.get('tid'), e.get('name')))
            if st:
                ts = st.pop()
                out.append({'name': e.get('name'), 'ph': 'X', 'ts': ts,
                            'dur': float(e.get('ts', ts)) - ts,
                            'pid': e.get('pid'), 'tid': e.get('tid')})
    return out


def _clip(ts, end, w0, w1):
    s, e = max(ts, w0), min(end, w1)
    return (s, e) if e > s else None


def _union_len(intervals):
    """Total covered length of an interval list (merged union)."""
    total = 0.0
    last_end = None
    for s, e in sorted(intervals):
        if last_end is None or s > last_end:
            total += e - s
            last_end = e
        elif e > last_end:
            total += e - last_end
            last_end = e
    return total


def _count_outermost(intervals):
    """Executions from possibly-nested duplicate events: count only
    outermost, non-overlapping intervals (the profiler emits one event per
    re-entered annotation level for the same call)."""
    n = 0
    cur_end = -1.0
    for s, e in sorted(intervals, key=lambda x: (x[0], -x[1])):
        if s >= cur_end:
            n += 1
            cur_end = e
    return n


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

def attribute(source, window_ms=None, publish=True, version=None,
              records=None):
    """Attribute a captured profile into per-category device time.

    ``source`` — artifact directory, trace file path, parsed trace doc, or
    bare event list. ``window_ms`` pins the attribution window (the
    capture window; default: the busy span of the trace). ``publish``
    lands the result on the registry (``devtime.*`` gauges +
    ``perf.mfu_measured{fn}``); ``records`` overrides the perf-record join
    source (tests). Returns the summary dict (also embedded by
    ``capture_profile`` into its ``summary.json``).
    """
    cls = classifier(version)
    raw = _events_of(source)
    events = _complete_events(raw)
    kineto = cls.version >= 2
    if kineto:
        dev_pids = {e.get('pid') for e in events
                    if e.get('cat') in DEVICE_CATS}
    else:
        dev_pids = _device_pids(raw)

    per_cat_iv = {c: [] for c in PRIORITY}
    lane_last_end = {}      # device pid -> latest op end
    lane_busy = {}          # device pid -> op intervals
    name_iv = {}            # event name -> intervals (for the MFU join)
    unknown = 0
    unknown_names = {}      # name -> count (the compute fallback's)
    host_events = 0
    counted = []            # (ts, end, category)

    for e in events:
        try:
            ts = float(e.get('ts', 0.0))
            dur = float(e.get('dur', 0.0))
        except (TypeError, ValueError):
            continue
        if dur <= 0:
            continue
        name = str(e.get('name', ''))
        pid = e.get('pid')
        ecat = e.get('cat')
        if kineto and ecat not in DEVICE_CATS:
            # host work; the MFU join counts the host ranges (a range's
            # device-side twin, gpu_user_annotation, would count twice)
            if ecat != 'gpu_user_annotation':
                name_iv.setdefault(name, []).append((ts, ts + dur))
            host_events += 1
            continue
        if not kineto and dev_pids and pid not in dev_pids:
            # host lane next to real device lanes: only the MFU-join names
            # matter; time attribution comes from the device lanes
            name_iv.setdefault(name, []).append((ts, ts + dur))
            host_events += 1
            continue
        cat, known = cls.classify(name, device_lane=bool(dev_pids),
                                  cat=ecat)
        if not kineto:
            name_iv.setdefault(name, []).append((ts, ts + dur))
        if cat == 'host':
            host_events += 1
            continue
        if not known:
            unknown += 1
            unknown_names[name] = unknown_names.get(name, 0) + 1
        counted.append((ts, ts + dur, cat))
        if dev_pids:
            lane_busy.setdefault(pid, []).append((ts, ts + dur))
            lane_last_end[pid] = max(lane_last_end.get(pid, ts), ts + dur)

    # window bounds: pin to the earliest counted instant; the capture
    # window (when given) fixes the length so categories + idle sum to it
    if counted:
        w0 = min(ts for ts, _, _ in counted)
        w1_data = max(end for _, end, _ in counted)
    else:
        w0, w1_data = 0.0, 0.0
    if window_ms is not None:
        w1 = w0 + float(window_ms) * 1e3
    else:
        w1 = w1_data
    window_us = max(w1 - w0, 0.0)

    for ts, end, cat in counted:
        iv = _clip(ts, end, w0, w1)
        if iv is not None:
            per_cat_iv[cat].append(iv)

    # priority boundary sweep: every instant goes to the highest-priority
    # active category; simultaneously measure collective-hidden-under-
    # compute for the overlap fraction
    bounds = []
    for ci, cat in enumerate(PRIORITY):
        for s, e in per_cat_iv[cat]:
            bounds.append((s, 0, ci))    # 0 = open before close at same t
            bounds.append((e, 1, ci))
    bounds.sort()
    active = [0] * len(PRIORITY)
    cat_us = {c: 0.0 for c in PRIORITY}
    busy_us = 0.0
    coll_total_us = 0.0
    coll_hidden_us = 0.0
    i_coll = PRIORITY.index('collective')
    i_mm = PRIORITY.index('matmul')
    i_cp = PRIORITY.index('compute')
    prev_t = None
    for t, kind, ci in bounds:
        if prev_t is not None and t > prev_t:
            seg = t - prev_t
            top = next((c for c in range(len(PRIORITY)) if active[c]), None)
            if top is not None:
                cat_us[PRIORITY[top]] += seg
                busy_us += seg
            if active[i_coll]:
                coll_total_us += seg
                if active[i_mm] or active[i_cp]:
                    coll_hidden_us += seg
        prev_t = t
        active[ci] += 1 if kind == 0 else -1
    idle_us = max(window_us - busy_us, 0.0)
    overlap = (coll_hidden_us / coll_total_us) if coll_total_us > 0 else 0.0

    skew_ms = 0.0
    if len(lane_last_end) >= 2:
        ends = sorted(lane_last_end.values())
        skew_ms = (ends[-1] - ends[0]) / 1e3

    mfu = _mfu_join(name_iv, window_us / 1e6, dev_pids, records=records)

    summary = {
        'classifier_version': cls.version,
        'window_ms': round(window_us / 1e3, 3),
        'window_source': 'capture' if window_ms is not None else 'events',
        'categories_ms': {c: round(cat_us[c] / 1e3, 3) for c in PRIORITY},
        'idle_ms': round(idle_us / 1e3, 3),
        'busy_ms': round(busy_us / 1e3, 3),
        'idle_pct': round(100.0 * idle_us / window_us, 2)
        if window_us else 0.0,
        'overlap': {'collective_ms': round(coll_total_us / 1e3, 3),
                    'hidden_ms': round(coll_hidden_us / 1e3, 3),
                    'fraction': round(overlap, 4)},
        'device_lanes': len(dev_pids),
        'per_lane_busy_ms': {str(p): round(_union_len(iv) / 1e3, 3)
                             for p, iv in sorted(lane_busy.items())},
        'straggler_skew_ms': round(skew_ms, 3),
        'events': len(events),
        'host_events': host_events,
        'unknown_events': unknown,
        'unknown_names': dict(sorted(unknown_names.items(),
                                     key=lambda kv: -kv[1])[:10]),
        'mfu_measured': mfu,
    }
    summary['categories_ms']['idle'] = summary['idle_ms']
    if publish and cfg.enabled:
        _publish(summary)
    return summary


def _mfu_join(name_iv, window_s, dev_pids, records=None):
    """Join counted executions of each perf-analyzed program against its
    static per-chip FLOPs: ``{fn: {execs, flops, mfu}}`` + ``'total'``.

    A program is matched by its record's ``module`` (the port: the label,
    the name of the ``record_function`` range it executes in; a
    reference trace: the compiled module name ``jit_<fn>``) or its python
    name wrapped in the reference's ``PjitFunction(<name>)`` dispatch
    event.
    """
    from . import perf
    if records is None:
        records = perf.records()
    if not records or window_s <= 0:
        return {}
    out = {}
    total_mfu = 0.0
    for label, rec in records.items():
        flops = float(rec.get('flops') or 0.0)
        if flops <= 0:
            continue
        module = rec.get('module')
        pyname = rec.get('pyname')
        candidates = []
        if module:
            candidates.append(str(module))
        if pyname:
            candidates.append(f'PjitFunction({pyname})')
        ivs = []
        for cand in candidates:
            ivs = name_iv.get(cand) or []
            if ivs:
                break
        if not ivs:
            continue
        execs = _count_outermost(ivs)
        if execs <= 0:
            continue
        peak_f, _, _ = perf.peaks(precision=rec.get('precision'))
        mfu = (flops * execs) / (window_s * peak_f)
        out[label] = {'execs': execs, 'flops': flops,
                      'mfu': round(mfu, 6)}
        total_mfu += mfu
    if out:
        out['total'] = round(total_mfu, 6)
    return out


def _publish(summary):
    """Land an attribution summary on the registry so federated /metrics,
    SLO rules, and obs_report consume it with zero new plumbing."""
    reg = _registry()
    for cat, ms in summary['categories_ms'].items():
        reg.gauge('devtime.category_ms', {'category': cat},
                  help='attributed device time per category, last '
                       'capture (ms)').set(ms)
    reg.gauge('devtime.window_ms',
              help='attribution window of the last capture (ms)').set(
        summary['window_ms'])
    reg.gauge('devtime.busy_ms').set(summary['busy_ms'])
    reg.gauge('devtime.idle_pct',
              help='idle fraction of the last capture window (%)').set(
        summary['idle_pct'])
    reg.gauge('devtime.overlap_fraction',
              help='collective time hidden under compute / total '
                   'collective time, last capture').set(
        summary['overlap']['fraction'])
    reg.gauge('devtime.straggler_skew_ms',
              help='spread between first- and last-finishing device '
                   'lane (ms)').set(summary['straggler_skew_ms'])
    reg.gauge('devtime.unknown_events',
              help='device events no classifier rule matched (compute '
                   'fallback)').set(summary['unknown_events'])
    reg.counter('devtime.captures_analyzed',
                help='profile captures run through devtime.attribute').inc()
    mfu = summary.get('mfu_measured') or {}
    for label, m in mfu.items():
        if label == 'total':
            continue
        reg.gauge('perf.mfu_measured', {'fn': label},
                  help='measured MFU from profiler device time (not the '
                       'cost-model join)').set(m['mfu'])
    if 'total' in mfu:
        reg.gauge('perf.mfu_measured').set(mfu['total'])
