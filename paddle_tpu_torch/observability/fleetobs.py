"""On-demand device profiling of a running process (port of the profiling
part of ``paddle_tpu/observability/fleetobs.py``).

:func:`capture_profile` is bounded on-demand tracing for a RUNNING
service: a ``torch.profiler`` capture (host and CUDA activity) of the
live traffic, one at a time (a concurrent request, or one while another
``torch.profiler`` session is active in the process, raises
:class:`ProfileBusyError`: HTTP 409 on the telemetry server), the window
clamped to ``MAX_PROFILE_WINDOW_MS``, Kineto's Chrome trace written under
an artifact directory beside a ``summary.json`` with the inline
``devtime`` attribution (per-category device time, overlap fraction,
measured MFU). The capture records every thread of the process where the
installed torch can (``profile_all_threads``; ``summary['all_threads']``
says), so an engine's scheduler thread shows while the HTTP handler's
thread holds the profiler; the card's kernels are recorded process-wide
either way. Old capture directories are removed past
``PADDLE_TPU_OBS_PROFILE_KEEP``.

The fleet plane of the reference (``MetricFederator``, ``FleetObs``,
``stitch``, ``register_gauge_semantics``) is not ported yet: each raises
NotImplementedError citing ROADMAP Queue 1 step F2.

Disabled mode (``PADDLE_TPU_OBS=0``): ``capture_profile`` returns
``{'disabled': True}`` without touching the profiler.

Env knobs: ``PADDLE_TPU_OBS_PROFILE_CAP_MS`` (capture ceiling, default
10000), ``PADDLE_TPU_OBS_PROFILE_DIR`` (artifact root, default a fresh
temp dir per capture), ``PADDLE_TPU_OBS_PROFILE_KEEP`` (default 8).
"""
import json
import os
import tempfile
import threading
import time

from .registry import cfg, counter

ENV_PROFILE_CAP = 'PADDLE_TPU_OBS_PROFILE_CAP_MS'
ENV_PROFILE_DIR = 'PADDLE_TPU_OBS_PROFILE_DIR'
ENV_PROFILE_KEEP = 'PADDLE_TPU_OBS_PROFILE_KEEP'

MAX_PROFILE_WINDOW_MS = float(os.environ.get(ENV_PROFILE_CAP, 10_000.0))
PROFILE_DIR_PREFIX = 'pt_profile_'
TRACE_FILE = 'capture.pt.trace.json'


def _deferred(what):
    return NotImplementedError(
        f'{what} (the fleet observability plane) is not ported to '
        f'paddle_tpu_torch yet (ROADMAP Queue 1 step F2)')


def register_gauge_semantics(name, how):
    raise _deferred('register_gauge_semantics')


def stitch(rid, recorders=None, urls=None):
    raise _deferred('stitch')


class MetricFederator:
    def __init__(self, *args, **kwargs):
        raise _deferred('MetricFederator')


class FleetObs:
    def __init__(self, *args, **kwargs):
        raise _deferred('FleetObs')


# ---------------------------------------------------------------------------
# on-demand device profiling
# ---------------------------------------------------------------------------

class ProfileBusyError(RuntimeError):
    """A profiler capture is already running (the profiler is a
    process-global singleton: two overlapping sessions would corrupt each
    other). Maps to HTTP 409."""


_profile_lock = threading.Lock()


def profile_keep():
    """How many capture artifact dirs to retain (LRU by mtime)."""
    try:
        return max(1, int(os.environ.get(ENV_PROFILE_KEEP, '8')))
    except ValueError:
        return 8


def _gc_profile_dirs(current_dir):
    """Retention for on-demand captures: keep the newest ``profile_keep()``
    ``pt_profile_*`` siblings of ``current_dir`` (by mtime, the running
    capture always kept), delete the rest so repeated ``/debug/profile``
    hits cannot fill the disk. Returns the number removed (also counted
    on ``fleet.obs.profile_gc_total``)."""
    import shutil
    root = os.path.dirname(os.path.abspath(current_dir))
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    dirs = []
    for n in names:
        if not n.startswith(PROFILE_DIR_PREFIX):
            continue
        p = os.path.join(root, n)
        if not os.path.isdir(p):
            continue
        try:
            mt = os.path.getmtime(p)
        except OSError:
            continue
        dirs.append((mt, p))
    keep = profile_keep()
    dirs.sort(reverse=True)                      # newest first
    cur = os.path.abspath(current_dir)
    victims = [p for _, p in dirs[keep:] if os.path.abspath(p) != cur]
    removed = 0
    for p in victims:
        shutil.rmtree(p, ignore_errors=True)
        removed += 1
    if removed:
        counter('fleet.obs.profile_gc_total',
                help='profile artifact dirs removed by retention').inc(
                    removed)
    return removed


def _profiler_active():
    """True while any ``torch.profiler`` session of this process runs."""
    import torch
    try:
        return bool(torch._C._autograd._profiler_enabled())
    except Exception:
        return False


def _all_threads_config():
    """The experimental config that records every thread (torch releases
    that have the knob), else None: then only the capturing thread's host
    events are recorded."""
    try:
        import torch
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except Exception:
        return None


def capture_profile(ms=500.0, out_dir=None):
    """Capture a bounded ``torch.profiler`` trace of the running process
    and return a summary dict.

    ``ms`` is clamped into ``[1, MAX_PROFILE_WINDOW_MS]``; the capture
    sleeps out the window on the CALLING thread while every engine keeps
    serving, so the trace records exactly the live traffic. Artifacts
    land under ``out_dir`` (default: a fresh temp dir, or
    ``PADDLE_TPU_OBS_PROFILE_DIR``): Kineto's Chrome trace
    (``capture.pt.trace.json``) and ``summary.json`` (window, wall time,
    artifact dir, file list, byte count, the ``devtime`` attribution).
    Raises :class:`ProfileBusyError` while another capture (or another
    ``torch.profiler`` session) is in flight; returns ``{'disabled':
    True}`` under ``PADDLE_TPU_OBS=0`` without touching the profiler."""
    if not cfg.enabled:
        return {'disabled': True}
    ms = min(max(float(ms), 1.0), MAX_PROFILE_WINDOW_MS)
    if not _profile_lock.acquire(blocking=False):
        raise ProfileBusyError(
            'a profiler capture is already in flight; retry after it '
            'completes')
    try:
        import torch
        if _profiler_active():
            raise ProfileBusyError(
                'another torch.profiler session is active in this '
                'process; retry after it ends')
        if out_dir is None:
            root = os.environ.get(ENV_PROFILE_DIR)
            if root:
                os.makedirs(root, exist_ok=True)
            out_dir = tempfile.mkdtemp(prefix=PROFILE_DIR_PREFIX, dir=root)
        else:
            os.makedirs(out_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        exp = _all_threads_config()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts,
                                    experimental_config=exp) as prof:
            time.sleep(ms / 1e3)
        wall_ms = round(1e3 * (time.perf_counter() - t0), 3)
        prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))
        files, total = [], 0
        for base, _, names in os.walk(out_dir):
            for n in names:
                p = os.path.join(base, n)
                try:
                    sz = os.path.getsize(p)
                except OSError:
                    continue
                files.append({'path': os.path.relpath(p, out_dir),
                              'bytes': sz})
                total += sz
        summary = {'window_ms': ms, 'wall_ms': wall_ms,
                   'artifact_dir': os.path.abspath(out_dir),
                   'files': sorted(files, key=lambda f: f['path']),
                   'bytes': total, 'ts': time.time(),
                   'profiler': 'torch.profiler',
                   'all_threads': exp is not None,
                   'cuda': torch.cuda.is_available()}
        # host-side attribution of the capture just written, published to
        # the registry AND embedded so /debug/profile returns it inline
        try:
            from . import devtime
            summary['devtime'] = devtime.attribute(out_dir, window_ms=ms)
        except Exception as e:
            summary['devtime'] = {
                'error': f'{type(e).__name__}: {e}'[:300]}
            counter('fleet.obs.profile_analyze_errors',
                    help='devtime attribution failures on captured '
                         'profiles').inc()
        try:
            with open(os.path.join(out_dir, 'summary.json'), 'w') as f:
                json.dump(summary, f, indent=1, sort_keys=True)
        except OSError:
            pass
        _gc_profile_dirs(out_dir)
        counter('fleet.obs.profiles',
                help='on-demand device profile captures').inc()
        return summary
    finally:
        _profile_lock.release()


def profile_in_flight():
    """True while a capture holds the profiler (the 409 predicate)."""
    if _profile_lock.acquire(blocking=False):
        _profile_lock.release()
        return False
    return True
