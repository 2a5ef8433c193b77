"""Readiness table (port of the probe registry in
``paddle_tpu/observability/server.py``). Engines register a probe at
construction and remove it at shutdown; ``readiness()`` aggregates them.
The HTTP plane that serves ``/readyz`` and ``/metrics`` is not ported
yet (ROADMAP Queue 1, control planes and observability)."""
import threading

_probes_lock = threading.Lock()
_probes = {}        # name -> callable() -> {'ready': bool, ...} | bool


def add_readiness(name, probe):
    """Register a readiness probe. ``probe()`` returns a dict with a
    ``'ready'`` bool (plus any detail fields) or a bare bool."""
    with _probes_lock:
        _probes[str(name)] = probe


def remove_readiness(name):
    with _probes_lock:
        _probes.pop(str(name), None)


def readiness():
    """Aggregate readiness: ``{'ready': bool, 'checks': {name: detail}}``.
    A probe that raises marks its check (and the whole answer) not
    ready. With no probes registered the process is trivially ready."""
    with _probes_lock:
        probes = dict(_probes)
    checks, ready = {}, True
    for name, probe in sorted(probes.items()):
        try:
            st = probe()
        except Exception as e:
            st = {'ready': False, 'error': f'{type(e).__name__}: {e}'[:200]}
        if isinstance(st, bool):
            st = {'ready': st}
        checks[name] = st
        ready = ready and bool(st.get('ready'))
    return {'ready': ready, 'checks': checks}
