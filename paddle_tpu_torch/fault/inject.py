"""Env-controlled fault injection (port of ``paddle_tpu/fault/inject.py``).

Armed via ``PADDLE_FAULT_INJECT="point:prob[:action],..."`` where action is
``raise`` (default: raise InjectedFault), ``kill`` (SIGKILL the process
mid-operation) or ``delay:<secs>`` (sleep at the point then continue — a
stall, not a failure). ``PADDLE_FAULT_SEED`` makes firing decisions
reproducible; ``PADDLE_FAULT_MAX`` caps how many faults fire per process.

Instrumented points in the port: ``gen.step`` (serving.GenerationEngine,
entry of every prefill and decode device call — inside the engine's
CircuitBreaker, so armed faults exercise the breaker-opening path),
``ckpt.write`` / ``ckpt.commit`` (framework_io.save, before the payload /
manifest os.replace), ``dataloader.step`` (per batch) and
``collective.entry`` (distributed.collective's all_reduce, all_gather,
broadcast, reduce_scatter, alltoall and barrier).

When no spec is armed, ``inject()`` is a single falsy-dict check.
"""
import os
import random
import signal
import time

from .errors import InjectedFault

ENV_SPEC = 'PADDLE_FAULT_INJECT'
ENV_SEED = 'PADDLE_FAULT_SEED'
ENV_MAX = 'PADDLE_FAULT_MAX'

_points = {}            # point -> (probability, action, delay_s)
_rng = random.Random()
_max_faults = None
_fired = 0


def _parse(spec):
    out = {}
    for part in (spec or '').split(','):
        part = part.strip()
        if not part:
            continue
        fields = part.split(':')
        if len(fields) < 2:
            raise ValueError(
                f'bad fault spec {part!r}: want point:prob[:action]')
        point, prob = fields[0], float(fields[1])
        action = fields[2] if len(fields) > 2 else 'raise'
        delay = 0.0
        if action == 'delay':
            if len(fields) < 4:
                raise ValueError(
                    f'bad fault spec {part!r}: delay wants '
                    f'point:prob:delay:<secs>')
            delay = float(fields[3])
        elif action not in ('raise', 'kill'):
            raise ValueError(f'bad fault action {action!r} in {part!r}')
        out[point] = (prob, action, delay)
    return out


def _norm_entry(ent):
    """Accept 2-tuples from programmatic configure(dict) callers."""
    if len(ent) == 2:
        return (ent[0], ent[1], 0.0)
    return ent


def configure(spec=None, seed=None, max_faults=None):
    """Programmatic arming (tests); ``configure(None)`` disarms."""
    global _points, _rng, _max_faults, _fired
    _points = _parse(spec) if isinstance(spec, str) else dict(spec or {})
    _rng = random.Random(seed)
    _max_faults = max_faults
    _fired = 0


def reload():
    """Re-read the PADDLE_FAULT_* environment (called once at import)."""
    seed = os.environ.get(ENV_SEED)
    mx = os.environ.get(ENV_MAX)
    configure(os.environ.get(ENV_SPEC),
              seed=int(seed) if seed else None,
              max_faults=int(mx) if mx else None)


def inject(point):
    """Fire the armed fault at ``point`` (probabilistically); no-op when
    disarmed. Place at the entry of any operation whose failure the caller
    claims to survive."""
    if not _points:
        return
    ent = _points.get(point)
    if ent is None:
        return
    global _fired
    if _max_faults is not None and _fired >= _max_faults:
        return
    prob, action, delay = _norm_entry(ent)
    if _rng.random() >= prob:
        return
    _fired += 1
    from .. import observability as _obs
    _obs.counter('fault.injected', {'point': point}).inc()
    _obs.record_event('fault.injected', point=point, action=action)
    if action == 'kill':
        os.kill(os.getpid(), signal.SIGKILL)
    if action == 'delay':
        time.sleep(delay)       # a stall, not a failure — then proceed
        return
    raise InjectedFault(point)


def active_points():
    return dict(_points)


def fired_count():
    return _fired


reload()
