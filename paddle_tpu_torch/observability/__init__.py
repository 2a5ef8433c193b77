"""paddle_tpu_torch.observability — metrics, trace spans, run telemetry
(port of ``paddle_tpu/observability``).

One process-wide metrics registry (Counter/Gauge/Histogram with labels,
JSON + Prometheus export) and one structured span tracer
(Chrome-trace/Perfetto export; each span is also a
``torch.profiler.record_function`` range). Every subsystem reports
through it under a shared namespace:

- ``train.*`` — hapi fit loop, StepTimer phase breakdown, eval batches
- ``serve.*`` / ``gen.*`` — InferenceEngine and GenerationEngine
- ``fault.*`` — retries, circuit breakers, injected faults
- ``ckpt.*``  — framework_io save/load, CheckpointManager save/restore
- ``data.*``  — DataLoader batches, host collation, device prefetch
- ``perf.*``  — counted FLOPs/bytes, MFU/roofline, device memory
- ``devtime.*`` — device-time attribution of ``/debug/profile`` captures
- ``goodput.*`` — the training goodput/badput ledger
- ``slo.*``   — SLO watcher breach counters and firing gauges
- ``request.*`` — request-scoped flight recorder (started/completed)
- ``server.*``  — telemetry HTTP plane request counters

Quick start::

    from paddle_tpu_torch import observability as obs
    eng = InferenceEngine(net, telemetry_port=0)   # /metrics, /readyz...
    snap = obs.snapshot()                  # JSON-able dict of every metric
    print(obs.to_prometheus())             # text exposition format
    obs.dump('run_dump/')                  # snapshot + prom + trace

Env knobs:

- ``PADDLE_TPU_OBS=0`` hard-disables the layer: metric helpers return one
  shared no-op singleton, ``span()`` a no-op context manager and
  ``serve_telemetry`` the inert ``NULL_SERVER``.
- ``PADDLE_TPU_OBS_DUMP=<dir>`` writes ``snapshot.json`` /
  ``metrics.prom`` / ``trace.json`` into ``<dir>`` at process exit.
- ``PADDLE_TPU_OBS_TRACE_CAP`` bounds the span ring buffer (default 1e5).

The fleet plane (``fleetobs``): ``MetricFederator`` merges the metrics of
a fleet's replicas, a model host's models, registries and remote
``/metrics`` URLs with semantic aggregates; ``stitch`` rebuilds one
request's timeline across failover attempts; ``FleetObs`` serves both
(``FleetObs().watch_router(router).serve(port=0)``, or
``serve_telemetry(fleetobs=...)``).
"""
import atexit
import os

from .registry import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                       NULL_METRIC, counter, enabled, find, fmt_key, gauge,
                       histogram, percentile, registry, set_enabled,
                       snapshot, to_prometheus)
from .trace import (NULL_SPAN, Span, build_trace_doc, dump_trace,  # noqa: F401
                    record_event, reset_trace, set_trace_cap, span,
                    trace_cap, trace_events)
from .reqtrace import (NULL_RECORD, FlightRecorder,  # noqa: F401
                       RequestRecord, recorder, reset_requests,
                       start_request)
from .server import (NULL_SERVER, TelemetryServer,  # noqa: F401
                     add_readiness, readiness, remove_readiness,
                     serve_telemetry, servers, shutdown_telemetry)
from .fleetobs import (FleetObs, MetricFederator,  # noqa: F401
                       ProfileBusyError, capture_profile, profile_in_flight,
                       register_gauge_semantics, stitch)
from . import perf  # noqa: F401  (perf.analyze / note_step / sweep_hbm)
from . import devtime  # noqa: F401  (devtime.attribute / classifier)
from . import goodput  # noqa: F401  (goodput.ledger / snapshot)
from . import promparse  # noqa: F401  (exposition parser)
from . import slo   # noqa: F401  (slo.Watcher / slo.watcher())

ENV_OBS = 'PADDLE_TPU_OBS'
ENV_DUMP = 'PADDLE_TPU_OBS_DUMP'

__all__ = [
    'Counter', 'Gauge', 'Histogram', 'MetricsRegistry', 'Span',
    'counter', 'gauge', 'histogram', 'registry', 'span', 'record_event',
    'snapshot', 'to_prometheus', 'trace_events', 'dump_trace', 'dump',
    'build_trace_doc', 'set_trace_cap', 'trace_cap',
    'enabled', 'set_enabled', 'reset', 'percentile', 'find',
    'start_request', 'recorder', 'reset_requests',
    'serve_telemetry', 'servers', 'shutdown_telemetry', 'TelemetryServer',
    'add_readiness', 'remove_readiness', 'readiness',
    'FleetObs', 'MetricFederator', 'ProfileBusyError', 'capture_profile',
    'profile_in_flight', 'register_gauge_semantics', 'stitch',
    'perf', 'devtime', 'goodput', 'promparse', 'slo',
]


def reset():
    """Clear the default registry, the trace ring, the request flight
    recorder, the perf roofline records and the goodput ledger (tests, run
    restarts). Metric objects already held by views keep working but are
    no longer exported until re-created."""
    registry().reset()
    reset_trace()
    reset_requests()
    perf.reset_perf()
    goodput.reset_goodput()


def dump(directory):
    """Write the full observability state into ``directory``:
    ``snapshot.json`` (metrics), ``metrics.prom`` (Prometheus text
    exposition), ``trace.json`` (Chrome trace). Returns the paths written
    (``tools/obs_report.py`` renders a report from such a dump)."""
    import json
    os.makedirs(directory, exist_ok=True)
    paths = {}
    paths['snapshot'] = os.path.join(directory, 'snapshot.json')
    with open(paths['snapshot'], 'w') as f:
        json.dump(snapshot(), f, indent=1, sort_keys=True, default=str)
    paths['prometheus'] = os.path.join(directory, 'metrics.prom')
    with open(paths['prometheus'], 'w') as f:
        f.write(to_prometheus())
    paths['trace'] = os.path.join(directory, 'trace.json')
    dump_trace(paths['trace'])
    return paths


def _dump_on_exit(directory):
    try:
        dump(directory)
    except Exception:        # never fail interpreter shutdown on telemetry
        pass


_dump_dir = os.environ.get(ENV_DUMP)
if _dump_dir and enabled():
    atexit.register(_dump_on_exit, _dump_dir)
