"""paddle_tpu_torch.observability — metrics, spans and request traces for
the serving and training paths (port of the part of
``paddle_tpu/observability`` the GenerationEngine and hapi's ``Model``
call).

- registry: Counter / Gauge / Histogram, ``registry()``, ``enabled()``
- trace:    ``span()`` / ``record_event()`` into a bounded event ring
- reqtrace: ``start_request()`` / ``NULL_RECORD`` flight recorder
- server:   the readiness table (``add_readiness`` / ``remove_readiness``)

``PADDLE_TPU_OBS=0`` disables the layer: helpers return shared no-op
singletons. Not ported yet (ROADMAP Queue 1): the telemetry HTTP plane
(``serve_telemetry``), fleet federation, perf/roofline and device-time
attribution.
"""
from .registry import (NULL_METRIC, Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, counter, enabled, find, gauge,
                       histogram, percentile, registry, snapshot,
                       to_prometheus)
from .trace import (NULL_SPAN, Span, dump_trace, record_event,  # noqa: F401
                    span, trace_events)
from .reqtrace import (NULL_RECORD, FlightRecorder,  # noqa: F401
                       RequestRecord, recorder, start_request)
from .server import add_readiness, readiness, remove_readiness  # noqa: F401
