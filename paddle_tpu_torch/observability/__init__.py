"""paddle_tpu_torch.observability — metrics, spans and request traces for
the serving path (port of the part of ``paddle_tpu/observability`` the
GenerationEngine calls).

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
                       percentile, registry)
from .trace import NULL_SPAN, Span, record_event, span, trace_events  # noqa: F401
from .reqtrace import (NULL_RECORD, FlightRecorder,  # noqa: F401
                       RequestRecord, recorder, start_request)
from .server import add_readiness, readiness, remove_readiness  # noqa: F401
