"""Live telemetry plane: ``/metrics`` + ``/healthz`` + ``/readyz`` +
``/debug/*`` over a stdlib ``http.server`` daemon thread (port of
``paddle_tpu/observability/server.py``).

No new dependencies: ``ThreadingHTTPServer`` on a daemon thread, bound to
**localhost** by default (expose it beyond the host through your own
ingress/auth, not by flipping the bind address casually).

Endpoints:

- ``GET /metrics``  — the registry's Prometheus text exposition, with the
  ``text/plain; version=0.0.4`` content type (byte-identical to
  ``observability.to_prometheus()``).
- ``GET /healthz``  — liveness: 200 + uptime while the process serves.
- ``GET /readyz``   — readiness: every registered probe must pass (engines
  register warmup-complete AND circuit-breaker-closed AND
  queue-below-backpressure); 503 + per-check detail otherwise.
- ``GET /debug/requests`` — the flight-recorder ring (``reqtrace.py``),
  filterable by ``?id=<rid>`` / ``?outcome=ok|error|expired|active`` /
  ``?limit=N`` / ``?tenant=``.
- ``GET /debug/trace?ms=N`` — on-demand bounded Chrome-trace capture of
  the spans recorded in the next N ms (clamped); ``?cap=N`` bounds the
  ring for the capture via ``set_trace_cap``.
- ``GET /debug/slo`` — every SLO watcher rule's ok/firing state.
- ``GET /debug/fleet`` — replica + host tables when a
  :class:`~.fleetobs.FleetObs` plane is attached (404 otherwise).
- ``GET /debug/profile?ms=N`` — a bounded ``torch.profiler`` capture
  (``fleetobs.capture_profile``): one at a time (a concurrent request gets
  **409**), summary JSON with the inline ``devtime`` attribution; 503
  when observability is disabled.
- ``GET /debug/goodput`` — the training goodput ledger
  (``goodput.snapshot()``).

A server with a ``FleetObs`` attached (``serve_telemetry(fleetobs=...)``
or ``FleetObs.serve()``) federates: ``/metrics`` returns the AGGREGATED
fleet exposition (per-replica series + semantic aggregates + staleness)
instead of the process registry, and ``/debug/requests?id=`` adds a
``stitched`` cross-replica timeline next to the raw records.

Start one with ``observability.serve_telemetry(port=0)`` (port 0 picks a
free port; read it back from ``server.port``), or let an engine own one:
``InferenceEngine(telemetry_port=0)`` / ``GenerationEngine(...)`` /
``Model.fit(telemetry_port=...)``.

Disabled mode (``PADDLE_TPU_OBS=0``): ``serve_telemetry`` returns the
shared ``NULL_SERVER`` — no thread, no socket.
"""
import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import fleetobs as _fleetobs
from . import reqtrace as _reqtrace
from . import slo as _slo
from . import trace as _trace
from .registry import cfg, counter, to_prometheus

PROM_CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'
MAX_TRACE_WINDOW_MS = 10_000.0      # /debug/trace capture ceiling

_probes_lock = threading.Lock()
_probes = {}        # name -> callable() -> {'ready': bool, ...} | bool


def add_readiness(name, probe):
    """Register a readiness probe. ``probe()`` returns a dict with a
    ``'ready'`` bool (plus any detail fields) or a bare bool; every
    registered probe must pass for ``/readyz`` to return 200. Probes are
    process-global so one server can answer for several engines."""
    with _probes_lock:
        _probes[str(name)] = probe


def remove_readiness(name):
    with _probes_lock:
        _probes.pop(str(name), None)


def readiness():
    """Aggregate readiness: ``{'ready': bool, 'checks': {name: detail}}``.
    A probe that raises marks its check (and the whole answer) not ready —
    a crashed engine must not read as servable. With no probes registered
    the process is trivially ready (liveness is the only claim)."""
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


class _Handler(BaseHTTPRequestHandler):
    server_version = 'paddle-tpu-torch-telemetry/1.0'
    protocol_version = 'HTTP/1.1'

    def log_message(self, fmt, *args):      # no stderr spam per request
        pass

    # ---- response helpers ------------------------------------------------
    def _send(self, code, body, ctype='application/json'):
        data = body if isinstance(body, bytes) else body.encode('utf-8')
        self.send_response(code)
        self.send_header('Content-Type', ctype)
        self.send_header('Content-Length', str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code, obj):
        self._send(code, json.dumps(obj, indent=1, sort_keys=True,
                                    default=str))

    # ---- routing ---------------------------------------------------------
    def do_GET(self):
        parsed = urllib.parse.urlsplit(self.path)
        path = parsed.path.rstrip('/') or '/'
        q = dict(urllib.parse.parse_qsl(parsed.query))
        counter('server.http_requests', {'path': path}).inc()
        try:
            handler = _ROUTES.get(path)
            if handler is None:
                self._send_json(404, {'error': f'unknown path {path!r}',
                                      'paths': sorted(_ROUTES)})
                return
            handler(self, q)
        except (BrokenPipeError, ConnectionResetError):
            pass                            # client went away mid-response
        except Exception as e:              # never kill the server thread
            counter('server.http_errors', {'path': path}).inc()
            try:
                self._send_json(
                    500, {'error': f'{type(e).__name__}: {e}'[:500]})
            except Exception:
                pass

    # ---- endpoints -------------------------------------------------------
    def _metrics(self, q):
        fobs = self.server._telemetry.fleetobs
        body = (fobs.to_prometheus() if fobs is not None
                else to_prometheus())
        self._send(200, body, PROM_CONTENT_TYPE)

    def _healthz(self, q):
        srv = self.server._telemetry
        self._send_json(200, {'status': 'alive', 'pid': os.getpid(),
                              'uptime_s': round(time.time() - srv.started,
                                                3)})

    def _readyz(self, q):
        r = readiness()
        self._send_json(200 if r['ready'] else 503, r)

    def _debug_requests(self, q):
        rec = _reqtrace.recorder()
        limit = q.get('limit')
        rid = q.get('id') or None
        reqs = rec.requests(outcome=q.get('outcome') or None,
                            rid=rid,
                            limit=int(limit) if limit else None,
                            tenant=q.get('tenant') or None)
        out = {'count': len(reqs), 'capacity': rec.capacity,
               'requests': reqs}
        fobs = self.server._telemetry.fleetobs
        if rid and fobs is not None:
            # the fleet view: every part of a failed-over/hedged/split
            # request (local + peers) merged into one timeline
            out['stitched'] = fobs.stitch(rid)
        self._send_json(200, out)

    def _debug_trace(self, q):
        ms = min(max(float(q.get('ms', 250.0)), 0.0), MAX_TRACE_WINDOW_MS)
        old_cap = None
        if 'cap' in q:
            old_cap = _trace.trace_cap()
            _trace.set_trace_cap(int(q['cap']))
        try:
            t0 = _trace.now_us()
            if ms > 0:
                time.sleep(ms / 1e3)        # handler thread only; the
            doc = _trace.build_trace_doc(   # engines keep running
                _trace.trace_events(since_us=t0))
        finally:
            if old_cap is not None:
                _trace.set_trace_cap(old_cap)
        doc['otherData']['capture_ms'] = ms
        body = json.dumps(doc, default=str).encode('utf-8')
        self.send_response(200)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Disposition',
                         'attachment; filename="trace.json"')
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _debug_slo(self, q):
        rules = _slo.rule_states()
        firing = [r['rule'] for r in rules if r['state'] == 'firing']
        self._send_json(200, {'count': len(rules), 'firing': firing,
                              'rules': rules})

    def _debug_fleet(self, q):
        fobs = self.server._telemetry.fleetobs
        if fobs is None:
            self._send_json(404, {'error': 'no fleet observability plane '
                                           'attached to this server'})
            return
        self._send_json(200, fobs.fleet_table())

    def _debug_profile(self, q):
        ms = float(q.get('ms', 500.0))
        try:
            summary = _fleetobs.capture_profile(ms)
        except _fleetobs.ProfileBusyError as e:
            self._send_json(409, {'error': str(e), 'busy': True})
            return
        if summary.get('disabled'):
            self._send_json(503, {'error': 'observability disabled '
                                           '(PADDLE_TPU_OBS=0)'})
            return
        self._send_json(200, summary)

    def _debug_goodput(self, q):
        from . import goodput as _goodput
        self._send_json(200, _goodput.snapshot())


_ROUTES = {
    '/metrics': _Handler._metrics,
    '/healthz': _Handler._healthz,
    '/readyz': _Handler._readyz,
    '/debug/requests': _Handler._debug_requests,
    '/debug/trace': _Handler._debug_trace,
    '/debug/slo': _Handler._debug_slo,
    '/debug/fleet': _Handler._debug_fleet,
    '/debug/profile': _Handler._debug_profile,
    '/debug/goodput': _Handler._debug_goodput,
}


class TelemetryServer:
    """One HTTP listener on a daemon thread. ``port=0`` binds an ephemeral
    port (read back from ``.port``); the default host is localhost — the
    telemetry plane is an operator surface, not a public one."""

    def __init__(self, port=0, host='127.0.0.1', fleetobs=None):
        self.host = host
        self.fleetobs = fleetobs        # FleetObs plane (or None)
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd._telemetry = self
        self.port = self._httpd.server_address[1]
        self.started = time.time()
        self._thread = None

    @property
    def url(self):
        return f'http://{self.host}:{self.port}'

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={'poll_interval': 0.1},
                name='paddle-tpu-torch-telemetry', daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._httpd.shutdown()
        self._httpd.server_close()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None
        with _servers_lock:
            if self in _servers:
                _servers.remove(self)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class _NullServer:
    """Shared no-op server for disabled mode: no socket, no thread."""

    __slots__ = ()
    host = ''
    port = 0
    url = ''
    started = 0.0
    fleetobs = None

    def start(self):
        return self

    def stop(self, timeout=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SERVER = _NullServer()

_servers_lock = threading.Lock()
_servers = []


def serve_telemetry(port=0, host='127.0.0.1', fleetobs=None):
    """Start a telemetry server (daemon thread) and return it. Attaching a
    ``FleetObs`` plane (``fleetobs=``) turns this server into the fleet
    face: federated ``/metrics``, ``/debug/fleet``, stitched
    ``/debug/requests?id=``. Returns ``NULL_SERVER`` when observability is
    disabled — fully inert."""
    if not cfg.enabled:
        return NULL_SERVER
    srv = TelemetryServer(port=port, host=host, fleetobs=fleetobs).start()
    with _servers_lock:
        _servers.append(srv)
    return srv


def servers():
    with _servers_lock:
        return list(_servers)


def shutdown_telemetry():
    """Stop every server started via ``serve_telemetry`` (tests)."""
    for srv in servers():
        srv.stop()
