"""Fleet observability plane: metric federation, cross-replica request
stitching, and on-demand device profiling (port of
``paddle_tpu/observability/fleetobs.py``).

The pane of glass over N replicas behind a
:class:`~..serving.FleetRouter` and the models of a
:class:`~..serving.ModelHost`:

- :class:`MetricFederator` merges N metric sources into fleet-level
  series. A source is an in-process replica (a :class:`~..serving.fleet.
  ReplicaSet`'s engines, distinguished by their ``engine`` label in the
  shared process registry), an in-process :class:`~..serving.host.
  ModelHost`'s hosted models, a whole ``MetricsRegistry``, or a remote
  ``/metrics`` URL parsed by the shared exposition parser
  (``promparse.py``). Every series is re-emitted with a ``replica``
  label, and **semantic aggregates** are computed across replicas:
  counters are SUMMED (bit-equal to the per-replica total — integer
  addition), gauges are folded per registered semantics
  (:func:`register_gauge_semantics` — ``sum`` by default, ``min`` for
  binding constraints like memory watermarks, ``mean`` for ratios like
  MFU), and histogram quantiles are merged from the sources' windowed
  sample buffers (true merged-window percentiles for in-process
  sources; for URL sources, which only expose p50/p90/p99, the
  fleet quantile degrades to the conservative per-replica maximum).
  Per-replica **staleness gauges** (``fleet.obs.staleness_s``) and
  ``fleet.obs.scrape_errors`` make a dead or unreachable replica
  visible in the federated exposition itself.
- :func:`stitch` reassembles ONE end-to-end timeline for a request that
  left per-attempt records in multiple flight recorders (failover,
  hedging, split requests): all parts are found by rid (including the
  recorders' evicted archives), events are merged on the wall clock,
  exact duplicates (the same record reached through two sources) are
  dropped, and per-attempt segments are derived from the
  ``route``/``failover``/``hedge`` annotations the fleet router stamps.
- :func:`capture_profile` is bounded on-demand tracing for a RUNNING
  service: a ``torch.profiler`` capture (host and CUDA activity) of the
  live traffic, one at a time (a concurrent request, or one while another
  ``torch.profiler`` session is active in the process, raises
  :class:`ProfileBusyError`: HTTP 409 on the telemetry server), the
  window clamped to ``MAX_PROFILE_WINDOW_MS``, Kineto's Chrome trace
  written under an artifact directory beside a ``summary.json`` with the
  inline ``devtime`` attribution (per-category device time, overlap
  fraction, measured MFU). The capture records every thread of the
  process where the installed torch can (``profile_all_threads``;
  ``summary['all_threads']`` says), so an engine's scheduler thread shows
  while the HTTP handler's thread holds the profiler; the card's kernels
  are recorded process-wide either way. Old capture directories are
  removed past ``PADDLE_TPU_OBS_PROFILE_KEEP``.
- :class:`FleetObs` wires the three together and attaches them to a
  telemetry server: ``FleetObs().watch_router(router).serve(port=0)``
  gives an aggregated ``/metrics``, ``/debug/fleet`` (replica + host
  tables), ``/debug/requests?id=`` (stitched timelines), and
  ``/debug/profile?ms=N``.

Disabled mode (``PADDLE_TPU_OBS=0``): ``capture_profile`` returns
``{'disabled': True}`` without touching the profiler, and ``FleetObs.
serve`` returns the shared ``NULL_SERVER`` — fully inert.

Env knobs: ``PADDLE_TPU_OBS_PROFILE_CAP_MS`` (capture ceiling, default
10000), ``PADDLE_TPU_OBS_PROFILE_DIR`` (artifact root, default a fresh
temp dir per capture), ``PADDLE_TPU_OBS_PROFILE_KEEP`` (default 8).
"""
import json
import os
import tempfile
import threading
import time
import urllib.parse
import urllib.request

from . import promparse
from . import reqtrace as _reqtrace
from .registry import (_prom_help, _prom_labels, _prom_name, cfg, counter,
                       gauge, percentile, registry)

ENV_PROFILE_CAP = 'PADDLE_TPU_OBS_PROFILE_CAP_MS'
ENV_PROFILE_DIR = 'PADDLE_TPU_OBS_PROFILE_DIR'
ENV_PROFILE_KEEP = 'PADDLE_TPU_OBS_PROFILE_KEEP'

MAX_PROFILE_WINDOW_MS = float(os.environ.get(ENV_PROFILE_CAP, 10_000.0))
PROFILE_DIR_PREFIX = 'pt_profile_'
TRACE_FILE = 'capture.pt.trace.json'

_QUANTS = ((50, 'p50', '0.5'), (90, 'p90', '0.9'), (99, 'p99', '0.99'))


# ---------------------------------------------------------------------------
# gauge aggregation semantics
# ---------------------------------------------------------------------------

_semantics_lock = threading.Lock()
# mangled family name -> 'sum' | 'min' | 'max' | 'mean' | 'last'
_GAUGE_SEMANTICS = {
    # the binding constraint across replicas is the smallest budget
    'host_hbm_watermark_bytes': 'min',
    # ratios average; summing MFU across replicas would exceed 1.0
    'perf_mfu': 'mean',
    'perf_mfu_measured': 'mean',
    'gen_occupancy': 'mean',
    'gen_page_utilization': 'mean',
    'devtime_overlap_fraction': 'mean',
    'devtime_idle_pct': 'mean',
    'goodput_ratio': 'mean',
    # liveness-style gauges: the worst replica is the story
    'fleet_obs_staleness_s': 'max',
    'devtime_straggler_skew_ms': 'max',
}
_VALID_SEMANTICS = ('sum', 'min', 'max', 'mean', 'last')


def register_gauge_semantics(name, how):
    """Declare how a gauge family federates across replicas (default:
    ``sum``). ``name`` may be dotted (``host.hbm_watermark_bytes``) or
    already exposition-mangled; ``how`` is one of sum/min/max/mean/last.
    """
    if how not in _VALID_SEMANTICS:
        raise ValueError(f'semantics must be one of {_VALID_SEMANTICS}, '
                         f'got {how!r}')
    with _semantics_lock:
        _GAUGE_SEMANTICS[_prom_name(name)] = how


def gauge_semantics(name):
    with _semantics_lock:
        return _GAUGE_SEMANTICS.get(_prom_name(name), 'sum')


def _fold_gauge(how, vals):
    if not vals:
        return 0.0
    if how == 'min':
        return min(vals)
    if how == 'max':
        return max(vals)
    if how == 'mean':
        return sum(vals) / len(vals)
    if how == 'last':
        return vals[-1]
    return sum(vals)


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

def _registry_snapshot(reg, engine_label=None):
    """Snapshot a :class:`MetricsRegistry` into the promparse schema.

    ``engine_label`` projects the shared process registry onto ONE
    in-process replica: only series carrying ``engine == engine_label``
    are taken, and the engine label itself is dropped (the federator
    re-keys by ``replica`` — keeping both would stop identical series
    from different replicas from aggregating). Histograms carry their
    raw windowed samples so fleet percentiles are computed over the
    MERGED window, not averaged quantiles."""
    snap = {'counters': {}, 'gauges': {}, 'histograms': {},
            'labels': {}, 'types': {}, 'help': {}}
    for name, t, children, help_text in reg._items():
        pname = _prom_name(name)
        for c in children:
            labels = dict(c.labels)
            if engine_label is not None:
                if labels.pop('engine', None) != engine_label:
                    continue
            elif 'engine' in labels:
                # un-projected registry source: engine-labeled series
                # belong to the per-replica projections, not the
                # process-level view (they would double-count)
                continue
            key = promparse.fmt_key(pname, labels)
            snap['labels'][key] = labels
            snap['types'][pname] = ('summary' if t == 'histogram' else t)
            snap['help'][pname] = help_text
            if t == 'histogram':
                st = c.stats()
                with c._lock:
                    st['samples'] = list(c._samples)
                snap['histograms'][key] = st
            elif t == 'counter':
                snap['counters'][key] = c.value
            else:
                snap['gauges'][key] = c.value
    return snap


class _RegistrySource:
    """One whole registry as one replica (private registries, tests)."""

    def __init__(self, name, reg):
        self.name = name
        self._reg = reg

    def collect_all(self, now):
        return [(self.name, _registry_snapshot(self._reg), True, None)]


class _URLSource:
    """A remote replica's ``/metrics``, parsed by the shared parser."""

    def __init__(self, name, url, timeout=5.0):
        self.name = name
        self.url = url
        self.timeout = timeout

    def collect_all(self, now):
        try:
            snap = promparse.scrape(self.url, timeout=self.timeout)
            return [(self.name, snap, True, None)]
        except Exception as e:
            return [(self.name, None, False,
                     f'{type(e).__name__}: {e}'[:200])]


class _ReplicaSetSource:
    """Every replica of an in-process :class:`ReplicaSet`, one logical
    source per replica: the shared process registry projected onto each
    replica's ``engine`` label. A replica that is no longer READY or
    DRAINING stops refreshing — its cached series go stale, which is
    exactly what the staleness gauge reports."""

    def __init__(self, rset):
        self._rset = rset

    def collect_all(self, now):
        reg = registry()
        out = []
        for rep in self._rset.snapshot():
            fresh = rep.state in ('ready', 'draining')
            try:
                label = rep.label
            except Exception:
                fresh, label = False, None
            if not fresh or label is None:
                out.append((rep.name, None, False, None))
                continue
            out.append((rep.name, _registry_snapshot(reg, label), True,
                        None))
        return out


class _HostSource:
    """Every hosted model of an in-process :class:`ModelHost`; evicted
    models (no engine) stop refreshing and read as stale, same as dead
    replicas."""

    def __init__(self, host):
        self._host = host

    def collect_all(self, now):
        reg = registry()
        out = []
        for mname, m in list(getattr(self._host, '_models', {}).items()):
            rep_name = f'{mname}@{self._host.name}'
            label = m.engine_label
            if m.state != 'live' or not label:
                out.append((rep_name, None, False, None))
                continue
            out.append((rep_name, _registry_snapshot(reg, label), True,
                        None))
        return out


# ---------------------------------------------------------------------------
# the federator
# ---------------------------------------------------------------------------

class FederatedSnapshot:
    """One collection pass over every source: per-replica rows plus the
    computed fleet aggregates, renderable as JSON or as a Prometheus
    text exposition."""

    def __init__(self, name, families, staleness, errors, collect_ms):
        self.name = name
        self.families = families   # pname -> {'type','help','rows'}
        self.staleness = staleness  # replica -> seconds (None = never)
        self.errors = errors        # replica -> last error string
        self.collect_ms = collect_ms
        self.ts = time.time()

    # ---- aggregate math --------------------------------------------------
    @staticmethod
    def _merge_hist(vals):
        """Fleet histogram row from per-replica stat dicts: counts and
        sums add; quantiles come from the MERGED sample windows when the
        sources expose them (in-process registries do), else degrade to
        the conservative per-replica maximum (URL sources only carry
        p50/p90/p99)."""
        out = {'count': sum(int(v.get('count', 0) or 0) for v in vals),
               'sum': sum(float(v.get('sum', 0.0) or 0.0) for v in vals)}
        if all('samples' in v for v in vals):
            merged = [s for v in vals for s in v['samples']]
            for q, pq, _ in _QUANTS:
                out[pq] = percentile(merged, q)
            out['merged_window'] = True
        else:
            for q, pq, _ in _QUANTS:
                qs = [v[pq] for v in vals
                      if v.get(pq) is not None]
                out[pq] = max(qs) if qs else None
            out['merged_window'] = False
        if out['count']:
            out['mean'] = out['sum'] / out['count']
        return out

    def aggregate(self, pname, labels=None):
        """The fleet-level value for one family/label row (None when the
        family is unknown)."""
        fam = self.families.get(_prom_name(pname))
        if fam is None:
            return None
        lk = tuple(sorted((labels or {}).items()))
        row = fam['rows'].get(lk)
        if row is None:
            return None
        vals = [v for _, v in sorted(row['replicas'].items())]
        if fam['type'] == 'counter':
            return sum(vals)
        if fam['type'] == 'gauge':
            return _fold_gauge(gauge_semantics(pname), vals)
        return self._merge_hist(vals)

    def as_dict(self):
        """JSON view: aggregates + per-replica values per family row."""
        out = {'fleet': self.name, 'ts': self.ts,
               'collect_ms': self.collect_ms,
               'staleness_s': dict(self.staleness),
               'scrape_errors': dict(self.errors),
               'families': {}}
        for pname, fam in sorted(self.families.items()):
            rows = []
            for lk, row in sorted(fam['rows'].items()):
                rows.append({'labels': dict(row['labels']),
                             'aggregate': self.aggregate(pname,
                                                         row['labels']),
                             'replicas': {r: v for r, v in
                                          sorted(row['replicas'].items())}})
            out['families'][pname] = {'type': fam['type'],
                                      'help': fam['help'], 'rows': rows}
        return out

    # ---- exposition ------------------------------------------------------
    def _emit_value(self, lines, pname, labels, val, is_hist):
        if not is_hist:
            lines.append(f'{pname}{_prom_labels(labels)} {val}')
            return
        for _, pq, qv in _QUANTS:
            v = val.get(pq)
            if v is None:
                continue
            lines.append(
                f'{pname}{_prom_labels(dict(labels, quantile=qv))} {v}')
        lbl = _prom_labels(labels)
        lines.append(f'{pname}_sum{lbl} {val.get("sum", 0.0)}')
        lines.append(f'{pname}_count{lbl} {val.get("count", 0)}')

    def to_prometheus(self):
        """The aggregated exposition: per family, the fleet aggregate
        (no ``replica`` label) followed by every per-replica series
        (``replica=<name>``), then the federation meta-series."""
        lines = []
        for pname, fam in sorted(self.families.items()):
            is_hist = fam['type'] == 'summary'
            lines.append(f'# HELP {pname} {_prom_help(fam["help"])}')
            lines.append(f'# TYPE {pname} {fam["type"]}')
            for lk, row in sorted(fam['rows'].items()):
                agg = self.aggregate(pname, row['labels'])
                self._emit_value(lines, pname, row['labels'], agg, is_hist)
                for rep, val in sorted(row['replicas'].items()):
                    self._emit_value(
                        lines, pname, dict(row['labels'], replica=rep),
                        val, is_hist)
        lines.append('# HELP fleet_obs_staleness_s seconds since this '
                     'replica last reported fresh metrics')
        lines.append('# TYPE fleet_obs_staleness_s gauge')
        for rep, s in sorted(self.staleness.items()):
            v = round(s, 3) if s is not None else -1
            lines.append(
                f'fleet_obs_staleness_s{_prom_labels({"replica": rep})} '
                f'{v}')
        lines.append('# HELP fleet_obs_collect_ms wall time of the last '
                     'federation pass')
        lines.append('# TYPE fleet_obs_collect_ms gauge')
        lines.append(f'fleet_obs_collect_ms {self.collect_ms}')
        return '\n'.join(lines) + '\n'


class MetricFederator:
    """Merges N metric sources into fleet-level series — see the module
    docstring for the aggregation semantics. Sources are added with
    :meth:`add_registry` / :meth:`add_url` / :meth:`add_replica_set` /
    :meth:`add_host`; :meth:`collect` runs one federation pass and
    returns a :class:`FederatedSnapshot`. Collection also publishes the
    meta-series (staleness, scrape errors, collect time) into the
    process registry so the local plane sees federation health too."""

    def __init__(self, name='fleet', stale_after_s=10.0):
        self.name = name
        self.stale_after_s = float(stale_after_s)
        self._lock = threading.Lock()
        self._providers = []
        self._cache = {}          # replica -> (snap, wall_ts)
        self._errors = {}         # replica -> last error string
        self._scrape_errors = 0

    # ---- source registration ---------------------------------------------
    def add_registry(self, name, reg):
        with self._lock:
            self._providers.append(_RegistrySource(name, reg))
        return self

    def add_url(self, name, url, timeout=5.0):
        with self._lock:
            self._providers.append(_URLSource(name, url, timeout))
        return self

    def add_replica_set(self, rset):
        with self._lock:
            self._providers.append(_ReplicaSetSource(rset))
        return self

    def add_host(self, host):
        with self._lock:
            self._providers.append(_HostSource(host))
        return self

    # ---- collection ------------------------------------------------------
    def collect(self):
        t0 = time.perf_counter()
        now = time.time()
        with self._lock:
            providers = list(self._providers)
        families = {}
        staleness = {}
        for provider in providers:
            try:
                results = provider.collect_all(now)
            except Exception as e:
                name = getattr(provider, 'name', type(provider).__name__)
                results = [(name, None, False,
                            f'{type(e).__name__}: {e}'[:200])]
            for rep, snap, fresh, error in results:
                if fresh and snap is not None:
                    with self._lock:
                        self._cache[rep] = (snap, now)
                        self._errors.pop(rep, None)
                    staleness[rep] = 0.0
                else:
                    if error is not None:
                        self._note_error(rep, error)
                    with self._lock:
                        cached = self._cache.get(rep)
                    if cached is None:
                        staleness[rep] = None     # never reported
                        continue
                    snap, ts = cached
                    staleness[rep] = now - ts
                self._fold(families, rep, snap)
        collect_ms = round(1e3 * (time.perf_counter() - t0), 3)
        with self._lock:
            errors = dict(self._errors)
        self._publish_meta(staleness, collect_ms)
        return FederatedSnapshot(self.name, families, staleness, errors,
                                 collect_ms)

    def _note_error(self, rep, error):
        with self._lock:
            self._errors[rep] = error
            self._scrape_errors += 1
        counter('fleet.obs.scrape_errors', {'replica': rep},
                help='failed scrapes/collections per replica').inc()

    @staticmethod
    def _fold(families, rep, snap):
        for section, default_t in (('counters', 'counter'),
                                   ('gauges', 'gauge'),
                                   ('histograms', 'summary')):
            for key, val in snap.get(section, {}).items():
                labels = snap.get('labels', {}).get(key)
                if labels is None:
                    pname, labels = promparse.split_key(key)
                else:
                    pname = key.split('{', 1)[0]
                labels = dict(labels)
                labels.pop('replica', None)   # re-keyed below, never nested
                fam = families.setdefault(
                    pname, {'type': snap.get('types', {}).get(pname,
                                                              default_t),
                            'help': snap.get('help', {}).get(pname)
                            or pname,
                            'rows': {}})
                lk = tuple(sorted(labels.items()))
                row = fam['rows'].setdefault(
                    lk, {'labels': labels, 'replicas': {}})
                row['replicas'][rep] = val

    def _publish_meta(self, staleness, collect_ms):
        gauge('fleet.obs.sources', {'fleet': self.name},
              help='replicas contributing to the federated view') \
            .set(sum(1 for s in staleness.values() if s is not None))
        gauge('fleet.obs.collect_ms', {'fleet': self.name},
              help='wall time of the last federation pass').set(collect_ms)
        for rep, s in staleness.items():
            gauge('fleet.obs.staleness_s', {'replica': rep},
                  help='seconds since this replica last reported fresh '
                       'metrics').set(round(s, 3) if s is not None else -1)

    def to_prometheus(self):
        return self.collect().to_prometheus()


# ---------------------------------------------------------------------------
# cross-replica request stitching
# ---------------------------------------------------------------------------

def _fetch_request_parts(base_url, rid, timeout=5.0):
    url = (base_url.rstrip('/')
           + '/debug/requests?id=' + urllib.parse.quote(str(rid)))
    with urllib.request.urlopen(url, timeout=timeout) as r:
        body = json.loads(r.read().decode('utf-8'))
    return body.get('requests', [])


def stitch_records(rid, parts):
    """Merge per-attempt record dicts for one rid into a single
    end-to-end timeline. Events are ordered on the wall clock (each
    part's ``wall_start`` plus the event's ms offset); exact duplicates
    — the same record reached through two sources — collapse to one.
    Attempt segments are derived from the router's ``route`` /
    ``failover`` / ``hedge`` annotations, each with the replica it ran
    on and how it ended."""
    # dedup whole parts first (same record dict via recorder AND url)
    seen, uniq = set(), []
    for p in parts:
        if not p:
            continue
        pk = (p.get('id'), p.get('engine'), p.get('wall_start'),
              len(p.get('timeline', ())))
        if pk in seen:
            continue
        seen.add(pk)
        uniq.append(p)
    if not uniq:
        return {'id': rid, 'found': False, 'parts': 0,
                'attempts': [], 'timeline': []}
    t_origin = min(p.get('wall_start', 0.0) for p in uniq)
    merged, ev_seen = [], set()
    for p in uniq:
        w0 = p.get('wall_start', 0.0)
        src = p.get('engine', '')
        for ev in p.get('timeline', ()):
            wall = w0 + float(ev.get('t_ms', 0.0)) / 1e3
            attrs = {k: v for k, v in ev.items()
                     if k not in ('ev', 't_ms')}
            ek = (ev.get('ev'), round(wall * 1e6),
                  json.dumps(attrs, sort_keys=True, default=str))
            if ek in ev_seen:
                continue
            ev_seen.add(ek)
            entry = {'ev': ev.get('ev'),
                     't_ms': round((wall - t_origin) * 1e3, 3),
                     'source': src}
            entry.update(attrs)
            merged.append(entry)
    merged.sort(key=lambda e: (e['t_ms'], e['ev'] or ''))
    # primary part: the one whose outcome is terminal (first found wins)
    primary = next((p for p in uniq if p.get('outcome') is not None),
                   uniq[0])
    attempts, current = [], None
    for e in merged:
        rep = e.get('replica')
        if e['ev'] == 'route':
            if current is not None and current['outcome'] is None:
                current['outcome'] = 'superseded'
            current = {'replica': rep, 'start_ms': e['t_ms'],
                       'end_ms': None, 'outcome': None, 'error': None,
                       'events': 0}
            attempts.append(current)
        elif e['ev'] == 'failover':
            frm = e.get('frm')
            for a in reversed(attempts):
                if a['outcome'] is None and (frm is None
                                             or a['replica'] == frm):
                    a['outcome'] = 'failover'
                    a['error'] = e.get('error')
                    a['end_ms'] = e['t_ms']
                    break
        elif current is not None and rep in (None, current['replica']):
            current['events'] += 1
            current['end_ms'] = e['t_ms']
    final_outcome = primary.get('outcome')
    for a in attempts:
        if a['outcome'] is None:
            a['outcome'] = final_outcome or 'active'
    return {'id': rid, 'found': True, 'parts': len(uniq),
            'kind': primary.get('kind'), 'engine': primary.get('engine'),
            'outcome': final_outcome, 'error': primary.get('error'),
            'duration_ms': primary.get('duration_ms'),
            'replicas': sorted({a['replica'] for a in attempts
                                if a['replica']}),
            'attempts': attempts, 'timeline': merged}


def stitch(rid, recorders=None, urls=None):
    """Gather every record carrying ``rid`` — from the given flight
    recorders (default: this process's) and remote ``/debug/requests``
    bases — and stitch them into one timeline via
    :func:`stitch_records`. Unreachable peers are skipped (counted on
    ``fleet.obs.scrape_errors{replica=<url>}``), never fatal: a
    post-mortem tool must degrade, not crash."""
    parts = []
    for rec in (recorders if recorders is not None
                else [_reqtrace.recorder()]):
        parts.extend(rec.requests(rid=rid))
    for url in (urls or ()):
        try:
            parts.extend(_fetch_request_parts(url, rid))
        except Exception:
            counter('fleet.obs.scrape_errors', {'replica': str(url)},
                    help='failed scrapes/collections per replica').inc()
    return stitch_records(rid, parts)


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


# ---------------------------------------------------------------------------
# the wiring object
# ---------------------------------------------------------------------------

class FleetObs:
    """One pane of glass over routers, hosts, and remote peers.

    Aggregation state for a telemetry server: the federator behind the
    aggregated ``/metrics``, the router/host references behind
    ``/debug/fleet``, and the recorder/peer set behind stitched
    ``/debug/requests?id=``. Attach with ``serve(port=0)`` or pass to
    ``observability.serve_telemetry(fleetobs=...)``."""

    def __init__(self, name='fleet', federator=None):
        self.name = name
        self.federator = (federator if federator is not None
                          else MetricFederator(name=name))
        self._lock = threading.Lock()
        self._routers = []
        self._hosts = []
        self._peer_urls = {}      # name -> base url (requests + metrics)

    # ---- watching --------------------------------------------------------
    def watch_router(self, router):
        """Federate a :class:`FleetRouter`'s replicas and include them
        in the ``/debug/fleet`` replica table."""
        with self._lock:
            self._routers.append(router)
        self.federator.add_replica_set(router.set)
        return self

    def watch_replica_set(self, rset):
        self.federator.add_replica_set(rset)
        return self

    def watch_host(self, host):
        with self._lock:
            self._hosts.append(host)
        self.federator.add_host(host)
        return self

    def add_peer(self, name, base_url):
        """A remote replica process: its ``/metrics`` joins the
        federation and its ``/debug/requests`` joins the stitcher."""
        self.federator.add_url(name, base_url)
        with self._lock:
            self._peer_urls[name] = base_url.rstrip('/')
        return self

    # ---- views -----------------------------------------------------------
    def to_prometheus(self):
        return self.federator.to_prometheus()

    def stitch(self, rid):
        with self._lock:
            urls = list(self._peer_urls.values())
        return stitch(rid, urls=urls)

    def fleet_table(self):
        """The ``/debug/fleet`` document: a replica table (lifecycle
        state, warm, breaker, queue depth, queue-wait p99) and a host
        table (HBM watermark/used, resident/evicted models, lane sheds,
        tenant inflight)."""
        with self._lock:
            routers = list(self._routers)
            hosts = list(self._hosts)
        reg = registry()
        replicas = []
        for router in routers:
            for rep in router.set.snapshot():
                row = {'fleet': router.name, 'replica': rep.name,
                       'state': rep.state, 'kind': rep.kind}
                try:
                    p = rep.probe()
                except Exception as e:
                    p = {'error': type(e).__name__}
                row.update({k: p.get(k) for k in
                            ('warm', 'breaker', 'queue_depth',
                             'queue_capacity', 'ready')})
                try:
                    h = reg.find('serve.queue_wait_ms',
                                 {'engine': rep.label})
                except Exception:
                    h = None
                row['queue_wait_p99_ms'] = (h.percentile(99)
                                            if h is not None else None)
                replicas.append(row)
        host_rows = [h.debug_table() for h in hosts]
        return {'ts': time.time(),
                'replicas': replicas,
                'hosts': host_rows,
                'profile_in_flight': profile_in_flight()}

    def serve(self, port=0, host='127.0.0.1'):
        """Start a telemetry server with this plane attached (aggregated
        ``/metrics``, ``/debug/fleet``, stitched ``?id=``,
        ``/debug/profile``). Returns ``NULL_SERVER`` when observability
        is disabled."""
        from .server import serve_telemetry
        return serve_telemetry(port=port, host=host, fleetobs=self)
