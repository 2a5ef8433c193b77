"""ModelHost: multi-tenant, multi-model serving on one card (port of
``paddle_tpu/serving/host.py``).

The fleet layer (``fleet.py``) scales ONE model across replicas; this
module is the orthogonal axis — N heterogeneous models (batch
``InferenceEngine`` and continuous-batching ``GenerationEngine`` mixes)
sharing one card's memory and one front door, surviving overload from
tenants that do not coordinate with each other:

- **Memory-aware admission.** A model is admitted only if its measured
  footprint plus live usage fits under a configurable watermark. Both
  count bytes the caching allocator hands out: a footprint is the blocks
  of every tensor the engine holds (weights, buffers, KV pool, its
  graphs' static inputs) plus the segments of its captured graphs'
  private pools (on the CPU, its tensors' bytes); the default watermark
  is what the allocator could hand out when the host is built
  (``torch.cuda.mem_get_info``'s free bytes plus its own reserved but
  unallocated ones). Read from the engine itself, a footprint holds
  while other engines serve beside the one being built. When a model
  does not fit, the host **LRU-evicts cold models** — drain the engine
  and drop it with its graphs and pool — or refuses with a typed
  :class:`HBMAdmissionError`.
  Weights the factory's closure holds stay where they are. Swap-in
  rebuilds from the factory and captures the engine's graphs again
  before the submit goes on (a graph holds its own engine's addresses,
  so the reference's executables, which outlive their engine, have no
  counterpart here): a GenerationEngine its prefill and step, an
  InferenceEngine the buckets its last engine had captured (the
  model's manifest). The swapped-in engine's first request adds no
  capture and no kernel build.
- **Priority lanes.** Every request is ``interactive`` or ``batch``.
  Batch may occupy at most ``batch_share`` of an engine's queue, and an
  SLO rule per hosted model on interactive ``serve.queue_wait_ms`` p99
  (the same series the fleet autoscaler keys on) flips the model into
  batch-shed mode while firing: new batch work is refused with a
  ``QueueFullError`` carrying ``retry_after_ms`` from the observed
  queue-wait distribution, so interactive latency degrades last.
- **Per-tenant accounting.** ``set_quota(tenant, n)`` caps a tenant's
  concurrent in-flight requests; every request's tenant/lane ride its
  ``RequestRecord`` attrs into the flight recorder
  (``/debug/requests?tenant=``) and the ``request.*`` / ``host.*``
  counters in ``/metrics``.

Each hosted model also gets its own :class:`~..fault.CircuitBreaker`
(device failures on one model must not take the host's other models
with it) and the host exposes two chaos points: ``host.admit`` (an
armed fault aborts admission before any side effect) and ``host.evict``
(an armed fault aborts an eviction, leaving the victim live).

The fleet router targets hosted models as ``model@host``
(``FleetRouter.submit(..., target='chat@host0')``) through the
process-local registry (``get_host`` / ``resolve_target``).

``deploy(mp=N)`` admits a mesh-sharded model (``parallel/
mesh_engine.py``): the factory is called as ``factory(mp=N)`` on every
(re)build, and admission holds the bytes of the device that holds the
most against the watermark, a per-device budget. On a virtual mesh (the
shards on one card) that is every shard's bytes: the reference divides a
mesh's whole footprint by the mesh size, which on one card would admit
N times what the card holds.
"""
import itertools
import threading
import time

import torch

from .. import fault
from .. import observability as _obs
from ..fault.errors import CircuitOpenError, InjectedFault
from ..models import decode_cache as _decode_cache
from ..observability import slo as _slo
from .errors import (DeadlineExceededError, EngineClosedError,
                     HBMAdmissionError, QueueFullError)
from .generation import GenerationEngine

LANES = ('interactive', 'batch')

_LIVE = 'live'
_EVICTED = 'evicted'
_ADMITTING = 'admitting'
_EVICTING = 'evicting'

_hosts_lock = threading.Lock()
_HOSTS = {}              # host name -> ModelHost


def get_host(name):
    """Look up a live :class:`ModelHost` by name (None when unknown)."""
    with _hosts_lock:
        return _HOSTS.get(name)


def resolve_target(target):
    """Parse a ``model@host`` target into ``(host, model_name)``.

    The fleet router's cross-host addressing: raises ``ValueError`` on a
    malformed target and ``KeyError`` when the host is not registered in
    this process."""
    if not isinstance(target, str) or target.count('@') != 1:
        raise ValueError(f"target must look like 'model@host', got "
                         f'{target!r}')
    model, host_name = target.split('@')
    if not model or not host_name:
        raise ValueError(f"target must look like 'model@host', got "
                         f'{target!r}')
    host = get_host(host_name)
    if host is None:
        raise KeyError(f'no ModelHost named {host_name!r} in this process')
    return host, model


def _storages(*trees):
    """The distinct tensor storages in nested dicts, lists and tuples:
    (device, address) -> bytes (other leaves are skipped)."""
    seen = {}

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[(x.device, st.data_ptr())] = st.nbytes()

    for t in trees:
        walk(t)
    return seen


def _captured_fns(engine):
    """The engine's captured functions: a GenerationEngine's prefill and
    step, an InferenceEngine's buckets."""
    cache = getattr(engine, '_cache', None)
    if cache is None:
        return list(getattr(engine, '_fns', {}).values())
    with cache._lock:
        return list(cache._fns.values())


def _bucket_manifest(engine):
    """The manifest of the buckets an InferenceEngine has captured, or
    None when it has captured none."""
    from ..warmup.manifest import Manifest, serving_bucket_entry
    cache = engine._cache
    with cache._lock:
        keys = list(cache._fns)
    man = Manifest()
    for bucket, sig, precision in keys:
        man.add(serving_bucket_entry(bucket, sig, precision,
                                     max_batch=engine.max_batch_size))
    return man if len(man) else None


def _warm(engine, manifest=None, input_spec=None):
    """Capture an engine's graphs before its first request: a
    GenerationEngine its prefill and step; an InferenceEngine the buckets
    of ``manifest``, else, with an example spec, its bucket ladder."""
    from .. import warmup as _warmup_mod
    if isinstance(engine, GenerationEngine):
        engine.warmup()
    elif manifest is not None:
        _warmup_mod.prebuild(manifest, engine=engine, strict=True)
        engine._warmed = True
    elif (input_spec or engine._example_spec) is not None:
        engine.warmup('all_buckets', input_spec=input_spec)


class HostedModel:
    """One model's host-side record: lifecycle state, HBM accounting,
    lane/inflight counters, per-model breaker, and an InferenceEngine's
    captured buckets (its manifest) across evictions."""

    __slots__ = ('name', 'factory', 'kind', 'engine', 'manifest',
                 'footprint_bytes', 'reserved_bytes', 'last_used', 'state',
                 'pinned', 'breaker', 'inflight', 'batch_inflight',
                 'shed_batch', 'rule_name', 'swap_ins', 'evictions',
                 'input_spec', 'prefix_cache_pages')

    def __init__(self, name, factory, *, pinned=False, input_spec=None,
                 footprint_bytes=0, breaker=None, prefix_cache_pages=None):
        self.name = name
        self.factory = factory
        self.kind = None             # 'infer' | 'gen', set at materialize
        self.engine = None
        self.manifest = None         # the buckets captured at eviction
        self.footprint_bytes = int(footprint_bytes)
        self.reserved_bytes = 0      # bytes currently counted against host
        self.last_used = None
        self.state = _ADMITTING
        self.pinned = bool(pinned)
        self.breaker = breaker if breaker is not None else \
            fault.CircuitBreaker(failure_threshold=5, recovery_timeout=5.0)
        self.inflight = 0
        self.batch_inflight = 0
        self.shed_batch = False
        self.rule_name = None
        self.swap_ins = 0
        self.evictions = 0
        self.input_spec = input_spec
        # residency bound for a generation engine's prefix cache, re-applied
        # on every swap-in (the host's lever to keep cached KV pages from
        # crowding the HBM watermark)
        self.prefix_cache_pages = prefix_cache_pages

    @property
    def warm_retained(self):
        """A swap-in captures the model's graphs again before its first
        request: a GenerationEngine's by its warm-up, an InferenceEngine's
        from its manifest."""
        return self.kind == 'gen' or self.manifest is not None

    @property
    def engine_label(self):
        eng = self.engine
        if eng is None:
            return ''
        if self.kind == 'gen':
            return eng.labels['engine']
        return eng._stats.labels['engine']

    def describe(self):
        pc = (getattr(self.engine, 'prefix_cache', None)
              if self.engine is not None else None)
        return {'state': self.state, 'kind': self.kind,
                'footprint_bytes': self.footprint_bytes,
                'prefix_cache_pages': self.prefix_cache_pages,
                'prefix_cached_pages': (pc.cached_pages
                                        if pc is not None else 0),
                'inflight': self.inflight,
                'batch_inflight': self.batch_inflight,
                'shed_batch': self.shed_batch,
                'pinned': self.pinned,
                'breaker': self.breaker.state,
                'engine': self.engine_label,
                'swap_ins': self.swap_ins,
                'evictions': self.evictions,
                'has_manifest': self.manifest is not None,
                'warm_retained': self.warm_retained}


class ModelHost:
    """N engines, one HBM budget, two priority lanes, per-tenant quotas.

    ``deploy(name, factory)`` admits a model (the factory builds its
    engine — called again on swap-in after an eviction);
    ``submit(model, *args, tenant=, lane=)`` routes one request. An
    evicted model is swapped back in transparently on its next submit.
    """

    _seq = itertools.count()

    def __init__(self, hbm_watermark_bytes=None, *, name=None,
                 interactive_p99_ms=100.0, slo_interval=0.25,
                 slo_debounce=2, batch_share=0.5, clock=None):
        if hbm_watermark_bytes is None:
            # default: what the allocator could hand out now, the driver's
            # free bytes and its own cached ones (the footprints' unit)
            if not torch.cuda.is_available():
                raise ValueError('hbm_watermark_bytes is required without '
                                 'a CUDA card')
            st = torch.cuda.memory_stats()
            hbm_watermark_bytes = (torch.cuda.mem_get_info()[0]
                                   + st.get('reserved_bytes.all.current', 0)
                                   - st.get('allocated_bytes.all.current',
                                            0))
        wm = int(hbm_watermark_bytes)
        if wm <= 0:
            raise ValueError('hbm_watermark_bytes must be > 0')
        self.name = name or f'host{next(ModelHost._seq)}'
        self.watermark_bytes = wm
        self.interactive_p99_ms = float(interactive_p99_ms)
        self.slo_debounce = int(slo_debounce)
        self.batch_share = float(batch_share)
        if not 0.0 < self.batch_share <= 1.0:
            raise ValueError('batch_share must be in (0, 1]')
        self._clock = clock or time.monotonic
        self._labels = {'host': self.name}
        self._lock = threading.Lock()
        self._models = {}            # name -> HostedModel (insertion order)
        self._used_bytes = 0
        self._quotas = {}            # tenant -> max concurrent in-flight
        self._tenant_inflight = {}   # tenant -> current in-flight
        self._closed = False
        self._n = {k: 0 for k in ('admitted', 'rejected', 'evictions',
                                  'swap_ins', 'shed')}
        # the host owns its SLO watcher: one interactive queue-wait p99
        # rule per hosted model drives batch-lane shedding
        self._watcher = _slo.Watcher(interval=slo_interval)
        self._watcher.start()
        self._probe_name = f'host.{self.name}'
        _obs.add_readiness(self._probe_name, self._readiness_probe)
        _obs.gauge('host.hbm_watermark_bytes', self._labels).set(wm)
        with _hosts_lock:
            _HOSTS[self.name] = self

    # ---- HBM accounting --------------------------------------------------
    def _publish_hbm_locked(self):
        _obs.gauge('host.hbm_used_bytes', self._labels).set(self._used_bytes)
        _obs.gauge('host.models_live', self._labels).set(
            sum(1 for m in self._models.values() if m.state == _LIVE))

    def _lru_cold_locked(self, exclude):
        """Least-recently-used live model with nothing in flight (the only
        safe eviction victims); None when every live model is hot/pinned."""
        cold = [m for m in self._models.values()
                if (m.state == _LIVE and not m.pinned and m.inflight == 0
                    and m.name != exclude)]
        if not cold:
            return None
        return min(cold, key=lambda m: m.last_used or 0.0)

    def _reserve(self, m, need):
        """Account ``need`` more bytes to ``m``, LRU-evicting cold models
        until it fits under the watermark; raises HBMAdmissionError when
        nothing evictable remains."""
        need = int(need)
        if need <= 0:
            return
        while True:
            with self._lock:
                free = self.watermark_bytes - self._used_bytes
                if need <= free:
                    self._used_bytes += need
                    m.reserved_bytes += need
                    self._publish_hbm_locked()
                    return
                # feasibility first: refuse before evicting anyone if the
                # request cannot fit even with every cold model gone — an
                # infeasible deploy must not strip the host bare
                evictable = sum(
                    x.reserved_bytes for x in self._models.values()
                    if (x.state == _LIVE and not x.pinned
                        and x.inflight == 0 and x.name != m.name))
                victim = (self._lru_cold_locked(exclude=m.name)
                          if need <= free + evictable else None)
                if victim is None:
                    self._n['rejected'] += 1
                    err = HBMAdmissionError(m.name, need, free,
                                            self.watermark_bytes)
                else:
                    victim.state = _EVICTING
                    err = None
            if err is not None:
                _obs.counter('host.admission_rejects', self._labels).inc()
                raise err
            self._evict_now(victim)

    def _release(self, m):
        with self._lock:
            self._used_bytes -= m.reserved_bytes
            m.reserved_bytes = 0
            self._publish_hbm_locked()

    # ---- footprint measurement -------------------------------------------
    def _measure_footprint(self, engine):
        """The model's device-memory footprint in bytes, read from the
        engine: the distinct storages of its weights, buffers, KV pool and
        graphs' static inputs, and its graphs' private pools. On the card
        these are counted as the caching allocator hands them out (see the
        module docstring); elsewhere as the storages' bytes. A mesh
        engine's footprint is that of the device holding the most (its
        graphs' pools count on the engine's device): a per-device budget,
        as the watermark is."""
        fns = _captured_fns(engine)
        held = _storages(getattr(engine, '_params', None),
                         getattr(engine, '_buffers', None),
                         getattr(engine, '_pool', None),
                         [f.buffers for f in fns])
        home = torch.device(getattr(engine, 'device', 'cpu'))
        by_dev = {}
        for (dev, ptr), n in held.items():
            by_dev.setdefault(dev, {})[ptr] = n
        if home.type != 'cuda':
            return max((sum(v.values()) for v in by_dev.values()),
                       default=0)
        return max((_decode_cache.held_bytes(
            list(v), fns if dev == home else [], dev)
            for dev, v in by_dev.items() if dev.type == 'cuda'), default=0)

    # ---- admission / deploy ----------------------------------------------
    def deploy(self, name, factory, *, footprint_bytes=None, input_spec=None,
               pin=False, warm=True, breaker=None, prefix_cache_pages=None,
               mp=None):
        """Admit one model onto the host.

        ``factory`` is a zero-arg callable building the model's engine —
        it is called again on swap-in after an eviction, so it must be
        repeatable. ``footprint_bytes`` pre-gates admission before the
        engine is even built (otherwise the first deploy builds, measures,
        and then enforces the watermark); ``pin=True`` exempts the model
        from LRU eviction; ``prefix_cache_pages`` caps a generation
        engine's prefix-cache residency (applied after every build, so the
        bound survives evict/swap-in cycles). Raises
        :class:`HBMAdmissionError` when the model cannot fit even after
        evicting every cold model.

        ``mp=N`` deploys a mesh-sharded replica: the factory is called as
        ``factory(mp=N)`` on every (re)build, so a swap-in after an
        eviction rebuilds the same mesh shape; admission then holds the
        footprint of the device that holds the most against the per-device
        watermark (``_measure_footprint``)."""
        if mp is not None:
            base_factory, mp = factory, int(mp)
            factory = lambda: base_factory(mp=mp)       # noqa: E731
        try:
            fault.inject('host.admit')
        except InjectedFault:
            _obs.counter('host.admit_faults', self._labels).inc()
            raise
        with self._lock:
            if self._closed:
                raise EngineClosedError(f'host {self.name} is closed')
            if name in self._models:
                raise ValueError(f'model {name!r} already deployed on host '
                                 f'{self.name}')
            m = HostedModel(name, factory, pinned=pin, input_spec=input_spec,
                            footprint_bytes=footprint_bytes or 0,
                            breaker=breaker,
                            prefix_cache_pages=prefix_cache_pages)
            self._models[name] = m
        try:
            if m.footprint_bytes:
                self._reserve(m, m.footprint_bytes)
            self._materialize(m, warm=warm)
        except BaseException:
            self._release(m)
            with self._lock:
                self._models.pop(name, None)
            raise
        with self._lock:
            m.state = _LIVE
            m.last_used = self._clock()
            self._n['admitted'] += 1
            self._publish_hbm_locked()
        self._register_slo(m)
        _obs.counter('host.admitted', self._labels).inc()
        _obs.record_event('host.admit', host=self.name, model=name,
                          footprint_bytes=m.footprint_bytes)
        return m

    def _materialize(self, m, warm=True):
        """Build the engine from the factory, warm it (always on a swap-in),
        and settle the memory reservation against the measured
        footprint."""
        engine = m.factory()
        try:
            m.kind = 'gen' if isinstance(engine, GenerationEngine) \
                else 'infer'
            if m.kind == 'gen' and m.prefix_cache_pages is not None:
                engine.set_prefix_capacity(m.prefix_cache_pages)
            if warm or m.manifest is not None:
                # before the first request: it adds no capture
                _warm(engine, m.manifest, m.input_spec)
            measured = self._measure_footprint(engine)
            if measured > m.footprint_bytes:
                m.footprint_bytes = measured
            extra = m.footprint_bytes - m.reserved_bytes
            if extra > 0:
                self._reserve(m, extra)
        except BaseException:
            engine.shutdown(drain=False)
            raise
        m.engine = engine

    # ---- eviction / swap-in ----------------------------------------------
    def evict(self, name):
        """Evict one cold model now (operator API; admission evicts LRU
        automatically). The engine drains and is dropped — weights and KV
        pool free — while an InferenceEngine's captured buckets are kept
        in its manifest for the swap-in. Refuses (RuntimeError) while
        requests are in flight."""
        with self._lock:
            m = self._models.get(name)
            if m is None:
                raise KeyError(f'unknown model {name!r} on host {self.name}')
            if m.state != _LIVE:
                return False
            if m.inflight > 0:
                raise RuntimeError(
                    f'model {name!r} has {m.inflight} requests in flight; '
                    f'only cold models can be evicted')
            m.state = _EVICTING
        self._evict_now(m)
        return True

    def _evict_now(self, m):
        """Tear down one model marked _EVICTING (never called under the
        host lock: drains the engine, which blocks)."""
        try:
            fault.inject('host.evict')
        except InjectedFault:
            _obs.counter('host.evict_faults', self._labels).inc()
            with self._lock:
                m.state = _LIVE
            raise
        t0 = time.perf_counter()
        self._remove_slo(m)
        engine = m.engine
        dev = None
        if engine is not None:
            if m.kind == 'infer':
                m.manifest = _bucket_manifest(engine) or m.manifest
            engine.shutdown(drain=True)
            dev = torch.device(getattr(engine, 'device', 'cpu'))
        with self._lock:
            m.engine = None
            m.state = _EVICTED
            m.evictions += 1
            self._n['evictions'] += 1
            self._used_bytes -= m.reserved_bytes
            m.reserved_bytes = 0
            self._publish_hbm_locked()
        engine = None
        if dev is not None and dev.type == 'cuda':
            # the engine, its graphs and its pool sit in reference
            # cycles: free them now, so the admission that evicted it
            # finds the memory
            _decode_cache.release(dev)
        evict_ms = (time.perf_counter() - t0) * 1e3
        _obs.counter('host.evictions',
                     {**self._labels, 'model': m.name}).inc()
        _obs.histogram('host.evict_ms', self._labels).observe(evict_ms)
        _obs.record_event('host.evict', host=self.name, model=m.name,
                          evict_ms=round(evict_ms, 3))

    def admit(self, name):
        """Swap an evicted model back in (also happens transparently on
        its next ``submit``). Returns the HostedModel."""
        with self._lock:
            m = self._models.get(name)
        if m is None:
            raise KeyError(f'unknown model {name!r} on host {self.name}')
        self._swap_in(m)
        return m

    def _swap_in(self, m):
        """Re-admit an evicted model: reserve its known footprint (may LRU-
        evict others), rebuild the engine and warm it. Concurrent
        submitters wait on the state flag rather than a lock (no lock may
        be held across the blocking rebuild)."""
        with self._lock:
            if m.state == _LIVE:
                return
            waiter = m.state in (_ADMITTING, _EVICTING)
            if not waiter:
                m.state = _ADMITTING
        if waiter:
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline:
                with self._lock:
                    state = m.state
                if state == _LIVE:
                    return
                if state == _EVICTED:      # the other admitter failed
                    raise EngineClosedError(
                        f'model {m.name!r} failed to swap in')
                time.sleep(0.005)
            raise TimeoutError(f'swap-in of model {m.name!r} stalled')
        try:
            fault.inject('host.admit')
        except InjectedFault:
            _obs.counter('host.admit_faults', self._labels).inc()
            with self._lock:
                m.state = _EVICTED
            raise
        t0 = time.perf_counter()
        try:
            if m.footprint_bytes:
                self._reserve(m, m.footprint_bytes)
            self._materialize(m, warm=True)
        except BaseException:
            self._release(m)
            with self._lock:
                m.state = _EVICTED
            raise
        with self._lock:
            m.state = _LIVE
            m.last_used = self._clock()
            m.swap_ins += 1
            self._n['swap_ins'] += 1
            self._publish_hbm_locked()
        self._register_slo(m)
        swap_ms = (time.perf_counter() - t0) * 1e3
        _obs.counter('host.swap_ins',
                     {**self._labels, 'model': m.name}).inc()
        _obs.histogram('host.swap_in_ms', self._labels).observe(swap_ms)
        _obs.record_event('host.swap_in', host=self.name, model=m.name,
                          swap_in_ms=round(swap_ms, 3),
                          traces=int(getattr(m.engine, '_trace_count', 0)))

    # ---- SLO lane control ------------------------------------------------
    def _register_slo(self, m):
        label = m.engine_label
        if not label:
            return
        m.rule_name = f'host.{self.name}.{m.name}.qwait'
        self._watcher.remove_rule(m.rule_name)

        def _fire(rule, value, m=m):
            with self._lock:
                m.shed_batch = True
            _obs.counter('host.slo_preempt',
                         {**self._labels, 'model': m.name}).inc()
            _obs.gauge('host.batch_shedding',
                       {**self._labels, 'model': m.name}).set(1)

        def _resolve(rule, value, m=m):
            with self._lock:
                m.shed_batch = False
            _obs.gauge('host.batch_shedding',
                       {**self._labels, 'model': m.name}).set(0)

        self._watcher.rule(m.rule_name, 'serve.queue_wait_ms',
                           self.interactive_p99_ms,
                           labels={'engine': label}, stat='p99', cmp='>',
                           debounce=self.slo_debounce,
                           on_fire=_fire, on_resolve=_resolve)

    def _remove_slo(self, m):
        if m.rule_name is not None:
            self._watcher.remove_rule(m.rule_name)
            m.rule_name = None
        if m.shed_batch:
            with self._lock:
                m.shed_batch = False
            _obs.gauge('host.batch_shedding',
                       {**self._labels, 'model': m.name}).set(0)

    def _retry_hint_ms(self, m):
        """Backoff hint from the model's observed queue-wait p99 (same
        convention as the fleet router's shed path)."""
        if _obs.enabled():
            metric = _obs.registry().find('serve.queue_wait_ms',
                                          {'engine': m.engine_label})
            if metric is not None:
                v = metric.percentile(99)
                if v:
                    return round(v, 3)
        return 50.0

    # ---- tenants ---------------------------------------------------------
    def set_quota(self, tenant, max_inflight):
        """Cap ``tenant``'s concurrent in-flight requests across every
        model on this host (None removes the cap)."""
        with self._lock:
            if max_inflight is None:
                self._quotas.pop(tenant, None)
            else:
                self._quotas[tenant] = max(0, int(max_inflight))

    def tenants(self):
        with self._lock:
            return {t: {'inflight': n, 'quota': self._quotas.get(t)}
                    for t, n in sorted(self._tenant_inflight.items())}

    # ---- front door ------------------------------------------------------
    def submit(self, model, *args, tenant='default', lane='interactive',
               deadline_ms=None, max_new_tokens=32, seed=0):
        """Route one request to a hosted model.

        ``lane='batch'`` work is capped to ``batch_share`` of the engine
        queue and shed outright (``QueueFullError.retry_after_ms``) while
        the model's interactive queue-wait SLO is firing; interactive
        work is only ever limited by the engine's own admission control
        and the tenant's quota. Submitting to an evicted model swaps it
        back in first. Generation models take ``(prompt,)`` plus
        ``max_new_tokens``/``seed``; inference models take ``*inputs``."""
        if lane not in LANES:
            raise ValueError(f'lane must be one of {LANES}, got {lane!r}')
        tenant = str(tenant)
        shed_reason = None
        with self._lock:
            if self._closed:
                raise EngineClosedError(f'host {self.name} is closed')
            m = self._models.get(model)
            if m is None:
                raise KeyError(f'unknown model {model!r} on host '
                               f'{self.name}; deployed: '
                               f'{sorted(self._models)}')
            m.last_used = self._clock()
            quota = self._quotas.get(tenant)
            cur = self._tenant_inflight.get(tenant, 0)
            cap = max(1, int(self._batch_cap(m)))
            if quota is not None and cur >= quota:
                shed_reason, shed_cap, shed_depth = 'tenant_quota', quota, cur
            elif lane == 'batch' and m.shed_batch:
                shed_reason, shed_cap, shed_depth = 'slo', cap, \
                    m.batch_inflight
            elif lane == 'batch' and m.batch_inflight >= cap:
                shed_reason, shed_cap, shed_depth = 'batch_cap', cap, \
                    m.batch_inflight
            else:
                # tentatively account the request; rolled back on any
                # submit failure below
                m.inflight += 1
                if lane == 'batch':
                    m.batch_inflight += 1
                self._tenant_inflight[tenant] = cur + 1
        if shed_reason is not None:
            self._count_shed(m, tenant, lane, shed_reason)
            raise QueueFullError(shed_cap, shed_depth,
                                 retry_after_ms=self._retry_hint_ms(m))
        try:
            if m.state != _LIVE:
                self._swap_in(m)
            if not m.breaker.allow():
                self._count_shed(m, tenant, lane, 'breaker')
                raise CircuitOpenError(m.breaker.recovery_timeout)
            engine = m.engine
            rec = _obs.start_request(
                'gen' if m.kind == 'gen' else 'serve',
                engine=m.engine_label, host=self.name, model=m.name,
                tenant=tenant, lane=lane)
            try:
                if m.kind == 'gen':
                    fut = engine.submit(args[0] if args else (),
                                        max_new_tokens=max_new_tokens,
                                        seed=seed, deadline_ms=deadline_ms,
                                        tenant=tenant, _record=rec)
                else:
                    fut = engine.submit(*args, deadline_ms=deadline_ms,
                                        _record=rec)
            except QueueFullError as e:
                # the engine finished rec ('rejected') and is alive enough
                # to apply backpressure — resolve any half-open probe as a
                # success, then re-raise with a useful backoff hint
                m.breaker.record_success()
                self._count_shed(m, tenant, lane, 'queue_full')
                if e.retry_after_ms is None:
                    raise QueueFullError(
                        e.capacity, e.depth,
                        retry_after_ms=self._retry_hint_ms(m)) from None
                raise
            except DeadlineExceededError:
                m.breaker.record_success()
                raise
            except BaseException as e:
                m.breaker.record_failure()
                rec.finish('error', e)
                raise
        except BaseException:
            self._request_done(m, tenant, lane, None, settle_breaker=False)
            raise
        self._watch_completion(m, tenant, lane, fut)
        _obs.counter('host.requests',
                     {**self._labels, 'model': m.name, 'tenant': tenant,
                      'lane': lane}).inc()
        return fut

    def _batch_cap(self, m):
        eng = m.engine
        capacity = getattr(eng, 'queue_capacity', 0) if eng is not None \
            else 16
        return capacity * self.batch_share

    def _count_shed(self, m, tenant, lane, reason):
        with self._lock:
            self._n['shed'] += 1
        _obs.counter('host.shed',
                     {**self._labels, 'model': m.name, 'tenant': tenant,
                      'lane': lane, 'reason': reason}).inc()

    def _watch_completion(self, m, tenant, lane, fut):
        """Decrement in-flight accounting and settle the model's breaker
        when the request finishes (engine threads call back here — only
        the host lock, a leaf, is taken)."""
        if m.kind == 'gen':
            def _on_event(kind, *event_args, _done=[False]):
                if kind != 'finish' or _done[0]:
                    return
                _done[0] = True
                self._request_done(m, tenant, lane,
                                   event_args[0] if event_args else None)
            fut._subscribe(_on_event)
        else:
            def _on_done(f):
                exc = None if f.cancelled() else f.exception()
                self._request_done(m, tenant, lane, exc)
            fut.add_done_callback(_on_done)

    def _request_done(self, m, tenant, lane, exc, settle_breaker=True):
        with self._lock:
            m.inflight = max(0, m.inflight - 1)
            if lane == 'batch':
                m.batch_inflight = max(0, m.batch_inflight - 1)
            cur = max(0, self._tenant_inflight.get(tenant, 1) - 1)
            if cur:
                self._tenant_inflight[tenant] = cur
            else:
                self._tenant_inflight.pop(tenant, None)
        _obs.gauge('host.tenant_inflight',
                   {**self._labels, 'tenant': tenant}).set(cur)
        if not settle_breaker:
            return
        # backpressure/deadline outcomes say nothing about model health
        if exc is None or isinstance(exc, (QueueFullError,
                                           DeadlineExceededError)):
            m.breaker.record_success()
        else:
            m.breaker.record_failure()

    # ---- introspection ---------------------------------------------------
    def _readiness_probe(self):
        with self._lock:
            live = sum(1 for m in self._models.values()
                       if m.state == _LIVE)
            closed = self._closed
            used = self._used_bytes
            states = {name: m.state for name, m in self._models.items()}
        return {'ready': live > 0 and not closed,
                'models_live': live, 'models': states,
                'hbm_used_bytes': used,
                'hbm_watermark_bytes': self.watermark_bytes,
                'closed': closed}

    def models(self):
        with self._lock:
            return {name: m.describe() for name, m in self._models.items()}

    def stats(self):
        with self._lock:
            out = dict(self._n)
            out['host'] = self.name
            out['hbm_used_bytes'] = self._used_bytes
            out['hbm_watermark_bytes'] = self.watermark_bytes
            out['models'] = {name: m.describe()
                             for name, m in self._models.items()}
            out['tenants'] = {t: {'inflight': n,
                                  'quota': self._quotas.get(t)}
                              for t, n in self._tenant_inflight.items()}
        return out

    def debug_table(self):
        """One ``/debug/fleet`` host row: HBM headroom, per-model
        residency (live/evicted, footprint, warmth retained), lane-shed
        and lifecycle counters, and per-tenant inflight vs quota — the
        operator's one-look answer to "why is this host shedding"."""
        with self._lock:
            models = {}
            for name, m in self._models.items():
                models[name] = {
                    'state': m.state, 'kind': m.kind,
                    'footprint_bytes': m.footprint_bytes,
                    'inflight': m.inflight,
                    'batch_inflight': m.batch_inflight,
                    'shed_batch': m.shed_batch,
                    'breaker': m.breaker.state,
                    'pinned': m.pinned,
                    'swap_ins': m.swap_ins,
                    'evictions': m.evictions,
                    'warm_retained': m.warm_retained}
            resident = sorted(n for n, m in self._models.items()
                              if m.state == _LIVE)
            evicted = sorted(n for n, m in self._models.items()
                             if m.state == _EVICTED)
            return {'host': self.name,
                    'hbm_watermark_bytes': self.watermark_bytes,
                    'hbm_used_bytes': self._used_bytes,
                    'hbm_free_bytes': self.watermark_bytes
                    - self._used_bytes,
                    'resident': resident, 'evicted': evicted,
                    'models': models,
                    'lane_sheds': self._n['shed'],
                    'admitted': self._n['admitted'],
                    'rejected': self._n['rejected'],
                    'evictions': self._n['evictions'],
                    'swap_ins': self._n['swap_ins'],
                    'tenants': {t: {'inflight': n,
                                    'quota': self._quotas.get(t)}
                                for t, n in
                                sorted(self._tenant_inflight.items())},
                    'closed': self._closed}

    # ---- lifecycle -------------------------------------------------------
    def undeploy(self, name, drain=True):
        """Remove a model entirely (its manifest is discarded)."""
        with self._lock:
            m = self._models.pop(name, None)
        if m is None:
            return False
        self._remove_slo(m)
        engine = m.engine
        if engine is not None:
            engine.shutdown(drain=drain)
        self._release(m)
        with self._lock:
            m.engine = None
            m.state = _EVICTED
            self._publish_hbm_locked()
        return True

    def close(self, drain=True):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            models = list(self._models.values())
        for m in models:
            self._remove_slo(m)
            engine = m.engine
            if engine is not None:
                engine.shutdown(drain=drain)
            with self._lock:
                m.engine = None
        self._watcher.stop()
        _obs.remove_readiness(self._probe_name)
        with _hosts_lock:
            if _HOSTS.get(self.name) is self:
                del _HOSTS[self.name]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
