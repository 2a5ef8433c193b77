"""Fleet front door: health-gated replica routing, failover, autoscaling
(port of ``paddle_tpu/serving/fleet.py``).

One engine is one failure domain: its circuit breaker opening, its queue
filling, or its process dying takes every queued request with it. This
module composes N single-replica engines (``InferenceEngine`` or
``GenerationEngine``) into one servable unit with an availability story:

- :class:`ReplicaSet` owns the replicas. It deregisters each engine's
  individual ``/readyz`` probe (one dead replica must not 503 the whole
  process) and registers a single aggregate probe — ready iff at least
  one replica is ready. ``spawn()`` builds a new replica from the
  factory and **warms it before it joins the routing set**, so scale-up
  serves its first request without a capture — provable via the new
  engine's capture counter (``stats()['traces']``). The reference clones
  the template's compiled executables, which take the weights as
  arguments; a captured CUDA graph holds the addresses of its own
  engine's input buffers, KV pool and weights, so a graph replayed by
  another engine would read and write the first engine's memory. Here a
  new replica captures its own graphs (a GenerationEngine its prefill
  and step, an InferenceEngine the buckets the template has captured);
  the kernel libraries are built once a process and are not built
  again.
- :class:`FleetRouter` is the front door. ``submit()`` routes to the
  least-loaded replica whose readiness probe passes and whose circuit
  breaker is closed. A replica failure mid-request fails over by
  resubmitting with the SAME :class:`~..observability.RequestRecord`,
  original enqueue timestamp, and original absolute deadline (the
  engines' ``_record``/``_enqueue_t``/``_deadline_t`` hooks), so no
  request is lost and SLO accounting stays truthful. Generation streams
  are deduplicated by token index against the engines' identical seeded
  regeneration (sampling keyed by (seed, position) only): a rerouted
  stream never emits a token twice.
  Load is shed (``QueueFullError`` with a ``retry_after_ms`` hint from
  the observed queue-wait p99) only when EVERY replica is saturated.
  ``drain()``/``decommission()`` stop routing to a replica, finish its
  in-flight work, and retire it — a rolling restart drops nothing.
- :class:`Autoscaler` evaluates per-replica SLO rules on
  ``serve.queue_wait_ms`` p99 (delta-window, debounced): sustained
  breach scales up from the factory; a replica idle past
  ``idle_s`` is gracefully drained back down between ``min``/``max``.

Replicas of one process share its card. Their scheduler threads replay
on the default stream, so their replays run one after another, which the
split-K merge tickets that every captured graph shares need. A spawn on
a worker thread warms up and captures on the device's side stream under
its capture lock (``models.decode_cache.capture_lock``), beside those
replays: its eager warm-up runs merge through the side stream's eager
tickets, never the graphs' (``ops.paged_attention._tickets``).

Failure handling is event-driven through ONE control thread: engines
report attempt outcomes by finishing a per-attempt record facade, which
posts to the router's event queue (a leaf lock — nothing is called
under it); the control thread serializes failover, parked-request
retry, hedged retries, the health sweep, and autoscaler ticks. No
router lock is ever held across an engine call.

Chaos inject points: ``fleet.route`` (routing decision; an armed fault
parks the request for retry instead of losing it) and
``fleet.failover`` (health sweep; an armed fault SIGKILL-simulates a
replica via ``shutdown(drain=False)``, exercising the full failover
path).

Env knobs: ``PADDLE_TPU_FLEET_REPLICAS`` (initial size),
``PADDLE_TPU_FLEET_MIN`` / ``PADDLE_TPU_FLEET_MAX`` (autoscale bounds),
``PADDLE_TPU_FLEET_QWAIT_P99_MS`` (scale-up threshold),
``PADDLE_TPU_FLEET_IDLE_S`` (scale-down idle window),
``PADDLE_TPU_FLEET_COOLDOWN_S`` (between scale ops).
"""
import itertools
import os
import threading
import time
from collections import deque
from concurrent.futures import Future

from .. import fault
from .. import observability as _obs
from ..fault.errors import InjectedFault
from ..observability import slo as _slo
from .errors import DeadlineExceededError, EngineClosedError, QueueFullError
from .generation import GenerationEngine, GenerationFuture
from .host import _bucket_manifest, _warm

ENV_REPLICAS = 'PADDLE_TPU_FLEET_REPLICAS'
ENV_MIN = 'PADDLE_TPU_FLEET_MIN'
ENV_MAX = 'PADDLE_TPU_FLEET_MAX'
ENV_QWAIT = 'PADDLE_TPU_FLEET_QWAIT_P99_MS'
ENV_IDLE = 'PADDLE_TPU_FLEET_IDLE_S'
ENV_COOLDOWN = 'PADDLE_TPU_FLEET_COOLDOWN_S'

_BREAKER_CODE = {'closed': 0, 'open': 1, 'half_open': 2}


def _env_num(name, default, cast):
    try:
        return cast(os.environ.get(name, default))
    except (TypeError, ValueError):
        return cast(default)


def _retryable(error):
    """Failover classification: deadline expiry and caller mistakes are
    terminal; infrastructure failures (closed engines, open breakers,
    injected faults, device errors) are worth another replica."""
    if error is None:
        return True
    if isinstance(error, (DeadlineExceededError, ValueError, TypeError,
                          AssertionError, KeyboardInterrupt)):
        return False
    return True


def _clone_warmth(src, dst):
    """Warm ``dst`` (built by the same factory as ``src``) before it serves:
    a GenerationEngine captures its prefill and step, an InferenceEngine
    the buckets ``src`` has captured (else, with an example spec, its
    bucket ladder), each over ``dst``'s own buffers, pool and weights
    (see the module docstring). ``dst``'s first request then adds no
    capture."""
    manifest = None
    if src is not None and not isinstance(dst, GenerationEngine):
        manifest = _bucket_manifest(src)
    _warm(dst, manifest)
    dst._warmed = True


class _AttemptRecord:
    """Per-attempt facade over the master :class:`RequestRecord`.

    The master record's ``finish`` is first-outcome-wins; a failed
    attempt finishing it would permanently seal the request's trace
    before failover even starts. The facade forwards notes (annotated
    with the replica) to the master, keeps its own split-parts counter,
    and intercepts ``finish`` to post an attempt-outcome event to the
    router; only the router finishes the master, on terminal outcomes.
    """

    __slots__ = ('master', 'replica', 'rid', 'attempt', 'outcome', 'error',
                 '_parts_left', '_alock', '_on_done')

    def __init__(self, master, replica_name, on_done):
        self.master = master
        self.replica = replica_name
        self.rid = master.rid
        self.attempt = None          # backref set by the router
        self.outcome = None
        self.error = None
        self._parts_left = 1
        self._alock = threading.Lock()
        self._on_done = on_done

    def note(self, ev, **attrs):
        self.master.note(ev, replica=self.replica, **attrs)
        return self

    def note_decode(self, pos):
        self.master.note_decode(pos)
        return self

    def expect_parts(self, n):
        with self._alock:
            self._parts_left = max(1, int(n))
        return self

    def part_retired(self):
        with self._alock:
            self._parts_left -= 1
            return self._parts_left <= 0

    def finish(self, outcome, error=None):
        with self._alock:
            if self.outcome is not None:
                return self
            self.outcome = str(outcome)
            self.error = error
        # outside _alock: posts to the router's leaf event queue (the
        # engine may be holding its scheduler lock right now)
        self._on_done(self)
        return self


class Replica:
    """One engine plus its fleet-visible state."""

    READY = 'ready'
    DRAINING = 'draining'
    DEAD = 'dead'
    STOPPED = 'stopped'

    __slots__ = ('name', 'engine', 'kind', 'state', 'idle_since')

    def __init__(self, name, engine, kind):
        self.name = name
        self.engine = engine
        self.kind = kind
        self.state = Replica.READY
        self.idle_since = None

    @property
    def label(self):
        """The engine's metrics label value (``e0``/``g3``) — the key the
        autoscaler's per-replica queue-wait rules select on."""
        if self.kind == 'gen':
            return self.engine.labels['engine']
        return self.engine._stats.labels['engine']

    def probe(self):
        return self.engine._readiness_probe()


class ReplicaSet:
    """Owns the replicas: lifecycle, readiness aggregation, warm spawn."""

    _seq = itertools.count()

    def __init__(self, factory=None, *, replicas=None, initial=None,
                 min_replicas=None, max_replicas=None, name=None):
        self.name = name or f'fleet{next(ReplicaSet._seq)}'
        self._factory = factory
        self._lock = threading.Lock()
        self._replicas = {}          # name -> Replica (insertion ordered)
        self._ridx = itertools.count()
        self.kind = None
        self.min_replicas = int(
            min_replicas if min_replicas is not None
            else _env_num(ENV_MIN, 1, int))
        mx = (max_replicas if max_replicas is not None
              else _env_num(ENV_MAX, 0, int))
        self.max_replicas = int(mx) if mx else None
        for eng in (replicas or ()):
            self.add(eng)
        if factory is not None and not self._replicas:
            n = int(initial if initial is not None
                    else _env_num(ENV_REPLICAS, max(1, self.min_replicas),
                                  int))
            for _ in range(max(1, n)):
                self.add(factory())
        self._probe_name = f'fleet.{self.name}'
        _obs.add_readiness(self._probe_name, self._aggregate_probe)

    # ---- membership ------------------------------------------------------
    def add(self, engine):
        kind = 'gen' if isinstance(engine, GenerationEngine) else 'infer'
        if self.kind is None:
            self.kind = kind
        elif kind != self.kind:
            raise ValueError(
                f'mixed fleet: set is {self.kind!r}, engine is {kind!r}')
        rep = Replica(f'{self.name}/r{next(self._ridx)}', engine, kind)
        # the readiness plane ANDs every registered probe; a replica must
        # contribute through the fleet aggregate, not gate the process
        _obs.remove_readiness(engine._probe_name)
        with self._lock:
            self._replicas[rep.name] = rep
        self._publish_size()
        _obs.record_event('fleet.replica_added', fleet=self.name,
                          replica=rep.name)
        return rep

    def spawn(self):
        """Build a replica from the factory and warm it (an InferenceEngine
        with a ready template's captured buckets) so it serves without a
        capture."""
        if self._factory is None:
            raise RuntimeError('ReplicaSet has no factory; cannot spawn')
        t0 = time.perf_counter()
        engine = self._factory()
        template = next((r for r in self.snapshot()
                         if r.state == Replica.READY), None)
        try:
            _clone_warmth(template.engine if template is not None
                          else None, engine)
        except BaseException:
            engine.shutdown(drain=False)
            raise
        rep = self.add(engine)
        dt_ms = 1e3 * (time.perf_counter() - t0)
        _obs.histogram('fleet.scale_up_ms', {'fleet': self.name}) \
            .observe(dt_ms)
        _obs.counter('fleet.scale_up', {'fleet': self.name}).inc()
        _obs.record_event('fleet.scale_up', fleet=self.name,
                          replica=rep.name, ms=round(dt_ms, 3))
        return rep

    def snapshot(self):
        with self._lock:
            return list(self._replicas.values())

    def get(self, name):
        with self._lock:
            return self._replicas.get(name)

    def counts(self):
        with self._lock:
            reps = list(self._replicas.values())
        alive = sum(1 for r in reps
                    if r.state in (Replica.READY, Replica.DRAINING))
        ready = sum(1 for r in reps if r.state == Replica.READY)
        return alive, ready

    # ---- lifecycle -------------------------------------------------------
    def drain(self, name, timeout=None):
        """Graceful: stop admitting (router filters on READY), finish all
        queued + in-flight work, then retire. Zero dropped requests."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None or rep.state in (Replica.DEAD, Replica.STOPPED):
                return rep
            rep.state = Replica.DRAINING
        self._publish_size()
        rep.engine.shutdown(drain=True, timeout=timeout)
        with self._lock:
            rep.state = Replica.STOPPED
        self._publish_size()
        _obs.record_event('fleet.replica_drained', fleet=self.name,
                          replica=name)
        return rep

    def kill(self, name):
        """Abrupt: fail everything queued/in-flight on the replica
        (EngineClosedError) — the SIGKILL simulation the failover path
        and the chaos drill are tested against."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None or rep.state in (Replica.DEAD, Replica.STOPPED):
                return rep
            rep.state = Replica.DEAD
        self._publish_size()
        rep.engine.shutdown(drain=False)
        _obs.record_event('fleet.replica_killed', fleet=self.name,
                          replica=name)
        return rep

    def mark_dead(self, name):
        with self._lock:
            rep = self._replicas.get(name)
            if rep is not None and rep.state == Replica.READY:
                rep.state = Replica.DEAD
        self._publish_size()
        return rep

    def decommission(self, name, timeout=None):
        rep = self.drain(name, timeout=timeout)
        with self._lock:
            self._replicas.pop(name, None)
        self._publish_size()
        _obs.record_event('fleet.replica_decommissioned', fleet=self.name,
                          replica=name)
        return rep

    def close(self, drain=True, timeout=None):
        for rep in self.snapshot():
            if rep.state in (Replica.READY, Replica.DRAINING):
                if drain:
                    self.drain(rep.name, timeout=timeout)
                else:
                    self.kill(rep.name)
        _obs.remove_readiness(self._probe_name)

    # ---- readiness -------------------------------------------------------
    def _aggregate_probe(self):
        """The fleet's single /readyz contribution: ready iff >=1 replica
        is ready (per-replica detail included for operators)."""
        detail, any_ready = {}, False
        for rep in self.snapshot():
            if rep.state != Replica.READY:
                detail[rep.name] = {'ready': False, 'state': rep.state}
                continue
            try:
                p = rep.probe()
            except Exception as e:
                p = {'ready': False, 'error': type(e).__name__}
            detail[rep.name] = p
            any_ready = any_ready or bool(p.get('ready'))
        return {'ready': any_ready, 'replicas': detail}

    def _publish_size(self):
        alive, ready = self.counts()
        _obs.gauge('fleet.replicas', {'fleet': self.name}).set(alive)
        _obs.gauge('fleet.replicas_ready', {'fleet': self.name}).set(ready)


class _Attempt:
    """One (request, replica) try."""

    __slots__ = ('freq', 'replica', 'record', 'inner', 'started',
                 'subscribed')

    def __init__(self, freq, replica, started):
        self.freq = freq
        self.replica = replica
        self.record = None
        self.inner = None
        self.started = started
        self.subscribed = False


class _FleetRequest:
    """Router-side state for one front-door request across attempts."""

    __slots__ = ('fid', 'kind', 'payload', 'max_new', 'seed', 'future',
                 'master', 'enqueue_t', 'deadline_t', 'attempts',
                 'failovers', 'bounces', 'hedged', 'done', 'parked',
                 '_mlock', '_next_idx', '_buffer')

    def __init__(self, fid, kind, payload, max_new, seed, future, master,
                 enqueue_t, deadline_t):
        self.fid = fid
        self.kind = kind
        self.payload = payload
        self.max_new = max_new
        self.seed = seed
        self.future = future
        self.master = master
        self.enqueue_t = enqueue_t
        self.deadline_t = deadline_t
        self.attempts = []
        self.failovers = 0
        self.bounces = 0
        self.hedged = False
        self.done = False
        self.parked = False
        # generation stream mirror: dedup-by-index against regenerated
        # tokens after failover (engines regenerate byte-identically from
        # seeded per-position keys; indices < _next_idx are re-plays)
        self._mlock = threading.Lock()
        self._next_idx = 0
        self._buffer = {}

    def mirror(self, ev, *args):
        """Inner-future listener: forward each token exactly once, in
        order, to the fleet-facing future. Completion is driven by the
        attempt record (router event), not by inner-future finish."""
        if ev != 'token':
            return
        idx, tok = args
        with self._mlock:
            if idx < self._next_idx or idx in self._buffer:
                return
            self._buffer[idx] = tok
            while self._next_idx in self._buffer:
                t = self._buffer.pop(self._next_idx)
                self._next_idx += 1
                self.future._append(t)


class Autoscaler:
    """SLO-driven sizing between ``min``/``max``: scales up when any
    replica's ``serve.queue_wait_ms`` p99 breaches the threshold for
    ``debounce`` consecutive evaluations, drains an idle replica down
    after ``idle_s``. Driven by the router's control thread via
    ``tick()`` — no thread of its own (spawn/drain run on short-lived
    workers so routing never blocks on a capture or a drain). Inert
    when observability is disabled (no queue-wait series to watch)."""

    def __init__(self, *, qwait_p99_ms=None, idle_s=None, cooldown_s=None,
                 debounce=2):
        self.qwait_p99_ms = float(
            qwait_p99_ms if qwait_p99_ms is not None
            else _env_num(ENV_QWAIT, 250.0, float))
        self.idle_s = float(idle_s if idle_s is not None
                            else _env_num(ENV_IDLE, 5.0, float))
        self.cooldown_s = float(cooldown_s if cooldown_s is not None
                                else _env_num(ENV_COOLDOWN, 2.0, float))
        self.debounce = max(1, int(debounce))
        self._watch = _slo.watcher()
        self._router = None
        self._last_scale_t = None
        self._busy = False           # one scale op in flight at a time

    def bind(self, router):
        self._router = router
        for rep in router.set.snapshot():
            self.track(rep)
        return self

    def track(self, rep):
        try:
            self._watch.rule(
                f'fleet.qwait.{rep.label}', 'serve.queue_wait_ms',
                self.qwait_p99_ms, labels={'engine': rep.label},
                stat='p99', cmp='>', debounce=self.debounce)
        except ValueError:
            pass                     # label re-added after decommission

    def untrack(self, rep):
        self._watch.remove_rule(f'fleet.qwait.{rep.label}')

    def firing(self):
        return [r.name for r in self._watch.rules if r.state == 'firing']

    def tick(self, now):
        """One evaluation + at most one scale decision. Called from the
        router control thread; scale work runs on a worker thread that
        reports back through the router's event queue."""
        router = self._router
        if router is None:
            return
        self._watch.evaluate()
        if self._busy:
            return
        if (self._last_scale_t is not None
                and now - self._last_scale_t < self.cooldown_s):
            return
        rset = router.set
        alive, _ = rset.counts()
        reps = [r for r in rset.snapshot() if r.state == Replica.READY]
        # delta-window SLO rules hold their last state when traffic stops
        # (no new samples = no transition); a fully idle fleet overrides a
        # stale 'firing' — there is no queue wait to scale for
        all_idle = bool(reps) and all(r.idle_since is not None
                                      for r in reps)
        if self.firing() and not all_idle:
            if rset.max_replicas is not None and alive >= rset.max_replicas:
                return
            if rset._factory is None:
                return
            self._busy = True
            self._last_scale_t = now
            threading.Thread(target=self._spawn_worker,
                             name='paddle-tpu-torch-fleet-spawn',
                             daemon=True).start()
            return
        # scale down: an idle replica past the window, above the floor
        if alive <= rset.min_replicas:
            return
        victim = next((r for r in rset.snapshot()
                       if r.state == Replica.READY
                       and r.idle_since is not None
                       and now - r.idle_since >= self.idle_s), None)
        if victim is None:
            return
        self._busy = True
        self._last_scale_t = now
        threading.Thread(target=self._drain_worker, args=(victim,),
                         name='paddle-tpu-torch-fleet-drain',
                         daemon=True).start()

    def _spawn_worker(self):
        router = self._router
        try:
            rep = router.set.spawn()
            router._post(('scaled', rep, None))
        except Exception as e:
            router._post(('scaled', None, e))

    def _drain_worker(self, rep):
        router = self._router
        try:
            self.untrack(rep)
            router.set.decommission(rep.name)
            _obs.counter('fleet.scale_down', {'fleet': router.name}).inc()
            router._post(('scaled', None, None))
        except Exception as e:
            router._post(('scaled', None, e))


class FleetRouter:
    """The fleet's front door — see the module docstring for semantics.

    Lock hierarchy (one direction only): router ``_lock`` (request
    tables) is never held across an engine call; engines finish attempt
    records under their scheduler locks, which only touches the router's
    ``_evcv`` event queue — a leaf lock under which nothing is called."""

    def __init__(self, replica_set, *, max_failovers=3, hedge_ms=None,
                 autoscaler=None, tick_s=0.02, clock=None):
        self.set = replica_set
        self.name = replica_set.name
        self.max_failovers = max(0, int(max_failovers))
        self.hedge_ms = hedge_ms
        self.autoscaler = autoscaler
        self.tick_s = float(tick_s)
        self._clock = clock or time.monotonic
        self._labels = {'fleet': self.name}
        self._lock = threading.Lock()
        self._inflight = {}          # fid -> _FleetRequest
        self._parked = deque()
        self._fseq = itertools.count(1)
        self._closed = False
        self._stopping = False
        self._evcv = threading.Condition()   # leaf: event queue only
        self._events = deque()
        if autoscaler is not None:
            autoscaler.bind(self)
        self._thread = threading.Thread(
            target=self._control_loop,
            name='paddle-tpu-torch-fleet-router', daemon=True)
        self._thread.start()

    # ---- event plumbing --------------------------------------------------
    def _post(self, event):
        with self._evcv:
            self._events.append(event)
            self._evcv.notify_all()

    def _post_done(self, record):
        self._post(('done', record.attempt))

    # ---- front door ------------------------------------------------------
    def submit(self, *args, deadline_ms=None, max_new_tokens=32, seed=0,
               target=None, tenant='default', lane='interactive'):
        """Route one request. Generation fleets take ``submit(prompt,
        max_new_tokens=, seed=, deadline_ms=)`` and return a
        :class:`GenerationFuture`; inference fleets take
        ``submit(*inputs, deadline_ms=)`` and return a Future.

        ``target='model@host'`` bypasses replica scoring entirely and
        forwards to that :class:`~.host.ModelHost`'s hosted model (with
        ``tenant``/``lane`` riding along) — the multi-model hosting
        front door behind the same fleet API.

        Raises :class:`QueueFullError` (with ``retry_after_ms``) only
        when every replica is saturated."""
        if target is not None:
            from .host import resolve_target
            host, model = resolve_target(target)
            _obs.counter('fleet.host_routed', self._labels).inc()
            return host.submit(model, *args, tenant=tenant, lane=lane,
                               deadline_ms=deadline_ms,
                               max_new_tokens=max_new_tokens, seed=seed)
        kind = self.set.kind
        if kind is None or self._closed:
            raise EngineClosedError('fleet router is closed or empty')
        now = self._clock()
        deadline_t = (now + deadline_ms / 1e3
                      if deadline_ms is not None else None)
        master = _obs.start_request('fleet', engine=self.name,
                                    fleet_kind=kind)
        if kind == 'gen':
            if len(args) != 1:
                raise TypeError('generation fleet submit() takes exactly '
                                'one prompt argument')
            payload = args[0]
            fut = GenerationFuture()
        else:
            payload = args
            fut = Future()
        fut.request_id = master.rid
        freq = _FleetRequest(next(self._fseq), kind, payload,
                             int(max_new_tokens), seed, fut, master, now,
                             deadline_t)
        with self._lock:
            self._inflight[freq.fid] = freq
        _obs.counter('fleet.submitted', self._labels).inc()
        master.note('enqueue', fleet=self.name)
        try:
            verdict = self._dispatch(freq)
        except Exception as e:
            self._fail(freq, 'error', e)
            raise
        if verdict == 'shed':
            err = self._shed(freq)
            raise err
        if verdict == 'park':
            self._park(freq)
        return fut

    # ---- routing ---------------------------------------------------------
    def _dispatch(self, freq, exclude=()):
        """Try to place ``freq`` on the best replica. Returns ``'ok'``
        (attempt in flight — rejections come back as events), ``'park'``
        (nothing routable right now, retry on the control loop), or
        ``'shed'`` (every replica saturated)."""
        try:
            fault.inject('fleet.route')
        except InjectedFault:
            _obs.counter('fleet.route_faults', self._labels).inc()
            freq.master.note('route_fault')
            return 'park'
        ready = [r for r in self.set.snapshot()
                 if r.state == Replica.READY]
        scored, saturated = [], 0
        for rep in ready:
            try:
                p = rep.probe()
            except Exception:
                continue
            healthy = (p.get('breaker') == 'closed'
                       and not p.get('closed'))
            full = (p.get('queue_depth', 0)
                    >= p.get('queue_capacity', 1))
            if healthy and full:
                saturated += 1
            # warmth is a preference, not a gate: a cold replica (fresh
            # spawn before its first request) still admits — routing away
            # from it forever would deadlock an entirely-cold fleet
            if healthy and not full and rep.name not in exclude:
                scored.append((not p.get('warm'), p.get('queue_depth', 0),
                               rep.name, rep))
        if not scored:
            # every replica is healthy-but-full -> backpressure; anything
            # else (breakers open, draining, spawning) may clear -> park
            if ready and saturated == len(ready):
                return 'shed'
            return 'park'
        scored.sort(key=lambda t: t[:2])
        cold, depth, _, rep = scored[0]
        att = _Attempt(freq, rep, self._clock())
        rec = _AttemptRecord(freq.master, rep.name, self._post_done)
        rec.attempt = att
        att.record = rec
        with self._lock:
            if freq.done:
                return 'ok'
            freq.attempts.append(att)
        try:
            if freq.kind == 'gen':
                inner = rep.engine.submit(
                    freq.payload, max_new_tokens=freq.max_new,
                    seed=freq.seed, _record=rec,
                    _enqueue_t=freq.enqueue_t, _deadline_t=freq.deadline_t)
            else:
                inner = rep.engine.submit(
                    *freq.payload, _record=rec,
                    _enqueue_t=freq.enqueue_t, _deadline_t=freq.deadline_t)
        except (QueueFullError, EngineClosedError, DeadlineExceededError):
            # the engine finished the attempt record ('rejected', or
            # 'expired' from the submit-time deadline fast-fail); that
            # event — the single failure path — drives the reroute
            return 'ok'
        except Exception:
            with self._lock:
                if att in freq.attempts:
                    freq.attempts.remove(att)
            raise
        att.inner = inner
        if freq.kind == 'gen':
            inner._subscribe(freq.mirror)
            att.subscribed = True
        freq.master.note('route', replica=rep.name, depth=depth)
        return 'ok'

    # ---- outcomes --------------------------------------------------------
    def _complete(self, freq, result):
        with self._lock:
            if freq.done:
                return
            freq.done = True
            self._inflight.pop(freq.fid, None)
        freq.master.finish('ok')
        if freq.kind == 'gen':
            freq.future._finish(None)
        else:
            try:
                freq.future.set_result(result)
            except Exception:
                pass                 # hedged duplicate already resolved it
        _obs.counter('fleet.completed', self._labels).inc()

    def _fail(self, freq, outcome, error):
        with self._lock:
            if freq.done:
                return
            freq.done = True
            self._inflight.pop(freq.fid, None)
            freq.parked = False
        freq.master.finish(outcome, error)
        if freq.kind == 'gen':
            freq.future._finish(error)
        else:
            try:
                freq.future.set_exception(error)
            except Exception:
                pass
        _obs.counter('fleet.failed', {**self._labels,
                                      'outcome': outcome}).inc()

    def _shed(self, freq):
        """All replicas saturated: reject with a useful backoff hint."""
        cap = depth = 0
        for rep in self.set.snapshot():
            if rep.state != Replica.READY:
                continue
            try:
                p = rep.probe()
            except Exception:
                continue
            cap += int(p.get('queue_capacity', 0))
            depth += int(p.get('queue_depth', 0))
        err = QueueFullError(cap, depth,
                             retry_after_ms=self._retry_after_ms())
        _obs.counter('fleet.shed', self._labels).inc()
        freq.master.note('shed', retry_after_ms=err.retry_after_ms)
        self._fail(freq, 'rejected', err)
        return err

    def _retry_after_ms(self):
        """Backoff hint from the observed queue-wait distribution."""
        best = None
        if _obs.enabled():
            reg = _obs.registry()
            for rep in self.set.snapshot():
                m = reg.find('serve.queue_wait_ms', {'engine': rep.label})
                if m is not None:
                    v = m.percentile(99)
                    if v:
                        best = max(best or 0.0, v)
        return round(best, 3) if best else 50.0

    def _park(self, freq):
        with self._lock:
            if freq.done or freq.parked:
                return
            freq.parked = True
            self._parked.append(freq)
        freq.master.note('park')

    # ---- control thread --------------------------------------------------
    def _control_loop(self):
        while True:
            with self._evcv:
                if not self._events and not self._stopping:
                    self._evcv.wait(self.tick_s)
                events = list(self._events)
                self._events.clear()
                stopping = self._stopping
            for ev in events:
                try:
                    self._handle(ev)
                except Exception:
                    _obs.counter('fleet.control_errors',
                                 self._labels).inc()
            if stopping and not events:
                return
            try:
                now = self._clock()
                self._sweep(now)
                self._tick_parked(now)
                self._tick_hedges(now)
                if self.autoscaler is not None:
                    self.autoscaler.tick(now)
            except Exception:
                _obs.counter('fleet.control_errors', self._labels).inc()

    def _handle(self, ev):
        kind = ev[0]
        if kind == 'done':
            self._handle_done(ev[1])
        elif kind == 'scaled':
            _, rep, error = ev
            if self.autoscaler is not None:
                self.autoscaler._busy = False
                if rep is not None:
                    self.autoscaler.track(rep)
            if error is not None:
                _obs.counter('fleet.scale_errors', self._labels).inc()

    def _handle_done(self, att):
        freq, rec = att.freq, att.record
        outcome, error = rec.outcome, rec.error
        if outcome == 'ok':
            # the engine can finish a request between its submit()
            # returning and the router wiring the attempt up; re-post
            # until the dispatch path has finished registering it
            if (freq.kind == 'gen' and not att.subscribed) or \
                    (freq.kind == 'infer' and att.inner is None):
                self._post(('done', att))
                return
        with self._lock:
            if att not in freq.attempts:
                return               # stale/aborted attempt
            freq.attempts.remove(att)
            if freq.done:
                return
            racing = len(freq.attempts)   # hedge twin still in flight?
        if outcome == 'ok':
            if freq.kind == 'infer':
                try:
                    result = att.inner.result(timeout=10.0)
                except Exception as e:
                    self._failover(freq, att, 'error', e, racing)
                    return
                self._complete(freq, result)
            else:
                # every token was mirrored before the engine finished the
                # attempt record (emit precedes retire in the scheduler)
                self._complete(freq, None)
            return
        self._failover(freq, att, outcome, error, racing)

    def _failover(self, freq, att, outcome, error, racing):
        now = self._clock()
        admitted = outcome != 'rejected'
        if isinstance(error, QueueFullError):
            freq.bounces += 1
        if admitted:
            freq.failovers += 1
            _obs.counter('fleet.failover', self._labels).inc()
            freq.master.note(
                'failover', frm=att.replica.name,
                error=(type(error).__name__ if error is not None
                       else outcome))
            _obs.record_event('fleet.failover', fleet=self.name,
                              replica=att.replica.name, outcome=outcome)
        if racing:
            return                   # a hedged twin is still running
        deadline_passed = (freq.deadline_t is not None
                           and now > freq.deadline_t)
        if deadline_passed and _retryable(error):
            waited = (now - freq.enqueue_t) * 1e3
            limit = (freq.deadline_t - freq.enqueue_t) * 1e3
            error = DeadlineExceededError(waited, limit)
            self._fail(freq, 'expired', error)
            return
        if not _retryable(error):
            self._fail(freq, outcome if outcome != 'ok' else 'error',
                       error)
            return
        if freq.failovers > self.max_failovers:
            self._fail(freq, 'error', error if error is not None
                       else RuntimeError('fleet failovers exhausted'))
            return
        if freq.bounces > max(8, 4 * len(self.set.snapshot())):
            self._shed(freq)
            return
        try:
            verdict = self._dispatch(freq, exclude=(att.replica.name,))
        except Exception as e:
            self._fail(freq, 'error', e)
            return
        if verdict == 'park':
            self._park(freq)
        elif verdict == 'shed':
            self._shed(freq)

    def _tick_parked(self, now):
        with self._lock:
            items = [f for f in self._parked]
        for freq in items:
            if freq.done:
                with self._lock:
                    if freq in self._parked:
                        self._parked.remove(freq)
                continue
            if freq.deadline_t is not None and now > freq.deadline_t:
                waited = (now - freq.enqueue_t) * 1e3
                limit = (freq.deadline_t - freq.enqueue_t) * 1e3
                self._fail(freq, 'expired',
                           DeadlineExceededError(waited, limit))
                continue
            with self._lock:
                if freq in self._parked:
                    self._parked.remove(freq)
                freq.parked = False
            try:
                verdict = self._dispatch(freq)
            except Exception as e:
                self._fail(freq, 'error', e)
                continue
            if verdict == 'park':
                self._park(freq)
            elif verdict == 'shed':
                self._shed(freq)

    def _tick_hedges(self, now):
        """Deadline-risk mitigation for batch inference: a request stuck
        on one replica past ``hedge_ms`` gets a second, racing attempt on
        another; first finish wins. Streams are never hedged — two
        concurrent emitters cannot both be byte-exact."""
        if self.hedge_ms is None or self.set.kind != 'infer':
            return
        with self._lock:
            candidates = [
                f for f in self._inflight.values()
                if (not f.done and not f.parked and not f.hedged
                    and len(f.attempts) == 1
                    and now - f.attempts[0].started > self.hedge_ms / 1e3)]
            for f in candidates:
                f.hedged = True
        for freq in candidates:
            primary = freq.attempts[0].replica.name if freq.attempts else ''
            _obs.counter('fleet.hedge', self._labels).inc()
            freq.master.note('hedge', primary=primary)
            try:
                self._dispatch(freq, exclude=(primary,))
            except Exception:
                pass                 # primary attempt is still running

    def _sweep(self, now):
        """Health pass: chaos hook, per-replica gauges, dead-replica
        detection (synthesizing failures for attempts stranded on an
        engine that died without failing its futures), idle tracking."""
        for rep in self.set.snapshot():
            if rep.state != Replica.READY:
                continue
            try:
                fault.inject('fleet.failover')
            except InjectedFault:
                _obs.counter('fleet.replicas_killed', self._labels).inc()
                self.set.kill(rep.name)
                self._strand_attempts(rep)
                continue
            labels = {'fleet': self.name, 'replica': rep.name}
            try:
                p = rep.probe()
            except Exception:
                p = None
            closed = bool(getattr(rep.engine, '_closed', False))
            if p is None or closed:
                self.set.mark_dead(rep.name)
                _obs.gauge('fleet.replica_breaker', labels) \
                    .set(_BREAKER_CODE['open'])
                self._strand_attempts(rep)
                continue
            depth = int(p.get('queue_depth', 0))
            _obs.gauge('fleet.replica_depth', labels).set(depth)
            _obs.gauge('fleet.replica_breaker', labels).set(
                _BREAKER_CODE.get(p.get('breaker'), 1))
            with self._lock:
                busy = any(a.replica is rep
                           for f in self._inflight.values()
                           for a in f.attempts)
            if depth == 0 and not busy:
                if rep.idle_since is None:
                    rep.idle_since = now
            else:
                rep.idle_since = None

    def _strand_attempts(self, rep):
        """Fail over every attempt still pointing at a dead replica. The
        finish facade is idempotent, so attempts the engine already
        failed on shutdown are unaffected."""
        with self._lock:
            atts = [a for f in self._inflight.values()
                    for a in f.attempts if a.replica is rep]
        for a in atts:
            a.record.finish('cancelled',
                            EngineClosedError('replica dead'))

    # ---- operator API ----------------------------------------------------
    def drain(self, name, timeout=None):
        """Stop routing to ``name``, finish its in-flight work."""
        return self.set.drain(name, timeout=timeout)

    def decommission(self, name, timeout=None):
        rep = self.set.get(name)
        if rep is not None and self.autoscaler is not None:
            self.autoscaler.untrack(rep)
        return self.set.decommission(name, timeout=timeout)

    def stats(self):
        alive, ready = self.set.counts()
        with self._lock:
            inflight = len(self._inflight)
            parked = len(self._parked)
        from ..parallel import mesh_engine as _mesh
        return {'fleet': self.name, 'kind': self.set.kind,
                'replicas': alive, 'replicas_ready': ready,
                'inflight': inflight, 'parked': parked,
                'replica_states': {r.name: r.state
                                   for r in self.set.snapshot()},
                'replica_mesh': {r.name: max(1, _mesh.mesh_size(r.engine))
                                 for r in self.set.snapshot()}}

    def close(self, drain=True, timeout=None):
        with self._lock:
            self._closed = True
        self.set.close(drain=drain, timeout=timeout)
        with self._evcv:
            self._stopping = True
            self._evcv.notify_all()
        self._thread.join(timeout or 10.0)
        with self._lock:
            leftovers = ([f for f in self._inflight.values()] +
                         [f for f in self._parked])
        for freq in leftovers:
            self._fail(freq, 'cancelled',
                       EngineClosedError('fleet router closed'))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
