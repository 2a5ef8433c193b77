"""The fleet front door of paddle_tpu_torch (serving/fleet.py) against the
JAX package's, on the CPU.

The reference's tiny GPT (vocab 97, hidden 32, 2 layers, 2 heads, f32;
block matrices x10 so streams depend on their context) carried over with
``gpt.params_from_numpy``; the same prompts and seeds go through a
``FleetRouter`` of two replicas in both packages, plain and with one
replica killed mid-decode (``fleet.failover``), and the streams are equal
token for token. The behaviour ``tests/test_fleet.py`` asserts of the
reference is held of the port: breaker skip, one master record across a
failover, shedding with ``retry_after_ms``, a rolling restart, autoscaling
up and back down, readiness aggregation, hedged batch inference, the
``fleet.route`` chaos point, and the resubmission hooks of
``GenerationEngine.submit``. A known difference (ROADMAP Queue 3): a
spawned replica captures its own graphs before it joins the routing set,
so its first request adds no capture (``traces`` stays at its warm-up
count, 2) where the reference's clone shows 0 traces.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

import jax

from paddle_tpu import fault as jfault
from paddle_tpu import observability as robs
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import (FleetRouter as JRouter,
                                GenerationEngine as JEngine,
                                ReplicaSet as JReplicaSet)
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch import fault, nn
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models import decode_cache
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import server as _server
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.serving import (Autoscaler, DeadlineExceededError,
                                      FleetRouter, GenerationEngine,
                                      InferenceEngine, QueueFullError,
                                      ReplicaSet)

CFG = jgpt.GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,
                     num_heads=2, max_seq_len=32, dtype='float32',
                     remat=False, use_flash=False)
PS = 8
FAIL_NEW = 24


@pytest.fixture(scope='module')
def params():
    """(reference params, port params, port config) from one init."""
    jp = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(CFG, jax.random.PRNGKey(0)))
    for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
        jp['blocks'][k] = jp['blocks'][k] * np.float32(10)
    tcfg = tgpt.GPTConfig(**dataclasses.asdict(CFG))
    return jp, tgpt.params_from_numpy(jp, tcfg, 'cpu'), tcfg


@pytest.fixture(autouse=True)
def _clean():
    prev = port_device._current
    port.set_device('cpu')
    obs.set_enabled(True)
    obs.reset()
    with _server._probes_lock:
        probes0 = dict(_server._probes)
    yield
    fault.configure(None)
    obs.shutdown_telemetry()
    with _server._probes_lock:
        _server._probes.clear()
        _server._probes.update(probes0)
    obs.reset()
    port_device._current = prev


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab_size, size=n) for n in lens]


SPREAD = _prompts([5, 7, 3, 9, 4, 6], seed=11)
FAILOVER = _prompts([9, 7, 8, 6, 9, 5], seed=17)


def _gen_engine(params, **kw):
    _, tp, tcfg = params
    kw.setdefault('num_slots', 2)
    kw.setdefault('page_size', PS)
    kw.setdefault('prefill_width', 16)
    kw.setdefault('queue_capacity', 64)
    return GenerationEngine(tp, tcfg, device='cpu', **kw)


def _warm(*engines):
    """Warm each engine directly (one short generation) so routing starts
    from an all-warm state, as the reference's test does."""
    for e in engines:
        e.submit(np.array([3, 1, 4]), max_new_tokens=2,
                 seed=1234).result(timeout=120)
    return engines


def _failover(router, prompts, n_new, seed):
    """Submit, let the streams start decoding, then kill one replica at
    the next health sweep. -> the streams."""
    futs = [router.submit(p, max_new_tokens=n_new, seed=i)
            for i, p in enumerate(prompts)]
    return futs, _armed(router, futs, seed)


def _decoding(futs):
    """Wait (bounded) until a stream has its first token: the replicas
    are mid-decode, with most of their work still ahead."""
    deadline = time.monotonic() + 60
    while not any(f._count() for f in futs):
        assert time.monotonic() < deadline, 'no stream ever started'
        time.sleep(0.001)


def _armed(router, futs, seed):
    """Kill one replica at the next health sweep once the streams are
    decoding. -> the streams."""
    _decoding(futs)
    mod = jfault if isinstance(router, JRouter) else fault
    mod.configure('fleet.failover:1.0', seed=seed, max_faults=1)
    try:
        return [list(f.stream(timeout=120)) for f in futs]
    finally:
        mod.configure(None)


@pytest.fixture(scope='module')
def ref_fleet(params):
    """The reference's router over two replicas (one engine compiled, the
    second spawned from its warmth): streams of SPREAD, and of FAILOVER
    with one replica killed mid-decode; the failed-over master record."""
    jp = params[0]
    robs.set_enabled(True)
    robs.reset_requests()
    rs = JReplicaSet(lambda: JEngine(jp, CFG, num_slots=2, page_size=PS,
                                     prefill_width=16, queue_capacity=64),
                     initial=1)
    _warm(rs.snapshot()[0].engine)
    rs.spawn()
    router = JRouter(rs, tick_s=0.005)
    try:
        spread = [router.submit(p, max_new_tokens=16, seed=i)
                  .result(timeout=120) for i, p in enumerate(SPREAD)]
        futs, streams = _failover(router, FAILOVER, FAIL_NEW, seed=7)
        killed = robs.find('fleet.replicas_killed', {'fleet': rs.name})
        states = sorted(r.state for r in rs.snapshot())
        recs = [r for r in robs.recorder().requests(outcome='ok')
                if r['kind'] == 'fleet'
                and any(e['ev'] == 'failover' for e in r['timeline'])]
    finally:
        router.close(drain=False)
    return {'spread': spread, 'failover': streams, 'states': states,
            'killed': killed.value, 'records': recs}


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_router_streams_equal_reference_and_spread_load(params, ref_fleet):
    engines = _warm(_gen_engine(params, num_slots=1),
                    _gen_engine(params, num_slots=1))
    rs = ReplicaSet(replicas=list(engines))
    router = FleetRouter(rs, tick_s=0.01)
    try:
        futs = [router.submit(p, max_new_tokens=16, seed=i)
                for i, p in enumerate(SPREAD)]
        got = [f.result(timeout=120) for f in futs]
        assert got == ref_fleet['spread']
        # least-queue-depth routing over a 6-deep burst on two 1-slot
        # replicas lands work on both
        per_replica = [r.engine.stats()['submitted'] - 1  # minus warm-up
                       for r in rs.snapshot()]
        assert sum(per_replica) == len(SPREAD)
        assert all(n > 0 for n in per_replica), per_replica
        st = router.stats()
        assert st['kind'] == 'gen' and st['replicas'] == 2
        # every replica is one device: a mesh of one shard each
        assert set(st['replica_mesh'].values()) == {1}
    finally:
        router.close()


def test_router_skips_replica_with_open_breaker(params):
    broken = _gen_engine(
        params, breaker=fault.CircuitBreaker(failure_threshold=1,
                                             recovery_timeout=300.0))
    broken._breaker.record_failure()            # open, stays open
    healthy = _gen_engine(params)
    rs = ReplicaSet(replicas=[broken, healthy])
    router = FleetRouter(rs, tick_s=0.01)
    try:
        prompts = _prompts([4, 6, 5], seed=13)
        futs = [router.submit(p, max_new_tokens=4, seed=i)
                for i, p in enumerate(prompts)]
        [f.result(timeout=120) for f in futs]
        assert broken.stats()['submitted'] == 0
        assert healthy.stats()['submitted'] == len(prompts)
    finally:
        router.close(drain=False)


# ---------------------------------------------------------------------------
# failover: kill a replica mid-decode (fleet.failover inject point)
# ---------------------------------------------------------------------------

def test_failover_mid_decode_streams_equal_reference(params, ref_fleet):
    engines = _warm(_gen_engine(params), _gen_engine(params))
    rs = ReplicaSet(replicas=list(engines))
    router = FleetRouter(rs, tick_s=0.005)
    try:
        _, streams = _failover(router, FAILOVER, FAIL_NEW, seed=7)
        # zero lost requests, zero duplicate emissions, and the tokens the
        # reference's fleet streamed through its own failover
        assert streams == ref_fleet['failover']
        assert all(len(s) == FAIL_NEW for s in streams)
        states = sorted(r.state for r in rs.snapshot())
        assert states == ref_fleet['states'] == ['dead', 'ready']
        killed = obs.find('fleet.replicas_killed', {'fleet': rs.name})
        assert killed is not None and killed.value == ref_fleet['killed']
        assert killed.value == 1
    finally:
        router.close(drain=False)


def test_failover_keeps_one_master_record_with_failover_event(params,
                                                              ref_fleet):
    engines = _warm(_gen_engine(params), _gen_engine(params))
    rs = ReplicaSet(replicas=list(engines))
    router = FleetRouter(rs, tick_s=0.005)
    try:
        futs = [router.submit(p, max_new_tokens=FAIL_NEW, seed=i)
                for i, p in enumerate(_prompts([8, 8, 7, 9, 6, 8], 19))]
        _armed(router, futs, seed=3)
        done = obs.recorder().requests(outcome='ok')
        failed_over = [r for r in done if r['kind'] == 'fleet'
                       and any(e['ev'] == 'failover'
                               for e in r['timeline'])]
        assert failed_over, 'no master record carries the failover event'
        # ONE record spans both attempts, finished ok exactly once, as
        # the reference's does
        for recs in (failed_over, ref_fleet['records']):
            rec = recs[0]
            assert len([e for e in rec['timeline']
                        if e['ev'] == 'route']) >= 2
            assert rec['outcome'] == 'ok'
        assert len({r['id'] for r in done}) == len(done)
    finally:
        router.close(drain=False)


def test_sampled_streams_regenerate_identically_on_the_survivor(params):
    """The mirror dedups by token index, which holds only because a
    sampled draw depends on (seed, position) alone: a stream restarted on
    the other replica regenerates the tokens it had already sent."""
    kw = dict(temperature=0.9, top_k=20)
    prompts = _prompts([9, 7, 8, 6, 9, 5], seed=31)
    single = _gen_engine(params, **kw)
    try:
        want = [single.submit(p, max_new_tokens=FAIL_NEW, seed=100 + i)
                .result(timeout=120) for i, p in enumerate(prompts)]
    finally:
        single.shutdown()
    engines = _warm(_gen_engine(params, **kw), _gen_engine(params, **kw))
    rs = ReplicaSet(replicas=list(engines))
    router = FleetRouter(rs, tick_s=0.005)
    try:
        futs = [router.submit(p, max_new_tokens=FAIL_NEW, seed=100 + i)
                for i, p in enumerate(prompts)]
        streams = _armed(router, futs, seed=7)
        assert streams == want
        assert sorted(r.state for r in rs.snapshot()) == ['dead', 'ready']
        failovers = obs.find('fleet.failover', {'fleet': rs.name})
        assert failovers is not None and failovers.value >= 1
    finally:
        router.close(drain=False)


def test_submit_hooks_keep_record_enqueue_time_and_deadline(params):
    """A resubmitted stream keeps its RequestRecord, its enqueue time and
    its absolute deadline: an already-passed deadline fails fast with the
    waited and limit times measured from the ORIGINAL enqueue, as the
    reference's engine reports them."""
    jp, tp, tcfg = params
    clock = lambda: 100.0                                    # noqa: E731
    errs = []
    for mk, o in ((lambda: JEngine(jp, CFG, num_slots=1, page_size=PS,
                                   prefill_width=16, autostart=False,
                                   clock=clock), robs),
                  (lambda: GenerationEngine(
                      tp, tcfg, device='cpu', num_slots=1, page_size=PS,
                      prefill_width=16, autostart=False, clock=clock), obs)):
        eng = mk()
        try:
            rec = o.start_request('fleet', engine='f')
            with pytest.raises(Exception) as ei:
                eng.submit(np.array([3, 1, 4]), max_new_tokens=4,
                           _record=rec, _enqueue_t=99.0, _deadline_t=99.5)
            errs.append((type(ei.value).__name__, str(ei.value)))
            assert rec.outcome == 'expired'
            fut = eng.submit(np.array([3, 1, 4]), max_new_tokens=4,
                             _record=o.start_request('fleet', engine='f'),
                             _enqueue_t=42.0, _deadline_t=None)
            assert fut.request_id
            assert eng._queue[0].enqueue_t == 42.0
            assert eng._queue[0].deadline_t is None
        finally:
            eng.shutdown(drain=False)
    assert errs[0] == errs[1]
    assert errs[1][0] == DeadlineExceededError.__name__


# ---------------------------------------------------------------------------
# shedding
# ---------------------------------------------------------------------------

def test_shed_only_when_all_replicas_saturated(params):
    rs = ReplicaSet(lambda: _gen_engine(params, num_slots=1,
                                        queue_capacity=2), initial=2)
    router = FleetRouter(rs, tick_s=0.01)
    try:
        accepted, shed = [], None
        for i in range(40):
            try:
                accepted.append(router.submit(
                    _prompts([8], seed=i)[0], max_new_tokens=24, seed=i))
            except QueueFullError as e:
                shed = e
                break
        assert shed is not None, 'saturated fleet never shed'
        assert shed.retry_after_ms is not None and shed.retry_after_ms > 0
        # shedding lost nothing that was admitted
        assert all(len(f.result(timeout=120)) == 24 for f in accepted)
        c = obs.find('fleet.shed', {'fleet': rs.name})
        assert c is not None and c.value >= 1
    finally:
        router.close()


# ---------------------------------------------------------------------------
# graceful drain / rolling restart
# ---------------------------------------------------------------------------

def test_rolling_restart_drops_nothing(params):
    rs = ReplicaSet(replicas=[_gen_engine(params) for _ in range(2)])
    router = FleetRouter(rs, tick_s=0.005)
    errors, results = [], []
    stop = threading.Event()

    def client(cid):
        rng = np.random.default_rng(cid)
        i = 0
        while not stop.is_set():
            try:
                f = router.submit(rng.integers(1, CFG.vocab_size, size=6),
                                  max_new_tokens=4, seed=cid * 997 + i)
                results.append(f.result(timeout=120))
            except Exception as e:           # noqa: BLE001 - recorded
                errors.append(e)
            i += 1

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.25)
        first, second = [r.name for r in rs.snapshot()]
        router.drain(first)                  # rolling restart, replica 1
        rs.add(_gen_engine(params))          # replacement joins
        time.sleep(0.15)
        router.drain(second)                 # rolling restart, replica 2
        time.sleep(0.15)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    assert not errors, f'rolling restart dropped requests: {errors[:3]}'
    assert results, 'clients made no progress'
    router.close()


# ---------------------------------------------------------------------------
# autoscaling: warm scale-up (the port's capture rule) and back down
# ---------------------------------------------------------------------------

def test_autoscaler_scales_up_warm_then_back_down(params):
    rs = ReplicaSet(lambda: _gen_engine(params, num_slots=1),
                    initial=1, min_replicas=1, max_replicas=3)
    asc = Autoscaler(qwait_p99_ms=1.0, idle_s=0.4, cooldown_s=0.2,
                     debounce=1)
    router = FleetRouter(rs, autoscaler=asc, tick_s=0.01)
    loads = _build.loads
    try:
        futs = [router.submit(_prompts([8], seed=i)[0], max_new_tokens=16,
                              seed=i) for i in range(12)]
        # the serve.queue_wait p99 breach must spawn a replica while the
        # burst is still in flight
        spawned = None
        deadline = time.time() + 60
        while time.time() < deadline and spawned is None:
            extra = rs.snapshot()[1:]
            spawned = extra[0] if extra else None
            time.sleep(0.02)
        assert spawned is not None, 'queue-wait breach never scaled up'
        # joined warm: its two functions captured before it was routable
        eng = spawned.engine
        assert eng._warmed and eng.stats()['traces'] == 2
        got = eng.submit(_prompts([6], seed=99)[0], max_new_tokens=4,
                         seed=1).result(timeout=120)
        assert len(got) == 4
        [f.result(timeout=120) for f in futs]
        # its requests added no capture and built no kernel
        assert eng.stats()['traces'] == 2
        assert _build.loads == loads
        # idle replicas drain back down to the floor
        deadline = time.time() + 60
        while time.time() < deadline and rs.counts()[0] > 1:
            time.sleep(0.05)
        assert rs.counts()[0] == 1, 'idle fleet never scaled down'
        h = obs.find('fleet.scale_up_ms', {'fleet': rs.name})
        assert h is not None and h.count >= 1
    finally:
        router.close()


def test_spawned_inference_replica_captures_the_templates_buckets():
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    rs = ReplicaSet(lambda: InferenceEngine(net, max_batch_size=8,
                                            max_delay_ms=0.5), initial=1)
    try:
        tmpl = rs.snapshot()[0].engine
        tmpl.warmup('all_buckets', input_spec=[((8,), 'float32')])
        rep = rs.spawn()
        eng = rep.engine
        assert eng._warmed
        # the template's bucket ladder (1, 2, 4, 8), captured anew over
        # the new engine's own buffers; its first request adds none
        assert eng.stats()['traces'] == tmpl.stats()['traces'] == 4
        x = np.random.RandomState(0).rand(3, 8).astype('float32')
        got = eng.submit(x).result(timeout=60)
        np.testing.assert_allclose(
            got, net(port.to_tensor(x)).numpy(), rtol=1e-5, atol=1e-6)
        assert eng.stats()['traces'] == 4
        assert eng.stats()['cache_misses'] == 0
    finally:
        rs.close(drain=False)


def test_capture_lock_is_one_per_device():
    a, b = decode_cache.capture_lock('cpu'), decode_cache.capture_lock('cpu')
    assert a is b
    with a:
        assert a.locked()
    decode_cache.release('cpu')          # takes the lock: not held here
    assert not a.locked()


def test_a_capture_tallies_only_its_own_threads_launches():
    """A spawn captures on a worker thread while the replicas' threads
    replay: their launches count as they run, the capture's go to its
    tally (what each replay of its graph adds)."""
    k = tfa.flash_decode
    saved = (k.launches, k.split_launches)
    try:
        with tfa.tally() as mine:
            tfa.add_launches(k, launches=1, split_launches=1)
            other = threading.Thread(target=tfa.add_launches, args=(k,),
                                     kwargs={'launches': 2})
            other.start()
            other.join()
        assert mine == {(k, 'launches'): 1, (k, 'split_launches'): 1}
        assert (k.launches, k.split_launches) == (saved[0] + 2, saved[1])
        tfa.add_tally(mine)                  # one replay
        assert (k.launches, k.split_launches) == (saved[0] + 3,
                                                  saved[1] + 1)
    finally:
        k.launches, k.split_launches = saved


# ---------------------------------------------------------------------------
# readiness aggregation
# ---------------------------------------------------------------------------

def test_readyz_aggregates_to_at_least_one_ready_replica(params):
    e0, e1 = _gen_engine(params), _gen_engine(params)
    rs = ReplicaSet(replicas=[e0, e1])
    router = FleetRouter(rs, tick_s=0.01)
    try:
        # engines joined the fleet aggregate; their individual probes no
        # longer gate the process /readyz
        checks = obs.readiness()['checks']
        assert e0._probe_name not in checks
        assert e1._probe_name not in checks
        router.submit(_prompts([5], seed=29)[0],
                      max_new_tokens=2).result(timeout=120)   # warms r0
        agg = obs.readiness()['checks'][f'fleet.{rs.name}']
        assert agg['ready'] is True
        names = [r.name for r in rs.snapshot()]
        # one dead replica must NOT 503 the fleet (r1 is the cold one)
        rs.kill(names[1])
        assert obs.readiness()['checks'][f'fleet.{rs.name}']['ready']
        # every replica gone -> not ready
        rs.kill(names[0])
        assert not obs.readiness()['checks'][f'fleet.{rs.name}']['ready']
    finally:
        router.close(drain=False)


# ---------------------------------------------------------------------------
# chaos: fleet.route parks the request instead of losing it
# ---------------------------------------------------------------------------

def test_route_fault_parks_and_retries(params):
    rs = ReplicaSet(replicas=list(_warm(_gen_engine(params))))
    router = FleetRouter(rs, tick_s=0.005)
    try:
        prompt = _prompts([6], seed=37)[0]
        want = rs.snapshot()[0].engine.submit(
            prompt, max_new_tokens=6, seed=5).result(timeout=120)
        fault.configure('fleet.route:1.0', seed=1, max_faults=1)
        fut = router.submit(prompt, max_new_tokens=6, seed=5)
        assert fut.result(timeout=120) == want
        c = obs.find('fleet.route_faults', {'fleet': rs.name})
        assert c is not None and c.value == 1
    finally:
        router.close()


# ---------------------------------------------------------------------------
# hedged retries (batch inference only)
# ---------------------------------------------------------------------------

def _mlp():
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    net.eval()
    return net


def test_hedge_rescues_request_stuck_on_stalled_replica():
    net = _mlp()
    # autostart=False and never started: admitted work sits forever — a
    # stall the circuit breaker cannot see
    stalled = InferenceEngine(net, autostart=False)
    healthy = InferenceEngine(net, max_batch_size=8, max_delay_ms=0.5)
    rs = ReplicaSet(replicas=[stalled, healthy])
    router = FleetRouter(rs, hedge_ms=60, tick_s=0.01)
    try:
        x = np.random.rand(3, 8).astype('float32')
        want = net(port.to_tensor(x)).numpy()
        got = np.asarray(router.submit(x).result(timeout=60))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        c = obs.find('fleet.hedge', {'fleet': rs.name})
        assert c is not None and c.value >= 1
    finally:
        router.close(drain=False)


def test_hedge_winner_with_breaker_opening_midflight_delivers_once():
    net = _mlp()
    stalled = InferenceEngine(
        net, autostart=False,
        breaker=fault.CircuitBreaker(failure_threshold=1,
                                     recovery_timeout=300.0))
    healthy = InferenceEngine(net, max_batch_size=8, max_delay_ms=0.5)
    rs = ReplicaSet(replicas=[stalled, healthy])
    router = FleetRouter(rs, hedge_ms=40, tick_s=0.01)
    try:
        x = np.random.rand(3, 8).astype('float32')
        want = net(port.to_tensor(x)).numpy()
        fut = router.submit(x)
        got = np.asarray(fut.result(timeout=60))      # hedge twin wins
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        # the primary's breaker opens while its attempt is still queued,
        # then the stalled engine wakes up: the abandoned attempt fails on
        # its open breaker and is recognized as stale — the master future
        # keeps the winner's result and no in-flight request leaks
        stalled._breaker.record_failure()
        assert stalled.stats()['circuit_state'] == 'open'
        stalled.start()
        deadline = time.time() + 30
        while True:
            with router._lock:
                if not router._inflight:
                    break
            assert time.time() < deadline, 'primary attempt never drained'
            time.sleep(0.01)
        np.testing.assert_allclose(np.asarray(fut.result(timeout=1)),
                                   want, rtol=1e-5, atol=1e-6)
        got2 = np.asarray(router.submit(x).result(timeout=60))
        np.testing.assert_allclose(got2, want, rtol=1e-5, atol=1e-6)
        assert stalled.stats()['completed'] == 0
        errors = obs.find('fleet.control_errors', {'fleet': rs.name})
        assert errors is None or errors.value == 0
    finally:
        router.close(drain=False)
