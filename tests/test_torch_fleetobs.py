"""The fleet observability plane of paddle_tpu_torch
(observability/fleetobs.py, the ``fleetobs=`` face of the telemetry
server) against the JAX package's, on the CPU.

The same metric series go into both packages' registries and through both
federators: counters sum bit-equal to the per-replica totals, gauges fold
by the same registered semantics, histogram quantiles come from the merged
window, URL sources degrade to the per-replica maximum, and the federated
expositions, parsed by both packages' ``promparse``, hold the same
families and values. ``stitch_records`` returns the reference's segments
for the same record parts. Then the plane over live port objects: a
``FleetRouter`` of two GenerationEngines (the reference's tiny GPT) with
one replica killed mid-decode, and a ``ModelHost``, served by
``FleetObs().serve(port=0)``: the federated ``/metrics`` counters equal the
per-replica sums, ``/debug/fleet`` lists replicas and hosted models, and
``/debug/requests?id=`` of a failed-over request shows two attempts.
"""
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

import paddle_tpu.observability as robs
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import fleetobs as rfleetobs
from paddle_tpu.observability import promparse as rpromparse
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch import fault, nn
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import fleetobs, promparse
from paddle_tpu_torch.observability import server as _server
from paddle_tpu_torch.serving import (FleetRouter, GenerationEngine,
                                      InferenceEngine, ModelHost,
                                      ReplicaSet)

MB = 1 << 20
BOTH = ((robs, rfleetobs), (obs, fleetobs))


@pytest.fixture(autouse=True)
def _clean():
    prev = port_device._current
    port.set_device('cpu')
    probes0 = {}
    for o, _ in BOTH:
        o.set_enabled(True)
        o.reset()
    with _server._probes_lock:
        probes0 = dict(_server._probes)
    # both packages' gauge-semantics tables are module-level: a test file
    # run before this one in the same process may have registered entries
    semantics0 = [dict(fo._GAUGE_SEMANTICS) for _, fo in BOTH]
    yield
    fault.configure(None)
    for o, _ in BOTH:
        o.shutdown_telemetry()
        o.set_enabled(True)
        o.reset()
    with _server._probes_lock:
        _server._probes.clear()
        _server._probes.update(probes0)
    for (_, fo), table in zip(BOTH, semantics0):
        fo._GAUGE_SEMANTICS.clear()
        fo._GAUGE_SEMANTICS.update(table)
    port_device._current = prev


def _get(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode('utf-8')
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode('utf-8')


class _FakeRep:
    def __init__(self, name, label, state='ready', kind='infer'):
        self.name = name
        self._label = label
        self.state = state
        self.kind = kind

    @property
    def label(self):
        return self._label

    def probe(self):
        return {'ready': self.state == 'ready', 'warm': True,
                'breaker': 'closed', 'queue_depth': 0,
                'queue_capacity': 16}


class _FakeSet:
    def __init__(self, reps, name='fakefleet'):
        self._reps = list(reps)
        self.name = name

    def snapshot(self):
        return list(self._reps)


class _FakeRouter:
    def __init__(self, reps, name='fakefleet'):
        self.set = _FakeSet(reps, name=name)
        self.name = name


def _two_replica_metrics(o, fo):
    """Two in-process 'replicas' (engine labels e0/e1) with counters,
    gauges, and histograms in package ``o``'s shared registry."""
    o.counter('serve.requests', {'engine': 'e0'},
              help='requests accepted').inc(3)
    o.counter('serve.requests', {'engine': 'e1'}).inc(4)
    o.counter('gen.tokens', {'engine': 'e0', 'lane': 'batch'}).inc(2 ** 40)
    o.counter('gen.tokens', {'engine': 'e1', 'lane': 'batch'}).inc(7)
    o.gauge('perf.mfu', {'engine': 'e0'}).set(0.5)
    o.gauge('perf.mfu', {'engine': 'e1'}).set(0.7)
    o.gauge('host.hbm_watermark_bytes', {'engine': 'e0'}).set(100.0)
    o.gauge('host.hbm_watermark_bytes', {'engine': 'e1'}).set(60.0)
    o.gauge('gen.slot_occupancy').set(0.25)     # process-level: no engine
    h0 = o.histogram('serve.queue_wait_ms', {'engine': 'e0'})
    for v in (1.0, 2.0, 3.0, 10.0):
        h0.observe(v)
    h1 = o.histogram('serve.queue_wait_ms', {'engine': 'e1'})
    for v in (5.0, 6.0):
        h1.observe(v)
    fed = fo.MetricFederator(name='t')
    fed.add_replica_set(_FakeSet([_FakeRep('r0', 'e0'),
                                  _FakeRep('r1', 'e1')]))
    fed.add_registry('proc', o.registry())
    return fed


def _families(text):
    """Both parsers' view of one exposition, minus the collect time."""
    out = []
    for parse in (promparse.parse_text, rpromparse.parse_text):
        snap = parse(text)
        for sec in ('counters', 'gauges'):
            snap[sec] = {k: v for k, v in snap[sec].items()
                         if 'collect_ms' not in k}
        out.append({k: snap[k] for k in ('counters', 'gauges',
                                         'histograms', 'types')})
    assert out[0] == out[1]
    return out[0]


# ---------------------------------------------------------------------------
# federation math, both packages on the same series
# ---------------------------------------------------------------------------

def test_counters_sum_bit_equal_and_replica_rows():
    snaps = [_two_replica_metrics(o, fo).collect() for o, fo in BOTH]
    for snap in snaps:
        assert snap.aggregate('serve_requests') == 3 + 4
        # integer addition: exact past float's 2^53 mantissa as well
        assert snap.aggregate('gen_tokens', {'lane': 'batch'}) == \
            2 ** 40 + 7
        lines = snap.to_prometheus().splitlines()
        assert 'serve_requests 7' in lines
        assert 'serve_requests{replica="r0"} 3' in lines
        assert 'serve_requests{replica="r1"} 4' in lines
    ref, got = (_families(s.to_prometheus()) for s in snaps)
    assert got == ref
    assert got['counters']['serve_requests'] == 7


def test_gauge_semantics_min_mean_sum_and_registration(monkeypatch):
    for _, fo in BOTH:
        # the default ('sum') is what the loop starts from
        monkeypatch.delitem(fo._GAUGE_SEMANTICS, 'data_prefetch_depth',
                            raising=False)
    for o, fo in BOTH:
        fed = _two_replica_metrics(o, fo)
        snap = fed.collect()
        # the watermark federates as the binding constraint (min)
        assert snap.aggregate('host_hbm_watermark_bytes') == 60.0
        # MFU-style ratios average
        assert snap.aggregate('perf_mfu') == pytest.approx(0.6)
        assert fo.gauge_semantics('perf.mfu') == 'mean'
        o.gauge('data.prefetch_depth', {'engine': 'e0'}).set(2.0)
        o.gauge('data.prefetch_depth', {'engine': 'e1'}).set(5.0)
        assert fed.collect().aggregate('data_prefetch_depth') == 7.0
        fo.register_gauge_semantics('data.prefetch_depth', 'max')
        assert fed.collect().aggregate('data_prefetch_depth') == 5.0
        fo.register_gauge_semantics('data.prefetch_depth', 'sum')
        with pytest.raises(ValueError):
            fo.register_gauge_semantics('x', 'median')
    assert fleetobs._GAUGE_SEMANTICS == rfleetobs._GAUGE_SEMANTICS


def test_histogram_quantiles_from_merged_window():
    aggs = [_two_replica_metrics(o, fo).collect()
            .aggregate('serve_queue_wait_ms') for o, fo in BOTH]
    assert aggs[0] == aggs[1]
    agg = aggs[1]
    assert agg['count'] == 6
    assert agg['sum'] == pytest.approx(27.0)
    assert agg['merged_window'] is True
    # nearest-rank over the MERGED window [1,2,3,5,6,10]
    assert agg['p50'] == 5.0
    assert agg['p99'] == 10.0


def test_url_source_federates_and_degrades_quantiles():
    got = []
    for o, fo in BOTH:
        o.counter('serve.requests').inc(5)
        h = o.histogram('serve.batch_ms')
        for v in (2.0, 4.0, 8.0):
            h.observe(v)
        srv = o.serve_telemetry(port=0)
        try:
            fed = fo.MetricFederator(name='u')
            fed.add_url('remote0', srv.url)
            snap = fed.collect()
        finally:
            srv.stop()
        assert snap.aggregate('serve_requests') == 5
        agg = snap.aggregate('serve_batch_ms')
        # a URL source only exposes p50/p90/p99: the fleet quantile is the
        # conservative per-replica maximum
        assert agg['merged_window'] is False
        assert agg['count'] == 3 and agg['p99'] == 8.0
        got.append(agg)
    assert got[0] == got[1]


def test_staleness_and_scrape_errors():
    fed = fleetobs.MetricFederator(name='s')
    rep = _FakeRep('r0', 'e0')
    fed.add_replica_set(_FakeSet([rep]))
    fed.add_url('ghost', 'http://127.0.0.1:9/')   # nothing listens there
    obs.counter('serve.requests', {'engine': 'e0'}).inc(2)
    snap = fed.collect()
    assert snap.staleness['r0'] == 0.0
    assert snap.staleness['ghost'] is None        # never reported
    assert 'ghost' in snap.errors
    errs = obs.find('fleet.obs.scrape_errors', {'replica': 'ghost'})
    assert errs is not None and errs.value >= 1
    # the replica dies: cached series keep serving, staleness grows
    rep.state = 'dead'
    time.sleep(0.02)
    snap2 = fed.collect()
    assert snap2.aggregate('serve_requests') == 2     # from the cache
    assert snap2.staleness['r0'] > 0.0
    text = snap2.to_prometheus()
    assert 'fleet_obs_staleness_s{replica="ghost"} -1' in text
    doc = snap2.as_dict()
    assert doc['families']['serve_requests']['rows'][0]['aggregate'] == 2


# ---------------------------------------------------------------------------
# stitching: the reference's segments for the same parts
# ---------------------------------------------------------------------------

def _failover_part(rid, base):
    return {'id': rid, 'kind': 'fleet', 'engine': 'fleet0',
            'wall_start': base, 'outcome': 'ok', 'error': None,
            'duration_ms': 30.0, 'attrs': {},
            'timeline': [
                {'ev': 'enqueue', 't_ms': 0.0},
                {'ev': 'route', 't_ms': 1.0, 'replica': 'r0'},
                {'ev': 'failover', 't_ms': 10.0, 'frm': 'r0',
                 'error': 'EngineClosedError'},
                {'ev': 'route', 't_ms': 11.0, 'replica': 'r1'},
                {'ev': 'hedge', 't_ms': 12.0, 'primary': 'r1'},
                {'ev': 'retire', 't_ms': 30.0}]}


def _split_parts(rid, base):
    a = {'id': rid, 'engine': 'e0', 'kind': 'serve', 'wall_start': base,
         'outcome': 'error', 'error': 'EngineClosedError',
         'duration_ms': 5.0, 'attrs': {},
         'timeline': [{'ev': 'enqueue', 't_ms': 0.0},
                      {'ev': 'route', 't_ms': 0.5, 'replica': 'r0'}]}
    b = {'id': rid, 'engine': 'e1', 'kind': 'serve',
         'wall_start': base + 0.010, 'outcome': None, 'error': None,
         'duration_ms': None, 'attrs': {},
         'timeline': [{'ev': 'enqueue', 't_ms': 0.0},
                      {'ev': 'retire', 't_ms': 2.0}]}
    return [b, a]


@pytest.mark.parametrize('case', ['failover', 'duplicate', 'split',
                                  'empty'])
def test_stitch_records_returns_the_references_segments(case):
    rid, base = f'fleet-abc-{case}', 1.7e9
    parts = {'failover': lambda: [_failover_part(rid, base)],
             'duplicate': lambda: [_failover_part(rid, base),
                                   json.loads(json.dumps(
                                       _failover_part(rid, base)))],
             'split': lambda: _split_parts(rid, base),
             'empty': lambda: [None, {}]}[case]
    got = fleetobs.stitch_records(rid, parts())
    assert got == rfleetobs.stitch_records(rid, parts())
    if case == 'failover':
        assert got['replicas'] == ['r0', 'r1']
        assert [a['outcome'] for a in got['attempts']] == ['failover', 'ok']
    if case == 'duplicate':
        assert got['parts'] == 1 and len(got['timeline']) == 6
    if case == 'split':
        assert [e['ev'] for e in got['timeline']] == [
            'enqueue', 'route', 'enqueue', 'retire']
        assert got['timeline'][2]['source'] == 'e1'
    if case == 'empty':
        assert got == {'id': rid, 'found': False, 'parts': 0,
                       'attempts': [], 'timeline': []}


def test_stitch_gathers_the_recorder_and_degrades_on_dead_peers():
    r = obs.start_request('fleet', engine='f0')
    r.note('enqueue')
    r.note('route', replica='r0')
    r.finish('ok')
    st = fleetobs.stitch(r.rid, urls=['http://127.0.0.1:9'])
    assert st['found'] and st['attempts'][0]['replica'] == 'r0'
    c = obs.find('fleet.obs.scrape_errors',
                 {'replica': 'http://127.0.0.1:9'})
    assert c is not None and c.value == 1
    assert fleetobs.stitch('no-such-rid')['found'] is False


# ---------------------------------------------------------------------------
# the HTTP face over live port objects
# ---------------------------------------------------------------------------

CFG = jgpt.GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,
                     num_heads=2, max_seq_len=32, dtype='float32',
                     remat=False, use_flash=False)


@pytest.fixture(scope='module')
def gen_params():
    jp = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(CFG, jax.random.PRNGKey(0)))
    for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
        jp['blocks'][k] = jp['blocks'][k] * np.float32(10)
    tcfg = tgpt.GPTConfig(**dataclasses.asdict(CFG))
    return tgpt.params_from_numpy(jp, tcfg, 'cpu'), tcfg


def _gen(gen_params, **kw):
    tp, tcfg = gen_params
    return GenerationEngine(tp, tcfg, device='cpu', num_slots=2,
                            page_size=8, prefill_width=16, **kw)


def _infer_factory():
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    return lambda: InferenceEngine(net, max_batch_size=4, max_delay_ms=0.5,
                                   queue_capacity=8)


def test_fleetobs_over_a_live_fleet_and_host(gen_params):
    engines = [_gen(gen_params) for _ in range(2)]
    for e in engines:
        e.warmup()
    rs = ReplicaSet(replicas=engines)
    router = FleetRouter(rs, tick_s=0.005)
    host = ModelHost(hbm_watermark_bytes=64 * MB, name='obshost')
    srv = None
    try:
        host.deploy('vision', _infer_factory(),
                    input_spec=[((8,), 'float32')])
        host.deploy('spare', _infer_factory())
        host.evict('spare')
        host.submit('vision', np.zeros((1, 8), np.float32)).result(
            timeout=60)
        rng = np.random.default_rng(17)
        futs = [router.submit(rng.integers(1, 97, size=n),
                              max_new_tokens=24, seed=i)
                for i, n in enumerate((9, 7, 8, 6, 9, 5))]
        deadline = time.monotonic() + 60       # mid-decode, then kill
        while not any(f._count() for f in futs):
            assert time.monotonic() < deadline, 'no stream ever started'
            time.sleep(0.001)
        fault.configure('fleet.failover:1.0', seed=7, max_faults=1)
        try:
            streams = [list(f.stream(timeout=120)) for f in futs]
        finally:
            fault.configure(None)
        assert all(len(s) == 24 for s in streams)
        fobs = fleetobs.FleetObs(name='live').watch_router(router) \
            .watch_host(host)
        srv = fobs.serve(port=0)

        # federated /metrics: each counter's fleet row is the sum over the
        # replicas (the dead one read from its last fresh snapshot)
        code, body = _get(srv.url + '/metrics')
        assert code == 200
        fams = _families(body)
        names = [r.name for r in rs.snapshot()]
        for fam in ('gen_requests_submitted', 'gen_tokens',
                    'gen_requests_completed'):
            per = [fams['counters'].get(
                promparse.fmt_key(fam, {'replica': n}), 0) for n in names]
            assert fams['counters'][fam] == sum(per), fam
        # the killed replica was never seen fresh by this federator: it
        # reads as never reported, and the fleet row sums the survivor's
        live = [r for r in rs.snapshot() if r.state == 'ready']
        dead = [r for r in rs.snapshot() if r.state == 'dead']
        assert fams['counters']['gen_tokens'] == \
            live[0].engine.stats()['tokens']
        assert f'fleet_obs_staleness_s{{replica="{dead[0].name}"}} -1' \
            in body
        assert f'fleet_obs_staleness_s{{replica="vision@obshost"}} 0.0' \
            in body

        # /debug/fleet: the replica table and the host table
        code, body = _get(srv.url + '/debug/fleet')
        assert code == 200
        table = json.loads(body)
        rows = {r['replica']: r for r in table['replicas']}
        assert sorted(rows) == sorted(names)
        assert sorted(r['state'] for r in rows.values()) == ['dead',
                                                             'ready']
        assert table['hosts'][0]['host'] == 'obshost'
        assert table['hosts'][0]['resident'] == ['vision']
        assert table['hosts'][0]['evicted'] == ['spare']

        # /debug/requests?id= of a failed-over request: two attempts
        failed = [r for r in obs.recorder().requests(outcome='ok')
                  if r['kind'] == 'fleet'
                  and any(e['ev'] == 'failover' for e in r['timeline'])]
        assert failed
        code, body = _get(srv.url + '/debug/requests?id=' + failed[0]['id'])
        st = json.loads(body)['stitched']
        assert st['found'] and len(st['attempts']) >= 2
        assert st['attempts'][0]['outcome'] == 'failover'
        assert st['attempts'][-1]['outcome'] == 'ok'
        assert len(st['replicas']) == 2
    finally:
        if srv is not None:
            srv.stop()
        router.close(drain=False)
        host.close(drain=False)


def test_serve_telemetry_fleetobs_and_404_without_plane():
    srv = obs.serve_telemetry(port=0)
    code, body = _get(srv.url + '/debug/fleet')
    assert code == 404 and 'no fleet observability' in json.loads(body)[
        'error']
    srv.stop()
    obs.counter('serve.requests', {'engine': 'e0'}).inc(2)
    fobs = fleetobs.FleetObs(name='httpfleet')
    fobs.watch_router(_FakeRouter([_FakeRep('r0', 'e0')]))
    srv = obs.serve_telemetry(port=0, fleetobs=fobs)
    try:
        code, body = _get(srv.url + '/metrics')
        assert code == 200
        assert 'serve_requests{replica="r0"} 2' in body
        assert 'fleet_obs_collect_ms' in body
        code, body = _get(srv.url + '/debug/fleet')
        table = json.loads(body)
        row = table['replicas'][0]
        assert row['replica'] == 'r0' and row['state'] == 'ready'
        assert row['breaker'] == 'closed' and row['queue_depth'] == 0
        assert table['hosts'] == []
        assert table['profile_in_flight'] is False
    finally:
        srv.stop()


def test_concurrent_profile_on_a_fleet_server_second_gets_409():
    fobs = fleetobs.FleetObs(name='proffleet')
    srv = fobs.serve(port=0)
    results = []

    def grab():
        results.append(_get(srv.url + '/debug/profile?ms=300'))

    threads = [threading.Thread(target=grab) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    srv.stop()
    codes = sorted(c for c, _ in results)
    assert codes == [200, 409], results
    assert not fleetobs.profile_in_flight()


def test_disabled_mode_is_inert():
    obs.set_enabled(False)
    assert fleetobs.capture_profile(ms=50) == {'disabled': True}
    fobs = fleetobs.FleetObs(name='off')
    assert fobs.serve(port=0) is _server.NULL_SERVER
    assert fleetobs.stitch('any')['found'] is False
