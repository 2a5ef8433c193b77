"""The telemetry plane of paddle_tpu_torch (registry, promparse, trace,
reqtrace, server) against the JAX package's, on the CPU.

The behaviour ``tests/test_telemetry.py`` and ``test_observability.py``
assert of the reference, held here of both packages side by side: the
Prometheus exposition byte for byte (``# HELP``, label escaping), every
endpoint of the HTTP plane over real sockets, the readiness flip of an
engine around ``warmup()`` and a request's timeline, the trace ring's cap
and dump, the flight recorder's retention, disabled mode, spans as
``torch.profiler`` ranges, and the reference's own ``tools/obs_report.py
--url`` scraping the port's server. Each server binds 127.0.0.1:0; a
fixture stops every server; readiness checks look only at their own
probes.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu.observability as robs
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import fleetobs, promparse
from paddle_tpu_torch.observability import trace as ptrace
from paddle_tpu_torch.serving import GenerationEngine, InferenceEngine

BOTH = (robs, obs)


@pytest.fixture(autouse=True)
def _clean():
    prev = port_device._current
    port.set_device('cpu')
    caps = [o.trace_cap() for o in BOTH]
    for o in BOTH:
        o.set_enabled(True)
        o.reset()
    yield
    for o, cap in zip(BOTH, caps):
        o.shutdown_telemetry()
        o.set_trace_cap(cap)
        o.set_enabled(True)
        o.reset()
    port_device._current = prev


def _get(url, timeout=30):
    """(status, body bytes, content type) over a real HTTP client."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read(), r.headers.get('Content-Type', '')
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get('Content-Type', '')


def _wait(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def _series(o):
    """The same series, labels (with every escaping corner) and
    observations in a package's registry."""
    o.counter('serve.requests', {'engine': 'e0', 'path': 'a"b\\c\nd'},
              help='requests seen\nby "the" engine \\ total').inc(7)
    o.counter('serve.requests', {'engine': 'e1'}).inc(2)
    o.gauge('serve.queue_depth', {'engine': 'e0'}).set(3.5)
    o.gauge('goodput.ratio', help='goodput / elapsed').set(0.25)
    h = o.histogram('serve.latency_ms', {'engine': 'e0'},
                    help='end-to-end latency (ms)')
    for v in (1.0, 2.5, 3.0, 40.0, 7.25):
        h.observe(v)
    o.histogram('serve.empty_ms')


# ---------------------------------------------------------------------------
# the registry and the exposition
# ---------------------------------------------------------------------------

def test_prometheus_exposition_is_byte_identical_across_packages():
    for o in BOTH:
        _series(o)
    texts = [o.to_prometheus() for o in BOTH]
    assert texts[0] == texts[1]
    assert '# HELP serve_requests requests seen\\nby "the" engine \\\\ ' \
        'total' in texts[1]
    assert 'path="a\\"b\\\\c\\nd"' in texts[1]
    snaps = [o.snapshot() for o in BOTH]
    for s in snaps:
        s.pop('ts')
    assert snaps[0] == snaps[1]
    assert robs.fmt_key('a', {'y': 1, 'x': 2}) == obs.fmt_key(
        'a', {'y': 1, 'x': 2}) == 'a{x=2,y=1}'


def test_promparse_round_trips_the_ports_snapshot():
    _series(obs)
    text = obs.to_prometheus()
    got = promparse.parse_text(text)
    assert got == robs.promparse.parse_text(text)
    snap = obs.snapshot()
    key = 'serve_requests{engine=e0,path=a"b\\c\nd}'
    assert got['counters'][key] == snap['counters'][
        'serve.requests{engine=e0,path=a"b\\c\nd}'] == 7
    hist = got['histograms']['serve_latency_ms{engine=e0}']
    want = snap['histograms']['serve.latency_ms{engine=e0}']
    for k in ('count', 'sum', 'p50', 'p90', 'p99'):
        assert hist[k] == want[k]
    assert got['help']['serve_requests'].startswith('requests seen\n')
    assert got['types']['serve_latency_ms'] == 'summary'


def test_registry_type_conflict_and_help_upgrade_as_the_reference():
    for o in BOTH:
        o.counter('x.c')
        with pytest.raises(ValueError, match='already registered'):
            o.gauge('x.c')
        o.counter('x.c', help='now explained')
    assert robs.registry().help_text('x.c') == \
        obs.registry().help_text('x.c') == 'now explained'


# ---------------------------------------------------------------------------
# every endpoint
# ---------------------------------------------------------------------------

def test_every_endpoint_over_a_real_socket():
    _series(obs)
    rec = obs.start_request('serve', engine='e0')
    rec.note('enqueue')
    rec.finish('ok')
    w = obs.slo.watcher()
    w.rule('queue_p99', 'serve.latency_ms', 5.0, labels={'engine': 'e0'},
           stat='p99')
    w.evaluate()
    srv = obs.serve_telemetry(port=0)
    assert srv.url.startswith('http://127.0.0.1:') and srv in obs.servers()
    code, body, ctype = _get(srv.url + '/metrics')
    assert code == 200 and ctype == obs.server.PROM_CONTENT_TYPE
    assert body.decode() == obs.to_prometheus()
    code, body, _ = _get(srv.url + '/healthz')
    assert code == 200 and json.loads(body)['status'] == 'alive'
    code, body, _ = _get(srv.url + '/readyz')
    assert code in (200, 503) and 'checks' in json.loads(body)
    code, body, _ = _get(srv.url + f'/debug/requests?id={rec.rid}')
    doc = json.loads(body)
    assert code == 200 and doc['requests'][0]['outcome'] == 'ok'
    code, body, _ = _get(srv.url + '/debug/requests?outcome=ok&limit=1')
    assert json.loads(body)['count'] == 1
    code, body, _ = _get(srv.url + '/debug/trace?ms=5')
    doc = json.loads(body)
    assert code == 200 and doc['otherData']['capture_ms'] == 5.0
    code, body, _ = _get(srv.url + '/debug/slo')
    doc = json.loads(body)
    assert doc['firing'] == ['queue_p99']
    assert doc['rules'][0]['series'] == 'serve.latency_ms{engine=e0}'
    code, body, _ = _get(srv.url + '/debug/goodput')
    assert code == 200 and json.loads(body)['ratio'] == 1.0
    code, body, _ = _get(srv.url + '/debug/fleet')
    assert code == 404 and 'no fleet' in json.loads(body)['error']
    code, body, _ = _get(srv.url + '/debug/nope')
    assert code == 404 and '/debug/profile' in json.loads(body)['paths']
    code, body, _ = _get(srv.url + '/debug/profile?ms=10')
    doc = json.loads(body)
    assert code == 200 and doc['devtime']['classifier_version'] == 2
    assert os.path.isfile(os.path.join(doc['artifact_dir'],
                                       fleetobs.TRACE_FILE))
    # one capture at a time: a request during one gets 409
    with fleetobs._profile_lock:
        assert obs.profile_in_flight()
        code, body, _ = _get(srv.url + '/debug/profile?ms=10')
    assert code == 409 and json.loads(body)['busy'] is True
    # as the reference's: requests are counted per path
    assert obs.find('server.http_requests', {'path': '/metrics'}).value == 1
    srv.stop()
    assert srv not in obs.servers()


def test_inference_engine_readyz_flip_and_request_timeline():
    net = port.nn.Linear(16, 4)
    engine = InferenceEngine(net, max_batch_size=8, max_delay_ms=0.5,
                             telemetry_port=0)
    base = engine.telemetry.url
    name = engine._probe_name
    try:
        code, body, _ = _get(base + '/readyz')
        check = json.loads(body)['checks'][name]
        assert code == 503 and check['warm'] is False
        engine.warmup(input_spec=[((16,), 'float32')])
        code, body, _ = _get(base + '/readyz')
        assert json.loads(body)['checks'][name]['ready'] is True
        fut = engine.submit(np.ones((2, 16), np.float32))
        fut.result(timeout=120)
        rid = fut.request_id
        assert rid.startswith('serve-')
        assert _wait(lambda: (obs.recorder().lookup(rid) or {})
                     .get('outcome') == 'ok')
        code, body, _ = _get(base + '/debug/requests?id=' + rid)
        rec = json.loads(body)['requests'][0]
        evs = [e['ev'] for e in rec['timeline']]
        assert evs.index('enqueue') < evs.index('admit') < evs.index('retire')
        spans = [e for e in obs.trace_events() if e['name'] == 'serve.batch']
        assert any(rid in e['args']['req_ids'] for e in spans)
    finally:
        engine.shutdown()
    assert name not in obs.readiness()['checks']
    with pytest.raises(OSError):
        urllib.request.urlopen(base + '/healthz', timeout=5)


def test_generation_engine_timeline_and_span_request_ids():
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,
                        num_heads=2, max_seq_len=32, dtype='float32',
                        remat=False, use_flash=False)
    params = gpt.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    eng = GenerationEngine(params, cfg, device='cpu', num_slots=2,
                           page_size=8, prefill_width=16, telemetry_port=0)
    base = eng.telemetry.url
    try:
        assert _get(base + '/readyz')[0] == 503
        eng.warmup()
        code, body, _ = _get(base + '/readyz')
        assert json.loads(body)['checks'][eng._probe_name]['ready'] is True
        rng = np.random.RandomState(3)
        futs = [eng.submit(rng.randint(0, 97, size=t).astype(np.int32),
                           max_new_tokens=5) for t in (5, 9)]
        rids = [f.request_id for f in futs]
        for f in futs:
            assert len(f.result(timeout=120)) >= 1
        for rid in rids:
            assert rid.startswith('gen-')
            assert _wait(lambda: (obs.recorder().lookup(rid) or {})
                         .get('outcome') == 'ok')
            evs = [e['ev'] for e in obs.recorder().lookup(rid)['timeline']]
            for ev in ('enqueue', 'admit', 'prefill', 'decode', 'retire'):
                assert ev in evs, (rid, evs)
        events = obs.trace_events()
        assert {e['args']['req_id'] for e in events
                if e['name'] == 'gen.prefill'} >= set(rids)
        code, body, _ = _get(base + '/debug/requests?id=' + rids[0])
        assert json.loads(body)['requests'][0]['outcome'] == 'ok'
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# the trace ring and the flight recorder
# ---------------------------------------------------------------------------

def test_trace_cap_drop_count_and_dump_as_the_reference(tmp_path):
    out = []
    for o in BOTH:
        o.set_trace_cap(4)
        for i in range(10):
            with o.span('t.s', i=i):
                pass
        o.record_event('t.i', n=1)
        docs = o.build_trace_doc()
        n = o.dump_trace(str(tmp_path / f'{o.__name__}.json'))
        loaded = json.load(open(tmp_path / f'{o.__name__}.json'))
        metas = [e['name'] for e in loaded['traceEvents'] if e['ph'] == 'M']
        out.append((o.trace_cap(), o.trace.trace_dropped(), n, metas,
                    [e.get('args') for e in docs['traceEvents']
                     if e['ph'] != 'M'],
                    sorted(loaded['otherData'])))
        t0 = o.trace.now_us()
        with o.span('t.late'):
            pass
        assert [e['name'] for e in o.trace_events(since_us=t0)] == ['t.late']
    assert out[0] == out[1]
    assert out[1][:3] == (4, 7, 4)
    assert out[1][3] == ['process_name', 'thread_name']


def test_flight_recorder_evicts_healthy_before_notable_as_the_reference():
    kept = []
    for o in BOTH:
        r = o.reqtrace.FlightRecorder(capacity=3, slow_ms=1e9)
        ids = []
        for outcome in ('error', 'ok', 'ok', 'expired', 'ok'):
            rec = r.start('serve', engine='e0')
            ids.append(rec.rid)
            rec.finish(outcome)
        order = {rid: i for i, rid in enumerate(ids)}
        kept.append(sorted(order[d['id']] for d in r.requests()))
        assert [order[d['id']] for d in r.requests(rid=ids[1])] == [1]
    assert kept[0] == kept[1] == [0, 3, 4]


def test_spans_are_torch_profiler_ranges(monkeypatch):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span('t.ranged'):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert 't.ranged' in names
    # no range outside a capture; a broken record_function degrades the
    # span to host-only timing inside one
    monkeypatch.setattr(ptrace._torch_profiler(), 'record_function',
                        lambda name: 1 / 0)
    with obs.span('t.outside'):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with obs.span('t.host_only'):
            pass
    assert [e['name'] for e in obs.trace_events()[-2:]] == [
        't.outside', 't.host_only']


def test_disabled_mode_is_fully_inert():
    obs.set_enabled(False)
    assert obs.serve_telemetry(port=0) is obs.NULL_SERVER
    assert obs.span('x') is obs.NULL_SPAN
    assert obs.counter('x') is obs.NULL_METRIC
    assert obs.start_request('serve') is obs.NULL_RECORD
    assert obs.capture_profile(5) == {'disabled': True}
    assert obs.slo.watcher() is obs.slo.NULL_WATCHER
    assert obs.perf.measure('x') is obs.perf.NULL_MEASURE
    assert not any(t.name == 'paddle-tpu-torch-telemetry'
                   for t in threading.enumerate())
    obs.set_enabled(True)
    # the environment knob sets it at import
    code = ('import paddle_tpu_torch.observability as o; '
            'print(o.enabled(), o.serve_telemetry(0) is o.NULL_SERVER)')
    env = dict(os.environ, PADDLE_TPU_OBS='0')
    out = subprocess.run([sys.executable, '-c', code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ['False', 'True'], out.stderr[-2000:]


def test_the_references_obs_report_scrapes_the_ports_server(capsys):
    obs.counter('serve.requests_submitted', {'engine': 'e0'}).inc(4)
    obs.gauge('request.active').set(2)
    h = obs.histogram('serve.latency_ms', {'engine': 'e0'})
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v)
    sys.path.insert(0, 'tools')
    try:
        import obs_report
    finally:
        sys.path.pop(0)
    srv = obs.serve_telemetry(port=0)
    try:
        assert obs_report.main(['--url', srv.url, '--json']) == 0
    finally:
        srv.stop()
    ns = json.loads(capsys.readouterr().out)['namespaces']
    assert ns['serve']['counters']['serve_requests_submitted{engine=e0}'] == 4
    assert ns['request']['gauges']['request_active'] == 2
    hist = ns['serve']['histograms']['serve_latency_ms{engine=e0}']
    assert hist['count'] == 4 and hist['p50'] == 3.0 and hist['p99'] == 4.0
