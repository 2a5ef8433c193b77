"""devtime (device-time attribution), goodput and capture_profile of
paddle_tpu_torch against the JAX package's, on the CPU.

The reference's golden trace through classifier version 1 in both
packages, with equal summaries; a Kineto-shaped golden (what
``torch.profiler`` writes on the card: ``kernel`` / ``gpu_memcpy`` /
``gpu_memset`` device events, ``user_annotation`` host ranges and their
``gpu_user_annotation`` twins) through version 2; the port's kernel names
from ``csrc``; the goodput ledger in both packages under one fake clock;
``/debug/goodput``; the profile artifacts' retention; one 50 ms CPU
capture with ``torch.profiler`` from another thread than the traffic's.
"""
import copy
import json
import os
import re
import threading
import time
import urllib.request

import pytest
import torch

import paddle_tpu.observability as robs
from paddle_tpu.observability import devtime as rdevtime
from paddle_tpu.observability import goodput as rgoodput
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import devtime, fleetobs, goodput, perf

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures', 'devtime',
                       'golden.trace.json')
CSRC = os.path.join(os.path.dirname(__file__), '..', 'paddle_tpu_torch',
                    'csrc')


@pytest.fixture(autouse=True)
def _clean():
    for o in (robs, obs):
        o.set_enabled(True)
        o.reset()
    yield
    for o in (robs, obs):
        o.shutdown_telemetry()
        o.set_enabled(True)
        o.reset()


# ---------------------------------------------------------------------------
# version 1: the reference's golden trace in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('window_ms', [None, 25])
def test_reference_golden_classifies_the_same_in_both_packages(
        monkeypatch, window_ms):
    monkeypatch.setenv(perf.ENV_PEAK_FLOPS, '1e9')
    records = {'fn': {'flops': 1.5e6, 'module': 'dot.1', 'pyname': None,
                      'precision': None}}
    got = devtime.attribute(FIXTURE, window_ms=window_ms, version=1,
                            records=records)
    want = rdevtime.attribute(FIXTURE, window_ms=window_ms, version=1,
                              records=records)
    assert got.pop('unknown_names') == {'zorble-op.9': 1}
    assert got == want
    assert got['categories_ms']['collective'] == 10.0
    assert got['overlap']['fraction'] == 0.5
    assert sum(got['categories_ms'].values()) == pytest.approx(
        got['window_ms'], abs=1e-6)
    for k in ('devtime.window_ms', 'devtime.overlap_fraction',
              'perf.mfu_measured{fn=fn}'):
        assert obs.snapshot()['gauges'][k] == \
            robs.snapshot()['gauges'][k]
    c = devtime.classifier(1)
    assert c.classify('all-reduce.17') == ('collective', True)
    assert c.classify('PjitFunction(step)') == ('host', True)
    with pytest.raises(ValueError, match='unknown classifier version'):
        devtime.classifier(99)


def test_begin_end_folding_and_mfu_join_as_the_reference(monkeypatch):
    events = [{'ph': 'B', 'pid': 1, 'tid': 1, 'ts': 100, 'name': 'f.1'},
              {'ph': 'B', 'pid': 1, 'tid': 1, 'ts': 200, 'name': 'f.1'},
              {'ph': 'E', 'pid': 1, 'tid': 1, 'ts': 300, 'name': 'f.1'},
              {'ph': 'E', 'pid': 1, 'tid': 1, 'ts': 600, 'name': 'f.1'},
              {'ph': 'E', 'pid': 2, 'tid': 1, 'ts': 900, 'name': 'orphan'}]
    assert devtime._complete_events(copy.deepcopy(events)) == \
        rdevtime._complete_events(copy.deepcopy(events))
    monkeypatch.setenv(perf.ENV_PEAK_FLOPS, '1e9')
    doc = {'traceEvents': [
        {'ph': 'X', 'pid': 1, 'tid': 1, 'ts': 0, 'dur': 1000,
         'name': 'PjitFunction(train_step)'},
        {'ph': 'X', 'pid': 1, 'tid': 1, 'ts': 5000, 'dur': 1000,
         'name': 'PjitFunction(train_step)'},
        {'ph': 'X', 'pid': 1, 'tid': 1, 'ts': 0, 'dur': 10000,
         'name': 'TfrtCpuExecutable::Execute'}]}
    records = {'fn': {'flops': 2e6, 'module': None, 'pyname': 'train_step',
                      'precision': None}}
    got = devtime.attribute(doc, publish=False, version=1, records=records)
    want = rdevtime.attribute(doc, publish=False, version=1,
                              records=records)
    assert got['mfu_measured'] == want['mfu_measured']
    assert got['mfu_measured']['fn']['mfu'] == pytest.approx(0.4)


# ---------------------------------------------------------------------------
# version 2: Kineto's Chrome trace
# ---------------------------------------------------------------------------

def _kineto_golden():
    """A card capture's shape: GPU 0 (pid 0) streams 7 and 8 beside the
    host (pid 4242). Device time, in ms: a cuBLAS GEMM [0, 4], kernel 1
    [3, 6] on another stream, an NCCL all-reduce [5, 9], a memcpy [10,
    11], a memset [11, 11.5], an elementwise kernel [12, 13], an unknown
    kernel [14, 15]; the host ranges of two executions of
    ``serving.bucket64`` (one with a nested duplicate), whose device-side
    twins must not count again."""
    def x(name, cat, ts, dur, pid=0, tid=7):
        return {'ph': 'X', 'cat': cat, 'name': name, 'pid': pid,
                'tid': tid, 'ts': ts * 1e3, 'dur': dur * 1e3}
    return {'traceEvents': [
        {'ph': 'M', 'name': 'process_name', 'pid': 0,
         'args': {'name': 'GPU 0'}},
        x('nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT', 'kernel', 0, 4),
        x('void flash_fwd_tc_kernel<64, __nv_bfloat16>(CUtensorMap, '
          'CUtensorMap, CUtensorMap, FwdArgs)', 'kernel', 3, 3, tid=8),
        x('ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgs)',
          'kernel', 5, 4, tid=9),
        x('Memcpy DtoH (Device -> Pinned)', 'gpu_memcpy', 10, 1),
        x('Memset (Device)', 'gpu_memset', 11, 0.5),
        x('void at::native::vectorized_elementwise_kernel<4, '
          'at::native::FillFunctor<float>>(int, ...)', 'kernel', 12, 1),
        x('mystery_kernel', 'kernel', 14, 1),
        x('serving.bucket64', 'user_annotation', 0, 7, pid=4242, tid=1),
        x('serving.bucket64', 'user_annotation', 1, 2, pid=4242, tid=1),
        x('serving.bucket64', 'user_annotation', 9, 5, pid=4242, tid=1),
        x('serving.bucket64', 'gpu_user_annotation', 0, 9),
        x('serving.bucket64', 'gpu_user_annotation', 10, 5),
        x('aten::mm', 'cpu_op', 0.1, 0.2, pid=4242, tid=1),
        x('cudaGraphLaunch', 'cuda_runtime', 0.5, 0.1, pid=4242, tid=1),
    ]}


def test_kineto_golden_through_version_2(monkeypatch):
    monkeypatch.setenv(perf.ENV_PEAK_FLOPS, '1e9')
    records = {'serving.bucket64': {'flops': 3e6, 'module':
                                    'serving.bucket64', 'pyname': 'forward',
                                    'precision': None}}
    s = devtime.attribute(_kineto_golden(), records=records)
    assert s['classifier_version'] == devtime.CLASSIFIER_VERSION == 2
    # collective [5, 9] over matmul [0, 6]; copy [10, 11.5]; compute
    # [12, 13] and the unknown kernel's [14, 15]
    assert s['categories_ms'] == {'collective': 4.0, 'matmul': 5.0,
                                  'copy': 1.5, 'infeed': 0.0,
                                  'compute': 2.0, 'idle': 2.5}
    assert s['window_ms'] == 15.0
    assert sum(s['categories_ms'].values()) == pytest.approx(15.0)
    assert s['overlap'] == {'collective_ms': 4.0, 'hidden_ms': 1.0,
                            'fraction': 0.25}
    assert s['unknown_events'] == 1
    assert s['unknown_names'] == {'mystery_kernel': 1}
    assert s['device_lanes'] == 1 and s['host_events'] == 7
    # two outermost host ranges: 2 x 3e6 flops over 15 ms at 1 GFLOP/s
    m = s['mfu_measured']['serving.bucket64']
    assert m['execs'] == 2 and m['mfu'] == pytest.approx(0.4)
    g = obs.snapshot()['gauges']
    assert g['perf.mfu_measured'] == pytest.approx(0.4)
    assert g['devtime.category_ms{category=matmul}'] == 5.0
    # a pinned capture window stretches idle only
    s = devtime.attribute(_kineto_golden(), window_ms=20, publish=False,
                          records=records)
    assert s['idle_ms'] == 7.5 and s['categories_ms']['matmul'] == 5.0


def test_every_port_kernel_classifies_as_known_matmul():
    names = set()
    for f in os.listdir(CSRC):
        if f.endswith(('.cu', '.cuh')):
            src = open(os.path.join(CSRC, f)).read()
            names |= set(re.findall(
                r'__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\)?\s*'
                r')?(\w+)\s*\(', src))
            names |= set(re.findall(r'\n(\w+_kernel)\(', src))
    # attention's kernels are matmul; NMS's (csrc/nms.cu) known compute
    assert names == set(devtime.PORT_KERNELS) | set(
        devtime.PORT_COMPUTE_KERNELS)
    c = devtime.classifier()
    for n in names:
        want = 'compute' if n in devtime.PORT_COMPUTE_KERNELS else 'matmul'
        assert c.classify(f'void {n}<64, __nv_bfloat16>(Args)',
                          cat='kernel') == (want, True), n
    for name, want in (('sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n',
                        'matmul'),
                       ('cutlass::Kernel2<cutlass_80_wmma>', 'matmul'),
                       ('void at::native::reduce_kernel<512, 1>',
                        'compute')):
        assert c.classify(name, cat='kernel') == (want, True)
    assert c.classify('anything', cat='gpu_memcpy') == ('copy', True)


# ---------------------------------------------------------------------------
# goodput
# ---------------------------------------------------------------------------

def _ledger_run(mod, monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(mod.time, 'perf_counter', lambda: clock[0])
    led = mod.GoodputLedger()
    led.note_badput('compile', 1.0)          # outside a run: lifetime only
    led.run_start()
    for i in range(20):
        clock[0] += 0.5
        led.note_step(0.5)
    led.note_badput('checkpoint', 2.0)
    led.note_badput('cosmic_rays', 0.25)     # unknown cause -> requeue
    led.note_data_wait(0.002)                # under the 5 ms floor
    led.note_data_wait(0.105)
    with led.badput('preemption'):
        clock[0] += 0.75
    assert list(led.data_iter(iter([1, 2, 3]))) == [1, 2, 3]
    led.run_end()
    clock[0] += 5.0                          # after the run: frozen
    return led.snapshot()


def test_goodput_ledger_equals_the_reference_under_one_fake_clock(
        monkeypatch):
    got = _ledger_run(goodput, monkeypatch)
    want = _ledger_run(rgoodput, monkeypatch)
    assert got == want
    assert got['elapsed_s'] == 10.75 and got['steps'] == 20
    assert got['badput_s']['requeue'] == 0.25
    assert got['badput_s']['data_stall'] == pytest.approx(0.1)
    assert got['badput_lifetime_s']['compile'] == 1.0
    assert got['badput_s']['compile'] == 0.0
    assert goodput.CAUSES == rgoodput.CAUSES


def test_debug_goodput_endpoint_and_disabled_ledger():
    led = goodput.ledger()
    led.run_start()
    led.note_badput('checkpoint', 0.01)
    led.run_end()
    srv = obs.serve_telemetry(port=0)
    with urllib.request.urlopen(srv.url + '/debug/goodput',
                                timeout=30) as r:
        doc = json.loads(r.read())
    srv.stop()
    assert doc['runs'] == 1 and 0.0 <= doc['ratio'] <= 1.0
    assert doc['badput_s']['checkpoint'] == pytest.approx(0.01)
    obs.set_enabled(False)
    led = goodput.GoodputLedger()
    led.run_start()
    led.note_badput('checkpoint', 5.0)
    assert led.snapshot()['runs'] == 0
    it = [1, 2]
    assert led.data_iter(it) is it


def test_checkpoint_restore_and_retry_book_their_badput(tmp_path):
    from paddle_tpu_torch import fault, framework_io
    from paddle_tpu_torch.utils.checkpoint import CheckpointManager
    led = goodput.ledger()
    led.run_start()
    framework_io.save({'w': torch.ones(4)}, str(tmp_path / 'a.pdparams'))
    mgr = CheckpointManager(str(tmp_path / 'ck'))
    mgr.save(1, {'w': torch.ones(2)}, wait=True)
    assert mgr.restore() is not None
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise RuntimeError('again')
        return 7
    assert fault.retry(flaky, retries=3, backoff=0.01) == 7
    led.run_end()
    snap = led.snapshot()
    saved = obs.find('ckpt.save_ms').sum
    # every save's span books as it is (the snapshot rounds to 1 us)
    assert snap['badput_s']['checkpoint'] * 1e3 == pytest.approx(
        saved, abs=2e-3)
    assert snap['badput_s']['preemption'] > 0
    assert snap['badput_s']['requeue'] >= 0.009


# ---------------------------------------------------------------------------
# captures
# ---------------------------------------------------------------------------

def test_profile_gc_keeps_newest(tmp_path, monkeypatch):
    monkeypatch.setenv(fleetobs.ENV_PROFILE_KEEP, '2')
    dirs = []
    for i in range(5):
        d = tmp_path / f'{fleetobs.PROFILE_DIR_PREFIX}{i}'
        d.mkdir()
        (d / 'x.trace.json').write_text('{}')
        os.utime(d, (1000 + i, 1000 + i))
        dirs.append(d)
    assert fleetobs._gc_profile_dirs(str(dirs[-1])) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f'{fleetobs.PROFILE_DIR_PREFIX}3', f'{fleetobs.PROFILE_DIR_PREFIX}4']
    assert obs.snapshot()['counters']['fleet.obs.profile_gc_total'] == 3


def test_a_50ms_capture_from_another_thread_than_the_traffic(
        tmp_path, monkeypatch):
    monkeypatch.setenv(fleetobs.ENV_PROFILE_DIR, str(tmp_path))
    x = torch.ones(64, 64)

    def step():
        return (x @ x).sum()
    perf.analyze('e2e.step', step)
    stop = threading.Event()

    def traffic():
        while not stop.is_set():
            with perf.program_range('e2e.step'):
                step()
            time.sleep(0.001)
    summary = {}

    def capture():
        summary.update(fleetobs.capture_profile(50))
    th = threading.Thread(target=traffic, daemon=True)
    th.start()
    cap = threading.Thread(target=capture)
    cap.start()
    cap.join()
    stop.set()
    th.join()
    dv = summary['devtime']
    assert 'error' not in dv and dv['host_events'] > 0
    assert dv['classifier_version'] == 2 and dv['device_lanes'] == 0
    assert summary['all_threads'] is True and summary['cuda'] is False
    # the traffic thread's ranges are in the capture: the MFU join
    # counts them
    assert dv['mfu_measured']['e2e.step']['execs'] > 0
    assert os.path.dirname(summary['artifact_dir']) == str(tmp_path)
    # one capture at a time, and none while another profiler runs
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(obs.ProfileBusyError, match='another'):
            fleetobs.capture_profile(5)
    assert not obs.profile_in_flight()
