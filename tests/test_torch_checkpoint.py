"""paddle.save / paddle.load, utils.checkpoint and fault.retry of
paddle_tpu_torch against the JAX package's, on the CPU.

Files pass between the two packages both ways with equal values (nested
dicts, Tensors, f32, int32, bool, hapi's .pdparams / .pdopt); the two
packages write byte-identical payloads and manifests. The bf16 rule
(a tagged uint16 view, bit for bit without ``ml_dtypes``), the restricted
unpickler, corruption and directory fallback, a fault mid-save, and the
CheckpointManager cases of ``tests/test_fault_tolerance.py``.
"""
import json
import os
import pickle
import re
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch import fault
from paddle_tpu_torch.fault import (CheckpointCorruptError, RetryError,
                                    UnsafePayloadError)
from paddle_tpu_torch.utils.checkpoint import (CheckpointManager,
                                               auto_resume,
                                               latest_verified_step,
                                               load_checkpoint,
                                               save_checkpoint)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev
    fault.configure(None)


def _arrays():
    rs = np.random.RandomState(0)
    return {'w': rs.rand(3, 4).astype('float32'),
            'i': rs.randint(-5, 5, (5,)).astype('int32'),
            'b': rs.rand(4) > 0.5}


def _tree(P, arrays):
    """Nested dicts and lists of the package's Tensors, bare arrays and
    Python values."""
    return {'params': {k: P.to_tensor(v) for k, v in arrays.items()},
            'step': P.to_tensor(np.float32(3.0)),
            'raw': dict(arrays),
            'meta': {'epoch': 2, 'name': 'x', 'lr': 0.5,
                     'hist': [P.to_tensor(arrays['w'][0]), 3]}}


def _value(x):
    if isinstance(x, (ref.Tensor, port.Tensor)):
        return np.asarray(x.numpy())
    return x


def _same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        g, w = _value(got), _value(want)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def _crcs(path):
    return [(a['key'], a['crc32'], a['dtype'], a['shape'])
            for a in json.load(open(path + '.manifest'))['arrays']]


def test_both_packages_write_the_same_bytes(tmp_path):
    ref.save(_tree(ref, _arrays()), str(tmp_path / 'r.pdparams'))
    port.save(_tree(port, _arrays()), str(tmp_path / 'p.pdparams'))
    assert (tmp_path / 'r.pdparams').read_bytes() == \
        (tmp_path / 'p.pdparams').read_bytes()
    assert _crcs(str(tmp_path / 'r.pdparams')) == \
        _crcs(str(tmp_path / 'p.pdparams'))


@pytest.mark.parametrize('writer', ['reference', 'port'])
def test_files_pass_between_the_packages(tmp_path, writer):
    w, r = (ref, port) if writer == 'reference' else (port, ref)
    path = str(tmp_path / 'ck.pdparams')
    w.save(_tree(w, _arrays()), path)
    got = r.load(path)
    _same(got, _tree(w, _arrays()))
    assert isinstance(got['params']['w'], r.Tensor)
    assert isinstance(got['raw']['w'], np.ndarray)
    if r is port:
        assert got['params']['w']._value.device.type == 'cpu'


def test_int64_follows_each_packages_convention(tmp_path):
    """An int64 Tensor entry loads as int32 (the port's and the
    reference's 64-bit rule); a bare int64 array stays int64 in both."""
    path = str(tmp_path / 'i64.pd')
    raw = np.arange(4, dtype=np.int64)
    with open(path, 'wb') as f:
        pickle.dump({'t': ('__tensor__', raw), 'a': raw}, f, protocol=4)
    got, want = port.load(path), ref.load(path)
    assert got['t'].dtype == port.int32 and want['t'].dtype == ref.int32
    assert got['a'].dtype == want['a'].dtype == np.int64
    np.testing.assert_array_equal(got['t'].numpy(), want['t'].numpy())


def _bf16_state():
    rs = np.random.RandomState(1)
    vals = torch.from_numpy(rs.randn(5, 3).astype('float32')).to(
        torch.bfloat16)
    return vals, {'w': port.to_tensor(vals.float().numpy()).astype(
        'bfloat16'), 'raw': vals.clone(), 'f': port.to_tensor([1.0]),
        'scalar': vals[0, 0].clone()}


def test_bf16_round_trips_bit_for_bit_as_a_tagged_view(tmp_path):
    vals, state = _bf16_state()
    path = str(tmp_path / 'bf.pdparams')
    port.save(state, path)
    with open(path, 'rb') as f:
        raw = pickle.load(f)
    assert raw['w'][0] == '__tensor_bf16__' and raw['w'][1].dtype == np.uint16
    assert raw['raw'][0] == '__bf16__'
    got = port.load(path)
    assert got['w'].dtype == port.bfloat16 and got['raw'].dtype == \
        torch.bfloat16
    assert torch.equal(got['w']._value.view(torch.int16),
                       vals.view(torch.int16))
    assert torch.equal(got['raw'].view(torch.int16), vals.view(torch.int16))
    assert got['scalar'].shape == () and torch.equal(got['scalar'],
                                                     vals[0, 0])
    # the reference reads the file; a bf16 entry stays the tagged tuple
    back = ref.load(path)
    assert back['w'][0] == '__tensor_bf16__'
    np.testing.assert_array_equal(back['f'].numpy(), [1.0])


def test_bf16_rule_holds_without_ml_dtypes(tmp_path):
    """The card's machine has no ml_dtypes: the port writes and reads bf16
    there bit for bit."""
    code = f'''
import sys
sys.modules['ml_dtypes'] = None
import torch
import paddle_tpu_torch as paddle
paddle.set_device('cpu')
v = torch.tensor([1.5, -2.25, 3e-3, 65504.0], dtype=torch.bfloat16)
paddle.save({{'w': paddle.Tensor(v), 'raw': v}}, {str(tmp_path / 'x.pd')!r})
got = paddle.load({str(tmp_path / 'x.pd')!r})
assert torch.equal(got['w']._value.view(torch.int16), v.view(torch.int16))
assert torch.equal(got['raw'].view(torch.int16), v.view(torch.int16))
import importlib.util
assert 'jax' not in sys.modules
print('ok')
'''
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, '-c', code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == 'ok', proc.stderr


def test_the_references_bf16_file_loads_in_the_port(tmp_path):
    path = str(tmp_path / 'rbf.pd')
    w = np.array([1.5, -2.25, 3e-3], 'float32')
    ref.save({'w': ref.to_tensor(w).astype('bfloat16')}, path)
    got = port.load(path)['w']
    assert got.dtype == port.bfloat16
    want = torch.from_numpy(w).to(torch.bfloat16)
    assert torch.equal(got._value.view(torch.int16), want.view(torch.int16))


def test_restricted_unpickler_refuses_code(tmp_path):
    path = str(tmp_path / 'evil.pdckpt')

    class Evil:
        def __reduce__(self):
            return (os.system, ('echo pwned',))

    with open(path, 'wb') as f:
        pickle.dump({'payload': Evil()}, f)
    with pytest.raises(UnsafePayloadError, match='system'):
        port.load(path)



def _global_call(module, name, *args):
    """A protocol-4 pickle that calls ``module``'s ``name`` (looked up
    through STACK_GLOBAL, which follows dotted names) on ``args``."""
    def s(x):
        b = x.encode()
        return b'\x8c' + bytes([len(b)]) + b
    return (b'\x80\x04' + s(module) + s(name) + b'\x93' + b'('
            + b''.join(s(a) if isinstance(a, str) else
                       (b'N' if a is None else (b'\x88' if a else b'\x89'))
                       for a in args) + b'tR.')


@pytest.mark.parametrize('module,name,args', [
    ('numpy', 'lib.format.os.system', ('echo pwned',)),
    ('numpy', 'load', ('elsewhere.npy', None, True)),
    ('numpy.core.multiarray', '_reconstruct.__globals__', ()),
    ('ml_dtypes', '__builtins__', ()),
], ids=['dotted-to-os.system', 'numpy.load', 'dotted-allowed-name',
        'ml_dtypes-dunder'])
def test_restricted_unpickler_refuses_names_beyond_the_array_globals(
        tmp_path, module, name, args):
    """Only the exact (module, name) pairs that numpy arrays pickle through
    are admitted: an unlisted name of an allowed module, or a dotted path
    from one, is refused before anything runs."""
    path = str(tmp_path / 'evil.pdckpt')
    with open(path, 'wb') as f:
        f.write(_global_call(module, name, *args))
    with pytest.raises(UnsafePayloadError, match=re.escape(name)):
        port.load(path)


def _sample():
    return {'w': np.arange(12, dtype='float32').reshape(3, 4),
            'b': np.ones(3, dtype='float32'),
            'meta': {'epoch': 2, 'name': 'x'}}


def test_save_writes_manifest_with_crcs(tmp_path):
    path = str(tmp_path / 'ck.pdckpt')
    port.save(_sample(), path)
    man = json.load(open(path + '.manifest'))
    assert man['format_version'] == 1
    assert man['payload_size'] == os.path.getsize(path)
    assert man['payload_crc32'] == zlib.crc32(open(path, 'rb').read())
    arrays = {a['key']: a for a in man['arrays']}
    assert arrays['w']['shape'] == [3, 4] and arrays['w']['dtype'] == \
        'float32'
    np.testing.assert_array_equal(port.load(path)['w'], _sample()['w'])


@pytest.mark.parametrize('damage', ['byte_flip', 'truncation', 'manifest'])
def test_corruption_raises(tmp_path, damage):
    path = str(tmp_path / 'ck.pdckpt')
    port.save(_sample(), path)
    raw = bytearray(open(path, 'rb').read())
    if damage == 'byte_flip':
        raw[len(raw) // 2] ^= 0xFF
        open(path, 'wb').write(bytes(raw))
    elif damage == 'truncation':
        open(path, 'wb').write(bytes(raw[:len(raw) // 2]))
    else:
        open(path + '.manifest', 'w').write('{not json')
    with pytest.raises(CheckpointCorruptError):
        port.load(path)


def test_directory_load_falls_back_to_intact(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    mgr.save(1, {'v': np.array([1.0])})
    mgr.save(2, {'v': np.array([2.0])})
    newest = tmp_path / 'ckpt-2.pdckpt'
    raw = bytearray(newest.read_bytes())
    raw[0] ^= 0xFF
    newest.write_bytes(bytes(raw))
    np.testing.assert_array_equal(port.load(str(tmp_path))['v'], [1.0])
    # the reference makes the same choice in the same directory
    np.testing.assert_array_equal(np.asarray(ref.load(str(tmp_path))['v']),
                                  [1.0])


def test_a_fault_mid_save_leaves_the_previous_file(tmp_path):
    path = str(tmp_path / 'ck.pdckpt')
    port.save({'v': np.array([1.0])}, path)
    fault.configure('ckpt.write:1.0:raise', max_faults=1)
    with pytest.raises(fault.InjectedFault):
        port.save({'v': np.array([2.0])}, path)
    assert fault.fired_count() == 1
    np.testing.assert_array_equal(port.load(path)['v'], [1.0])
    assert [f for f in os.listdir(tmp_path) if '.tmp.' in f] == []
    # torn debris a killed writer left is swept by the next save
    (tmp_path / f'ck.pdckpt.tmp.{os.getpid() + 1}').write_bytes(b'torn')
    port.save({'v': np.array([3.0])}, path)
    assert [f for f in os.listdir(tmp_path) if '.tmp.' in f] == []
    np.testing.assert_array_equal(port.load(path)['v'], [3.0])


def test_checkpoint_manager_keep_period_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, keep_period=2)
    for step in range(6):
        mgr.save(step, {'v': np.array([float(step)])})
    # keep_period multiples (0, 2, 4) survive GC; max_to_keep keeps 4, 5
    assert mgr.all_steps() == [0, 2, 4, 5]
    assert not (tmp_path / 'ckpt-1.pdckpt.manifest').exists()


def test_checkpoint_save_retries_through_transient_fault(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_retries=3)
    fault.configure('ckpt.write:1.0:raise', max_faults=1)
    mgr.save(7, {'v': np.array([7.0])})     # first attempt faulted, retried
    fault.configure(None)
    np.testing.assert_array_equal(mgr.restore(7)['v'], [7.0])
    fault.configure('ckpt.write:1.0:raise')
    with pytest.raises(RetryError):
        CheckpointManager(str(tmp_path), save_retries=2).save(
            8, {'v': np.array([8.0])})
    assert mgr.all_steps() == [7]


def test_latest_verified_step_skips_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    mgr.save(3, {'v': np.array([3.0])})
    mgr.save(9, {'v': np.array([9.0])})
    assert latest_verified_step(str(tmp_path)) == mgr.latest_step() == 9
    raw = bytearray((tmp_path / 'ckpt-9.pdckpt').read_bytes())
    raw[1] ^= 0xFF
    (tmp_path / 'ckpt-9.pdckpt').write_bytes(bytes(raw))
    assert latest_verified_step(str(tmp_path)) == 3
    # the reference's manager agrees on the port's directory
    from paddle_tpu.utils.checkpoint import \
        latest_verified_step as ref_latest
    assert ref_latest(str(tmp_path)) == 3


def test_orbax_backend_names_the_local_one(tmp_path):
    with pytest.raises(ValueError, match="'local'"):
        CheckpointManager(str(tmp_path), backend='orbax')


def test_save_load_checkpoint_and_auto_resume(tmp_path):
    d = str(tmp_path / 'ck')
    state, start = auto_resume(d, lambda: {'v': np.zeros(2)})
    assert start == 0 and state['v'].tolist() == [0.0, 0.0]
    save_checkpoint(d, {'v': np.ones(2)}, step=4)
    np.testing.assert_array_equal(load_checkpoint(d)['v'], np.ones(2))
    state, start = auto_resume(d, lambda: {'v': np.zeros(2)})
    assert start == 5 and state['v'].tolist() == [1.0, 1.0]
    # the reference resumes from the port's directory at the same step
    from paddle_tpu.utils.checkpoint import auto_resume as ref_resume
    assert ref_resume(d, lambda: None)[1] == 5


def test_retry_schedule_under_a_fake_clock():
    now, slept, calls = [0.0], [], []

    def sleep(s):
        slept.append(s)
        now[0] += s

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError('transient')
        return 'done'

    assert fault.retry(flaky, retries=3, backoff=0.1, factor=2.0,
                       clock=lambda: now[0], sleep=sleep) == 'done'
    assert slept == pytest.approx([0.1, 0.2])
    with pytest.raises(RetryError) as e:
        fault.retry(lambda: 1 / 0, retries=5, backoff=1.0, deadline=2.5,
                    exceptions=(ZeroDivisionError,),
                    clock=lambda: now[0], sleep=sleep)
    assert e.value.attempts == 2 and isinstance(e.value.last_exception,
                                                ZeroDivisionError)
    with pytest.raises(KeyError):        # not retried
        fault.retry(lambda: {}['x'], exceptions=(OSError,), sleep=sleep)
