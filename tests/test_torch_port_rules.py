"""Rules the PyTorch/CUDA port keeps: it imports neither JAX nor the JAX
package, its entry points refuse to run on a machine without a card
unless the CPU is asked for, and chip_smoke.py reports nothing without a
card or without the port beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import GenerationEngine

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / 'paddle_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'paddle_tpu')


def _imports(path):
    """Absolute module names imported by one source file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''
        elif (isinstance(node, ast.Call)
              and getattr(node.func, 'attr', getattr(node.func, 'id', ''))
              in ('import_module', '__import__') and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(name):
    top = name.split('.')[0]
    return top in FORBIDDEN


@pytest.mark.parametrize('path', sorted(PORT.rglob('*.py')) +
                         [ROOT / 'chip_smoke.py'],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f'{path.relative_to(ROOT)} imports {bad}'


def test_the_scan_covers_the_training_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob('*.py')}
    assert {'optimizer/__init__.py', 'optimizer/optimizer.py',
            'ops/xent.py', 'ops/flash_attention.py'} <= scanned


def test_the_scan_sees_forbidden_imports(tmp_path):
    f = tmp_path / 'probe.py'
    f.write_text('import jax.numpy as jnp\nfrom paddle_tpu.ops import x\n'
                 'import importlib\n'
                 'importlib.import_module("paddle_tpu.ops")\n'
                 'from . import paged_kv\nimport paddle_tpu_torch\n')
    found = [n for n in _imports(f) if _forbidden(n)]
    assert found == ['jax.numpy', 'paddle_tpu.ops', 'paddle_tpu.ops']


def _tiny():
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                         num_heads=2, max_seq_len=16, dtype='float32')
    return tgpt.init_params(cfg, torch.Generator().manual_seed(0),
                            'cpu'), cfg


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    params, cfg = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEngine(params, cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        paddle_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match='CUDA'):
        paddle_tpu_torch.resolve_device('cuda:0')
    assert paddle_tpu_torch.resolve_device('cpu') == torch.device('cpu')
    eng = GenerationEngine(params, cfg, device='cpu', autostart=False)
    assert eng.device == torch.device('cpu')
    eng.shutdown()


def _smoke(cwd, env):
    return subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_card_or_port(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    env.pop('PYTHONPATH', None)
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(ROOT / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
        proc = _smoke(cwd, env)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_kernel_source_exports_the_c_entry_point():
    src = (PORT / 'csrc' / 'paged_decode.cu').read_text()
    assert 'extern "C"' in src and 'int paged_decode(' in src
    assert 'cudaGetLastError()' in src


def test_the_generate_model_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    params, cfg = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.GPTForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.GPTForCausalLM(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.init_kv_cache(cfg, 1)
    model = tgpt.GPTForCausalLM(cfg, params, device='cpu')
    assert model.device == torch.device('cpu')
    assert tgpt.init_kv_cache(cfg, 1, 'cpu')['k'].device.type == 'cpu'


@pytest.mark.parametrize('src,entries', [
    ('flash_decode.cu', ('flash_decode', 'flash_decode_int8')),
    ('flash_fwd.cu', ('flash_fwd',)),
    ('flash_bwd.cu', ('flash_bwd_dq', 'flash_bwd_dkv')),
])
def test_new_kernel_sources_export_their_c_entry_points(src, entries):
    text = (PORT / 'csrc' / src).read_text()
    assert 'extern "C"' in text and '#include "attention.cuh"' in text
    head, _, body = text.partition('extern "C" {')
    for name in entries + ('attn_error_string',):
        assert f'int {name}(' in body or f'* {name}(' in body, name
    assert 'cudaGetLastError()' in (PORT / 'csrc' / 'attention.cuh'
                                    ).read_text()


class _CudaStandIn(torch.Tensor):
    """A CPU tensor that reports itself on the card: what a wrapper does
    with a CUDA tensor up to its library load, on a machine with none."""

    @property
    def device(self):
        return torch.device('cuda')


@pytest.mark.parametrize('op', ['flash_decode', 'flash_decode_int8',
                                'flash_fwd'])
def test_a_cuda_call_raises_when_its_kernel_cannot_load(monkeypatch, op):
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as tfa

    def no_library(name):
        raise RuntimeError(f'nvcc not found building {name}')

    def twin(*a, **k):
        raise AssertionError('a CUDA tensor ran the plain twin')

    monkeypatch.setattr(_build, 'load', no_library)
    monkeypatch.setattr(tfa, '_libs', {})
    for name in ('flash_decode_reference', 'flash_decode_int8_reference',
                 'flash_fwd_reference'):
        monkeypatch.setattr(tfa, name, twin)

    def card(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype).as_subclass(_CudaStandIn)

    q = card((2, 1, 4, 64))
    pos = card((1,), torch.int32)
    with pytest.raises(RuntimeError, match=f'nvcc not found building '
                       f'{op.replace("_int8", "")}'):
        if op == 'flash_decode':
            kc = card((2, 16, 4, 64))
            tfa.decode_attention(q, kc, kc, pos)
        elif op == 'flash_decode_int8':
            bank = {'int8': card((2, 16, 4, 64), torch.int8),
                    'scale': card((2, 16, 4), torch.float32)}
            tfa.decode_attention(q, bank, bank, pos)
        else:
            tfa.flash_attention(card((2, 8, 4, 64)), card((2, 8, 4, 64)),
                                card((2, 8, 4, 64)), causal=True)
    assert getattr(tfa, op).launches == 0


def test_the_paged_source_exports_the_int8_entry_point():
    src = (PORT / 'csrc' / 'paged_decode.cu').read_text()
    _, _, body = src.partition('extern "C" {')
    assert 'int paged_decode_int8(' in body
    assert 'paged_instances<__nv_bfloat16, int8_t>' in src


@pytest.mark.parametrize('op', ['flash_bwd', 'paged_decode_int8'])
def test_a_cuda_training_or_int8_call_raises_when_its_kernel_cannot_load(
        monkeypatch, op):
    """Kernels 2, 3 and 7: a CUDA tensor launches the kernel or raises;
    the plain twin never runs for it."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as tfa
    from paddle_tpu_torch.ops import paged_attention as tpa

    def no_library(name):
        raise RuntimeError(f'nvcc not found building {name}')

    def twin(*a, **k):
        raise AssertionError('a CUDA tensor ran the plain twin')

    monkeypatch.setattr(_build, 'load', no_library)
    monkeypatch.setattr(tfa, '_libs', {})
    monkeypatch.setattr(tpa, '_lib', None)
    for mod, name in ((tfa, 'flash_bwd_reference'),
                      (tpa, 'paged_decode_int8_reference'),
                      (tpa, 'paged_decode_reference')):
        monkeypatch.setattr(mod, name, twin)

    def card(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype).as_subclass(_CudaStandIn)

    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches,
              tpa.paged_flash_decode_int8.launches)
    with pytest.raises(RuntimeError, match=f'nvcc not found building '
                       f'{op.replace("_int8", "")}'):
        if op == 'flash_bwd':
            x = card((2, 8, 4, 64))
            lse = card((2, 4, 8), torch.float32)
            tfa._flash_bwd(x, x, x, x, x, lse, True)
        else:
            bank = {'int8': card((3, 16, 4, 64), torch.int8),
                    'scale': card((3, 16, 4), torch.float32)}
            tpa.paged_attention(card((2, 1, 4, 64)), bank, bank,
                                card((2, 2), torch.int32),
                                card((2,), torch.int32))
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches,
            tpa.paged_flash_decode_int8.launches) == before


def test_a_header_edit_changes_every_build_digest(tmp_path):
    from paddle_tpu_torch.ops import _build
    csrc = tmp_path / 'csrc'
    shutil.copytree(PORT / 'csrc', csrc)
    names = sorted(p.stem for p in csrc.glob('*.cu'))
    assert {'paged_decode', 'flash_decode', 'flash_fwd',
            'flash_bwd'} <= set(names)
    before = {n: _build.source_digest(n, csrc) for n in names}
    assert before == {n: _build.source_digest(n) for n in names}
    hdr = csrc / 'attention.cuh'
    hdr.write_bytes(hdr.read_bytes() + b'\n// one more line\n')
    after = {n: _build.source_digest(n, csrc) for n in names}
    assert all(before[n] != after[n] for n in names)
