"""Build and load the port's CUDA kernels.

Each kernel source ``paddle_tpu_torch/csrc/<name>.cu`` has a plain C
interface. It is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``paddle_tpu_torch/_build/`` at first use, and
loaded with ``ctypes``. The library's file name carries a hash of the
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source or header is rebuilt and a stale build is never loaded. The build
directory sits inside the package, so the port is run from a checkout (or
an editable install), where it is writable. ``build`` compiles several
sources at once, one ``nvcc`` each. Nothing here runs at import: the CPU
tests import every module of the port on a machine with no ``nvcc``.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_libs = {}
# name -> {'seconds': build time (0.0 when an earlier build was reused),
#          'ptxas': the compiler's register / shared-memory report}
build_log = {}


def nvcc_path():
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the CUDA
    toolkit's default prefix. Raises when none exists."""
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    for cand in ((os.path.join(home, 'bin', 'nvcc') if home else None),
                 shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: building the CUDA kernels needs the '
                       'CUDA toolkit (set CUDA_HOME)')


def source_digest(name, csrc=CSRC):
    """Hash of what ``csrc/<name>.cu`` builds from: the source, every
    shared header ``csrc/*.cuh`` (a source may include any of them) and
    the compiler flags. An edit to any of them names a new library."""
    csrc = Path(csrc)
    h = hashlib.sha1((csrc / f'{name}.cu').read_bytes())
    for hdr in sorted(csrc.glob('*.cuh')):
        h.update(hdr.name.encode() + b'\0' + hdr.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _lib_path(name):
    return BUILD_DIR / f'lib{name}-{source_digest(name)[:12]}.so'


def build(names):
    """Build the libraries of ``names`` that are not built yet: one
    ``nvcc`` for each source, all started together, then waited for.
    Raises on the first that fails (after every compiler has ended)."""
    with _lock:
        _build_locked(names)


def _build_locked(names):
    todo = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            build_log.setdefault(name, {'seconds': 0.0, 'ptxas': ''})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, '-o', tmp, str(CSRC / f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        todo.append((name, cmd, tmp, out, proc, time.perf_counter()))
    failed = []
    for name, cmd, tmp, out, proc, t0 in todo:
        stdout, stderr = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f'nvcc failed building {name} ({" ".join(cmd)}):'
                          f'\n{stdout}{stderr}')
            continue
        os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
        build_log[name] = {'seconds': secs, 'ptxas': stderr.strip()}
    if failed:
        raise RuntimeError('\n'.join(failed))


def load(name):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _build_locked([name])
        lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib
