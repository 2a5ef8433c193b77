"""Build and load the port's CUDA kernels.

Each kernel source ``paddle_tpu_torch/csrc/<name>.cu`` has a plain C
interface. It is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``paddle_tpu_torch/_build/`` at first use, and
loaded with ``ctypes``. The library's file name carries a hash of the
source and the flags, so an edited source is rebuilt and a stale build is
never loaded. The build directory sits inside the package, so the port is
run from a checkout (or an editable install), where it is writable. Nothing here runs at import: the CPU tests import every
module of the port on a machine with no ``nvcc``.
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


def _compile(name, src, out):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', tmp, str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed building {name} '
                           f'({" ".join(cmd)}):\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    build_log[name] = {'seconds': secs, 'ptxas': proc.stderr.strip()}


def load(name):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f'{name}.cu'
        digest = hashlib.sha1(src.read_bytes()
                              + ' '.join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f'lib{name}-{digest[:12]}.so'
        if out.exists():
            build_log.setdefault(name, {'seconds': 0.0, 'ptxas': ''})
        else:
            _compile(name, src, out)
        lib = _libs[name] = ctypes.CDLL(str(out))
        return lib
