"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu, for NVIDIA Hopper.

The port mirrors the JAX package's module paths
(``paddle_tpu/ops/paged_kv.py`` <-> ``paddle_tpu_torch/ops/paged_kv.py``)
so every piece has an obvious counterpart, and each is held against the
JAX package by tests that feed both the same inputs. It never imports
``jax`` or ``paddle_tpu``: what it needs of the JAX package it keeps as
its own copy.

Implemented so far, for GPT: the serving path of
``serving.GenerationEngine`` (continuous batching over the paged KV pool,
bf16/f32 or int8), whose attention runs the hand-written Hopper kernels in
``csrc/paged_decode.cu``; ``models.gpt.GPTForCausalLM`` with its plain
forward and ``generate()`` over the dense KV cache (bf16/f32 or int8),
whose attention runs ``csrc/flash_fwd.cu`` and ``csrc/flash_decode.cu``;
and the single-device train step (``models.gpt.make_train_step`` with
``optimizer.AdamW`` and the blockwise LM-head loss ``ops/xent.py``),
whose attention backward runs ``csrc/flash_bwd.cu``.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
with no card and no explicit CPU request they raise (``resolve_device``)
instead of quietly running on the host.

The eager Paddle API runs on the card too: ``import paddle_tpu_torch as
paddle`` gives ``paddle.to_tensor``, ``Tensor.backward()``,
``paddle.grad``, ``PyLayer`` and the ``paddle.tensor`` op library over
torch's autograd, with the JAX package's module paths (``core/``,
``autograd/``, ``device/``, ``tensor/``), and ``paddle.amp``
(``auto_cast`` in bfloat16, float16 and float8, ``GradScaler``).
``paddle.set_device('cpu')`` runs it on the host.

fp8 training: ``GPTConfig(matmul_precision='fp8')`` (and MoE's) runs the
block matmuls through ``quantization/fp8.py``'s delayed-scaling product,
on the card's fp8 tensor cores.

``paddle.nn`` (``Layer``, ``Parameter``, the MLP, transformer, conv,
pooling, RNN and quantized layers; ``scaled_dot_product_attention`` on
the flash kernels), ``paddle.optimizer`` (the eager ``step()`` with
groups, clipping, regularizers and the LR schedulers), ``paddle.
regularizer`` and ``paddle.vision.models`` (LeNet, ResNet, VGG,
MobileNet) run Paddle programs that build a model from layers and train
it with ``opt.step()``.

``paddle.jit.save`` / ``load`` (the forward exported with
``torch.export``), ``paddle.inference`` (the Predictor, layer-free over the
exported program or over an attached Layer on CUDA graphs),
``paddle.serving.InferenceEngine`` (dynamic batching over one captured
graph per bucket), ``paddle.warmup`` (capture manifests) and
``models.ernie`` (ERNIE, served and pretrained) serve a trained model.

``paddle.io`` (datasets, samplers, the DataLoader over the native worker
pool, ``prefetch_to_device``), ``paddle.save`` / ``paddle.load`` (the JAX
package's file format, atomic and CRC-checked), ``utils.checkpoint``,
``paddle.metric`` and hapi's ``paddle.Model`` (``fit`` / ``evaluate`` /
``predict``, the callbacks, ``AutoResume``) run the training loop users
write on top of layers; ``paddle.fft`` and ``paddle.signal`` run on
``torch.fft``.
"""
import torch

__version__ = '0.1.0'


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` by default, whatever the
    caller names otherwise. Raises when CUDA is asked for (explicitly or by
    default) and the process has no usable card — the port never falls
    back to the CPU on its own."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'paddle_tpu_torch runs on a CUDA device and none is available; '
            "pass device='cpu' to run the plain PyTorch path on the host")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev}; use cuda or cpu')
    return dev


from .core.dtype import (  # noqa: E402,F401
    bool, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
    float64, complex64, complex128)
from .core.tensor import Tensor, to_tensor  # noqa: E402,F401
from .autograd import no_grad, enable_grad  # noqa: E402,F401
from .tensor import *  # noqa: E402,F401,F403
from .tensor import fft, signal  # noqa: E402,F401
from .tensor.random import seed, get_rng_state, set_rng_state  # noqa: E402,F401
from .tensor import linalg  # noqa: E402,F401
from . import autograd  # noqa: E402,F401
from . import device  # noqa: E402,F401
from .autograd import grad  # noqa: E402,F401
from .device import (  # noqa: E402,F401
    CPUPlace, CUDAPlace, TPUPlace, device_count, get_device,
    is_compiled_with_cuda, set_device)
from .compat_api import (  # noqa: E402,F401
    VarBase, add_n, create_parameter, crop_tensor, diagonal, dtype,
    get_default_dtype, in_dygraph_mode, scatter_, set_default_dtype,
    set_grad_enabled, set_printoptions, t, tanh_, unique_consecutive, unstack)
from . import amp, quantization  # noqa: E402,F401
from . import nn, optimizer, regularizer  # noqa: E402,F401
from .nn.layer_base import ParamAttr  # noqa: E402,F401
from . import io, metric, reader, sparsity, utils  # noqa: E402,F401
from .framework_io import save, load  # noqa: E402,F401
from .hapi.model import Model  # noqa: E402,F401
from .hapi import summary, flops, callbacks  # noqa: E402,F401
from . import hapi  # noqa: E402,F401
from . import callbacks as callbacks_mod  # noqa: E402,F401
from .batch import batch  # noqa: E402,F401
from . import jit, static  # noqa: E402,F401
from . import profiler  # noqa: E402,F401

_LAZY = ('vision', 'inference', 'models', 'serving', 'warmup',
         'distributed')


def __getattr__(name):
    """``paddle.vision``, ``paddle.inference``, ``paddle.models``,
    ``paddle.serving``, ``paddle.warmup`` and ``paddle.distributed`` on
    first use, as the reference imports them (and ``paddle.DataParallel``,
    the reference's top-level name for ``distributed.DataParallel``)."""
    if name == 'DataParallel':
        from .distributed.parallel import DataParallel
        return DataParallel
    if name in _LAZY:
        import importlib
        return importlib.import_module(f'.{name}', __name__)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
