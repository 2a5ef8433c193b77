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
