"""Signal ops: frame, overlap_add, stft, istft (port of
``paddle_tpu/tensor/signal.py``, its layouts included: ``frame`` along
the last axis gives [..., frame_length, n_frames], ``stft``
[..., freq, n_frames])."""
import math

import torch
import torch.nn.functional as F

from ..core.dispatch import op, to_float
from ..core.tensor import Tensor

# jnp.pad's mode names -> torch's
_PAD_MODES = {'reflect': 'reflect', 'constant': 'constant',
              'edge': 'replicate', 'wrap': 'circular'}


@op
def frame(x, frame_length, hop_length, axis=-1, name=None):
    frames = x.movedim(axis, -1).unfold(-1, frame_length, hop_length)
    if axis in (-1, x.dim() - 1):    # [..., n_frames, frame_length]
        return frames.transpose(-1, -2)
    return frames


def _overlap_add(frames, hop_length):
    """Sum of [..., n_frames, L] frames laid ``hop_length`` apart ->
    [..., L + hop_length * (n_frames - 1)], frame 0 added first."""
    n_frames, length = frames.shape[-2], frames.shape[-1]
    out_len = length + hop_length * (n_frames - 1)
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop_length
           + torch.arange(length, device=frames.device)[None, :])
    out = frames.new_zeros(frames.shape[:-2] + (out_len,))
    return out.index_add(-1, idx.reshape(-1),
                         frames.reshape(frames.shape[:-2] + (-1,)))


@op
def overlap_add(x, hop_length, axis=-1, name=None):
    # x: [..., frame_length, n_frames] (axis=-1 layout)
    moved = x.movedim(axis, -1) if axis not in (-1, x.dim() - 1) else x
    return _overlap_add(moved.transpose(-1, -2), hop_length)


def _window(window, win_length, n_fft, device):
    if window is None:
        w = torch.ones(win_length, dtype=torch.float32, device=device)
    else:
        w = (window._value if isinstance(window, Tensor)
             else torch.as_tensor(window)).to(device=device,
                                              dtype=torch.float32)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        w = F.pad(w, (pad, n_fft - win_length - pad))
    return w


@op
def stft(x, n_fft, hop_length=None, win_length=None, window=None, center=True,
         pad_mode='reflect', normalized=False, onesided=True, name=None):
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    w = _window(window, win_length, n_fft, x.device)
    sig = to_float(x)
    if center:
        lead = sig.shape[:-1]
        flat = sig.reshape((-1,) + sig.shape[-1:])
        flat = F.pad(flat, (n_fft // 2, n_fft // 2),
                     mode=_PAD_MODES[pad_mode])
        sig = flat.reshape(lead + flat.shape[-1:])
    frames = sig.unfold(-1, n_fft, hop_length) * w   # [..., n_frames, n_fft]
    spec = torch.fft.rfft(frames, dim=-1) if onesided else \
        torch.fft.fft(frames, dim=-1)
    if normalized:
        spec = spec / math.sqrt(n_fft)
    return spec.transpose(-1, -2)                  # [..., freq, n_frames]


@op
def istft(x, n_fft, hop_length=None, win_length=None, window=None, center=True,
          normalized=False, onesided=True, length=None, return_complex=False,
          name=None):
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    w = _window(window, win_length, n_fft, x.device)
    spec = x.transpose(-1, -2)                      # [..., n_frames, freq]
    if normalized:
        spec = spec * math.sqrt(n_fft)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) if onesided else \
        torch.fft.ifft(spec, dim=-1).real
    frames = frames * w
    sig = _overlap_add(frames, hop_length)
    win_sq = _overlap_add(
        torch.square(w).expand(frames.shape[-2], n_fft), hop_length)
    sig = sig / torch.clamp(win_sq, min=1e-10)
    if center:
        sig = sig[..., n_fft // 2:-(n_fft // 2)]
    if length is not None:
        sig = sig[..., :length]
    return sig
