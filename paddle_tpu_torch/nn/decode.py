"""Sequence decoding. Port of ``paddle_tpu/nn/decode.py``.

Kept from the reference: ``dynamic_decode`` decodes greedily whatever
``beam_size`` is (one token a batch row and step, the argmax of the
log-softmax in float32), and stops once every row emits ``end_token``,
which reads a bool back from the device each step. The ids and scores
carry no gradient (the reference computes them off its tape).
"""
import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor, wrap
from ..device import current_device


class BeamSearchDecoder:
    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B * beam_size, ...], each row repeated in place."""
        return apply_op(lambda v: torch.repeat_interleave(v, beam_size, 0),
                        x)


def dynamic_decode(decoder, inits=None, max_step_num=32, **kwargs):
    """Decode with ``decoder.cell`` from ``inits`` -> (ids [B, steps]
    int32, the summed log-probabilities [B] float32)."""
    cell, end = decoder.cell, decoder.end_token
    state = inits
    if state is not None:
        s0 = state[0] if isinstance(state, (tuple, list)) else state
        batch, device = s0.shape[0], s0._value.device
    else:
        batch, device = 1, current_device()
    tok = wrap(torch.full((batch,), decoder.start_token, dtype=torch.int32,
                          device=device))
    ids = torch.zeros((batch, 0), dtype=torch.int32, device=device)
    scores = torch.zeros((batch,), dtype=torch.float32, device=device)
    for _ in range(max_step_num):
        emb = decoder.embedding_fn(tok) if decoder.embedding_fn else tok
        out, state = cell(emb, state)
        logits = decoder.output_fn(out) if decoder.output_fn else out
        lv = logits._value if isinstance(logits, Tensor) else logits
        logp = torch.log_softmax(lv.detach().float(), -1)
        nxt = torch.argmax(logp, -1)
        scores = scores + torch.gather(logp, 1, nxt[:, None])[:, 0]
        nxt = nxt.to(torch.int32)
        ids = torch.cat([ids, nxt[:, None]], 1)
        tok = wrap(nxt)
        if bool(torch.all(nxt == end)):
            break
    return wrap(ids), wrap(scores)
