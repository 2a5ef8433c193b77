"""paddle_tpu_torch.serving — continuous-batching LLM serving on the card.

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import GenerationEngine
    cfg = gpt.GPTConfig(vocab_size=32768, hidden_size=1024, num_layers=24,
                        num_heads=16, max_seq_len=1024, dtype='bfloat16')
    gen = torch.Generator(device='cuda').manual_seed(0)
    params = gpt.init_params(cfg, gen, 'cuda')
    with GenerationEngine(params, cfg, num_slots=8, page_size=128) as eng:
        eng.warmup()
        toks = eng.submit(prompt_ids, max_new_tokens=32).result()

``GenerationEngine(..., precision='int8_wo')`` serves weight-only int8
matrices; ``prefix_cache=True`` reuses the KV pages of earlier requests
(``PrefixCache``). The batch ``InferenceEngine``, the fleet router and the
model host are not ported yet (ROADMAP Queue 1).
"""
from .errors import (DeadlineExceededError, EngineClosedError,  # noqa: F401
                     QueueFullError)
from .generation import GenerationEngine, GenerationFuture  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401

__all__ = ['GenerationEngine', 'GenerationFuture', 'PrefixCache',
           'QueueFullError', 'DeadlineExceededError', 'EngineClosedError']
