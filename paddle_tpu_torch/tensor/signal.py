"""Signal ops (``paddle_tpu/tensor/signal.py``): not ported yet, ROADMAP
Queue 1 item 6's next slice. Every one raises."""
from .fft import _deferred

for _name in ('frame', 'overlap_add', 'stft', 'istft'):
    globals()[_name] = _deferred('signal', _name)
