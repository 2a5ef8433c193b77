"""FFT ops (``paddle_tpu/tensor/fft.py``): not ported yet, ROADMAP Queue 1
item 6's next slice. Every one raises."""

_TODO = 'is not ported yet (ROADMAP Queue 1 item 6: fft and signal)'


def _deferred(module, name):
    def fn(*args, **kwargs):
        raise NotImplementedError(f'paddle.{module}.{name} {_TODO}')
    fn.__name__ = fn.__qualname__ = name
    return fn


for _name in ('fft', 'ifft', 'rfft', 'irfft', 'fft2', 'ifft2', 'fftn',
              'ifftn', 'rfft2', 'irfft2', 'hfft', 'ihfft', 'fftshift',
              'ifftshift', 'fftfreq', 'rfftfreq'):
    globals()[_name] = _deferred('fft', _name)
