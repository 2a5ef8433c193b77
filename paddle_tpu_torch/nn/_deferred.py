"""Names of the rest of ``nn`` (ROADMAP Queue 1 item 7, step J3): conv,
pooling, RNN, decoding, quantized layers and the functional extensions.
Each exists under its reference module path and raises
``NotImplementedError`` citing step J3 when called or constructed."""
from .layer_base import Layer

WHY = 'is not ported yet (ROADMAP Queue 1 item 7, step J3: the rest of nn)'


def _function(qualname):
    def fn(*args, **kwargs):
        raise NotImplementedError(f'{qualname} {WHY}')
    fn.__name__ = fn.__qualname__ = qualname.rsplit('.', 1)[-1]
    fn.__doc__ = f'{qualname} {WHY}.'
    return fn


def _class(qualname, base=Layer):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f'{qualname} {WHY}')
    name = qualname.rsplit('.', 1)[-1]
    return type(name, (base,), {'__init__': __init__,
                                '__doc__': f'{qualname} {WHY}.'})


def install(namespace, functions=(), layers=(), classes=()):
    """Put deferred functions, Layer subclasses and plain classes into a
    module's namespace (``namespace['__name__']`` names them)."""
    mod = namespace['__name__'].replace('paddle_tpu_torch', 'paddle')
    for n in functions:
        namespace[n] = _function(f'{mod}.{n}')
    for n in layers:
        namespace[n] = _class(f'{mod}.{n}')
        namespace[n].__module__ = namespace['__name__']
    for n in classes:
        namespace[n] = _class(f'{mod}.{n}', object)
        namespace[n].__module__ = namespace['__name__']
