"""Names that exist under their reference module paths but are not ported
yet: each raises ``NotImplementedError`` citing its ROADMAP step when
called or constructed."""


def function(qualname, why):
    def fn(*args, **kwargs):
        raise NotImplementedError(f'{qualname} {why}')
    fn.__name__ = fn.__qualname__ = qualname.rsplit('.', 1)[-1]
    fn.__doc__ = f'{qualname} {why}.'
    return fn


def klass(qualname, why):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f'{qualname} {why}')
    name = qualname.rsplit('.', 1)[-1]
    return type(name, (), {'__init__': __init__,
                           '__doc__': f'{qualname} {why}.'})


def install(namespace, why, functions=(), classes=()):
    """Put deferred functions and classes into a module's namespace
    (``namespace['__name__']`` names them, with Paddle's package name)."""
    mod = namespace['__name__'].replace('paddle_tpu_torch', 'paddle')
    for n in functions:
        namespace[n] = function(f'{mod}.{n}', why)
    for n in classes:
        namespace[n] = klass(f'{mod}.{n}', why)
        namespace[n].__module__ = namespace['__name__']
