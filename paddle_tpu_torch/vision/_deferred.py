"""The names of ``vision`` beyond the models (ROADMAP Queue 1 item 9,
step H (rest)): datasets, transforms, ops, detection and the image
backend. Each exists under its reference module path and raises
``NotImplementedError`` citing that step when called or constructed."""

WHY = 'is not ported yet (ROADMAP Queue 1 item 9, step H (rest))'


def _function(qualname):
    def fn(*args, **kwargs):
        raise NotImplementedError(f'{qualname} {WHY}')
    fn.__name__ = fn.__qualname__ = qualname.rsplit('.', 1)[-1]
    fn.__doc__ = f'{qualname} {WHY}.'
    return fn


def _class(qualname):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f'{qualname} {WHY}')
    name = qualname.rsplit('.', 1)[-1]
    return type(name, (), {'__init__': __init__,
                           '__doc__': f'{qualname} {WHY}.'})


def install(namespace, functions=(), classes=()):
    """Put deferred functions and classes into a module's namespace
    (``namespace['__name__']`` names them)."""
    mod = namespace['__name__'].replace('paddle_tpu_torch', 'paddle')
    for n in functions:
        namespace[n] = _function(f'{mod}.{n}')
    for n in classes:
        namespace[n] = _class(f'{mod}.{n}')
        namespace[n].__module__ = namespace['__name__']
