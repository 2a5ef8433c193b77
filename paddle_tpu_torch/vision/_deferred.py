"""The names of ``vision`` beyond the models (ROADMAP Queue 1 item 9,
step H (rest)): datasets, transforms, ops, detection and the image
backend. Each exists under its reference module path and raises
``NotImplementedError`` citing that step when called or constructed."""
from .. import _deferred

WHY = 'is not ported yet (ROADMAP Queue 1 item 9, step H (rest))'


def install(namespace, functions=(), classes=()):
    """Put deferred functions and classes into a module's namespace
    (``namespace['__name__']`` names them)."""
    _deferred.install(namespace, WHY, functions, classes)
