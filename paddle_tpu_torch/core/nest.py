"""Walking the nested dicts, lists and tuples that batches, state dicts
and checkpoint payloads are made of."""


def map_nested(fn, obj, is_leaf=None):
    """``fn`` over the leaves of nested dicts, lists and tuples, keeping
    each container's type; a leaf is anything else, or anything that
    ``is_leaf`` accepts."""
    if is_leaf is not None and is_leaf(obj):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_nested(fn, v, is_leaf) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_nested(fn, v, is_leaf) for v in obj)
    return fn(obj)
