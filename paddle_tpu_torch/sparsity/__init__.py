"""ASP n:m structured sparsity (``paddle_tpu/sparsity``): not ported yet,
ROADMAP Queue 1 step M. Every public name raises; hapi's ``Model`` has no
masks to re-apply until it lands."""

_TODO = 'is not ported yet (ROADMAP Queue 1 step M: sparsity)'


def _deferred(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(f'paddle.sparsity.{name} {_TODO}')
    fn.__name__ = fn.__qualname__ = name
    return fn


for _name in ('calculate_density', 'create_mask', 'check_sparsity',
              'check_mask_1d', 'check_mask_2d', 'get_mask_1d',
              'get_mask_2d_greedy', 'get_mask_2d_best', 'prune_model',
              'prune_tree', 'apply_mask_tree', 'decorate',
              'set_excluded_layers', 'reset_excluded_layers'):
    globals()[_name] = _deferred(_name)
