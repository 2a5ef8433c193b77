"""High-level API (hapi; port of ``paddle_tpu/hapi``): ``Model``, the
callbacks, ``summary`` and ``flops``."""
from .model import Model  # noqa: F401
from . import callbacks  # noqa: F401


def _numel(p):
    n = 1
    for d in p.shape:
        n *= d
    return n


def summary(net, input_size=None, dtypes=None, input=None):
    """Layer-by-layer parameter summary (printed) -> {'total_params',
    'trainable_params'}."""
    rows = []
    total = 0
    trainable = 0
    for name, layer in net.named_sublayers(include_self=True):
        n_params = sum(_numel(p) for p in layer._parameters.values()
                       if p is not None)
        if n_params or not layer._sub_layers:
            rows.append((name or type(net).__name__, type(layer).__name__,
                         n_params))
    for p in net.parameters():
        n = _numel(p)
        total += n
        if p.trainable:
            trainable += n
    width = max([len(r[0]) for r in rows] + [10]) + 2
    lines = [f'{"Layer":{width}}{"Type":24}{"Params":>12}', '-' * (width + 36)]
    for r in rows:
        lines.append(f'{r[0]:{width}}{r[1]:24}{r[2]:>12,}')
    lines.append('-' * (width + 36))
    lines.append(f'Total params: {total:,}')
    lines.append(f'Trainable params: {trainable:,}')
    print('\n'.join(lines))
    return {'total_params': total, 'trainable_params': trainable}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Rough FLOPs estimate: 2 * in * out for each Linear, and for each
    Conv2D 2 * kh * kw * in * out over its output's spatial size / groups,
    the size taken as the input's shrunk by each conv's stride in layer
    order (the reference's estimate, as rough)."""
    from ..nn import Conv2D, Linear
    total = 0
    spatial = None
    if isinstance(input_size, (list, tuple)) and len(input_size) == 4:
        spatial = (input_size[2], input_size[3])
    for _, layer in net.named_sublayers(include_self=True):
        if isinstance(layer, Conv2D):
            k = layer._kernel_size
            if spatial:
                st = (layer._stride if isinstance(layer._stride, int)
                      else layer._stride[0])
                spatial = (spatial[0] // st, spatial[1] // st)
                total += (2 * k[0] * k[1] * layer._in_channels
                          * layer._out_channels * spatial[0] * spatial[1]
                          // layer._groups)
        elif isinstance(layer, Linear):
            total += 2 * layer.in_features * layer.out_features
    if print_detail:
        print(f'FLOPs: {total:,}')
    return total
