"""Normalization functionals. Port of
``paddle_tpu/nn/functional/norm.py``.

``batch_norm`` keeps the reference's running statistics: ``running =
running * momentum + batch * (1 - momentum)`` with the biased two-pass
batch variance (torch's ``F.batch_norm`` weighs momentum the other way
round and keeps the unbiased variance, so it is not used).

Its ``mesh_axis`` (SyncBatchNorm, reference ``norm.py:75-140``): when the
process topology's group along that axis spans more than one rank, each
rank's channel mean and two-pass variance are merged as the reference
merges them: the means of ``var + mean^2`` and of ``mean`` over the
group (one all-reduce of the two [C] rows, summed in f32), then ``var =
max(E[x^2] - mean^2, 0)``. The merge's backward all-reduces the two
channel rows' cotangents the same way, so each rank's input gradient is
that of the ranks' summed losses (DataParallel then averages the
parameters' gradients). The running statistics take the global moments.
In one process it is BatchNorm.
"""
import torch

from ...core.dispatch import apply_op, op, promote_all
from ...core.tensor import Tensor

__all__ = ['normalize', 'layer_norm', 'group_norm_fn', 'instance_norm_fn',
           'instance_norm', 'batch_norm', 'local_response_norm']


@op
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    norm = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                               keepdim=True), 1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


@op
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    shape = tuple(int(s) for s in normalized_shape)
    ts = [t for t in (x, weight, bias) if t is not None]
    if len({t.dtype for t in ts}) > 1:
        ts = promote_all(ts)
        x = ts.pop(0)
        weight = ts.pop(0) if weight is not None else None
        bias = ts.pop(0) if bias is not None else None
    if ((weight is None or tuple(weight.shape) == shape)
            and (bias is None or tuple(bias.shape) == shape)):
        return torch.nn.functional.layer_norm(x, shape, weight, bias,
                                              epsilon)
    axes = tuple(range(x.dim() - len(shape), x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@op
def group_norm_fn(x, num_groups, weight=None, bias=None, epsilon=1e-05,
                  data_format='NCHW'):
    chan_first = data_format.startswith('NC')
    if not chan_first:
        x = torch.movedim(x, -1, 1)
    n, c = x.shape[:2]
    spatial = tuple(x.shape[2:])
    g = num_groups
    xg = x.reshape((n, g, c // g) + spatial)
    axes = tuple(range(2, xg.dim()))
    mean = torch.mean(xg, dim=axes, keepdim=True)
    var = torch.mean(torch.square(xg - mean), dim=axes, keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + epsilon)
    out = xg.reshape((n, c) + spatial)
    if weight is not None:
        out = out * weight.reshape((1, c) + (1,) * len(spatial))
    if bias is not None:
        out = out + bias.reshape((1, c) + (1,) * len(spatial))
    if not chan_first:
        out = torch.movedim(out, 1, -1)
    return out


@op
def instance_norm_fn(x, weight=None, bias=None, epsilon=1e-05,
                     data_format='NCHW'):
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    c = x.shape[1]
    if weight is not None:
        out = out * weight.reshape((1, c) + (1,) * (x.dim() - 2))
    if bias is not None:
        out = out + bias.reshape((1, c) + (1,) * (x.dim() - 2))
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format='NCHW', name=None):
    return instance_norm_fn(x, weight, bias, eps, data_format)


def _sync_group(mesh_axis):
    """The process topology's group along ``mesh_axis`` when it spans more
    than one rank (an unknown axis raises), else None."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return None
    from ...distributed.topology import get_mesh
    grp = get_mesh().group(mesh_axis)
    return grp if grp is not None and grp.nranks > 1 else None


class _GroupMean(torch.autograd.Function):
    """The mean over a group, forward and backward (the cotangents of the
    ranks' summed losses meet the same way), summed in f32."""

    @staticmethod
    def forward(ctx, x, grp):
        from ...distributed.collective import pmean
        ctx.grp = grp
        return pmean(x.float(), grp).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        from ...distributed.collective import pmean
        return pmean(g.float(), ctx.grp).to(g.dtype), None


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format='NCHW', use_global_stats=None, mesh_axis=None,
               name=None):
    """Returns the output; when training with batch statistics, replaces
    the running statistics' values (detached) as the reference does."""
    grp = _sync_group(mesh_axis) if mesh_axis is not None else None
    chan_axis = 1 if data_format.startswith('NC') else -1
    use_batch_stats = training and not use_global_stats
    # the running statistics are constants of the graph, as in the
    # reference
    rm = (running_mean._value if isinstance(running_mean, Tensor)
          else running_mean)
    rv = (running_var._value if isinstance(running_var, Tensor)
          else running_var)
    rm = rm.detach() if isinstance(rm, torch.Tensor) else rm
    rv = rv.detach() if isinstance(rv, torch.Tensor) else rv

    def pure(v, w, b):
        ax = chan_axis % v.dim()
        axes = tuple(i for i in range(v.dim()) if i != ax)
        shape = [1] * v.dim()
        shape[ax] = v.shape[ax]
        if use_batch_stats:
            mean = torch.mean(v, dim=axes)
            # two-pass variance (E[x^2] - mean^2 cancels below zero)
            var = torch.mean(torch.square(v - mean.reshape(shape)), dim=axes)
            if grp is not None:
                # E[x^2] from the LOCAL mean (the global one would drop
                # the between-rank variance), then the merge, clamped
                moments = _GroupMean.apply(
                    torch.stack([var + torch.square(mean), mean]), grp)
                mean = moments[1]
                var = torch.clamp_min(moments[0] - torch.square(mean), 0.0)
        else:
            mean, var = rm, rv
        out = (v - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + epsilon)
        if w is not None:
            out = out * w.reshape(shape)
        if b is not None:
            out = out + b.reshape(shape)
        return out, mean, var

    out, bmean, bvar = apply_op(pure, x, weight, bias)
    if use_batch_stats and isinstance(running_mean, Tensor):
        m = momentum
        running_mean._replace_value(rm * m + bmean._value.detach() * (1 - m))
        running_var._replace_value(rv * m + bvar._value.detach() * (1 - m))
    return out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format='NCHW', name=None):
    def pure(v):
        chan_first = data_format.startswith('NC')
        if not chan_first:
            v = torch.movedim(v, -1, 1)
        sq = torch.square(v)
        half = size // 2
        flat = [0, 0] * (v.dim() - 2) + [half, size - 1 - half]
        sq = torch.nn.functional.pad(sq, flat)
        c = v.shape[1]
        acc = sum(sq[:, i:i + c] for i in range(size))
        out = v / torch.pow(k + alpha * acc / size, beta)
        if not chan_first:
            out = torch.movedim(out, 1, -1)
        return out
    return apply_op(pure, x)
