"""DistributedStrategy. Port of ``paddle_tpu/distributed/fleet/
strategy.py``: a plain config object (the reference's is protobuf-backed)
whose ``hybrid_configs`` become the mesh's degrees; ``validate_degrees``
holds them against the world's rank count before any group is built."""
import warnings

_warned_na = set()


def warn_na_once(key, msg):
    """One warning per accepted-but-unused toggle."""
    if key not in _warned_na:
        _warned_na.add(key)
        warnings.warn(msg, stacklevel=3)


class _Cfg(dict):
    def __getattr__(self, k):
        return self.get(k)

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        self.amp = False
        self.amp_configs = _Cfg(init_loss_scaling=32768.0, use_pure_fp16=False,
                                custom_white_list=[], custom_black_list=[])
        self.recompute = False
        self.recompute_configs = _Cfg(checkpoints=[])
        self.gradient_merge = False
        self.gradient_merge_configs = _Cfg(k_steps=1, avg=True)
        self.sharding = False
        self.sharding_configs = _Cfg(sharding_degree=1, stage=1,
                                     segment_broadcast_MB=32)
        self.pipeline = False
        self.pipeline_configs = _Cfg(accumulate_steps=1, micro_batch_size=1,
                                     schedule_mode='1F1B')
        self.tensor_parallel = False
        self.tensor_parallel_configs = _Cfg(tensor_parallel_degree=1)
        self.hybrid_configs = _Cfg(dp_degree=1, mp_degree=1, pp_degree=1,
                                   sharding_degree=1, sp_degree=1, ep_degree=1)
        self.lamb = False
        self.lars = False
        self.lars_configs = _Cfg(lars_coeff=0.001, lars_weight_decay=0.0005,
                                 epsilon=1e-9, exclude_from_weight_decay=[])
        self.localsgd = False
        self.localsgd_configs = _Cfg(k_steps=4, begin_step=1)
        self.asp = False
        self.dgc = False
        self.fp16_allreduce = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.nccl_comm_num = 1

    def validate_degrees(self, n_devices=None):
        """Check the hybrid degrees against the rank count (default: the
        world's) before any group is built: each must be >= 1 and their
        product must divide the count (leftover ways grow dp). -> the
        degree dict."""
        if n_devices is None:
            from .. import get_world_size
            n_devices = get_world_size()
        hc = self.hybrid_configs
        deg = {k: (1 if hc.get(f'{k}_degree', 1) is None
                   else int(hc.get(f'{k}_degree', 1)))
               for k in ('dp', 'mp', 'pp', 'sharding', 'sp', 'ep')}
        bad = {k: d for k, d in deg.items() if d < 1}
        if bad:
            raise ValueError(
                f'DistributedStrategy.hybrid_configs degrees must be >= 1, '
                f'got {bad}')
        need = 1
        for d in deg.values():
            need *= d
        if n_devices % need != 0:
            raise ValueError(
                f'DistributedStrategy.hybrid_configs degrees {deg} need '
                f'dp*mp*pp*sharding*sp*ep = {need} ways, which does not '
                f'divide the {n_devices} available device(s). Adjust the '
                f'degrees (their product must divide the device count; '
                f'leftover ways grow dp).')
        return deg

    def to_partition_rules(self, mesh=None):
        """The logical -> mesh rules table of this strategy
        (``parallel.partitioner.Partitioner.from_strategy``)."""
        from ...parallel.partitioner import Partitioner
        return Partitioner.from_strategy(self, mesh=mesh)

    def __setattr__(self, k, v):
        if v and k in ('dgc', 'fp16_allreduce'):
            warn_na_once(k, (
                f'DistributedStrategy.{k}=True is accepted but has no '
                'effect, as in the reference: training proceeds without '
                'it.'))
        object.__setattr__(self, k, v)

    def __repr__(self):
        on = [k for k, v in self.__dict__.items()
              if isinstance(v, bool) and v]
        return (f'DistributedStrategy(enabled={on}, '
                f'hybrid={dict(self.hybrid_configs)})')
