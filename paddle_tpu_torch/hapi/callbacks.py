"""Training callbacks (port of ``paddle_tpu/hapi/callbacks.py``)."""
import os
import time
import warnings

import numpy as np
import torch

from ..device import current_device
from ..tensor.random import generator


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None, model=None, verbose=2, log_freq=10):
        self.callbacks = list(callbacks or [])
        if verbose and not any(isinstance(c, ProgBarLogger) for c in self.callbacks):
            # align the auto-inserted logger with fit()'s log_freq so the
            # deferred loss is a float whenever the progress bar prints
            self.callbacks.insert(0, ProgBarLogger(log_freq=log_freq,
                                                   verbose=verbose))
        for c in self.callbacks:
            c.set_model(model)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def on_begin(self, mode, params=None):
        for c in self.callbacks:
            c.set_params(params)
        self._call(f'on_{mode}_begin', params)

    def on_end(self, mode, logs=None):
        self._call(f'on_{mode}_end', logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call('on_epoch_begin', epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call('on_epoch_end', epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call(f'on_{mode}_batch_begin', step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call(f'on_{mode}_batch_end', step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._step_t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = ' - '.join(f'{k}: {v:.4f}' for k, v in (logs or {}).items()
                               if isinstance(v, (int, float)) and k != 'step')
            dt = (time.time() - self._step_t0) / max(step + 1, 1)
            print(f'Epoch {self.epoch} step {step}: {items} ({dt * 1000:.1f} ms/step)')

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            items = ' - '.join(f'{k}: {v:.4f}' for k, v in (logs or {}).items()
                               if isinstance(v, (int, float)) and k != 'step')
            print(f'Epoch {epoch} done: {items}')


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        # reference saves when epoch % save_freq == 0 (epoch 0 included)
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        # reference hapi/callbacks.py: a '<save_dir>/final' checkpoint is
        # always written at train end — Model.load(save_dir + '/final') is
        # the documented resume idiom
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, 'final'))


def _rng_state():
    """meta's RNG entries: the current device's generator state as a
    uint8 array ('rng'), and the host generator's ('rng_host') when the
    device is the card (kernel route dropout seeds are drawn there)."""
    dev = current_device()
    out = {'rng': generator(dev).get_state().numpy()}
    if dev.type != 'cpu':
        out['rng_host'] = generator(torch.device('cpu')).get_state().numpy()
    return out


def _restore_rng(meta):
    """Set the generators from meta's RNG entries. A reference checkpoint's
    threefry key (not a uint8 generator state) cannot seed torch's
    generators: it is skipped with a warning, and the rest loads."""
    for key, dev in (('rng', current_device()),
                     ('rng_host', torch.device('cpu'))):
        st = meta.get(key)
        if st is None:
            continue
        st = np.asarray(st)
        if st.dtype != np.uint8:
            warnings.warn(f'AutoResume: meta[{key!r}] is not a torch '
                          f'generator state ({st.dtype}); the random '
                          f'streams start from paddle.seed')
            continue
        generator(dev).set_state(torch.from_numpy(st.copy()))


class AutoResume(Callback):
    """Durable training checkpoints + automatic restore on (re)start.

    Writes atomic, CRC-verified checkpoints (``ckpt-<global_step>.pdckpt``
    via utils.checkpoint.CheckpointManager) holding params, optimizer
    state, RNG state and progress meta (epoch / step-in-epoch /
    global_step / shuffle seed). On train begin it restores the newest
    intact checkpoint — so an elastic relaunch or plain rerun continues
    mid-run instead of restarting from step 0. ``Model.fit(resume=...)``
    is sugar for installing this callback.

    If the launcher advertised an agreed restore point through the
    elastic KVStore (env ``PADDLE_RESUME_STEP``), restores the newest
    checkpoint at or below it so re-ranked workers agree.

    - ``every_n_steps``: additionally checkpoint every N train batches
      (step-granular resume; epoch-end checkpoints always happen per
      ``save_freq``).
    - ``keep_period``: steps divisible by it survive GC forever.
    """

    def __init__(self, directory, every_n_steps=None, save_freq=1,
                 max_to_keep=3, keep_period=None, save_retries=3, verbose=0):
        super().__init__()
        from ..utils.checkpoint import CheckpointManager
        self.directory = directory
        self.every_n_steps = every_n_steps
        self.save_freq = max(1, save_freq)
        self.verbose = verbose
        self.mgr = CheckpointManager(directory, max_to_keep=max_to_keep,
                                     keep_period=keep_period,
                                     save_retries=save_retries)
        self.resume_info = None
        self.seed_base = 0
        self._gstep = 0
        self._epoch = 0

    # ---- restore --------------------------------------------------------
    def on_train_begin(self, logs=None):
        self.resume_info = None
        self.seed_base = int(np.random.randint(0, 2 ** 31))
        cap = os.environ.get('PADDLE_RESUME_STEP')
        cap = int(cap) if cap else None
        from ..fault import CheckpointCorruptError
        for step in reversed(self.mgr.all_steps()):
            if cap is not None and step > cap:
                continue
            try:
                state = self.mgr.restore(step)
            except (CheckpointCorruptError, OSError):
                continue              # fall back to the next older intact one
            self._apply(state)
            return

    def _apply(self, state):
        model = self.model
        model.network.set_state_dict(state['params'])
        opt = state.get('opt')
        if opt is not None and model._optimizer is not None:
            model._set_opt_state(opt)
        meta = state.get('meta', {})
        self._gstep = int(meta.get('global_step', 0))
        self.seed_base = int(meta.get('seed_base', self.seed_base))
        _restore_rng(meta)
        if meta.get('lr') is not None and model._optimizer is not None:
            try:
                model._optimizer.set_lr(float(meta['lr']))
            except Exception:         # schedulers own their own lr
                pass
        self.resume_info = {'epoch': int(meta.get('epoch', 0)),
                            'step': meta.get('step'),
                            'global_step': self._gstep}
        if self.verbose:
            print(f'[AutoResume] restored global step {self._gstep} '
                  f'from {self.directory}')

    # ---- save -----------------------------------------------------------
    def _state(self, step_in_epoch):
        model = self.model
        # a checkpoint is a read point: settle the in-flight steps first
        model._drain_inflight()
        meta = {'epoch': self._epoch, 'step': step_in_epoch,
                'global_step': self._gstep, 'seed_base': self.seed_base}
        meta.update(_rng_state())
        if model._optimizer is not None:
            try:
                meta['lr'] = float(model._optimizer.get_lr())
            except Exception:
                pass
        state = {'params': model.network.state_dict(), 'meta': meta}
        if model._opt_state is not None:
            state['opt'] = model._opt_state
        return state

    def _save(self, step_in_epoch):
        try:
            self.mgr.save(self._gstep, self._state(step_in_epoch))
        except Exception as e:        # RetryError after exhausted retries:
            warnings.warn(            # keep training, next save may succeed
                f'AutoResume: checkpoint at step {self._gstep} failed '
                f'after retries: {e!r}')

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        self._gstep += 1
        if self.every_n_steps and self._gstep % self.every_n_steps == 0:
            self._save(step)

    def on_epoch_end(self, epoch, logs=None):
        if epoch % self.save_freq == 0:
            self._save(None)

    def on_train_end(self, logs=None):
        self._save(None)


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, '_optimizer', None)
        if opt is not None and isinstance(opt._lr, Sched):
            return opt._lr
        return None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and self.by_epoch:
            s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor='loss', mode='auto', patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == 'auto':
            mode = 'max' if 'acc' in monitor else 'min'
        self.mode = mode
        self.best = None
        self.wait = 0

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == 'min':
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            cur = (logs or {}).get('eval_' + self.monitor)
        if cur is None:
            return
        if self._better(float(cur)):
            self.best = float(cur)
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.model.stop_training = True


class VisualDL(Callback):
    """CSV/JSONL logger standing in for the reference's VisualDL writer."""

    def __init__(self, log_dir='./log'):
        super().__init__()
        self.log_dir = log_dir

    def on_epoch_end(self, epoch, logs=None):
        import json
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, 'metrics.jsonl'), 'a') as f:
            f.write(json.dumps({'epoch': epoch, **{k: float(v) for k, v in
                                                   (logs or {}).items()
                                                   if isinstance(v, (int, float))}}) + '\n')


class MetricsExporter(Callback):
    """Periodic observability export during training.

    Writes the full ``observability.snapshot()`` as JSONL (one line per
    export, so a run's history is greppable) every ``every_n_epochs``, and
    a complete dump (``snapshot.json`` / ``metrics.prom`` / ``trace.json``)
    into ``log_dir`` at train end. No-ops cheaply when observability is
    disabled (``PADDLE_TPU_OBS=0``)."""

    def __init__(self, log_dir='./obs_log', every_n_epochs=1,
                 prometheus=True, trace=True):
        super().__init__()
        self.log_dir = log_dir
        self.every_n_epochs = max(1, int(every_n_epochs))
        self.prometheus = prometheus
        self.trace = trace

    def _obs(self):
        from .. import observability
        return observability

    def on_epoch_end(self, epoch, logs=None):
        obs = self._obs()
        if not obs.enabled() or (epoch + 1) % self.every_n_epochs:
            return
        import json
        os.makedirs(self.log_dir, exist_ok=True)
        snap = obs.snapshot()
        snap['epoch'] = epoch
        with open(os.path.join(self.log_dir, 'snapshots.jsonl'), 'a') as f:
            f.write(json.dumps(snap, sort_keys=True, default=str) + '\n')

    def on_train_end(self, logs=None):
        obs = self._obs()
        if not obs.enabled():
            return
        import json
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, 'snapshot.json'), 'w') as f:
            json.dump(obs.snapshot(), f, indent=1, sort_keys=True,
                      default=str)
        if self.prometheus:
            with open(os.path.join(self.log_dir, 'metrics.prom'), 'w') as f:
                f.write(obs.to_prometheus())
        if self.trace:
            obs.dump_trace(os.path.join(self.log_dir, 'trace.json'))


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor='loss', factor=0.1, patience=10, verbose=1,
                 mode='auto', min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        if mode == 'auto':
            mode = 'max' if 'acc' in monitor else 'min'
        self.mode = mode
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor) or (logs or {}).get('eval_' + self.monitor)
        if cur is None:
            return
        cur = float(cur)
        better = (cur < self.best - self.min_delta if self.mode == 'min'
                  else cur > self.best + self.min_delta) if self.best is not None else True
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                opt = self.model._optimizer
                new_lr = max(opt.get_lr() * self.factor, self.min_lr)
                opt.set_lr(new_lr)
                self.wait = 0
