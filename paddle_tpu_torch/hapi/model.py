"""High-level Model API: prepare/fit/evaluate/predict (port of
``paddle_tpu/hapi/model.py``).

The step is the reference's: a forward through ``nn.functional_call`` over
the Layer's own Parameters with autograd on, the loss through
``_compute_loss``, the gradients by ``torch.autograd.grad``, and the update
by ``Optimizer.functional_apply`` in place over ``opt_state``, a dict by
parameter name made by ``functional_init`` (so ``.pdopt`` keeps the
reference's shape, ``{'opt_state': {name: {...}}}``).

The reference's async executor keeps its state on the device between
compiled steps (``DeviceResidentRef``). Here the Parameters already live
on the card and are updated in place, so what remains of it is: no host
sync in a step (the loss stays a device scalar, read to a float only at
``log_freq`` points and at epoch end), and a bounded in-flight window
(``PADDLE_TPU_INFLIGHT``, default 2) that waits on a CUDA event of the step
``window`` steps back (counted by ``train.inflight_waits``).
``PADDLE_TPU_SYNC_EXECUTOR=1`` reads every step's loss (a sync a step).

Serving: ``serving_engine()`` builds (and caches) a
``serving.InferenceEngine`` over the network, and ``predict(engine=True)``
routes the batches through it. ``prepare(warmup=)``, ``fit(warmup=)`` and
``prebuild_warmup`` replay a warmup manifest (``warmup.prebuild(...,
model=self)``): the steps here are eager, so there is nothing to build for
its train and eval entries, which count as ``untargeted`` (ROADMAP known
differences).

Telemetry, as the reference's ``fit``: ``fit(telemetry_port=N)`` serves
the HTTP plane (``self.telemetry``); the goodput ledger's run window, data
stalls (``goodput.data_iter``), compile badput (a step during which a
kernel library was built or loaded, or a CUDA graph captured: the eager
step traces nothing), ``perf.note_step('hapi.train_step', ...)``,
``perf.sweep_hbm()`` at log points and ``self._step_timer``'s phases
(``profiler.StepTimer``; a raising step books nothing). The first run of
each step kind is counted by ``perf.measure`` (``hapi.train_step``,
``hapi.accum_step``, ``hapi.apply_accum``, ``hapi.eval_step``): a step
that already runs, never an extra one, since a step updates the
Parameters in place.

Not ported, raising NotImplementedError citing its ROADMAP Queue 1 step:
``prepare(strategy=)`` (step K4); ASP sparsity masks are step M's.
"""
import collections
import os
import sys
import time

import numpy as np
import torch

from .. import observability as _obs
from ..core.nest import map_nested
from ..core.tensor import Tensor, wrap
from ..device import current_device
from ..io import DataLoader, Dataset
from ..nn.layer_base import functional_call

HEARTBEAT_ENV = 'PADDLE_HEARTBEAT_FILE'


def _deferred(what, step):
    return NotImplementedError(
        f'{what} is not ported yet (ROADMAP Queue 1 step {step})')


def _touch_heartbeat():
    """Signal liveness to an elastic launcher (no-op when not launched by
    one); the launcher's own copy is ``paddle_tpu/distributed/launch.py``."""
    path = os.environ.get(HEARTBEAT_ENV)
    if not path:
        return
    try:
        with open(path, 'a'):
            os.utime(path, None)
    except OSError:
        pass


def _compile_events():
    """Kernel libraries loaded and CUDA graphs captured so far in the
    process: what moves during a step that pays a build ('compile'
    badput)."""
    b = sys.modules.get('paddle_tpu_torch.ops._build')
    dc = sys.modules.get('paddle_tpu_torch.models.decode_cache')
    return ((b.loads if b is not None else 0)
            + (dc.captures if dc is not None else 0))


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _host(x):
    """A torch output as a host ndarray (bfloat16 as float32, as
    ``Tensor.numpy()`` gives it)."""
    return wrap(x).numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _state_to(tree, device):
    """A loaded optimizer state (ndarrays or torch tensors by name) as
    torch tensors on ``device``."""
    def leaf(x):
        if isinstance(x, Tensor):
            x = x._value
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.asarray(x, order='C'))  # 0-d stays
        return x.to(device)
    return map_nested(leaf, tree)


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._loss = None
        self._optimizer = None
        self._metrics = []
        self._opt_state = None
        self._opt_restored = False
        self._opt_init_pending = True
        self._grad_acc = None
        self._accum_count = 0
        self._net_mode = None
        self._last_outputs = None
        self._inflight = collections.deque()
        self._async = os.environ.get('PADDLE_TPU_SYNC_EXECUTOR') != '1'
        try:
            self._inflight_window = max(
                1, int(os.environ.get('PADDLE_TPU_INFLIGHT', '2')))
        except ValueError:
            self._inflight_window = 2
        self.stop_training = False
        self._engine = None
        self._engine_kwargs = None
        self._step_timer = None     # attach a profiler.StepTimer before fit
        self.telemetry = _obs.NULL_SERVER

    # ---- setup -----------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, warmup=None, strategy=None):
        """The optimizer, the loss (a callable of the outputs then the
        labels) and the metrics of ``fit`` / ``evaluate``. Under amp, wrap
        the calls in ``paddle.amp.auto_cast``."""
        if strategy is not None:
            raise _deferred('Model.prepare(strategy=)', 'K4')
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        self._opt_init_pending = True
        if warmup is not None:
            self.prebuild_warmup(warmup)

    def prebuild_warmup(self, manifest):
        """Replay a warmup manifest (a ``warmup.Manifest`` or a path)
        against this Model; returns the prebuild report. The port's steps
        are eager, so its train/eval entries count as ``untargeted``. Also
        reachable as ``prepare(warmup=)`` / ``fit(warmup=)``."""
        from .. import warmup as _warmup_mod
        return _warmup_mod.prebuild(manifest, model=self)

    def serving_engine(self, **kwargs):
        """Lazily build (and cache) a ``serving.InferenceEngine`` over this
        model's network: the dynamic-batching path for online traffic
        (``predict(..., engine=True)`` routes through it). Other kwargs
        than the cached engine's rebuild it."""
        if self._engine is not None and kwargs and \
                kwargs != self._engine_kwargs:
            self._engine.shutdown()
            self._engine = None
        if self._engine is None:
            from ..serving import InferenceEngine
            self._engine = InferenceEngine(self, **kwargs)
            self._engine_kwargs = kwargs
        return self._engine

    # ---- the step ----------------------------------------------------------
    def _compute_loss(self, outputs, labels):
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        loss = self._loss(*[wrap(o) for o in outs],
                          *[wrap(lab) for lab in labels])
        if isinstance(loss, (list, tuple)):
            total = loss[0]
            for part in loss[1:]:
                total = total + part
            loss = total
        return loss._value if isinstance(loss, Tensor) else loss

    def _loss_and_grads(self, inputs, labels):
        """(loss, outputs, gradients by parameter name): gradients of the
        Parameters that require one, None for the rest."""
        named = list(self.network.named_parameters())
        out, buffers = functional_call(self.network, None, None, *inputs)
        # functional_call restores the buffers; the step keeps what the
        # forward made of them (BatchNorm's running statistics), as the
        # reference's step does
        for n, b in self.network.named_buffers():
            if b is not None and n in buffers:
                b._value = buffers[n]
        loss = self._compute_loss(out, labels)
        live = [(n, p._value) for n, p in named if p._value.requires_grad]
        got = torch.autograd.grad(loss, [v for _, v in live],
                                  allow_unused=True)
        grads = {n: None for n, _ in named}
        for (n, v), g in zip(live, got):
            grads[n] = torch.zeros_like(v) if g is None else g
        out = [o.detach() for o in out] if isinstance(out, (list, tuple)) \
            else out.detach()
        return loss.detach(), out, grads

    def _apply(self, grads):
        params = {n: p._value for n, p in self.network.named_parameters()}
        self._optimizer.functional_apply(params, grads, self._opt_state,
                                         self._optimizer.get_lr())

    def _finish_step(self, loss):
        if not self._async:
            return [float(loss)]
        # bounded in-flight window: wait on the step ``window`` back, so a
        # NaN or a device fault surfaces within ~window steps of its batch
        if loss.device.type == 'cuda':
            ev = torch.cuda.Event()
            ev.record()
            self._inflight.append(ev)
            while len(self._inflight) > self._inflight_window:
                self._inflight.popleft().synchronize()
                _obs.counter('train.inflight_waits').inc()
        return [loss]

    def _drain_inflight(self):
        while self._inflight:
            self._inflight.popleft().synchronize()

    # ---- mode handling ---------------------------------------------------
    def _enter_mode(self, training):
        """The network is flipped only when crossing the train/eval
        boundary, so a user's override of one sublayer (freezing a
        BatchNorm with ``bn.eval()``) persists."""
        if self._net_mode is not training:
            if training:
                self.network.train()
            else:
                self.network.eval()
            self._net_mode = training

    def _split_batch(self, batch):
        batch = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        arrs = [self._as_device(b) for b in batch]
        n_in = len(self._inputs) if self._inputs else (
            len(arrs) - len(self._labels) if self._labels else
            (len(arrs) - 1 if self._loss is not None and len(arrs) > 1
             else len(arrs)))
        return arrs[:n_in], arrs[n_in:]

    @staticmethod
    def _as_device(t):
        """Tensor / torch tensor / host data -> a torch tensor on the
        current place (a batch of a dataset kept on the host moves there,
        as the reference's arrays land on its device)."""
        if isinstance(t, Tensor):
            t = t._value
        if isinstance(t, torch.Tensor):
            return t.to(current_device())
        return Tensor(t)._value

    # ---- public batch APIs ----------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One step; ``update=False`` is a gradient-merge micro step (the
        gradients accumulate, the Parameters stay), and the next step with
        ``update=True`` applies their average. -> [loss] (a device scalar;
        a float under ``PADDLE_TPU_SYNC_EXECUTOR=1``)."""
        _touch_heartbeat()   # liveness signal for an elastic launcher
        self._enter_mode(True)
        if self._opt_state is None or (self._opt_init_pending
                                       and not self._opt_restored):
            # a restored opt_state (Model.load / AutoResume) survives the
            # first step instead of being initialized again
            self._opt_state = self._optimizer.functional_init(
                {n: p._value for n, p in self.network.named_parameters()})
        self._opt_init_pending = False
        inputs = [self._as_device(t) for t in _to_list(inputs)]
        labels = [self._as_device(t) for t in _to_list(labels)]
        if not update or self._grad_acc is not None:
            # gradient merge: accumulate, and on the last micro step apply
            # the average
            with _obs.perf.measure('hapi.accum_step') as m:
                loss, out, grads = self._loss_and_grads(inputs, labels)
                if self._grad_acc is None:
                    self._grad_acc = {
                        n: torch.zeros_like(p._value)
                        for n, p in self.network.named_parameters()}
                    self._accum_count = 0
                with torch.no_grad():
                    for n, g in grads.items():
                        if g is not None:
                            self._grad_acc[n].add_(g)
                m.set_outputs((loss, out))
            self._last_outputs = out
            self._accum_count += 1
            if update:
                with _obs.perf.measure('hapi.apply_accum'):
                    self._flush_grad_acc()
        else:
            with _obs.perf.measure('hapi.train_step') as m:
                loss, out, grads = self._loss_and_grads(inputs, labels)
                self._apply(grads)
                m.set_outputs((loss, out))
            self._last_outputs = out
        return self._finish_step(loss)

    def _flush_grad_acc(self):
        """Apply any pending accumulated gradients (their average over the
        micro steps taken): at the last micro step, and at epoch end for a
        partial cycle."""
        if self._grad_acc is None:
            return
        named = dict(self.network.named_parameters())
        scale = 1.0 / max(self._accum_count, 1)
        with torch.no_grad():
            grads = {n: (acc * torch.full((), scale, dtype=torch.float32,
                                          device=acc.device).to(acc.dtype)
                         if named[n]._value.requires_grad else None)
                     for n, acc in self._grad_acc.items()}
        self._grad_acc = None
        self._accum_count = 0
        self._apply(grads)

    def eval_batch(self, inputs, labels=None):
        """-> ([loss as a host array] or None, the outputs on the device)."""
        self._enter_mode(False)
        _obs.counter('train.eval_batches').inc()
        inputs = [self._as_device(t) for t in _to_list(inputs)]
        labels = [self._as_device(t) for t in _to_list(labels)]
        with torch.no_grad(), _obs.perf.measure('hapi.eval_step') as m:
            out, _ = functional_call(self.network, None, None, *inputs)
            loss = None
            if self._loss is not None and labels:
                loss = self._compute_loss(out, labels)
            m.set_outputs((loss, out))
        return ([_host(loss)] if loss is not None else None), out

    def predict_batch(self, inputs):
        _, out = self.eval_batch(inputs, [])
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [_host(o) for o in outs]

    # ---- fit/evaluate/predict -------------------------------------------
    def _as_loader(self, data, batch_size, shuffle):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle)
        return data

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, resume=None,
            warmup=None, telemetry_port=None):
        from .callbacks import AutoResume, CallbackList, ModelCheckpoint
        if telemetry_port is not None:
            # fit-time telemetry opt-in: serve /metrics (+ /healthz,
            # /debug/*) for this training run; lives until process exit
            # (daemon thread), reachable at self.telemetry.url
            self.telemetry = _obs.serve_telemetry(port=telemetry_port)
        if warmup is not None:
            self.prebuild_warmup(warmup)
        loader = self._as_loader(train_data, batch_size, shuffle)
        eval_loader = self._as_loader(eval_data, batch_size, False)
        callbacks = list(callbacks or [])
        if resume:
            # resume=<dir> (or resume=True with save_dir) restores the
            # newest verified checkpoint and continues mid-run; one owner,
            # an AutoResume callback
            rdir = resume if isinstance(resume, str) else save_dir
            if rdir and not any(isinstance(c, AutoResume) for c in callbacks):
                callbacks.append(AutoResume(rdir, save_freq=save_freq))
        if save_dir and not any(isinstance(c, ModelCheckpoint)
                                for c in callbacks):
            # save_dir/save_freq delegate to a ModelCheckpoint: one owner of
            # the save schedule
            callbacks.append(ModelCheckpoint(save_freq, save_dir))
        auto_resume = next((c for c in callbacks if isinstance(c, AutoResume)),
                           None)
        cbks = CallbackList(callbacks, self, verbose=verbose,
                            log_freq=log_freq)
        names = ['loss'] + sum([m.name() if isinstance(m.name(), list)
                                else [m.name()] for m in self._metrics], [])
        cbks.on_begin('train', {
            'epochs': epochs,
            'steps': len(loader) if hasattr(loader, '__len__') else None,
            'metrics': names})
        it_count = 0
        logs = {}
        start_epoch, skip_steps = 0, 0
        if auto_resume is not None and auto_resume.resume_info:
            info = auto_resume.resume_info
            if info.get('step') is None:      # epoch boundary checkpoint
                start_epoch = info['epoch'] + 1
            else:                             # mid-epoch: redo epoch tail
                start_epoch = info['epoch']
                skip_steps = info['step'] + 1
            it_count = info.get('global_step', 0)
        use_prefetch = self._async and isinstance(loader, DataLoader)
        timer = self._step_timer
        step_ms = _obs.histogram('train.step_ms')
        wait_ms = _obs.histogram('train.data_wait_ms')
        step_counter = _obs.counter('train.steps')
        loss_gauge = _obs.gauge('train.loss')
        from ..optimizer.lr import LRScheduler, ReduceOnPlateau
        with _obs.span('train.fit', epochs=epochs, start_epoch=start_epoch):
            # always-on goodput accounting: the run window opens here;
            # steps, data stalls and compile steps are classified below,
            # checkpoint / preemption / requeue badput arrives from the
            # checkpoint and retry paths
            goodput = _obs.goodput.ledger()
            goodput.run_start()
            for epoch in range(start_epoch, epochs):
                if auto_resume is not None:
                    # deterministic per-epoch shuffle so a resumed lifetime
                    # sees the batch order the interrupted one did
                    np.random.seed((auto_resume.seed_base + epoch) % (2 ** 32))
                    bs = getattr(loader, 'batch_sampler', None)
                    if bs is not None and hasattr(bs, 'set_epoch'):
                        bs.set_epoch(epoch)
                cbks.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                logs = {}
                prefetch_gen = (loader.prefetch_to_device() if use_prefetch
                                else None)
                # innermost wrapper: the raw loader / prefetch wait, so a
                # blocking wait above the stall floor books as data_stall
                batch_iter = goodput.data_iter(
                    prefetch_gen if prefetch_gen is not None else loader)
                if timer is not None:
                    batch_iter = timer.timed_iter('data', batch_iter)
                batch_iter = iter(batch_iter)
                try:
                    step_idx = -1
                    while True:
                        t0 = time.perf_counter()
                        try:
                            batch = next(batch_iter)
                        except StopIteration:
                            break
                        wait_ms.observe(1e3 * (time.perf_counter() - t0))
                        step_idx += 1
                        if epoch == start_epoch and step_idx < skip_steps:
                            continue      # trained before the restart
                        cbks.on_batch_begin('train', step_idx, logs)
                        inputs, labels = self._split_batch(batch)
                        do_update = (step_idx + 1) % \
                            accumulate_grad_batches == 0
                        t0 = time.perf_counter()
                        builds = _compile_events()
                        try:
                            with _obs.span('train.step', step=it_count) as sp:
                                loss = self.train_batch(inputs, labels,
                                                        update=do_update)
                        except BaseException:
                            # a raising step books no partial duration
                            # into the phase histograms
                            if timer is not None:
                                timer.abort_step()
                            raise
                        step_ms.observe(1e3 * sp.duration)
                        step_counter.inc()
                        _obs.perf.note_step('hapi.train_step', sp.duration)
                        if _compile_events() > builds:
                            # the step built a kernel or captured a graph:
                            # its whole wall time is compile badput
                            goodput.note_badput('compile', sp.duration)
                        goodput.note_step(sp.duration)
                        if timer is not None:
                            timer.add('dispatch', time.perf_counter() - t0)
                        lval = loss[0]
                        if not self._async or step_idx % log_freq == 0:
                            # deferred loss readback: the device scalar is
                            # read only at logging points (every step when
                            # synchronous, where it is a float already)
                            t0 = time.perf_counter()
                            lval = float(lval)
                            if timer is not None:
                                timer.add('readback',
                                          time.perf_counter() - t0)
                            loss_gauge.set(lval)
                            if step_idx % log_freq == 0:
                                # the device memory sweep at log points
                                _obs.perf.sweep_hbm()
                        logs = {'loss': lval, 'step': step_idx}
                        self._update_metrics(logs, labels)
                        cbks.on_batch_end('train', step_idx, logs)
                        if timer is not None:
                            timer.step_done()
                        it_count += 1
                        if num_iters is not None and it_count >= num_iters:
                            break
                finally:
                    if prefetch_gen is not None:
                        prefetch_gen.close()   # stop the producer thread
                # flush a partial gradient-merge cycle so stale grads never
                # leak into the next epoch with a wrong divisor
                self._flush_grad_acc()
                self._drain_inflight()
                if 'loss' in logs and not isinstance(logs['loss'], float):
                    logs['loss'] = float(logs['loss'])
                if isinstance(self._optimizer._lr, LRScheduler) and \
                        not isinstance(self._optimizer._lr, ReduceOnPlateau):
                    self._optimizer._lr.step()
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    eval_logs = self.evaluate(eval_loader, verbose=0)
                    logs.update({'eval_' + k: v for k, v in eval_logs.items()})
                cbks.on_epoch_end(epoch, logs)
                _obs.counter('train.epochs').inc()
                if self.stop_training:
                    break
            goodput.run_end()
        self._drain_inflight()
        cbks.on_end('train', logs)

    def _update_metrics(self, logs, labels):
        """Metrics from the train step's own outputs (no second forward)."""
        if not self._metrics or not labels:
            return
        out = self._last_outputs
        first = out[0] if isinstance(out, (list, tuple)) else out
        for m in self._metrics:
            res = m.compute(wrap(first), wrap(labels[0]))
            # a tuple-returning compute() is unpacked into update(*results)
            acc = m.update(*(res if isinstance(res, (list, tuple))
                             else (res,)))
            if acc is None:
                # Precision/Recall/Auc-style updates return nothing; the
                # running value comes from accumulate()
                acc = m.accumulate()
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = acc if isinstance(acc, list) else [acc]
            for n, v in zip(names, vals):
                logs[n] = float(v)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = self._as_loader(eval_data, batch_size, False)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            inputs, labels = self._split_batch(batch)
            loss, out = self.eval_batch(inputs, labels)
            if loss is not None:
                losses.append(loss[0])
            if self._metrics and labels:
                outs = out if isinstance(out, (list, tuple)) else [out]
                for m in self._metrics:
                    res = m.compute(wrap(outs[0]), wrap(labels[0]))
                    m.update(*(res if isinstance(res, (list, tuple))
                               else (res,)))
        logs = {}
        if losses:
            logs['loss'] = float(np.mean([np.asarray(x) for x in losses]))
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, list) else [vals]
            for n, v in zip(names, vals):
                logs[n] = float(v)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None,
                bucket_pad=True, engine=None):
        """Run inference over ``test_data`` -> a list (one entry per output)
        of per-batch host arrays, concatenated when ``stack_outputs``.

        ``bucket_pad`` (default on) pads a ragged tail batch up to the
        nominal batch size (repeating the last row) and slices the outputs
        back, so every batch has one shape. Outputs stay on the device
        until the end: no host round trip per batch. ``engine`` routes the
        batches through a ``serving.InferenceEngine`` instead: an engine,
        or ``True`` for ``self.serving_engine()``."""
        if engine is not None:
            return self._predict_engine(test_data, batch_size, engine,
                                        stack_outputs)
        loader = self._as_loader(test_data, batch_size, False)
        device_outs = []
        nominal = None
        for batch in loader:
            inputs, _ = self._split_batch(batch)
            first = inputs[0] if inputs else None
            n = first.shape[0] if getattr(first, 'ndim', 0) >= 1 else None
            if nominal is None:
                nominal = n
            padded = (bucket_pad and n is not None and nominal is not None
                      and n < nominal)
            if padded:
                pad = nominal - n
                inputs = [torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
                          if getattr(x, 'ndim', 0) >= 1 and x.shape[0] == n
                          else x for x in inputs]
            _, out = self.eval_batch(inputs, [])
            outs = out if isinstance(out, (list, tuple)) else [out]
            if padded:
                outs = [o[:n] if (getattr(o, 'ndim', 0) >= 1
                                  and o.shape[0] == nominal) else o
                        for o in outs]
            device_outs.append(outs)
        # one host read at the end: every batch was queued above
        outputs = [[_host(o) for o in outs] for outs in device_outs]
        n_out = len(outputs[0])
        grouped = [[o[i] for o in outputs] for i in range(n_out)]
        if stack_outputs:
            grouped = [np.concatenate(g, axis=0) for g in grouped]
        return grouped

    def _predict_engine(self, test_data, batch_size, engine, stack_outputs):
        from ..serving.errors import QueueFullError
        loader = self._as_loader(test_data, batch_size, False)
        eng = self.serving_engine() if engine is True else engine
        # a bounded in-flight window: submitting the whole loader up front
        # would trip the engine's own admission control. Results are
        # consumed in submission order, so output order is kept.
        window = max(1, getattr(eng, 'queue_capacity', 256) // 2)
        pending = collections.deque()
        outputs = []

        def consume(f):
            res = f.result()
            outputs.append(res if isinstance(res, list) else [res])

        for batch in loader:
            inputs, _ = self._split_batch(batch)
            while len(pending) >= window:
                consume(pending.popleft())
            while True:
                try:
                    pending.append(eng.submit(*inputs))
                    break
                except QueueFullError as e:
                    # other submitters (or split chunks) filled the
                    # queue: drain one of ours and retry
                    if pending:
                        consume(pending.popleft())
                    else:
                        time.sleep((e.retry_after_ms or 1.0) / 1e3)
        while pending:
            consume(pending.popleft())
        grouped = [[o[i] for o in outputs] for i in range(len(outputs[0]))]
        if stack_outputs:
            grouped = [np.concatenate(g, axis=0) for g in grouped]
        return grouped

    # ---- persistence -----------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (the state dict) and, when ``training``,
        ``path.pdopt`` ({'opt_state': ...}), in the reference's format."""
        from ..framework_io import save as fsave
        self._drain_inflight()
        fsave(self.network.state_dict(), path + '.pdparams')
        if training and self._optimizer is not None:
            fsave({'opt_state': self._opt_state}, path + '.pdopt')

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework_io import load as fload
        self.network.set_state_dict(fload(path + '.pdparams'))
        opt_path = path + '.pdopt'
        if not reset_optimizer and os.path.exists(opt_path):
            st = fload(opt_path)
            if st.get('opt_state') is not None:
                self._set_opt_state(st['opt_state'])

    def _set_opt_state(self, state):
        """A loaded optimizer state, each parameter's on its device."""
        dev = {n: p._value.device
               for n, p in self.network.named_parameters()}
        self._opt_state = {n: _state_to(s, dev[n]) for n, s in state.items()}
        self._opt_restored = True

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from . import summary as _summary
        return _summary(self.network, input_size, dtype)
