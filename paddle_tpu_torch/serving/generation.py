"""GenerationEngine: continuous (iteration-level) batching for LLM decode.

Port of ``paddle_tpu/serving/generation.py``. Requests arrive ragged and
produce different numbers of tokens, so a fixed-batch ``generate()`` call
would head-of-line block every sequence on the longest one. This engine
schedules at the *iteration* level (the Orca discipline): a fixed number
of decode **slots** advances one token per iteration, and the host
scheduler admits new sequences into free slots and retires finished ones
*between* steps. Two device calls serve the whole workload:

 - ``prefill``: batch-1, prompts padded to a fixed ``prefill_width`` (pad
   rows are routed to the paged pool's trash page and the last REAL row's
   logits sample token 0);
 - ``step``: all ``num_slots`` rows advance one token — inactive slots
   decode garbage into the trash page and their sample is discarded.

Both run GPT's paged forward (models/gpt.py), whose attention is the
Hopper kernel ``csrc/paged_decode.cu`` on the card (the plain PyTorch
twin on the CPU): every layer of every prefill and step launches it once.

KV state lives in a paged pool (``ops/paged_kv.py``) that the forward
writes in place: fixed-size pages in one shared buffer, a per-slot page
table, and a host-side free-list allocator, so slot occupancy — not
worst-case sequence length — bounds device memory. Pages are allocated
lazily at each page boundary; on exhaustion the most-recently-admitted
active slot — possibly the requester itself — is evicted (pages freed,
request requeued at the queue FRONT), so the oldest sequence always
advances and no pair of growing sequences can livelock each other.
Sampling draws are keyed by (seed, position) only (models/gpt._sample),
so a restarted sequence regenerates identical tokens and its future never
re-emits ones already streamed.

Robustness / telemetry: bounded admission queue (``QueueFullError``),
per-request deadlines (``DeadlineExceededError``, fast-failed at submit
when already expired), a ``fault.CircuitBreaker`` + ``gen.step`` chaos
point around device calls, ``gen.*`` metrics in the observability
registry, and request-scoped timelines.

``config.kv_cache_int8`` stores the pool as int8 banks with per-row
scales (ops/paged_kv.py); attention then runs kernel 7.

Not ported yet, each raising with its ROADMAP item: the prefix cache
(``prefix_cache=True`` / ``prefix_cache_pages``), int8 weight-only
serving (``precision='int8_wo'``), mesh sharding (``mesh=`` / ``mp>1``) and the telemetry HTTP plane
(``telemetry_port=``).

Captured device calls (the reference's ``_build_fns``/``_fns_pair``): the
prefill and the step are each one CUDA graph (``models.decode_cache.
CapturedFn``), captured once per engine, at ``warmup()`` or at first use.
Their inputs (tokens, positions, page tables, seeds, valid rows, start)
live in static device buffers, copied in from pinned staging on every
call; the parameters and the pool stay where they are for the engine's
life (a device failure zeroes the pool in place). ``_trace_count`` counts
captures, as the reference's counts traces: ``warmup()`` makes it 2 and
live traffic adds nothing. On the CPU the same functions run eagerly from
the same buffers. A failed capture or replay fails the call; it never
falls back to the eager path.

Env knobs: ``PADDLE_TPU_GEN_SLOTS`` (default 8),
``PADDLE_TPU_GEN_PAGE_SIZE`` (default 128, clamped to max_seq_len).
"""
import itertools
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from .. import fault
from .. import observability as _obs
from .. import resolve_device
from ..models import gpt as _gpt
from ..models.decode_cache import CapturedFn
from ..ops import paged_kv as _pkv
from .errors import DeadlineExceededError, EngineClosedError, QueueFullError

ENV_SLOTS = 'PADDLE_TPU_GEN_SLOTS'
ENV_PAGE_SIZE = 'PADDLE_TPU_GEN_PAGE_SIZE'

_HIST_WINDOW = 4096

# sentinel distinguishing "deadline not supplied" from "no deadline"
_UNSET = object()


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _not_ported(what, item):
    return NotImplementedError(
        f'GenerationEngine: {what} is not ported to paddle_tpu_torch yet '
        f'(ROADMAP Queue 1: {item})')


def _resolve_generation_model(net, config, forward_fn):
    """(params, config, forward_fn) as the reference's
    ``_resolve_generation_model`` takes them: a model with ``.config``
    (``models.gpt.GPTForCausalLM``, whose ``param_dict()`` gives the
    parameters) when ``config`` is None, else a ``(params, config)`` pair;
    ``forward_fn`` defaults to GPT's ``forward_with_cache``."""
    if config is None:
        cfg = getattr(net, 'config', None)
        if cfg is None:
            raise TypeError('GenerationEngine needs a model with a .config '
                            'or an explicit (params, config) pair')
        params = net.param_dict()
    else:
        params, cfg = net, config
    if 'moe' in type(cfg).__name__.lower():
        raise _not_ported('a MoE model', 'step H, item 9: other models')
    return params, cfg, forward_fn or _gpt.forward_with_cache


class GenerationFuture:
    """Handle for one submitted sequence. ``result()`` blocks for the full
    token list; ``stream()`` yields tokens as decode iterations emit them.
    Eviction/readmission never re-yields: regenerated tokens are only
    appended past what the future already holds."""

    def __init__(self):
        self._cv = threading.Condition()
        self._tokens = []
        self._done = False
        self._exc = None

    # ---- engine-internal ------------------------------------------------
    def _count(self):
        with self._cv:
            return len(self._tokens)

    def _append(self, tok):
        with self._cv:
            if self._done:
                return
            self._tokens.append(int(tok))
            self._cv.notify_all()

    def _finish(self, exc=None):
        with self._cv:
            if self._done:
                return False
            self._done = True
            self._exc = exc
            self._cv.notify_all()
        return True

    # ---- caller API -----------------------------------------------------
    def done(self):
        with self._cv:
            return self._done

    def exception(self, timeout=None):
        with self._cv:
            if not self._cv.wait_for(lambda: self._done, timeout):
                raise TimeoutError('generation still running')
            return self._exc

    def result(self, timeout=None):
        exc = self.exception(timeout)
        if exc is not None:
            raise exc
        with self._cv:
            return list(self._tokens)

    def stream(self, timeout=None):
        """Generator of tokens in emission order; returns at EOS/limit,
        raises the failure exception if the sequence failed."""
        i = 0
        while True:
            with self._cv:
                if not self._cv.wait_for(
                        lambda: self._done or i < len(self._tokens), timeout):
                    raise TimeoutError('generation stalled')
                if i < len(self._tokens):
                    tok = self._tokens[i]
                    i += 1
                elif self._exc is not None:
                    raise self._exc
                else:
                    return
            yield tok


class _Request:
    __slots__ = ('prompt', 'eff_max_new', 'seed', 'future', 'enqueue_t',
                 'deadline_t', 'evictions', 'ttft_noted', 'rec')

    def __init__(self, prompt, eff_max_new, seed, future, enqueue_t,
                 deadline_t, rec=None):
        self.prompt = prompt
        self.eff_max_new = eff_max_new
        self.seed = seed
        self.future = future
        self.enqueue_t = enqueue_t
        self.deadline_t = deadline_t
        self.evictions = 0
        self.ttft_noted = False
        # request-scoped trace record (observability.reqtrace); the shared
        # no-op singleton when the layer is disabled
        self.rec = rec if rec is not None else _obs.NULL_RECORD


class _Slot:
    __slots__ = ('req', 'pos', 'last_tok', 'produced', 'table', 'admit_seq')

    def __init__(self, req, table, admit_seq):
        self.req = req
        self.pos = len(req.prompt)      # next KV write position
        self.last_tok = 0
        self.produced = 0
        self.table = table              # np [p_max] i32, 0 = unallocated
        self.admit_seq = admit_seq


class GenerationEngine:
    """Continuous-batching generation over one GPT model.

    ``GenerationEngine(model)`` serves a ``models.gpt.GPTForCausalLM`` on
    the model's device; ``GenerationEngine(params, config, device=None)``
    a parameter dict (``models.gpt.init_params`` or ``params_from_numpy``)
    with its ``models.gpt.GPTConfig``, on ``cuda`` unless ``device='cpu'``
    is given (raising when there is no card). ``forward_fn`` replaces
    GPT's ``forward_with_cache`` (same signature) for another model
    family. ``submit(prompt)`` returns a
    ``GenerationFuture`` immediately; the scheduler thread prefills it
    into a free slot and advances it one token per decode iteration
    alongside every other active sequence. Sampling knobs
    (temperature/top_k/top_p, greedy by default) are engine-wide while
    the RNG seed is per-request.
    """

    _seq = itertools.count()

    def __init__(self, net, config=None, *, device=None, num_slots=None,
                 page_size=None, num_pages=None, prefill_width=None,
                 temperature=0.0, top_k=None, top_p=None, eos_id=None,
                 queue_capacity=64, default_deadline_ms=None, breaker=None,
                 autostart=True, forward_fn=None, clock=None, precision=None,
                 telemetry_port=None, prefix_cache=None,
                 prefix_cache_pages=None, mesh=None, mp=None):
        if precision not in (None, 'float32', 'int8_wo'):
            raise ValueError(
                f"GenerationEngine precision must be None/'float32'/"
                f"'int8_wo', got {precision!r}")
        if precision == 'int8_wo':
            raise _not_ported("precision='int8_wo'", 'item 5, low precision')
        if prefix_cache or prefix_cache_pages is not None:
            raise _not_ported('the prefix cache',
                              'item 1, deferred: prefix cache')
        if mesh is not None or (mp is not None and int(mp) != 1):
            raise _not_ported('mesh sharding (mesh= / mp>1)',
                              'item 1, deferred: mesh-sharded serving')
        if telemetry_port is not None:
            raise _not_ported('the telemetry HTTP plane (telemetry_port=)',
                              'item 1, deferred: telemetry HTTP plane')
        params, cfg, self._forward_fn = _resolve_generation_model(
            net, config, forward_fn)
        if device is None and config is None:
            device = net.device
        self.device = resolve_device(device)
        params = {k: ({bk: bv.to(self.device) for bk, bv in v.items()}
                      if k == 'blocks' else v.to(self.device))
                  for k, v in params.items()}
        self._params = _gpt.serving_params(params, cfg)
        self.config = cfg
        self._precision = precision or 'float32'

        s_max = int(cfg.max_seq_len)
        self.max_seq_len = s_max
        self.num_slots = int(num_slots if num_slots is not None
                             else _env_int(ENV_SLOTS, 8))
        ps = int(page_size if page_size is not None
                 else min(_env_int(ENV_PAGE_SIZE, 128), s_max))
        if ps < 1:
            raise ValueError(f'page_size must be >= 1, got {ps}')
        self.page_size = ps
        self.p_max = _pkv.pages_for(s_max, ps)
        self.prefill_width = int(prefill_width if prefill_width is not None
                                 else s_max)
        if not 1 <= self.prefill_width <= s_max:
            raise ValueError(
                f'prefill_width {self.prefill_width} outside '
                f'[1, {s_max}]')
        # +1: page 0 is the reserved trash page
        self.num_pages = int(num_pages if num_pages is not None
                             else self.num_slots * self.p_max + 1)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.queue_capacity = int(queue_capacity)
        self.default_deadline_ms = default_deadline_ms
        self._breaker = breaker if breaker is not None else \
            fault.CircuitBreaker(failure_threshold=5, recovery_timeout=5.0)
        self._clock = clock or time.monotonic
        self._autostart = autostart

        self._pool = _gpt.init_paged_kv_cache(cfg, self.num_pages, ps,
                                              self.device)
        self._alloc = _pkv.PageAllocator(self.num_pages)
        self._slots = [None] * self.num_slots
        self._queue = deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._thread = None
        self._closed = False
        self._draining = False
        self._admit_seq = 0
        self._trace_count = 0
        self._fns = {}           # 'prefill' / 'step' -> CapturedFn
        self._capture = True     # False: eager, for comparisons only
        self._start_t = self._clock()
        self._n = {k: 0 for k in ('submitted', 'completed', 'rejected',
                                  'expired', 'failed', 'evictions',
                                  'tokens', 'prefills', 'steps')}
        self._make_metrics()
        # readiness: warm AND breaker closed AND queue below capacity
        self._warmed = False
        self._probe_name = f'serving.{self.labels["engine"]}'
        _obs.add_readiness(self._probe_name, self._readiness_probe)

    def _readiness_probe(self):
        with self._lock:
            depth = len(self._queue)
            closed = self._closed
        warm = self._warmed
        breaker = self._breaker.state
        ready = (warm and breaker == 'closed'
                 and depth < self.queue_capacity and not closed)
        return {'ready': ready, 'warm': warm, 'breaker': breaker,
                'queue_depth': depth, 'queue_capacity': self.queue_capacity,
                'closed': closed}

    # ---- telemetry -------------------------------------------------------
    def _make_metrics(self):
        labels = self.labels = {'engine': f'g{next(GenerationEngine._seq)}'}
        if _obs.enabled():
            reg = _obs.registry()
            mk_c = lambda n: reg.counter(n, labels)             # noqa: E731
            mk_h = lambda n: reg.histogram(n, labels,           # noqa: E731
                                           window=_HIST_WINDOW)
            mk_g = lambda n: reg.gauge(n, labels)               # noqa: E731
        else:
            mk_c = lambda n: _obs.Counter(n, labels)            # noqa: E731
            mk_h = lambda n: _obs.Histogram(n, labels,          # noqa: E731
                                            window=_HIST_WINDOW)
            mk_g = lambda n: _obs.Gauge(n, labels)              # noqa: E731
        self._c = {k: mk_c(f'gen.requests_{k}') for k in
                   ('submitted', 'completed', 'rejected', 'expired',
                    'failed')}
        self._c['evictions'] = mk_c('gen.evictions')
        self._c['tokens'] = mk_c('gen.tokens')
        self._h = {'prefill': mk_h('gen.prefill_ms'),
                   'step': mk_h('gen.decode_step_ms'),
                   'ttft': mk_h('gen.ttft_ms'),
                   # observed at admit from the ORIGINAL enqueue_t, which
                   # requeue-after-eviction preserves
                   'queue_wait': mk_h('serve.queue_wait_ms')}
        self._g = {'occupancy': mk_g('gen.slot_occupancy'),
                   'pages': mk_g('gen.page_utilization')}

    def _note(self, key, n=1):
        self._n[key] += n
        c = self._c.get(key)
        if c is not None:
            c.inc(n)

    def _update_gauges_locked(self):
        active = sum(1 for s in self._slots if s is not None)
        self._g['occupancy'].set(active / max(self.num_slots, 1))
        # page 0 (the reserved trash page) is excluded from the
        # denominator: a fully loaded pool reads 1.0
        usable = max(self.num_pages - 1, 1)
        self._g['pages'].set(self._alloc.used_pages / usable)

    # ---- device calls ----------------------------------------------------
    def _sample_rows(self, lg, seeds, positions):
        # greedy is a per-row argmax; sampled draws are keyed by (seed,
        # input position) only — batch-composition independent
        return _gpt._sample(lg, self.temperature, self.top_k, self.top_p,
                            seeds=seeds, positions=positions)

    def _prefill_fn(self, prompt, start, valid, table, seed):
        """One padded batch-1 prefill from the static buffers; the pool is
        written in place. -> sampled first token [1] int32."""
        cache = {'k': self._pool['k'], 'v': self._pool['v'],
                 'page_table': table, 'valid': valid}
        logits, _ = self._forward_fn(self._params, prompt, cache, start,
                                     self.config, last_only=True)
        # absolute position start+valid-1 keys the prompt's last row
        return self._sample_rows(logits[:, 0], seed, start + valid - 1)

    def _step_fn(self, tok, pos, table, seeds):
        """One decode step over every slot from the static buffers; the
        pool is written in place. -> next token per slot [S] int32."""
        cache = {'k': self._pool['k'], 'v': self._pool['v'],
                 'page_table': table}
        logits, _ = self._forward_fn(self._params, tok[:, None], cache, pos,
                                     self.config)
        return self._sample_rows(logits[:, 0], seeds, pos)

    def _build_fn(self, kind):
        """Capture the prefill or the step over zeroed static buffers (the
        warm-up runs write the trash page only)."""
        s, p_max, dev = self.num_slots, self.p_max, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        if kind == 'prefill':
            fn, bufs = self._prefill_fn, dict(
                prompt=torch.zeros((1, self.prefill_width), **i32),
                start=torch.zeros((1,), **i32),
                valid=torch.ones((1,), **i32),
                table=torch.zeros((1, p_max), **i32),
                seed=torch.zeros((1,), **i64))
        else:
            fn, bufs = self._step_fn, dict(
                tok=torch.zeros((s,), **i32), pos=torch.zeros((s,), **i32),
                table=torch.zeros((s, p_max), **i32),
                seeds=torch.zeros((s,), **i64))
        cap = CapturedFn(fn, bufs, dev, capture=self._capture)
        self._trace_count += 1
        return cap

    def _fn(self, kind):
        """The engine's captured ``kind`` ('prefill' or 'step'), captured
        on first use (``warmup()`` does both before traffic)."""
        cap = self._fns.get(kind)
        if cap is None:
            cap = self._fns[kind] = self._build_fn(kind)
        return cap

    @torch.no_grad()
    def _prefill_call(self, prompt, start, valid, table, seed):
        """One padded batch-1 prefill (numpy inputs). -> sampled first
        token [1] int32 (on the device)."""
        return self._fn('prefill').replay(prompt=prompt, start=start,
                                          valid=valid, table=table,
                                          seed=seed)

    @torch.no_grad()
    def _step_call(self, tok, pos, table, seeds):
        """One decode step over every slot (numpy inputs). -> next token
        per slot [S] int32 (on the device)."""
        return self._fn('step').replay(tok=tok, pos=pos, table=table,
                                       seeds=seeds)

    def warmup(self):
        """Capture the prefill and the decode step before traffic (a live
        call after this captures nothing), replay each once into the trash
        page, and flip the readiness warm check. Returns ``{'prebuilt': the
        functions captured now, 'already_cached': those captured before,
        'seconds': ...}``."""
        t0 = time.perf_counter()
        kinds = ('prefill', 'step')
        cached = sum(k in self._fns for k in kinds)
        s, p_max = self.num_slots, self.p_max
        self._prefill_call(np.zeros((1, self.prefill_width), np.int32),
                           np.zeros((1,), np.int32),
                           np.ones((1,), np.int32),
                           np.zeros((1, p_max), np.int32),
                           np.zeros((1,), np.int64)).cpu()
        self._step_call(np.zeros((s,), np.int32), np.zeros((s,), np.int32),
                        np.zeros((s, p_max), np.int32),
                        np.zeros((s,), np.int64)).cpu()
        self._warmed = True
        return {'prebuilt': len(kinds) - cached, 'already_cached': cached,
                'seconds': time.perf_counter() - t0}

    # ---- lifecycle -------------------------------------------------------
    def start(self):
        with self._lock:
            if self._closed:
                raise EngineClosedError('engine already shut down')
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._scheduler_loop,
                    name='paddle-tpu-torch-generation-sched', daemon=True)
                self._thread.start()
        return self

    def shutdown(self, drain=True, timeout=None):
        """Stop the scheduler. ``drain=True`` finishes every admitted and
        queued sequence first; otherwise their futures fail with
        EngineClosedError."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._draining = drain
            failed = []
            if not drain:
                failed = [r for r in self._queue]
                self._queue.clear()
                for i, slot in enumerate(self._slots):
                    if slot is not None:
                        failed.append(slot.req)
                        self._free_slot_locked(i)
            inline = drain and self._thread is None
            self._cv.notify_all()
        for r in failed:
            err = EngineClosedError('engine shut down')
            r.rec.note('cancel')
            r.rec.finish('cancelled', err)
            if r.future._finish(err):
                self._note('failed')
        if inline:
            self._drain_inline()
        if self._thread is not None:
            self._thread.join(timeout)
        _obs.remove_readiness(self._probe_name)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # ---- admission -------------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, deadline_ms=None, seed=0):
        """Enqueue one sequence. ``prompt`` is a 1-D token id sequence of
        length 1..prefill_width; returns a ``GenerationFuture``. Tokens
        stop at ``eos_id`` (emitted), ``max_new_tokens``, or the context
        window (a prompt of exactly max_seq_len still yields one token).
        A deadline that has already passed raises
        ``DeadlineExceededError`` here instead of queueing."""
        arr = np.asarray(prompt, dtype=np.int32).reshape(-1)
        t0 = int(arr.size)
        if not 1 <= t0 <= self.prefill_width:
            raise ValueError(
                f'prompt length {t0} outside [1, {self.prefill_width}] '
                f'(prefill_width)')
        if int(max_new_tokens) < 1:
            raise ValueError('max_new_tokens must be >= 1')
        # the final decode write lands at position max_seq_len-1; the +1 is
        # the token sampled from that full-window step
        eff = min(int(max_new_tokens), self.max_seq_len - t0 + 1)
        deadline_ms = (deadline_ms if deadline_ms is not None
                       else self.default_deadline_ms)
        now = self._clock()
        deadline_t = (now + deadline_ms / 1e3
                      if deadline_ms is not None else None)
        fut = GenerationFuture()
        rec = _obs.start_request('gen', engine=self.labels['engine'],
                                 prompt_len=t0, max_new=eff)
        fut.request_id = rec.rid
        if deadline_t is not None and now >= deadline_t:
            # already unmeetable: fail fast instead of queueing a request
            # the admitter would only expire after it reached a slot
            err = DeadlineExceededError(0.0, float(deadline_ms))
            self._note('expired')
            rec.note('expire', waited_ms=0.0, fast_fail=True)
            rec.finish('expired', err)
            raise err
        req = _Request(arr, eff, int(seed) & 0xFFFFFFFF, fut, now,
                       deadline_t, rec=rec)
        try:
            with self._cv:
                if self._closed:
                    raise EngineClosedError('engine already shut down')
                if len(self._queue) >= self.queue_capacity:
                    self._note('rejected')
                    raise QueueFullError(self.queue_capacity,
                                         len(self._queue))
                rec.note('enqueue', depth=len(self._queue))
                self._queue.append(req)
                self._note('submitted')
                self._cv.notify_all()
        except Exception as e:
            rec.finish('rejected', e)
            raise
        if self._autostart and self._thread is None:
            self.start()
        return fut

    # ---- scheduler -------------------------------------------------------
    def _scheduler_loop(self):
        while True:
            with self._cv:
                while (not self._closed and not self._queue
                       and not any(s is not None for s in self._slots)):
                    self._cv.wait(0.05)
                if self._closed:
                    if not self._draining:
                        return
                    if (not self._queue
                            and not any(s is not None for s in self._slots)):
                        return
                admitted = self._admit_locked()
            for idx in admitted:
                self._prefill_one(idx)
            if any(s is not None for s in self._slots):
                self._decode_step()

    def _drain_inline(self):
        """Finish all admitted+queued work on the caller's thread (used by
        shutdown(drain=True) when no scheduler thread ever started)."""
        while True:
            with self._cv:
                if (not self._queue
                        and not any(s is not None for s in self._slots)):
                    return
                admitted = self._admit_locked()
            for idx in admitted:
                self._prefill_one(idx)
            if any(s is not None for s in self._slots):
                self._decode_step()

    def _admit_locked(self):
        out = []
        while self._queue:
            free_idx = next((i for i, s in enumerate(self._slots)
                             if s is None), None)
            if free_idx is None:
                break
            req = self._queue[0]
            now = self._clock()
            if req.deadline_t is not None and now > req.deadline_t:
                self._queue.popleft()
                waited = (now - req.enqueue_t) * 1e3
                limit = (req.deadline_t - req.enqueue_t) * 1e3
                err = DeadlineExceededError(waited, limit)
                req.rec.note('expire', waited_ms=round(waited, 3))
                req.rec.finish('expired', err)
                if req.future._finish(err):
                    self._note('expired')
                continue
            need = _pkv.pages_for(len(req.prompt), self.page_size)
            if need > self.num_pages - 1:
                self._queue.popleft()
                err = ValueError(
                    f'prompt needs {need} pages but the pool only has '
                    f'{self.num_pages - 1} allocatable')
                req.rec.finish('error', err)
                req.future._finish(err)
                self._note('failed')
                continue
            pages = self._alloc.alloc(need)
            if pages is None:
                break       # active slots will free pages; retry next round
            self._queue.popleft()
            table = np.zeros((self.p_max,), np.int32)
            table[:need] = pages
            waited_ms = max(0.0, (now - req.enqueue_t) * 1e3)
            self._h['queue_wait'].observe(waited_ms)
            req.rec.note('admit', slot=free_idx, pages=need,
                         waited_ms=round(waited_ms, 3))
            self._slots[free_idx] = _Slot(req, table, self._admit_seq)
            self._admit_seq += 1
            out.append(free_idx)
        if out:
            self._update_gauges_locked()
        return out

    def _prefill_one(self, idx):
        slot = self._slots[idx]
        if slot is None:
            return
        req = slot.req
        t0 = len(req.prompt)
        prompt = np.zeros((1, self.prefill_width), np.int32)
        prompt[0, :t0] = req.prompt
        start = np.zeros((1,), np.int32)
        valid = np.asarray([t0], np.int32)
        table = slot.table[None].copy()
        seed = np.asarray([req.seed], np.int64)
        wall0 = time.perf_counter()

        def dev():
            fault.inject('gen.step')
            tok = self._prefill_call(prompt, start, valid, table, seed)
            return int(tok.cpu()[0])

        req.rec.note('prefill', slot=idx, prompt_len=t0)
        try:
            with _obs.span('gen.prefill', slot=idx, prompt_len=t0,
                           req_id=req.rec.rid):
                tok = self._breaker.call(dev)
        except Exception as e:
            self._handle_device_failure(e)
            return
        self._h['prefill'].observe(1e3 * (time.perf_counter() - wall0))
        self._n['prefills'] += 1
        with self._cv:
            slot.last_tok = tok
            self._emit_locked(slot, tok)
            if self._slot_finished(slot, tok):
                self._finish_slot_locked(idx)
            self._update_gauges_locked()

    def _decode_step(self):
        s = self.num_slots
        tok = np.zeros((s,), np.int32)
        pos = np.zeros((s,), np.int32)
        table = np.zeros((s, self.p_max), np.int32)
        seeds = np.zeros((s,), np.int64)
        rids = []
        with self._cv:
            self._ensure_pages_locked()
            active = []
            for i, slot in enumerate(self._slots):
                if slot is None:
                    continue
                tok[i] = slot.last_tok
                pos[i] = slot.pos
                table[i] = slot.table
                seeds[i] = slot.req.seed
                active.append(i)
                if slot.req.rec.rid:
                    rids.append(slot.req.rec.rid)
        if not active:
            return
        wall0 = time.perf_counter()

        def dev():
            fault.inject('gen.step')
            # ONE host readback per iteration for every slot
            return self._step_call(tok, pos, table, seeds).cpu().numpy()

        try:
            with _obs.span('gen.decode_step', slots=len(active),
                           req_ids=rids):
                nxt = self._breaker.call(dev)
        except Exception as e:
            self._handle_device_failure(e)
            return
        self._h['step'].observe(1e3 * (time.perf_counter() - wall0))
        self._n['steps'] += 1
        with self._cv:
            for i in active:
                slot = self._slots[i]
                if slot is None:        # evicted between snapshot and here
                    continue
                t = int(nxt[i])
                slot.pos += 1
                slot.last_tok = t
                slot.req.rec.note_decode(slot.pos)
                self._emit_locked(slot, t)
                if self._slot_finished(slot, t):
                    self._finish_slot_locked(i)
            self._update_gauges_locked()
            self._cv.notify_all()

    # ---- slot state (all called under the lock) --------------------------
    def _emit_locked(self, slot, tok):
        req = slot.req
        idx = slot.produced
        slot.produced += 1
        self._note('tokens')
        if idx >= req.future._count():
            req.future._append(tok)
            if not req.ttft_noted:
                req.ttft_noted = True
                ttft_ms = 1e3 * (self._clock() - req.enqueue_t)
                self._h['ttft'].observe(ttft_ms)
                req.rec.note('first_emit', ttft_ms=round(ttft_ms, 3))

    def _slot_finished(self, slot, tok):
        if self.eos_id is not None and tok == self.eos_id:
            return True
        if slot.produced >= slot.req.eff_max_new:
            return True
        return slot.pos >= self.max_seq_len

    def _free_slot_locked(self, idx):
        slot = self._slots[idx]
        pages = [int(p) for p in slot.table if p != _pkv.TRASH_PAGE]
        if pages:
            self._alloc.free(pages)
        self._slots[idx] = None

    def _finish_slot_locked(self, idx):
        slot = self._slots[idx]
        self._free_slot_locked(idx)
        slot.req.rec.note('retire', produced=slot.produced,
                          evictions=slot.req.evictions)
        slot.req.rec.finish('ok')
        if slot.req.future._finish():
            self._note('completed')
        self._cv.notify_all()

    def _ensure_pages_locked(self):
        """Allocate the next page for any slot crossing a page boundary.
        On pool exhaustion, evict the most-recently-admitted active slot —
        INCLUDING the requester itself (self-preemption). The oldest
        active sequence is therefore never a victim: it monotonically
        advances, finishes, and frees its pages, which bounds every other
        sequence's wait (the no-livelock invariant). An evicted request
        requeues at the FRONT and later regenerates identical tokens."""
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            li = slot.pos // self.page_size
            if li >= self.p_max or slot.table[li] != _pkv.TRASH_PAGE:
                continue
            while True:
                pg = self._alloc.alloc(1)
                if pg is not None:
                    slot.table[li] = pg[0]
                    break
                victim = self._pick_victim_locked()
                only = sum(1 for s in self._slots if s is not None) == 1
                if victim == i and only:
                    # alone and exhausted: this request's total demand
                    # exceeds the whole pool — retrying cannot succeed
                    self._free_slot_locked(i)
                    if slot.req.future._finish(RuntimeError(
                            f'request needs more KV pages than the pool '
                            f'holds ({self.num_pages - 1} allocatable)')):
                        self._note('failed')
                    break
                self._evict_locked(victim)
                if victim == i:
                    break       # self-preempted; re-admitted when pages free
            # fall through to the next slot whether or not i survived

    def _pick_victim_locked(self):
        best, best_seq = None, -1
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if slot.admit_seq > best_seq:
                best, best_seq = i, slot.admit_seq
        return best

    def _evict_locked(self, idx):
        slot = self._slots[idx]
        req = slot.req
        self._free_slot_locked(idx)
        req.evictions += 1
        req.rec.note('evict', count=req.evictions)
        self._note('evictions')
        # FRONT of the queue: an evicted sequence restarts before any new
        # arrival — bounded starvation, deterministic regeneration
        self._queue.appendleft(req)

    def _handle_device_failure(self, exc):
        """A failed device call may have left the pool half written: fail
        every active sequence, release their pages, zero the pool."""
        with self._cv:
            failed = []
            for i, slot in enumerate(self._slots):
                if slot is not None:
                    failed.append(slot.req)
                    self._free_slot_locked(i)
            # the captured prefill and step hold the pool's addresses
            _gpt.zero_kv(self._pool)
            self._update_gauges_locked()
            self._cv.notify_all()
        for r in failed:
            r.rec.finish('error', exc)
            if r.future._finish(exc):
                self._note('failed')

    # ---- observability ---------------------------------------------------
    def stats(self):
        elapsed = max(self._clock() - self._start_t, 1e-9)

        def pct(h, q):
            v = h.percentile(q)
            return round(v, 3) if v is not None else 0.0

        with self._lock:
            active = sum(1 for s in self._slots if s is not None)
            depth = len(self._queue)
            free_pages = self._alloc.free_pages
        out = dict(self._n)
        out.update({
            'active_slots': active,
            'queue_depth': depth,
            'free_pages': free_pages,
            'num_slots': self.num_slots,
            'page_size': self.page_size,
            'num_pages': self.num_pages,
            'prefill_width': self.prefill_width,
            'tokens_per_sec': round(self._n['tokens'] / elapsed, 2),
            'prefill_ms_p50': pct(self._h['prefill'], 50),
            'prefill_ms_p99': pct(self._h['prefill'], 99),
            'prefill_ms_mean': self._h['prefill'].mean,
            'decode_step_ms_p50': pct(self._h['step'], 50),
            'decode_step_ms_p99': pct(self._h['step'], 99),
            'decode_step_ms_mean': self._h['step'].mean,
            'ttft_ms_p50': pct(self._h['ttft'], 50),
            'ttft_ms_p99': pct(self._h['ttft'], 99),
            'traces': self._trace_count,
            'circuit_state': self._breaker.state,
            'precision': self._precision,
            'device': str(self.device),
            'warmed': self._warmed,
            'uptime_s': round(elapsed, 3),
        })
        return out
