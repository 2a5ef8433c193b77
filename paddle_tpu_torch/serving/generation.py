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

Both run the model family's paged forward (``models/gpt.py``, or
``models/moe_gpt.py`` for a ``MoEConfig``, whose FFN routes each call's
rows through its experts), whose attention is the Hopper kernel
``csrc/paged_decode.cu`` on the card (the plain PyTorch twin on the CPU):
every layer of every prefill and step launches it once.

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
``precision='int8_wo'`` quantizes the weights once, at construction
(the family's ``quantize_decode_params``): GPT's four block matrices, or
MoE's attention matrices and expert banks, and the tied embedding are
served as int8 banks with per-channel scales.

With ``prefix_cache=True`` the engine indexes finished sequences' pages in
a :class:`~.prefix_cache.PrefixCache` (tenant-namespaced trie over
page-aligned chunks): a later request with a cached prefix is admitted
with those pages pre-mapped and prefills only the uncached tail through
the SAME captured prefill (the tail's start position is one of its device
buffers: zero new captures, provable via ``_trace_count``); an exact
``(prompt, seed)`` repeat skips the prefill device call entirely and
replays the recorded first token; when it finds the queue empty and the
scheduler running, ``submit`` admits it itself, so its first token is
there before ``submit`` returns (the scheduler thread then only steps it).
Shared pages are refcounted by the allocator; mid-page divergence copies
the page (copy-on-write) before any write, and cache residency is
released LRU before any live slot is ever evicted for pages.

Not ported yet, each raising with its ROADMAP item: mesh sharding
(``mesh=`` / ``mp>1``; for MoE, expert parallelism, step K) and the
telemetry HTTP plane (``telemetry_port=``).

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
``PADDLE_TPU_GEN_PAGE_SIZE`` (default 128, clamped to max_seq_len),
``PADDLE_TPU_GEN_PREFIX`` (=1 enables the prefix cache by default).
"""
import itertools
import os
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from .. import fault
from .. import observability as _obs
from .. import resolve_device
from ..models import gpt as _gpt
from ..models import moe_gpt as _moe
from ..models.decode_cache import CapturedFn
from ..ops import paged_kv as _pkv
from ..ops.weight_only import is_weight_only
from .errors import DeadlineExceededError, EngineClosedError, QueueFullError
from .prefix_cache import PrefixCache

ENV_SLOTS = 'PADDLE_TPU_GEN_SLOTS'
ENV_PAGE_SIZE = 'PADDLE_TPU_GEN_PAGE_SIZE'
ENV_PREFIX = 'PADDLE_TPU_GEN_PREFIX'

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


def _family(cfg):
    """The model module serving ``cfg``: ``models.moe_gpt`` for a MoE
    config (the reference tells them by the config's class name), else
    ``models.gpt``."""
    return _moe if 'moe' in type(cfg).__name__.lower() else _gpt


def _resolve_generation_model(net, config, forward_fn):
    """(params, config, forward_fn) as the reference's
    ``_resolve_generation_model`` takes them: a model with ``.config``
    (``models.gpt.GPTForCausalLM``, whose ``_decode_params()`` gives the
    parameters it serves: its own, or its int8 snapshot after
    ``enable_int8_decode()``) when ``config`` is None, else a ``(params,
    config)`` pair; ``forward_fn`` defaults to the family's
    ``forward_with_cache`` (GPT's, or MoE's for a ``MoEConfig``)."""
    if config is None:
        cfg = getattr(net, 'config', None)
        if cfg is None:
            raise TypeError('GenerationEngine needs a model with a .config '
                            'or an explicit (params, config) pair')
        params = (net._decode_params() if hasattr(net, '_decode_params')
                  else net.param_dict())
    else:
        params, cfg = net, config
    return params, cfg, forward_fn or _family(cfg).forward_with_cache


def _to_device(tree, dev):
    """A parameter dict (int8 banks included) with every tensor on
    ``dev``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


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
        self._listeners = []

    # ---- engine-internal ------------------------------------------------
    def _count(self):
        with self._cv:
            return len(self._tokens)

    def _snapshot(self, n):
        """First ``n`` emitted tokens (the prefix-cache publisher's view of
        what the KV rows past the prompt hold)."""
        with self._cv:
            return [int(t) for t in self._tokens[:n]]

    def _subscribe(self, fn):
        """Register ``fn(kind, *args)`` invoked OUTSIDE the future's lock:
        ``('token', idx, tok)`` per emission and ``('finish', exc)`` once.
        Tokens already emitted are replayed so a late subscriber misses
        nothing; the index identifies each token's position."""
        with self._cv:
            self._listeners.append(fn)
            replay = list(enumerate(self._tokens))
            done, exc = self._done, self._exc
        for i, t in replay:
            fn('token', i, t)
        if done:
            fn('finish', exc)

    def _append(self, tok):
        with self._cv:
            if self._done:
                return
            self._tokens.append(int(tok))
            idx = len(self._tokens) - 1
            listeners = list(self._listeners)
            self._cv.notify_all()
        # listeners run outside the lock: they may take other locks that
        # must never nest inside this one
        for fn in listeners:
            fn('token', idx, int(tok))

    def _finish(self, exc=None):
        with self._cv:
            if self._done:
                return False
            self._done = True
            self._exc = exc
            listeners = list(self._listeners)
            self._cv.notify_all()
        for fn in listeners:
            fn('finish', exc)
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
                 'deadline_t', 'evictions', 'ttft_noted', 'rec', 'tenant')

    def __init__(self, prompt, eff_max_new, seed, future, enqueue_t,
                 deadline_t, rec=None, tenant='default'):
        self.prompt = prompt
        self.eff_max_new = eff_max_new
        self.seed = seed
        self.tenant = tenant
        self.future = future
        self.enqueue_t = enqueue_t
        self.deadline_t = deadline_t
        self.evictions = 0
        self.ttft_noted = False
        # request-scoped trace record (observability.reqtrace); the shared
        # no-op singleton when the layer is disabled
        self.rec = rec if rec is not None else _obs.NULL_RECORD


class _Slot:
    __slots__ = ('req', 'pos', 'last_tok', 'produced', 'table', 'admit_seq',
                 'start', 'cow', 'first_tok')

    def __init__(self, req, table, admit_seq, start=0, cow=None,
                 first_tok=None):
        self.req = req
        self.pos = len(req.prompt)      # next KV write position
        self.last_tok = 0
        self.produced = 0
        self.table = table              # np [p_max] i32, 0 = unallocated
        self.admit_seq = admit_seq
        self.start = start              # first prompt row prefill computes
                                        # (cached rows < start are mapped)
        self.cow = cow                  # pending (src, dst) page copy
        self.first_tok = first_tok      # full prefix hit: replay this token
                                        # instead of running prefill


class GenerationEngine:
    """Continuous-batching generation over one GPT or MoE GPT model.

    ``GenerationEngine(model)`` serves a ``models.gpt.GPTForCausalLM`` on
    the model's device; ``GenerationEngine(params, config, device=None)``
    a parameter dict (``models.gpt.init_params`` or ``params_from_numpy``)
    with its ``models.gpt.GPTConfig`` (or ``models.moe_gpt.init_params``
    with its ``MoEConfig``), on ``cuda`` unless ``device='cpu'`` is given
    (raising when there is no card). ``forward_fn`` replaces the family's
    ``forward_with_cache`` (same signature). ``submit(prompt)`` returns a
    ``GenerationFuture`` immediately; the scheduler thread prefills it
    into a free slot and advances it one token per decode iteration
    alongside every other active sequence. Sampling knobs
    (temperature/top_k/top_p, greedy by default) are engine-wide while
    the RNG seed is per-request. ``precision='int8_wo'`` serves int8
    weight-only matrices; ``prefix_cache=True`` (or ``prefix_cache_pages``,
    a residency bound, or ``PADDLE_TPU_GEN_PREFIX=1``) reuses the KV pages
    of earlier requests of the same tenant.
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
        if mesh is not None or (mp is not None and int(mp) != 1):
            cfg = config if config is not None else getattr(net, 'config',
                                                             None)
            if _family(cfg) is _moe:
                raise _not_ported('a MoE model over a mesh (mesh= / mp>1)',
                                  'step K, item 10: expert parallelism')
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
        params = _to_device(params, self.device)
        fam = _family(cfg)
        if precision == 'int8_wo' and not is_weight_only(params['wte']):
            # quantized once, here, on the engine's device, by the config's
            # family; a model already snapshot (enable_int8_decode) passes
            # through untouched
            params = fam.quantize_decode_params(params)
        self._params = fam.serving_params(params, cfg)
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
        # prefix cache: opt-in (constructor flag, giving it a residency
        # bound, or the env knob): page accounting changes when finished
        # sequences stay resident, so it is never silently enabled
        if prefix_cache is None:
            prefix_cache = (prefix_cache_pages is not None
                            or _env_int(ENV_PREFIX, 0) > 0)
        self._prefix = (PrefixCache(self._alloc, ps, prefix_cache_pages)
                        if prefix_cache else None)
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
                                  'tokens', 'prefills', 'steps',
                                  'prefix_hits', 'prefix_misses',
                                  'prefix_full_hits', 'prefix_tokens_saved',
                                  'prefix_evictions')}
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
        # gen.prefix.*: the prefix cache's series
        self._c['prefix_hits'] = mk_c('gen.prefix.hits')
        self._c['prefix_misses'] = mk_c('gen.prefix.misses')
        self._c['prefix_full_hits'] = mk_c('gen.prefix.full_hits')
        self._c['prefix_tokens_saved'] = mk_c('gen.prefix.tokens_saved')
        self._c['prefix_evictions'] = mk_c('gen.prefix.evictions')
        self._h = {'prefill': mk_h('gen.prefill_ms'),
                   'step': mk_h('gen.decode_step_ms'),
                   'ttft': mk_h('gen.ttft_ms'),
                   # observed at admit from the ORIGINAL enqueue_t, which
                   # requeue-after-eviction preserves
                   'queue_wait': mk_h('serve.queue_wait_ms')}
        self._g = {'occupancy': mk_g('gen.slot_occupancy'),
                   'pages': mk_g('gen.page_utilization'),
                   'prefix_pages': mk_g('gen.prefix.cached_pages')}

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
        if self._prefix is not None:
            self._g['prefix_pages'].set(self._prefix.cached_pages)
            ev = self._prefix.stats()['evictions']
            delta = ev - self._n['prefix_evictions']
            if delta > 0:
                self._note('prefix_evictions', delta)

    # ---- device calls ----------------------------------------------------
    def _sample_rows(self, lg, seeds, positions):
        # greedy is a per-row argmax; sampled draws are keyed by (seed,
        # input position) only — batch-composition independent
        return _gpt._sample(lg, self.temperature, self.top_k, self.top_p,
                            seeds=seeds, positions=positions)

    def _prefill_fn(self, prompt, start, valid, table, seed):
        """One padded batch-1 prefill from the static buffers; the pool is
        written in place. -> sampled first token [1] int32. ``start`` (a
        prefix-cache tail's first row, else 0) stays on the device with
        everything that depends on it (positions, the rows written, the
        ``wpe`` rows, the sampled row), so one capture serves cold prefills
        and tails alike; the tail's rows attend the cached pages through
        the paged kernel, as every prefill does."""
        cache = {'k': self._pool['k'], 'v': self._pool['v'],
                 'page_table': table, 'valid': valid}
        logits, _ = self._forward_fn(self._params, prompt, cache, start,
                                     self.config, last_only=True)
        # absolute position start+valid-1 keys the prompt's last row: the
        # sampling key must not depend on how much was cached
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
        self._maybe_record()
        cap = self._fns.get(kind)
        if cap is None:
            cap = self._fns[kind] = self._build_fn(kind)
        return cap

    def _manifest_entries(self):
        from ..warmup.manifest import generation_entry
        geom = dict(slots=self.num_slots, page_size=self.page_size,
                    num_pages=self.num_pages,
                    prefill_width=self.prefill_width,
                    table_width=self.p_max)
        return [generation_entry('gen_prefill', **geom),
                generation_entry('gen_decode', **geom)]

    def _maybe_record(self):
        """Record both functions into an active ``warmup.capture()``."""
        wm = sys.modules.get('paddle_tpu_torch.warmup.manifest')
        if wm is not None and wm.capturing():
            for e in self._manifest_entries():
                wm.record(e)

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

    def _warm(self, kind):
        """Capture ``kind`` ('prefill' or 'step') if it is not yet, and
        replay it once into the trash page. -> True when this captured."""
        new = kind not in self._fns
        s, p_max = self.num_slots, self.p_max
        if kind == 'prefill':
            self._prefill_call(np.zeros((1, self.prefill_width), np.int32),
                               np.zeros((1,), np.int32),
                               np.ones((1,), np.int32),
                               np.zeros((1, p_max), np.int32),
                               np.zeros((1,), np.int64)).cpu()
        else:
            self._step_call(np.zeros((s,), np.int32),
                            np.zeros((s,), np.int32),
                            np.zeros((s, p_max), np.int32),
                            np.zeros((s,), np.int64)).cpu()
        return new

    def warmup(self):
        """Capture the prefill and the decode step before traffic (a live
        call after this captures nothing), replay each once into the trash
        page, and flip the readiness warm check. Returns ``{'prebuilt': the
        functions captured now, 'already_cached': those captured before,
        'seconds': ...}``."""
        t0 = time.perf_counter()
        built = [self._warm(kind) for kind in ('prefill', 'step')]
        self._warmed = True
        return {'prebuilt': sum(built),
                'already_cached': len(built) - sum(built),
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
        if self._prefix is not None:
            with self._lock:
                self._prefix.clear()
        _obs.remove_readiness(self._probe_name)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # ---- admission -------------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, deadline_ms=None, seed=0,
               tenant='default'):
        """Enqueue one sequence. ``prompt`` is a 1-D token id sequence of
        length 1..prefill_width; returns a ``GenerationFuture``. Tokens
        stop at ``eos_id`` (emitted), ``max_new_tokens``, or the context
        window (a prompt of exactly max_seq_len still yields one token).
        ``tenant`` namespaces the prefix cache: KV pages are only ever
        reused within one tenant's own traffic. A deadline that has
        already passed raises ``DeadlineExceededError`` here instead of
        queueing."""
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
                       deadline_t, rec=rec, tenant=str(tenant))
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
                if (self._thread is not None and len(self._queue) == 1
                        and self._prefix is not None
                        and self._prefix.full_hit(req.tenant, req.prompt,
                                                  req.seed)):
                    # a full hit with nobody ahead: admitted and its first
                    # token emitted here, not after a wake-up of the
                    # scheduler thread and another of this one (each
                    # costs more than the admission itself)
                    for idx in self._admit_locked():
                        self._skip_prefill_locked(idx)
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
            if admitted:
                # a client waiting on a first token gets the GIL now, not
                # after the next step's staging (CPython hands it over when
                # the holder blocks, or after its 5 ms switch interval)
                time.sleep(0)
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
            # longest cached prefix: matched full pages arrive retained
            # (this slot's references); the COW source page stays owned by
            # the cache and is copied into a private page before any write
            hit = (self._prefix.acquire(req.tenant, req.prompt, req.seed)
                   if self._prefix is not None else None)
            shared = hit['pages'] if hit else []
            cow_src = hit['cow'] if hit else None
            # the COW destination is one of the `need` logical pages and
            # comes out of the fresh allocation (pages[0] below)
            pages = self._alloc_with_release_locked(need - len(shared))
            if pages is None:
                if shared:
                    self._alloc.free(shared)    # undo; re-acquired on retry
                break       # active slots will free pages; retry next round
            self._queue.popleft()
            table = np.zeros((self.p_max,), np.int32)
            n_shared = len(shared)
            table[:n_shared] = shared
            cow = None
            if cow_src is not None:
                cow = (cow_src, pages[0])
                table[n_shared] = pages[0]
                pages = pages[1:]
            if pages:
                table[need - len(pages):need] = pages
            waited_ms = max(0.0, (now - req.enqueue_t) * 1e3)
            self._h['queue_wait'].observe(waited_ms)
            req.rec.note('admit', slot=free_idx, pages=need,
                         waited_ms=round(waited_ms, 3))
            start, first_tok = 0, None
            if hit is not None:
                start = hit['match']
                first_tok = hit['next_tok']
                self._note('prefix_hits')
                self._note('prefix_tokens_saved', start)
                if first_tok is not None:
                    self._note('prefix_full_hits')
                req.rec.note('prefix_hit', tokens=start,
                             full=first_tok is not None)
            elif self._prefix is not None:
                self._note('prefix_misses')
            self._slots[free_idx] = _Slot(req, table, self._admit_seq,
                                          start=start, cow=cow,
                                          first_tok=first_tok)
            self._admit_seq += 1
            out.append(free_idx)
        if out:
            self._update_gauges_locked()
        return out

    def _prefill_one(self, idx):
        slot = self._slots[idx]
        if slot is None:
            return
        if slot.first_tok is not None:
            with self._cv:
                if self._slots[idx] is slot:
                    self._skip_prefill_locked(idx)
            return
        req = slot.req
        t0 = len(req.prompt)
        self._copy_on_write(slot)
        start = slot.start
        tail = t0 - start               # uncached rows to prefill
        prompt = np.zeros((1, self.prefill_width), np.int32)
        prompt[0, :tail] = req.prompt[start:]
        startv = np.asarray([start], np.int32)
        valid = np.asarray([tail], np.int32)
        table = slot.table[None].copy()
        seed = np.asarray([req.seed], np.int64)
        wall0 = time.perf_counter()

        def dev():
            fault.inject('gen.step')
            tok = self._prefill_call(prompt, startv, valid, table, seed)
            return int(tok.cpu()[0])

        req.rec.note('prefill', slot=idx, prompt_len=t0, start=start)
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

    def _copy_on_write(self, slot):
        """Duplicate the shared mid-page the slot will write into, before
        it does (on the stream the prefill and the steps run on, so the
        copy lands before them)."""
        if slot.cow is not None:
            src, dst = slot.cow
            slot.cow = None
            _pkv.copy_page(self._pool, src, dst)

    def _skip_prefill_locked(self, idx):
        """A full prefix hit: every prompt row is already in mapped pages
        and the donor recorded the first sampled token for this seed, so
        no device call at all: TTFT is the admission latency."""
        slot = self._slots[idx]
        tok = slot.first_tok
        self._copy_on_write(slot)
        slot.req.rec.note('prefill_skip', slot=idx,
                          prompt_len=len(slot.req.prompt))
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

    def _publish_locked(self, slot):
        """Index a retiring/evicted slot's written pages in the prefix
        cache (called BEFORE the slot's own references are freed, so every
        published page is still live when the cache retains it)."""
        if self._prefix is None:
            return
        req = slot.req
        t0 = len(req.prompt)
        # KV row p >= t0 holds the (p - t0)-th generated token; the final
        # sampled token was emitted but never written, so rows == slot.pos
        gen = req.future._snapshot(slot.pos - t0)
        tokens = req.prompt.tolist() + gen
        first = (req.future._snapshot(1) or [None])[0]
        self._prefix.publish(req.tenant, tokens, slot.table, slot.pos,
                             prompt_len=t0, seed=req.seed, first_tok=first)

    def _finish_slot_locked(self, idx):
        slot = self._slots[idx]
        self._publish_locked(slot)
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
        requeues at the FRONT and later regenerates identical tokens.
        Prefix-cache residency yields before any live slot does."""
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            li = slot.pos // self.page_size
            if li >= self.p_max or slot.table[li] != _pkv.TRASH_PAGE:
                continue
            while True:
                pg = self._alloc_with_release_locked(1)
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

    def _alloc_with_release_locked(self, n):
        """``alloc(n)``, releasing LRU prefix-cache residency on failure
        until the allocation fits or the cache is dry. A released page
        only reaches the free list at refcount zero, so keep releasing
        while the cache still holds anything."""
        pages = self._alloc.alloc(n)
        while pages is None and self._prefix is not None:
            if not self._prefix.release_lru(n):
                break
            pages = self._alloc.alloc(n)
        return pages

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
        # publish what the victim already computed: its re-admission (and
        # anyone sharing its prefix) prefills only past the cached rows
        self._publish_locked(slot)
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
            if self._prefix is not None:
                # cached KV lives in the pool being zeroed: drop it all
                self._prefix.clear()
            # the captured prefill and step hold the pool's addresses
            _gpt.zero_kv(self._pool)
            self._update_gauges_locked()
            self._cv.notify_all()
        for r in failed:
            r.rec.finish('error', exc)
            if r.future._finish(exc):
                self._note('failed')

    # ---- prefix cache knobs ----------------------------------------------
    @property
    def prefix_cache(self):
        """The engine's :class:`~.prefix_cache.PrefixCache` (None when
        disabled)."""
        return self._prefix

    def set_prefix_capacity(self, capacity_pages):
        """Bound prefix-cache residency to ``capacity_pages`` pool pages
        (None lifts the bound). Evicts LRU leaves immediately when already
        over."""
        if self._prefix is None:
            return
        with self._lock:
            self._prefix.set_capacity(capacity_pages)
            self._update_gauges_locked()

    def clear_prefix_cache(self):
        """Release every cached page back toward the allocator (pages also
        mapped by live slots free when those slots retire). Returns the
        number of entries dropped."""
        if self._prefix is None:
            return 0
        with self._lock:
            n = self._prefix.clear()
            self._update_gauges_locked()
            return n

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
        out['prefix'] = (self._prefix.stats()
                         if self._prefix is not None else None)
        return out
