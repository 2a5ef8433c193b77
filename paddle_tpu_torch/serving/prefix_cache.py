"""Prefix cache: KV reuse over the paged pool.

Port of ``paddle_tpu/serving/prefix_cache.py``, kept as the port's own
copy (the reference module imports nothing of JAX, but the port imports
nothing of the JAX package at all). Shared system prompts, few-shot
templates and multi-turn chats re-send the same prefix tokens on every
request. This module indexes **page-aligned prefix chunks** of finished
(or evicted) sequences so a later request with the same prefix is
admitted with those pages already mapped and prefill runs only on the
uncached tail. A full hit skips the prefill device call entirely: the
donor's recorded first token is replayed and TTFT collapses to the
admission latency.

Structure
---------
A trie of :class:`_Entry` nodes, one per cached chunk. A node's key is
``(parent_key, chunk_tokens)`` (exact token tuples, so there are no hash
collisions by construction) and the root key is the namespace
``(tenant,)``: cross-tenant reuse is structurally impossible because a
lookup only walks chains rooted at its own tenant (each GenerationEngine
owns one cache). Interior nodes are FULL ``page_size`` chunks; *partial*
nodes cover a chunk that ends mid-page (a prompt boundary or the last
written rows of a donor). Several entries may reference the same physical
page (the donor's prompt-end chunk and its longer written-end chunk share
a page); the refcounting :class:`~..ops.paged_kv.PageAllocator` makes that
safe.

Sharing rules (decided here, enforced by the engine):

 - **Full-page chunks** are mapped read-only into the consumer's page
   table with one fresh allocator reference each. The consumer never
   writes them: its first write lands strictly past the matched prefix.
 - Any page the consumer WILL write mid-page (a partial match, or an exact
   match whose last page is not full) is returned as ``cow``: the engine
   copies it into a private page (``ops/paged_kv.copy_page``) before any
   device call.
 - A **full hit** (whole prompt covered AND the donor recorded the first
   generated token for this seed) returns ``next_tok`` so the engine skips
   prefill outright.

Residency: every page an entry maps holds one allocator reference.
``release_lru(n)`` frees cold LEAF entries (children first, so an interior
node can never strand a reachable subtree) until ``n`` references drop;
the engine calls it whenever a live allocation would otherwise fail (live
slots always win over cache residency), and :meth:`set_capacity` bounds
total residency. The cache has its own lock for stats readers, but
mutating calls arrive under the engine lock; the allocator's lock is a
leaf below both (engine -> cache -> allocator).
"""
import threading

from ..ops.paged_kv import TRASH_PAGE


def _ints(tokens):
    """Token ids as a list of Python ints (an array converts in one call:
    the admission path runs this on every prompt)."""
    if hasattr(tokens, 'tolist'):
        return tokens.tolist()      # a 1-D array: already Python ints
    return list(map(int, tokens))


class _Entry:
    __slots__ = ('key', 'parent', 'chunk', 'page', 'partial', 'next_tok',
                 'last_used')

    def __init__(self, key, parent, chunk, page, partial):
        self.key = key
        self.parent = parent        # parent _Entry or None (root chunk)
        self.chunk = chunk          # tuple of token ids this node covers
        self.page = int(page)       # physical page id (one allocator ref)
        self.partial = bool(partial)
        self.next_tok = {}          # seed -> first token generated after
                                    # the EXACT prompt ending at this node
        self.last_used = 0


class PrefixCache:
    """Trie/hash index of cached prefix pages over one engine's pool."""

    def __init__(self, allocator, page_size, capacity_pages=None):
        self._alloc = allocator
        self.page_size = int(page_size)
        self._capacity = (int(capacity_pages) if capacity_pages is not None
                          else None)
        self._entries = {}          # key -> _Entry
        self._children = {}         # parent key (incl. (tenant,)) -> {keys}
        self._pages_held = 0        # allocator references this cache holds
        self._tick = 0
        self._lock = threading.RLock()
        self._n = {'insertions': 0, 'evictions': 0, 'hits': 0, 'misses': 0,
                   'full_hits': 0}

    # ---- introspection ---------------------------------------------------
    @property
    def cached_pages(self):
        """Allocator references held (two entries on one physical page
        count twice — this is the residency the allocator sees)."""
        with self._lock:
            return self._pages_held

    @property
    def capacity_pages(self):
        return self._capacity

    def stats(self):
        with self._lock:
            out = dict(self._n)
            out['entries'] = len(self._entries)
            out['cached_pages'] = self._pages_held
            out['capacity_pages'] = self._capacity
            return out

    def debug_pages(self, tenant=None):
        """{tenant: sorted physical page ids} (one tenant when given) —
        the cross-tenant isolation gate asserts these sets are disjoint."""
        with self._lock:
            out = {}
            for e in self._entries.values():
                ns = self._root_tenant(e)
                if tenant is not None and ns != tenant:
                    continue
                out.setdefault(ns, set()).add(e.page)
            return {ns: sorted(pages) for ns, pages in out.items()}

    @staticmethod
    def _root_tenant(e):
        while e.parent is not None:
            e = e.parent
        return e.key[0][0]          # a root entry's parent key is (tenant,)

    # ---- capacity --------------------------------------------------------
    def set_capacity(self, capacity_pages):
        """Bound total residency; evicts LRU leaves immediately when over
        (the engine's ``set_prefix_capacity``)."""
        with self._lock:
            self._capacity = (int(capacity_pages)
                              if capacity_pages is not None else None)
            if self._capacity is not None:
                over = self._pages_held - self._capacity
                if over > 0:
                    self._evict_leaves_locked(over)

    # ---- lookup / acquire ------------------------------------------------
    def acquire(self, tenant, prompt, seed, full_only=False):
        """Longest cached prefix of ``prompt`` under ``tenant``.
        ``full_only`` takes it only when it is a full hit (the whole
        prompt cached with its first token for ``seed``), and otherwise
        returns ``None`` touching nothing: no LRU tick, no count, no
        reference.

        Returns ``None`` on a miss, else a dict:
          ``pages``    — page ids to map read-only, in logical order; each
                         already carries a fresh allocator reference owned
                         by the caller (freed via normal slot teardown)
          ``match``    — prompt tokens covered by ``pages`` plus the COW
                         page: the engine's prefill start position
          ``cow``      — physical page to copy-on-write into the logical
                         slot after ``pages`` (it contains the matched
                         rows past the full pages and WILL be written by
                         the consumer), or None. NOT retained — the cache
                         keeps holding it; the caller copies, not shares.
          ``next_tok`` — the donor's first generated token when the WHOLE
                         prompt is covered and was recorded for ``seed``
                         (the skip-prefill full-hit path), else None.

        When the whole prompt is covered but no ``next_tok`` is known for
        this seed, the match is trimmed to ``len(prompt) - 1`` so at least
        one token re-prefills (the engine needs the last row's logits) —
        the final page becomes the COW source since the re-prefilled row
        lands mid-page."""
        prompt = _ints(prompt)
        skey = int(seed) & 0xFFFFFFFF
        with self._lock:
            chain, match, cow_entry, next_tok = self._match_locked(
                tenant, prompt, skey)
            if full_only and next_tok is None:
                return None
            self._tick += 1
            if not chain and cow_entry is None:
                self._n['misses'] += 1
                return None
            for e in chain:
                e.last_used = self._tick
            if cow_entry is not None:
                cow_entry.last_used = self._tick
                covered = match + len(cow_entry.chunk)
                # leave >= 1 token to prefill unless next_tok skips prefill
                match = covered if next_tok is not None \
                    else min(covered, len(prompt) - 1)
            pages = [e.page for e in chain]
            if pages:
                self._alloc.retain(pages)
            self._n['hits'] += 1
            if next_tok is not None:
                self._n['full_hits'] += 1
            return {'pages': pages, 'match': match,
                    'cow': cow_entry.page if cow_entry is not None else None,
                    'next_tok': next_tok}

    def _match_locked(self, tenant, prompt, skey):
        """``acquire``'s lookup, without its effects: (the matched full
        entries, the tokens they cover, the partial entry to copy-on-write
        or None, the recorded first token or None). A page-aligned prompt
        whose first token is unknown gives up its last full entry as the
        COW source, so one token re-prefills."""
        ps = self.page_size
        chain = []
        parent_key = (tenant,)
        for i in range(len(prompt) // ps):
            chunk = tuple(prompt[i * ps:(i + 1) * ps])
            e = self._entries.get((parent_key, chunk))
            if e is None:
                break
            chain.append(e)
            parent_key = e.key
        match = len(chain) * ps
        rest = tuple(prompt[match:])
        next_tok = None
        cow_entry = None
        if rest:
            cow_entry, next_tok = self._best_partial_locked(
                parent_key, rest, skey)
        elif chain:
            # page-aligned prompt fully covered by full chunks
            tok = chain[-1].next_tok.get(skey)
            if tok is not None:
                next_tok = int(tok)
            else:
                # unknown first token: re-prefill the last prompt token;
                # its KV write lands in the final page -> COW it
                cow_entry = chain.pop()
                match -= ps
        return chain, match, cow_entry, next_tok

    def _best_partial_locked(self, parent_key, rest, skey):
        """Longest partial child of ``parent_key`` whose chunk is a prefix
        of ``rest`` (-> COW source), plus the recorded first token when the
        chunk covers ``rest`` exactly."""
        best, best_tok = None, None
        for key in self._children.get(parent_key, ()):
            e = self._entries[key]
            if not e.partial:
                continue
            n = len(e.chunk)
            if n > len(rest) or tuple(rest[:n]) != e.chunk:
                continue
            if best is None or n > len(best.chunk):
                best = e
                best_tok = (int(e.next_tok[skey])
                            if n == len(rest) and skey in e.next_tok
                            else None)
        return best, best_tok

    # ---- publish ---------------------------------------------------------
    def publish(self, tenant, tokens, table, written, *, prompt_len=None,
                seed=None, first_tok=None):
        """Index a retiring/evicted slot's pages.

        ``tokens``: the KV-row token sequence (prompt followed by the
        generated tokens actually written); ``table``: the slot's page
        table; ``written``: rows ``0..written-1`` hold valid KV. Full
        pages become interior chunks and the final partial page (if any)
        a terminal partial chunk. When ``prompt_len``/``seed``/
        ``first_tok`` are given, the boundary at exactly ``prompt_len``
        tokens also gets an entry (a partial chunk when mid-page, sharing
        the physical page with the longer chunk) recording the donor's
        first generated token — the skip-prefill full-hit path for an
        identical ``(prompt, seed)`` resubmission.

        Each newly indexed page is retained (+1 ref); re-publishing a
        chunk already indexed is a no-op refresh of its LRU stamp, so a
        consumer retiring through the same pages it borrowed never
        double-indexes them. Never blocks on pool pressure — capacity is
        enforced by evicting LRU leaves after insertion."""
        ps = self.page_size
        tokens = _ints(tokens)[:written]
        skey = (int(seed) & 0xFFFFFFFF) if seed is not None else None
        with self._lock:
            self._tick += 1
            chain = []              # successfully indexed full-chunk entries
            parent_key, parent = (tenant,), None
            for i in range(len(tokens) // ps):
                page = int(table[i])
                if page == TRASH_PAGE:
                    break           # table hole: stop the chain here
                chunk = tuple(tokens[i * ps:(i + 1) * ps])
                parent = self._insert_locked(parent_key, parent, chunk,
                                             page, partial=False)
                chain.append(parent)
                parent_key = parent.key
            n_ok = len(chain)
            rest = tuple(tokens[n_ok * ps:])
            if rest and n_ok == len(tokens) // ps and n_ok < len(table):
                page = int(table[n_ok])
                if page != TRASH_PAGE:
                    self._insert_locked(parent_key, parent, rest, page,
                                        partial=True)
            # prompt-boundary entry for the full-hit fast path
            if (prompt_len is not None and first_tok is not None
                    and prompt_len <= len(tokens)):
                k = prompt_len // ps
                if prompt_len % ps == 0 and 0 < k <= n_ok:
                    chain[k - 1].next_tok[skey] = int(first_tok)
                elif prompt_len % ps and k <= n_ok and k < len(table):
                    page = int(table[k])
                    if page != TRASH_PAGE:
                        pkey = chain[k - 1].key if k else (tenant,)
                        pent = chain[k - 1] if k else None
                        head = tuple(tokens[k * ps:prompt_len])
                        e = self._insert_locked(pkey, pent, head, page,
                                                partial=True)
                        e.next_tok[skey] = int(first_tok)
            if self._capacity is not None:
                over = self._pages_held - self._capacity
                if over > 0:
                    self._evict_leaves_locked(over)

    def _insert_locked(self, parent_key, parent, chunk, page, partial):
        key = (parent_key, chunk)
        e = self._entries.get(key)
        if e is None:
            # retain BEFORE indexing: retaining a freed page raises, so a
            # buggy caller (publishing after release) fails loudly instead
            # of the cache aliasing whoever allocates that page next
            self._alloc.retain([page])
            e = _Entry(key, parent, chunk, page, partial)
            self._entries[key] = e
            self._children.setdefault(parent_key, set()).add(key)
            self._pages_held += 1
            self._n['insertions'] += 1
        e.last_used = self._tick
        return e

    # ---- eviction --------------------------------------------------------
    def release_lru(self, n_pages):
        """Drop cache references for up to ``n_pages`` pages, LRU leaves
        first (live allocations outrank cache residency). Returns how many
        references were dropped — a dropped page only reaches the free
        list once every live slot sharing it retires, so callers re-try
        their allocation and keep releasing while still short."""
        with self._lock:
            return self._evict_leaves_locked(n_pages)

    def _evict_leaves_locked(self, n_pages):
        dropped = 0
        while dropped < n_pages and self._entries:
            victim = None
            for e in self._entries.values():
                if self._children.get(e.key):
                    continue        # interior: evicting would strand kids
                if victim is None or e.last_used < victim.last_used:
                    victim = e
            if victim is None:      # unreachable (a trie always has leaves)
                break
            self._remove_locked(victim)
            dropped += 1
        return dropped

    def _remove_locked(self, e):
        del self._entries[e.key]
        self._children.pop(e.key, None)
        sibs = self._children.get(e.key[0])
        if sibs is not None:
            sibs.discard(e.key)
            if not sibs:
                del self._children[e.key[0]]
        self._pages_held -= 1
        self._n['evictions'] += 1
        self._alloc.free([e.page])

    def clear(self):
        """Release everything (device-failure recovery, shutdown, and the
        leak gate's drain + clear check). Returns entries released."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
            self._children.clear()
            for e in entries:
                self._alloc.free([e.page])
            self._pages_held = 0
            return len(entries)
