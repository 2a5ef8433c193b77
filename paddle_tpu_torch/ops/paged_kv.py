"""Paged KV cache: fixed-size pages in a shared pool + per-slot page tables.

Port of ``paddle_tpu/ops/paged_kv.py``. The pool is one buffer per k/v

    pool      [L, N_pages, page_size, H_kv, Dh]   (k and v each)
    table     [slots, P_max] int32                (page ids per slot)

so a sequence only pins ``ceil(len/page_size)`` pages and the
continuous-batching engine (serving/generation.py) packs many ragged
sequences into one fixed-slot decode batch. Page ids are host-side state
handed to each device call as an int32 table.

int8 pools (``kv_cache_int8``) hold each plane as a bank ``{'int8': [L,
N, page_size, H_kv, Dh] int8, 'scale': [L, N, page_size, H_kv] f32}``
(the dense cache's bank layout, ``ops/weight_only.init_kv_bank``): rows
quantize on write with ``quantize_kv``, one scale per row and head.

Conventions shared by every consumer:

 - **Page 0 is the trash page.** The allocator never hands it out. Writes
   that must go nowhere (prompt padding rows past a sequence's valid
   length, decode rows of inactive slots) are routed to page 0, and
   unassigned page-table entries stay 0 — a gather through a fresh table
   reads zeros, and the attention mask discards those positions anyway.
 - Pages are layer-major: ``pool[l]`` is layer l's ``[N, ps, H_kv, D]``
   pool, a contiguous view the attention kernel reads in place.
 - Where the reference returns a new pool (JAX donates the old buffer),
   the port writes the pool in place and says so.
"""
import threading

import torch

from .weight_only import init_kv_bank, is_weight_only, kv_plane, quantize_kv

TRASH_PAGE = 0   # reserved; see module docstring


def pages_for(n_tokens, page_size):
    """Pages needed to hold ``n_tokens`` rows."""
    return max(0, -(-int(n_tokens) // int(page_size)))


def init_paged_pool(num_layers, num_pages, page_size, kv_heads, head_dim,
                    dtype, device, int8=False):
    """Allocate the shared page pool: ``{'k': pages, 'v': pages}`` with
    pages ``[L, N, page_size, H_kv, Dh]`` of ``dtype`` on ``device`` (int8:
    banks of that shape, ``dtype`` unused). ``num_pages`` INCLUDES the
    reserved trash page 0."""
    if num_pages < 2:
        raise ValueError('num_pages must be >= 2 (page 0 is reserved)')
    shape = (num_layers, num_pages, page_size, kv_heads, head_dim)
    if int8:
        return {'k': init_kv_bank(shape, device),
                'v': init_kv_bank(shape, device)}
    return {'k': torch.zeros(shape, dtype=dtype, device=device),
            'v': torch.zeros(shape, dtype=dtype, device=device)}


class PageAllocator:
    """Host-side REFCOUNTED free-list over pages ``1..num_pages-1`` (page 0
    reserved — it is never handed out and never re-enters the free list).

    All-or-nothing ``alloc(n)``: a request either gets all n pages or None,
    so a half-admitted sequence never strands pages. A fresh allocation
    carries refcount 1; ``retain()`` lets a second holder pin the same
    page, and ``free()`` decrements — the page returns to the free list
    only at refcount zero. Freeing a page that holds no references (a
    double free) raises instead of silently corrupting the pool.
    Thread-safe (the engine's scheduler thread and stats readers may
    race); this lock is a LEAF — never call out while holding it."""

    def __init__(self, num_pages):
        if num_pages < 2:
            raise ValueError('num_pages must be >= 2 (page 0 is reserved)')
        self.num_pages = int(num_pages)
        self._free = list(range(self.num_pages - 1, 0, -1))  # pop() -> low ids
        self._refs = {}          # page id -> live reference count (>= 1)
        self._lock = threading.Lock()

    @property
    def free_pages(self):
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self):
        return (self.num_pages - 1) - self.free_pages

    def refcount(self, page):
        """Current reference count of ``page`` (0 when on the free list)."""
        with self._lock:
            return self._refs.get(int(page), 0)

    def alloc(self, n):
        """-> list of n page ids (each at refcount 1), or None if the pool
        can't cover them."""
        n = int(n)
        if n < 0:
            raise ValueError('alloc(n) needs n >= 0')
        with self._lock:
            if n > len(self._free):
                return None
            out = [self._free.pop() for _ in range(n)]
            for p in out:
                self._refs[p] = 1
        return out

    def retain(self, pages):
        """Add one reference to each already-allocated page. Retaining a
        free or invalid page raises — sharing an unowned page would alias
        whoever allocates it next."""
        with self._lock:
            for p in pages:
                p = int(p)
                if not 0 < p < self.num_pages:
                    raise ValueError(f'retain() of invalid page id {p}')
                if p not in self._refs:
                    raise ValueError(f'retain() of unallocated page {p}')
            for p in pages:
                self._refs[int(p)] += 1

    def free(self, pages):
        """Drop one reference per page; a page returns to the free list at
        refcount zero. Raises on page 0, out-of-range ids, and double
        frees (the trash page can therefore never reach the free list)."""
        with self._lock:
            for p in pages:
                p = int(p)
                if not 0 < p < self.num_pages:
                    raise ValueError(f'free() of invalid page id {p}')
                if p not in self._refs:
                    raise ValueError(f'double free of page {p}')
            for p in pages:
                p = int(p)
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    del self._refs[p]
                    self._free.append(p)


def flat_write_indices(page_table, pos, n_rows, page_size, valid=None):
    """[B, n_rows] int64 indices into a ``[N*page_size, ...]`` flattened
    pool for the rows a (prefill or decode) step writes.

    ``page_table``: [B, P_max] int; ``pos``: [B] int (absolute position of
    each sequence's first new row); ``valid``: [B] int or None — rows with
    j >= valid[b] are padding and route to the trash page (index j % ps
    inside page 0, which real pages can never alias since they start at
    ``page_size``)."""
    ps = int(page_size)
    p_max = int(page_table.shape[1])
    j = torch.arange(n_rows, device=page_table.device)[None, :]   # [1, T]
    abs_pos = pos.long()[:, None] + j                             # [B, T]
    logical = torch.clamp(abs_pos // ps, 0, p_max - 1)
    page = torch.gather(page_table.long(), 1, logical)            # [B, T]
    flat = page * ps + abs_pos % ps
    if valid is not None:
        ok = j < valid.long()[:, None]
        # trash rows: distinct offsets inside page 0 (j % ps) — collisions
        # between sequences are fine, the rows are garbage by definition
        flat = torch.where(ok, flat, j % ps)
    return flat


def paged_write(pages, rows, page_table, pos, valid=None, flat_idx=None):
    """Scatter new KV rows into the (single-layer) page pool IN PLACE (the
    reference returns a new pool and donates the old buffer; here
    ``pages`` itself is written) and return it.

    ``pages``: [N, page_size, H, D] (or an int8 bank of that shape, whose
    rows are quantized with ``quantize_kv`` on the way in, as the
    reference's ``paged_write`` does); ``rows``: [B, T, H, D] fresh k or v
    rows for absolute positions ``pos[b] + j``; ``page_table``: [B, P_max];
    ``valid``: [B] or None (rows past it go to the trash page).
    ``flat_idx`` takes indices already computed by ``flat_write_indices``
    for this call — every layer of one forward writes the same rows, so
    the forward computes them once."""
    b, t = rows.shape[:2]
    n, ps, h, d = kv_plane(pages).shape
    if flat_idx is None:
        flat_idx = flat_write_indices(page_table, pos, t, ps, valid)
    idx = flat_idx.reshape(-1)
    if is_weight_only(pages):
        qr, sr = quantize_kv(rows)
        pages['int8'].view(n * ps, h, d).index_copy_(
            0, idx, qr.reshape(b * t, h, d))
        pages['scale'].view(n * ps, h).index_copy_(0, idx,
                                                   sr.reshape(b * t, h))
        return pages
    pages.view(n * ps, h, d).index_copy_(
        0, idx, rows.reshape(b * t, h, d).to(pages.dtype))
    return pages


def copy_page(pool, src, dst):
    """Copy-on-write primitive: duplicate physical page ``src`` into
    ``dst`` across every pool plane (k and v, all layers; int8 banks copy
    both the int8 and scale planes), in place. ``pool`` is the engine's
    full paged cache ``{'k': [L, N, ps, H, D], 'v': ...}``; returns it."""
    src, dst = int(src), int(dst)
    for plane in pool.values():
        for arr in (plane.values() if is_weight_only(plane) else (plane,)):
            arr[:, dst].copy_(arr[:, src])
    return pool


def gather_virtual(pages, page_table):
    """Reconstruct each slot's virtual dense cache from its pages:
    ``[N, page_size, H, D]`` + ``[B, P_max]`` -> ``[B, P_max*page_size,
    H, D]`` (an int8 bank gathers both planes). The result is
    value-identical to the dense cache regardless of physical page
    placement."""
    if is_weight_only(pages):
        return {k: gather_virtual(v, page_table) for k, v in pages.items()}
    g = pages[page_table.long()]                  # [B, P_max, ps, ...]
    b, p_max, ps = g.shape[:3]
    return g.reshape((b, p_max * ps) + tuple(g.shape[3:]))
