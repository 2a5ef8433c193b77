"""The port's paged KV pool (paddle_tpu_torch/ops/paged_kv.py) against the
JAX package's (paddle_tpu/ops/paged_kv.py): the allocator op for op, and
paged_write / gather_virtual / copy_page exactly, on the same inputs."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops import paged_kv as jkv
from paddle_tpu_torch.ops import paged_kv as tkv
from paddle_tpu_torch.ops import weight_only as two


def _outcome(fn):
    """('ok', value) or ('raise', exception type) for one call."""
    try:
        return 'ok', fn()
    except ValueError as e:
        return 'raise', type(e)


# one script of allocator calls, replayed on both allocators
_SCRIPT = [('alloc', 3), ('alloc', 2), ('retain', [1, 2]), ('free', [1]),
           ('free', [1]), ('free', [1]), ('free', [0]), ('free', [9]),
           ('retain', [1]), ('retain', [0]), ('alloc', 5), ('alloc', 2),
           ('free', [2, 3]), ('free', [2]), ('alloc', 0), ('alloc', 3),
           ('free', [4, 5, 6])]


@pytest.mark.parametrize('num_pages', [2, 8])
def test_allocator_matches_reference_op_for_op(num_pages):
    ref, port = jkv.PageAllocator(num_pages), tkv.PageAllocator(num_pages)
    for op, arg in _SCRIPT:
        want = _outcome(lambda: getattr(ref, op)(arg))
        got = _outcome(lambda: getattr(port, op)(arg))
        assert got == want, (op, arg)
        assert port.free_pages == ref.free_pages
        assert port.used_pages == ref.used_pages
        for p in range(num_pages):
            assert port.refcount(p) == ref.refcount(p)


def test_allocator_rules():
    with pytest.raises(ValueError):
        tkv.PageAllocator(1)
    a = tkv.PageAllocator(4)
    assert a.alloc(4) is None            # all-or-nothing: 3 allocatable
    pages = a.alloc(3)
    assert tkv.TRASH_PAGE not in pages and sorted(pages) == [1, 2, 3]
    a.free(pages)
    with pytest.raises(ValueError, match='double free'):
        a.free([pages[0]])
    with pytest.raises(ValueError):
        a.alloc(-1)


def _setup(seed, b=3, t=6, n=12, ps=4, h=2, d=3, p_max=4):
    rng = np.random.RandomState(seed)
    pool = rng.randn(n, ps, h, d).astype(np.float32)
    rows = rng.randn(b, t, h, d).astype(np.float32)
    perm = rng.permutation(np.arange(1, n))
    table = np.zeros((b, p_max), np.int32)
    table[:, :3] = perm[:b * 3].reshape(b, 3)   # scattered; last entry 0
    pos = np.array([0, 5, 9], np.int32)[:b]
    valid = np.array([6, 2, 4], np.int32)[:b]  # rows past valid -> trash
    return pool, rows, table, pos, valid


@pytest.mark.parametrize('with_valid', [False, True])
@pytest.mark.parametrize('seed', [0, 1])
def test_write_indices_match_reference(seed, with_valid):
    _, rows, table, pos, valid = _setup(seed)
    v = valid if with_valid else None
    want = jkv.flat_write_indices(jnp.asarray(table), jnp.asarray(pos), 6, 4,
                                  None if v is None else jnp.asarray(v))
    got = tkv.flat_write_indices(torch.from_numpy(table),
                                 torch.from_numpy(pos), 6, 4,
                                 None if v is None else torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_write_indices_clip_to_last_page():
    # positions past P_max*ps clip to the last logical page, as the
    # reference's clip(abs_pos // ps, 0, p_max - 1) does
    table = np.array([[3, 5]], np.int32)
    pos = np.array([7], np.int32)
    want = jkv.flat_write_indices(jnp.asarray(table), jnp.asarray(pos), 4, 4)
    got = tkv.flat_write_indices(torch.from_numpy(table),
                                 torch.from_numpy(pos), 4, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('with_valid', [False, True])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_paged_write_then_gather_matches_reference_exactly(seed,
                                                           with_valid):
    pool, rows, table, pos, valid = _setup(seed)
    v = valid if with_valid else None
    want_pool = jkv.paged_write(jnp.asarray(pool), jnp.asarray(rows),
                                jnp.asarray(table), jnp.asarray(pos),
                                None if v is None else jnp.asarray(v))
    want = jkv.gather_virtual(want_pool, jnp.asarray(table))
    tpool = torch.from_numpy(pool.copy())
    out = tkv.paged_write(tpool, torch.from_numpy(rows),
                          torch.from_numpy(table), torch.from_numpy(pos),
                          None if v is None else torch.from_numpy(v))
    assert out is tpool                  # written in place
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(want_pool))
    got = tkv.gather_virtual(tpool, torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_copy_page_matches_reference():
    rng = np.random.RandomState(3)
    pool = {'k': rng.randn(2, 5, 4, 2, 3).astype(np.float32),
            'v': rng.randn(2, 5, 4, 2, 3).astype(np.float32)}
    want = jkv.copy_page({k: jnp.asarray(v) for k, v in pool.items()}, 1, 3)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    got = tkv.copy_page(tpool, 1, 3)
    for k in pool:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_init_paged_pool_shape_and_trash_rule():
    pool = tkv.init_paged_pool(2, 5, 4, 3, 8, torch.bfloat16, 'cpu')
    ref = jkv.init_paged_pool(2, 5, 4, 3, 8, jnp.bfloat16)
    assert tuple(pool['k'].shape) == tuple(ref['k'].shape)
    assert pool['v'].dtype == torch.bfloat16 and not pool['k'].any()
    with pytest.raises(ValueError):
        tkv.init_paged_pool(2, 1, 4, 3, 8, torch.float32, 'cpu')
    assert tkv.pages_for(9, 4) == jkv.pages_for(9, 4) == 3
    assert tkv.pages_for(0, 4) == 0


# ---------------------------------------------------------------------------
# int8 pools (the engine's kv_cache_int8): banks quantized on write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('with_valid', [False, True])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_int8_paged_write_matches_reference_bit_for_bit(seed, with_valid):
    _, rows, table, pos, valid = _setup(seed, d=16)
    rows = rows * np.float32(5)
    v = valid if with_valid else None
    jbank = jkv.init_paged_pool(1, 12, 4, 2, 16, jnp.float32,
                                int8=True)['k']
    jbank = {k: a[0] for k, a in jbank.items()}
    want = jkv.paged_write(jbank, jnp.asarray(rows), jnp.asarray(table),
                           jnp.asarray(pos),
                           None if v is None else jnp.asarray(v))
    tbank = tkv.init_paged_pool(1, 12, 4, 2, 16, torch.float32, 'cpu',
                                int8=True)['k']
    layer = two.kv_layer(tbank, 0)
    out = tkv.paged_write(layer, torch.from_numpy(rows),
                          torch.from_numpy(table), torch.from_numpy(pos),
                          None if v is None else torch.from_numpy(v))
    assert out is layer and layer['int8'].dtype == torch.int8
    for k in ('int8', 'scale'):
        # written in place, through the layer's views into the pool
        np.testing.assert_array_equal(tbank[k][0].numpy(),
                                      np.asarray(want[k]))
    got = tkv.gather_virtual(layer, torch.from_numpy(table))
    ref = jkv.gather_virtual(want, jnp.asarray(table))
    for k in ('int8', 'scale'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_int8_pool_layout_and_copy_page_match_reference():
    pool = tkv.init_paged_pool(2, 5, 4, 3, 16, torch.bfloat16, 'cpu',
                               int8=True)
    ref = jkv.init_paged_pool(2, 5, 4, 3, 16, jnp.bfloat16, int8=True)
    for plane in ('k', 'v'):
        for k in ('int8', 'scale'):
            assert tuple(pool[plane][k].shape) == tuple(ref[plane][k].shape)
            assert not pool[plane][k].any()
    assert pool['k']['int8'].dtype == torch.int8
    assert pool['k']['scale'].dtype == torch.float32
    assert two.kv_plane(pool['k']) is pool['k']['int8']
    rng = np.random.RandomState(4)
    for plane in ('k', 'v'):
        pool[plane]['int8'].copy_(torch.from_numpy(
            rng.randint(-127, 128, size=(2, 5, 4, 3, 16)).astype(np.int8)))
        pool[plane]['scale'].copy_(torch.from_numpy(
            rng.rand(2, 5, 4, 3).astype(np.float32)))
    jpool = {p: {k: jnp.asarray(a.numpy()) for k, a in b.items()}
             for p, b in pool.items()}
    want = jkv.copy_page(jpool, 2, 4)
    got = tkv.copy_page(pool, 2, 4)
    for plane in ('k', 'v'):
        for k in ('int8', 'scale'):
            np.testing.assert_array_equal(got[plane][k].numpy(),
                                          np.asarray(want[plane][k]))
