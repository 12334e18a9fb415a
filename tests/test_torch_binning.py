"""PyTorch port parity: tile binning and the plain versions of K1/K2.

K1/K2's plain PyTorch versions are held exactly against the JAX Pallas
kernels `fill_decode_keys` and `rank_cap_decode`, run in interpret mode
(as tests/test_fill_pallas.py runs them): below 65,535 splats the port's
keys are int32 on grids of up to 32,767 tiles and int64 above, and both
hold the JAX package's uint32 values. At 65,536 splats and more the gauss
field widens (`fill_cuda.key_layout`), and gsvc_tpu sorts (tile, gauss)
pairs with its stable pair sort (`binning._sort_by_tile_gauss`): K1/K2's
plain versions are held exactly to that sort of the expansion of K1's
inputs, and `bin_gaussians` to gsvc_tpu's general path. K2's third output, the tile edges, is held to
gsvc_tpu's `bin_gaussians` tile counts and kept total on the scenes, and
to the counts of K1's keys on the synthetic inputs (no splats, a budget
filled exactly, empty tiles at both ends of the grid, caps 1 and 4, runs
past the cap across 1024-lane blocks). `bin_gaussians` is held exactly
against gsvc_tpu's on the contract fields: per-tile member lists in
(tile, gauss) order with the cap, tile counts, num_intersects, overflow,
gauss_slot_start and bbox_pack, at n from 50 to 70,000 (16- and 17-bit
gauss fields, int32 and int64 keys). The TPU-only row padding is not part
of the contract, so sorted arrays are compared through the member lists;
between 32,768 and 65,534 splats gsvc_tpu's Pallas path (a three-row seed
fill, interpret mode) makes 16-bit keys, which the port's equal bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsvc_tpu.ops.fill_pallas as fp
from gsvc_tpu.ops import binning as jbin
from gsvc_tpu.ops.projection import project_gaussians_2d as jproject
from gsvc_tpu_torch.ops import binning, fill_cuda
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.scripts.common import synthetic_key_inputs


@pytest.fixture
def _pallas_interpret():
    fp.INTERPRET = True
    yield
    fp.INTERPRET = False


def _scene(n, H, W, seed):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.1, 1.1, (n, 2)).astype(np.float32)
    L = (rng.uniform(0, 2, (n, 3)) + np.array([0.5, 0.0, 0.5])).astype(np.float32)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    j = jproject(jnp.asarray(means), jnp.asarray(L), H, W, tb)
    t = project_gaussians_2d(torch.from_numpy(means), torch.from_numpy(L), H, W, tb)
    return tb, j, t


def _jax_seeds(ki):
    """gsvc_tpu's 2-row seed scatter (binning.py:205-230) from K1's inputs."""
    starts, nth = ki.starts.numpy(), ki.nth.numpy()
    kept = ki.kept.numpy()
    payload = [
        (starts.astype(np.int64) << 8) | ki.bbox_w.numpy(),
        ((np.arange(len(starts), dtype=np.int64) + 1) << 16)
        | (ki.tmin_x.numpy() << 8) | ki.tmin_y.numpy(),
    ]
    seeds = np.full((2, ki.num_slots), -1, np.int64)
    for g in np.nonzero(kept)[0]:
        seeds[:, starts[g]] = np.maximum(seeds[:, starts[g]], [p[g] for p in payload])
    return jnp.asarray(seeds.astype(np.int32))


SCENES = [(50, (48, 64), 0, None, 256), (200, (64, 96), 1, None, 256),
          (500, (32, 128), 2, None, 256), (100, (48, 64), 3, 64, 256),
          (120, (32, 32), 4, None, 4),
          (300, (2080, 4080), 5, 4096, 256)]  # 33,150 tiles: int64 keys


@pytest.mark.parametrize("n,hw,seed,budget,cap", SCENES)
def test_plain_k1_k2_match_pallas_kernels(_pallas_interpret, n, hw, seed, budget, cap):
    tb, _j, (xys, _d, radii, _c, nth) = _scene(n, hw[0], hw[1], seed)
    if budget is None:
        budget = binning.default_max_intersects(n, tb[0] * tb[1])
    ki = binning.key_inputs(xys, radii, nth, tb, 16, 16, budget)
    keys = fill_cuda.fill_decode_keys_torch(*ki.k1)
    assert keys.dtype == (torch.int32 if ki.num_tiles <= 32767 else torch.int64)
    _assert_keys_equal_jax(ki, keys)
    assert torch.equal(fill_cuda.fill_decode_keys(*ki.k1), keys)  # CPU wrapper

    skeys = torch.sort(keys).values
    tiles, gauss, edges = _assert_k2_equal_jax(skeys, cap, n, ki.num_tiles)
    assert int(edges[-1]) == int(ki.total_kept)
    got = fill_cuda.rank_cap_decode(skeys, cap, n, ki.num_tiles)  # CPU wrapper
    assert all(torch.equal(a, b) for a, b in zip(got, (tiles, gauss, edges)))


def _assert_k2_equal_jax(skeys, cap, n, num_tiles):
    """The plain K2's ids exactly the Pallas kernel's (interpret mode); its
    edges [num_tiles + 1] int32, from 0 to the first sentinel lane."""
    tiles, gauss, edges = fill_cuda.rank_cap_decode_torch(skeys, cap, n, num_tiles)
    jt, jg = fp.rank_cap_decode(jnp.asarray(skeys.numpy().astype(np.uint32)), cap, n)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(gauss.numpy(), np.asarray(jg))
    assert edges.dtype == torch.int32 and edges.shape == (num_tiles + 1,)
    assert int(edges[0]) == 0 and int(edges[-1]) == int((tiles < num_tiles).sum())
    return tiles, gauss, edges


def _assert_keys_equal_jax(ki, keys):
    jkeys = fp.fill_decode_keys(_jax_seeds(ki), jnp.int32(int(ki.total_kept)),
                                ki.tb_x, ki.num_tiles, ki.starts.shape[0])
    np.testing.assert_array_equal(keys.numpy().astype(np.int64),
                                  np.asarray(jkeys).astype(np.int64))


# (n, tile grid, budget or "exact" (filled to the last slot), K2's cap,
# y_range of synthetic_key_inputs)
HARD_KEYS = [
    (6000, (120, 68), 20480, 256, None), (6000, (120, 68), 4096, 256, None),
    (0, (120, 68), 1024, 256, None),  # no splats: every lane a sentinel
    (6000, (255, 200), 20480, 256, None), (6000, (255, 200), 4096, 256, None),
    (6000, (120, 68), "exact", 256, None),  # no sentinel lane
    (6000, (120, 68), 20480, 1, (10, 12)),  # empty tile rows at both ends
    (6000, (255, 200), 20480, 4, (100, 104)),  # int64 keys, gaps, runs past cap
]


def runs_past_cap_across_blocks(tiles: np.ndarray, cap: int, num_tiles: int) -> bool:
    """A tile's run of more than `cap` lanes holds the last lane of a
    1024-lane block and the first of the next."""
    edges = np.searchsorted(tiles, np.arange(num_tiles + 1))
    lo, hi = edges[:-1], edges[1:]
    blocks = np.arange(1024, len(tiles), 1024)
    return any(((lo < b) & (b < hi) & (hi - lo > cap)).any() for b in blocks)


@pytest.mark.parametrize("n,tb,budget,cap,y_range", HARD_KEYS)
def test_plain_k1_matches_pallas_kernel_on_hard_inputs(_pallas_interpret, n, tb, budget,
                                                       cap, y_range):
    """K1 and K2 on `synthetic_key_inputs`; K2's edges give the tile counts
    of K1's keys."""
    exact = budget == "exact"
    seed = n if exact else n + budget
    if exact:  # the budget ends where a kept splat's tiles end
        nth = synthetic_key_inputs(n, tb, 1 << 22, seed, y_range=y_range).nth
        budget = int(torch.cumsum(nth, 0)[n // 2])
    ki = synthetic_key_inputs(n, tb, budget, seed, y_range=y_range)
    if n:
        assert (ki.nth == 0).any() and int(ki.nth.max()) == 64 * 50
    if budget == 4096:
        assert int(ki.nth.sum()) > int(ki.total_kept)
    keys = fill_cuda.fill_decode_keys_torch(*ki.k1)
    layout = fill_cuda.key_layout(ki.num_tiles, n)
    assert keys.dtype == layout.dtype and layout.gauss_bits == 16
    _assert_keys_equal_jax(ki, keys)

    skeys = torch.sort(keys).values
    tiles, _gauss, edges = _assert_k2_equal_jax(skeys, cap, n, ki.num_tiles)
    counts = np.bincount((keys.numpy() >> layout.gauss_bits).astype(np.int64),
                         minlength=ki.num_tiles + 1)
    np.testing.assert_array_equal(torch.diff(edges).numpy(), counts[:ki.num_tiles])
    assert int(edges[-1]) == int(ki.total_kept)
    gaps = np.diff(edges.numpy(), prepend=0) == 0  # tiles with no lane
    if n == 0:
        assert not edges.any()
    if exact:  # the last lane is kept: edge T is S
        assert int(ki.total_kept) == budget == len(tiles) == int(edges[-1])
    if y_range is not None:  # long runs of empty tiles at both ends of the grid
        row = tb[0]
        assert gaps[:y_range[0] * row].all() and gaps[(y_range[1] + 49) * row:-1].all()
        assert runs_past_cap_across_blocks(tiles.numpy(), cap, ki.num_tiles)


def _expansion(ki, n):
    """[S] tile and gauss id of every slot of K1's inputs, expanded in numpy
    (gsvc_tpu's general path: the owner of each slot, its rank in the
    owner's bbox decoded row-major); num_tiles and n past the kept total."""
    kept = ki.kept.numpy()
    nth = np.where(kept, ki.nth.numpy(), 0).astype(np.int64)
    g = np.repeat(np.arange(n), nth)
    j = np.arange(len(g)) - np.repeat(ki.starts.numpy().astype(np.int64), nth)
    bw = ki.bbox_w.numpy().astype(np.int64)[g]
    tile = (ki.tmin_y.numpy()[g] + j // bw) * ki.tb_x + ki.tmin_x.numpy()[g] + j % bw
    pad = ki.num_slots - len(g)
    return (np.concatenate([tile, np.full(pad, ki.num_tiles)]).astype(np.int32),
            np.concatenate([g, np.full(pad, n)]).astype(np.int32))


def _jax_capped_pair_sort(ki, n, cap):
    """gsvc_tpu's wide path on K1's inputs: its stable (tile, gauss) pair
    sort of the expansion, then its cap (lanes ranked >= cap in their tile
    run get gauss id n; binning.py:367-384)."""
    tile, gauss = _expansion(ki, n)
    jt, jg = jbin._sort_by_tile_gauss(jnp.asarray(tile), jnp.asarray(gauss), n,
                                      ki.num_tiles)
    jt, jg = np.asarray(jt), np.asarray(jg)
    lane = np.arange(len(jt))
    run_start = np.maximum.accumulate(np.where(np.diff(jt, prepend=-1) != 0, lane, 0))
    return jt, np.where(lane - run_start < cap, jg, n)


# (tile grid, budget, K2's cap, key dtype) at 70,000 splats: a 17-bit gauss
# field; synthetic_key_inputs' splats that hit no tile and budgets that drop
# the tail
WIDE_KEYS = [((120, 68), 1 << 20, 256, torch.int32),  # 1080p
             ((120, 68), 1 << 19, 4, torch.int32),  # runs past a cap of 4
             ((255, 200), 1 << 20, 256, torch.int64)]


@pytest.mark.parametrize("tb,budget,cap,dtype", WIDE_KEYS)
def test_plain_k1_k2_wide_keys_match_jax_pair_sort(tb, budget, cap, dtype):
    n = 70000
    ki = synthetic_key_inputs(n, tb, budget, seed=budget + cap)
    assert (ki.nth == 0).any() and int(ki.nth.sum()) > int(ki.total_kept)
    layout = fill_cuda.key_layout(ki.num_tiles, n)
    keys = fill_cuda.fill_decode_keys_torch(*ki.k1)
    assert keys.dtype == layout.dtype == dtype and layout.gauss_bits == 17
    assert torch.equal(fill_cuda.fill_decode_keys(*ki.k1), keys)  # CPU wrapper
    skeys = torch.sort(keys).values
    tiles, gauss, edges = fill_cuda.rank_cap_decode_torch(skeys, cap, n, ki.num_tiles)
    jt, jg = _jax_capped_pair_sort(ki, n, cap)
    np.testing.assert_array_equal(tiles.numpy(), jt)
    np.testing.assert_array_equal(gauss.numpy(), jg)
    if cap == 4:  # lanes past the cap
        assert (jg == n).sum() > (jt == ki.num_tiles).sum()
    np.testing.assert_array_equal(
        edges.numpy(), np.searchsorted(jt, np.arange(ki.num_tiles + 1)))
    assert int(edges[-1]) == int(ki.total_kept)
    got = fill_cuda.rank_cap_decode(skeys, cap, n, ki.num_tiles)  # CPU wrapper
    assert all(torch.equal(a, b) for a, b in zip(got, (tiles, gauss, edges)))


# (num_tiles, n, dtype, gauss bits): 1080p, 3840x2160 (32,400 tiles),
# 4080x2080 (33,150) and the 255 x 255 grid, at the edges of each width;
# 3840x2160 at 100,000 splats and 2048x2048 (16,384 tiles) at 70,000
@pytest.mark.parametrize("num_tiles,n,dtype,bits", [
    (8160, 10000, torch.int32, 16), (8160, 65535, torch.int32, 16),
    (8160, 65536, torch.int32, 17), (8160, 262143, torch.int32, 18),
    (8160, 262144, torch.int64, 19), (32767, 0, torch.int32, 16),
    (32767, 65535, torch.int32, 16), (32768, 300, torch.int64, 16),
    (32400, 65535, torch.int32, 16), (32400, 65536, torch.int64, 17),
    (33150, 70000, torch.int64, 17), (255 * 255, 2**23 - 1, torch.int64, 23),
    (16383, 65536, torch.int32, 17), (16384, 65536, torch.int64, 17),
    (32400, 100000, torch.int64, 17), (16384, 70000, torch.int64, 17),
])
def test_key_dtype_follows_the_tile_count(num_tiles, n, dtype, bits):
    layout = fill_cuda.key_layout(num_tiles, n)
    assert (layout.dtype, layout.gauss_bits) == (dtype, bits)
    assert layout.gauss_mask == 2**bits - 1 >= n  # the sentinel is no real id
    assert layout.sentinel == (num_tiles << bits) | layout.gauss_mask
    # int32 exactly where the largest key, the sentinel, fits 31 bits
    assert (layout.sentinel <= 2**31 - 1) == (dtype == torch.int32)
    if n <= 65535:  # the 16-bit layout: int32 up to 32,767 tiles, as before
        assert dtype == (torch.int32 if num_tiles <= 32767 else torch.int64)


def _members(gauss_ids, starts, counts, cap):
    g = np.asarray(gauss_ids)
    return [g[s:s + min(c, cap)].tolist() for s, c in zip(np.asarray(starts),
                                                          np.asarray(counts))]


# gsvc_tpu bins these on its general path: the stable (tile, gauss) pair sort
WIDE_SCENES = [
    (65535, (48, 64), 7, 172032, 256),  # the first n past gsvc_tpu's 16-bit key
    (65536, (48, 64), 8, 172032, 256),  # the first 17-bit gauss field
    (70000, (48, 64), 9, 131072, 256),  # 177,198 intersections: overflow
    (66000, (32, 32), 10, 139264, 4),  # cap 4, runs past it on every tile
    (65536, (2080, 4080), 11, 204800, 256),  # int64 wide keys; 10,801 hit no tile
]


@pytest.mark.parametrize("n,hw,seed,budget,cap", SCENES + WIDE_SCENES)
def test_bin_gaussians_contract_matches_jax(n, hw, seed, budget, cap):
    tb, (jx, _jd, jr, _jc, jn), (xys, _d, radii, _c, nth) = _scene(n, hw[0], hw[1], seed)
    if budget is None:
        budget = binning.default_max_intersects(n, tb[0] * tb[1])
    jb = jax.jit(lambda x, r, k: jbin.bin_gaussians(x, r, k, tb, 16, 16, budget,
                                                    cap=cap))(jx, jr, jn)
    for kernels in (True, False):
        tb_ = binning.bin_gaussians(xys, radii, nth, tb, 16, 16, budget, cap=cap,
                                    kernels=kernels)
        for name in ("tile_counts", "num_intersects", "overflow",
                     "gauss_slot_start", "bbox_pack"):
            np.testing.assert_array_equal(
                getattr(tb_, name).numpy(), np.asarray(getattr(jb, name)),
                err_msg=name,
            )
        assert _members(tb_.sorted_gauss_ids, tb_.tile_bin_start,
                        tb_.tile_counts, cap) == _members(
            jb.sorted_gauss_ids, jb.tile_bin_start, jb.tile_counts, cap)
        # lanes past the cap carry the sentinel, as in gsvc_tpu
        counts = tb_.tile_counts.numpy()
        starts = tb_.tile_bin_start.numpy()
        ids = tb_.sorted_gauss_ids.numpy()
        for s, c in zip(starts, counts):
            assert (ids[s + min(c, cap):s + c] == n).all()
        assert tb_.sorted_gauss_ids.shape == (budget,)
        assert (ids[int(tb_.num_intersects):] == n).all()
    # K2's edges: the JAX package's tile counts and kept total
    _t, _g, edges = fill_cuda.rank_cap_decode_torch(tb_.sorted_keys, cap, n, tb[0] * tb[1])
    np.testing.assert_array_equal(torch.diff(edges).numpy(), np.asarray(jb.tile_counts))
    assert int(edges[-1]) == int(jb.num_intersects)
    layout = fill_cuda.key_layout(tb[0] * tb[1], n)
    assert tb_.sorted_keys.dtype == layout.dtype
    assert layout.gauss_bits == (17 if n >= 65536 else 16)
    if budget < int(nth.sum()):
        assert int(jb.overflow) > 0
    if cap == 4:
        assert (counts > cap).any()
    if hw == (2080, 4080):
        assert (nth == 0).any()


def test_middle_band_keys_equal_jax_three_row_fill(_pallas_interpret):
    """32,767 < n < 65,535: gsvc_tpu's Pallas path with its three-row seed
    fill (binning.py:231-238) makes 16-bit keys; the port's real keys equal
    its keys bitwise (less the TPU's row pads), the rest the sentinel."""
    n, budget = 40000, 106496
    tb, (jx, _jd, jr, _jc, jn), (xys, _d, radii, _c, nth) = _scene(n, 48, 64, 12)
    jb = jax.jit(lambda x, r, k: jbin.bin_gaussians(x, r, k, tb, 16, 16, budget))(
        jx, jr, jn)
    assert jb.sorted_keys is not None  # the fast key path ran
    layout = fill_cuda.key_layout(tb[0] * tb[1], n)  # 16 bits: gsvc_tpu's keys
    jk = np.asarray(jb.sorted_keys).astype(np.int64)
    real = jk[(jk & layout.gauss_mask) != layout.gauss_mask]
    assert len(real) == int(jb.num_intersects) == int(nth.sum()) > 100000
    for kernels in (True, False):
        keys = binning.bin_gaussians(xys, radii, nth, tb, 16, 16, budget,
                                     kernels=kernels).sorted_keys
        assert keys.dtype == layout.dtype == torch.int32
        got = keys.numpy().astype(np.int64)
        np.testing.assert_array_equal(got[:len(real)], real)
        assert (got[len(real):] == layout.sentinel).all()


def test_budget_helpers_match_jax():
    rng = np.random.default_rng(6)
    nth = rng.integers(0, 9, 300).astype(np.int32)
    for budget in (0, 100, 700, 5000):
        assert int(binning.budget_overflow(torch.from_numpy(nth), budget)) == int(
            jbin.budget_overflow(jnp.asarray(nth), budget))
    for n, t in ((10, 4), (10000, 8160), (50000, 8160), (3, 1)):
        assert binning.default_max_intersects(n, t) == jbin.default_max_intersects(n, t)


def test_packing_limits_raise():
    z = torch.zeros((4, 2))
    r = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        binning.bin_gaussians(z, r, r, (256, 4, 1), 16, 16, 1024)
    with pytest.raises(ValueError):
        binning.bin_gaussians(z, r, r, (4, 4, 1), 16, 16, 1 << 23)
    big = torch.zeros((1 << 23, 2))  # gsvc_tpu's 23-bit gaussian-id limit
    rb = torch.zeros(1 << 23, dtype=torch.int32)
    with pytest.raises(ValueError):
        binning.bin_gaussians(big, rb, rb, (4, 4, 1), 16, 16, 1024)
