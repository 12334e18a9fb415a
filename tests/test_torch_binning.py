"""PyTorch port parity: tile binning and the plain versions of K1/K2.

K1/K2's plain PyTorch versions are held exactly against the JAX Pallas
kernels `fill_decode_keys` and `rank_cap_decode`, run in interpret mode
(as tests/test_fill_pallas.py runs them): the port's keys are int32 on
grids of up to 32,767 tiles and int64 above, and both hold the JAX
package's uint32 values. K2's third output, the tile edges, is held to
gsvc_tpu's `bin_gaussians` tile counts and kept total on the scenes, and
to the counts of K1's keys on the synthetic inputs (no splats, a budget
filled exactly, empty tiles at both ends of the grid, caps 1 and 4, runs
past the cap across 1024-lane blocks). `bin_gaussians` is held exactly
against gsvc_tpu's on the contract fields: per-tile member lists in
(tile, gauss) order with the cap, tile counts, num_intersects, overflow,
gauss_slot_start and bbox_pack. The TPU-only row padding is not part of
the contract, so sorted arrays are compared through the member lists.
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
    assert keys.dtype == fill_cuda.key_dtype(ki.num_tiles)
    _assert_keys_equal_jax(ki, keys)

    skeys = torch.sort(keys).values
    tiles, _gauss, edges = _assert_k2_equal_jax(skeys, cap, n, ki.num_tiles)
    counts = np.bincount((keys.numpy() >> 16).astype(np.int64), minlength=ki.num_tiles + 1)
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


def test_key_dtype_follows_the_tile_count():
    assert fill_cuda.key_dtype(8160) == torch.int32  # 1080p
    assert fill_cuda.key_dtype(32767) == torch.int32
    assert fill_cuda.key_dtype(32768) == torch.int64
    assert fill_cuda.key_dtype(255 * 255) == torch.int64
    assert fill_cuda._sentinel(32767) == 2**31 - 1


def _members(gauss_ids, starts, counts, cap):
    g = np.asarray(gauss_ids)
    return [g[s:s + min(c, cap)].tolist() for s, c in zip(np.asarray(starts),
                                                          np.asarray(counts))]


@pytest.mark.parametrize("n,hw,seed,budget,cap", SCENES)
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
    if budget == 64:
        assert int(jb.overflow) > 0
    if cap == 4:
        assert (counts > cap).any()


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
    big = torch.zeros((0xFFFF, 2))
    rb = torch.zeros(0xFFFF, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        binning.bin_gaussians(big, rb, rb, (4, 4, 1), 16, 16, 1024)
