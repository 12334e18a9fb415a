"""PyTorch port parity: tile binning and the plain versions of K1/K2.

K1/K2's plain PyTorch versions are held exactly against the JAX Pallas
kernels `fill_decode_keys` and `rank_cap_decode`, run in interpret mode
(as tests/test_fill_pallas.py runs them): the port's keys are int32 on
grids of up to 32,767 tiles and int64 above, and both hold the JAX
package's uint32 values. `bin_gaussians` is held exactly
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
    tiles, gauss = fill_cuda.rank_cap_decode_torch(skeys, cap, n)
    jt, jg = fp.rank_cap_decode(jnp.asarray(skeys.numpy().astype(np.uint32)), cap, n)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(gauss.numpy(), np.asarray(jg))
    wt, wg = fill_cuda.rank_cap_decode(skeys, cap, n, ki.num_tiles)
    assert torch.equal(wt, tiles) and torch.equal(wg, gauss)


def _assert_keys_equal_jax(ki, keys):
    jkeys = fp.fill_decode_keys(_jax_seeds(ki), jnp.int32(int(ki.total_kept)),
                                ki.tb_x, ki.num_tiles, ki.starts.shape[0])
    np.testing.assert_array_equal(keys.numpy().astype(np.int64),
                                  np.asarray(jkeys).astype(np.int64))


@pytest.mark.parametrize("n,tb,budget", [
    (6000, (120, 68), 20480), (6000, (120, 68), 4096), (0, (120, 68), 1024),
    (6000, (255, 200), 20480), (6000, (255, 200), 4096)])
def test_plain_k1_matches_pallas_kernel_on_hard_inputs(_pallas_interpret, n, tb, budget):
    ki = synthetic_key_inputs(n, tb, budget, seed=n + budget)
    if n:
        assert (ki.nth == 0).any() and int(ki.nth.max()) == 64 * 50
    if budget == 4096:
        assert int(ki.nth.sum()) > int(ki.total_kept)
    keys = fill_cuda.fill_decode_keys_torch(*ki.k1)
    assert keys.dtype == fill_cuda.key_dtype(ki.num_tiles)
    _assert_keys_equal_jax(ki, keys)


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
