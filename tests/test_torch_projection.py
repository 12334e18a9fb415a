"""PyTorch port parity: config, core and projection against gsvc_tpu.

Inputs are drawn with numpy from a seed and fed to both packages.
Tolerances: integers (radii, tile counts, bboxes) exact; floats rtol 1e-6
(the same f32 formulas, evaluated by XLA on one side and ATen on the
other).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.config import FrameConfig as JFrameConfig
from gsvc_tpu.core import SplatParams
from gsvc_tpu.ops import projection as jproj
from gsvc_tpu_torch import core
from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.ops import projection

RTOL = 1e-6


def _splats(n, seed):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.1, 1.1, (n, 2)).astype(np.float32)
    L = (rng.uniform(0, 2, (n, 3)) + np.array([0.5, 0.0, 0.5])).astype(np.float32)
    L[:5, 0] = 0.0  # det == 0: l11 = 0
    L[5:9, 1:] = 0.0  # det == 0: l21 = l22 = 0
    alive = rng.uniform(size=n) > 0.2
    return means, L, alive


@pytest.mark.parametrize("hw,seed,use_alive", [
    ((48, 64), 0, False), ((37, 51), 1, True), ((64, 96), 2, True),
])
def test_project_gaussians_2d_matches_jax(hw, seed, use_alive):
    H, W = hw
    means, L, alive = _splats(300, seed)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    j = jproj.project_gaussians_2d(
        jnp.asarray(means), jnp.asarray(L), H, W, tb,
        alive=jnp.asarray(alive) if use_alive else None,
    )
    t = projection.project_gaussians_2d(
        torch.from_numpy(means), torch.from_numpy(L), H, W, tb,
        alive=torch.from_numpy(alive) if use_alive else None,
    )
    names = ("xys", "depths", "radii", "conics", "num_tiles_hit")
    for name, a, b in zip(names, j, t):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, name
        if name in ("radii", "num_tiles_hit"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=0, err_msg=name)
    radii = t[2].numpy()
    assert (radii[:9] == 0).all()  # det == 0 rows are rejected
    if use_alive:
        assert (radii[~alive] == 0).all() and (t[4].numpy()[~alive] == 0).all()


def test_cov2d_bounds_and_tile_bbox_match_jax():
    rng = np.random.default_rng(3)
    cov = rng.uniform(-2, 8, (200, 3)).astype(np.float32)
    cov[:10, 1] = np.sqrt(cov[:10, 0].clip(0) * cov[:10, 2].clip(0))  # det ~ 0
    cov[10:15] = 0.0  # det == 0 exactly
    jc, jr, jok = jproj.compute_cov2d_bounds(jnp.asarray(cov))
    tc, tr, tok = projection.compute_cov2d_bounds(torch.from_numpy(cov))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL, atol=0)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))

    xys = rng.uniform(-20, 120, (200, 2)).astype(np.float32)
    radius = rng.integers(0, 40, 200).astype(np.float32)
    tb = (7, 5, 1)
    jb = jproj._tile_bbox(jnp.asarray(xys), jnp.asarray(radius), tb, 16, 16)
    tbb = projection._tile_bbox(torch.from_numpy(xys), torch.from_numpy(radius), tb, 16, 16)
    for a, b in zip(jb, tbb):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("hw", [(1080, 1920), (37, 51), (64, 64)])
def test_frame_config_tile_bounds(hw):
    H, W = hw
    kw = dict(H=H, W=W, num_points=10, max_num_points=10, iterations=1)
    assert FrameConfig(**kw).tile_bounds == JFrameConfig(**kw).tile_bounds


def test_gaussian_frame_activations_match_splat_params():
    rng = np.random.default_rng(4)
    arrays = dict(
        xyz=rng.normal(0, 0.7, (50, 2)).astype(np.float32),
        cholesky=rng.uniform(0, 1, (50, 3)).astype(np.float32),
        features_dc=rng.uniform(0, 1, (50, 3)).astype(np.float32),
        rgb_w=rng.uniform(0, 1, (50, 1)).astype(np.float32),
    )
    jp = SplatParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    for frame in (core.from_numpy(arrays), core.from_numpy(jp)):
        assert frame.capacity == 50
        for name in ("get_xyz", "get_cholesky_elements", "get_features"):
            np.testing.assert_allclose(
                getattr(frame, name).detach().numpy(),
                np.asarray(getattr(jp, name)), rtol=RTOL, atol=1e-7,
                err_msg=name,
            )
    ck = core.from_numpy({"_xyz": arrays["xyz"], "_cholesky": arrays["cholesky"],
                          "_features_dc": arrays["features_dc"]})
    assert torch.equal(ck.rgb_w.detach(), torch.ones(50, 1))


def test_init_splats_takes_injected_draws():
    rng = np.random.default_rng(5)
    u = (rng.uniform(-1, 1, (12, 2)), rng.uniform(0, 1, (12, 3)),
         rng.uniform(0, 1, (12, 3)))
    u[0][0, 0] = 1.0  # the atanh pole is clipped
    frame, alive = core.init_splats(8, capacity=12, rgb_w_value=0.01, uniforms=u)
    want = np.arctanh(np.clip(u[0].astype(np.float32), -1 + 1e-7, 1 - 1e-7))
    np.testing.assert_allclose(frame.xyz.detach().numpy(), want, rtol=RTOL)
    np.testing.assert_array_equal(frame.cholesky.detach().numpy(),
                                  u[1].astype(np.float32))
    assert np.isfinite(frame.xyz.detach().numpy()).all()
    assert alive.tolist() == [True] * 8 + [False] * 4
    assert torch.all(frame.rgb_w == 0.01)
    g = torch.Generator().manual_seed(0)
    drawn, _ = core.init_splats(6, generator=g)
    assert drawn.xyz.shape == (6, 2) and drawn.features_dc.min() >= 0
