"""PyTorch port parity: the deprecated `.apply` shims (gsvc_tpu_torch/legacy.py),
the root CLI shims of the port, and the public surface: every public name of
gsvc_tpu.ops, gsvc_tpu.utils and gsvc_tpu.legacy exists at the same path in
gsvc_tpu_torch.

Each shim must warn one DeprecationWarning a call and return what the
port's free function returns (exactly) and what gsvc_tpu's shim returns on
the same numpy inputs (floats rtol 1e-5 / atol 1e-5; integers and the
binning's contract fields exactly). The root shims run in a subprocess with
the port's mains replaced by stubs: each must reach its main with the
command line, and load no JAX.
"""

import subprocess
import sys
import types
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsvc_tpu.legacy as jlegacy
import gsvc_tpu.ops as jops
import gsvc_tpu.utils as jutils
import gsvc_tpu_torch.ops as tops
import gsvc_tpu_torch.utils as tutils
from gsvc_tpu_torch import legacy
from gsvc_tpu_torch.ops import binning, projection, projection3d, rasterize, rasterize_alpha
from gsvc_tpu_torch.ops import sh

REPO = Path(__file__).resolve().parents[1]
H, W = 40, 56
TB = ((W + 15) // 16, (H + 15) // 16, 1)


def _public(mod):
    return {n: v for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("jmod,tmod", [(jops, tops), (jutils, tutils), (jlegacy, legacy)],
                         ids=["ops", "utils", "legacy"])
def test_port_exports_cover_gsvc_tpu(jmod, tmod):
    mine = _public(tmod)
    missing = sorted(set(_public(jmod)) - set(mine))
    assert not missing, missing
    for name, v in _public(jmod).items():
        assert isinstance(mine[name], type) == isinstance(v, type), name
    if hasattr(jmod, "__all__"):
        assert sorted(tmod.__all__) == sorted(jmod.__all__)


def _inputs():
    rng = np.random.default_rng(0)
    n = 60
    means = rng.uniform(-1.1, 1.1, (n, 2)).astype(np.float32)
    L = (rng.uniform(0, 2, (n, 3)) + np.array([0.5, 0.0, 0.5])).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.2, 1.0, (n, 1)).astype(np.float32)
    depths = rng.uniform(1, 5, n).astype(np.float32)
    scales = rng.uniform(0.5, 3.0, (n, 2)).astype(np.float32)
    theta = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    m3 = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(2, 6, (n, 1))], 1)
    s3 = rng.uniform(0.02, 0.2, (n, 3))
    q = rng.normal(size=(n, 4))
    coeffs = rng.normal(size=(n, 9, 3))
    return dict(means=means, L=L, colors=colors, opacity=opacity, depths=depths,
                scales=scales, theta=theta, m3=m3.astype(np.float32),
                s3=s3.astype(np.float32), q=q.astype(np.float32),
                coeffs=coeffs.astype(np.float32), view=np.eye(4, dtype=np.float32))


def _calls(lib):
    """{shim: (args, kwargs)} in `lib`'s arrays (torch or jax.numpy)."""
    x = {k: (torch.tensor(v) if lib is torch else jnp.asarray(v)) for k, v in _inputs().items()}
    proj = (projection.project_gaussians_2d if lib is torch else
            jops.project_gaussians_2d)(x["means"], x["L"], H, W, TB)
    xys, _d, radii, conics, nth = proj
    cov2d = lib.stack([x["L"][:, 0] ** 2, x["L"][:, 0] * x["L"][:, 1],
                       x["L"][:, 1] ** 2 + x["L"][:, 2] ** 2], -1)
    return {
        "ComputeCov2dBounds": ((cov2d,), {}),
        "BinAndSortGaussians": ((xys, radii, nth, TB, 16, 16, 4096), {}),
        "ProjectGaussians": ((x["m3"], x["s3"], 1.0, x["q"], x["view"], 40.0, 40.0, W / 2,
                              H / 2, H, W, TB), {}),
        "ProjectGaussians2d": ((x["means"], x["L"], H, W, TB), {}),
        "ProjectGaussians2dScaleRot": ((x["means"], x["scales"], x["theta"], H, W, TB), {}),
        "RasterizeGaussians": ((xys, x["depths"], radii, conics, None, x["colors"],
                                x["opacity"], H, W), {"return_alpha": True}),
        "RasterizeGaussiansSum": ((xys, x["depths"], radii, conics, nth, x["colors"],
                                   x["opacity"], H, W), {}),
        "SphericalHarmonics": ((2, x["m3"], x["coeffs"]), {}),
    }


FREE = {
    "ComputeCov2dBounds": lambda c: projection.compute_cov2d_bounds(c)[:2],
    "BinAndSortGaussians": binning.bin_gaussians,
    "ProjectGaussians": projection3d.project_gaussians,
    "ProjectGaussians2d": projection.project_gaussians_2d,
    "ProjectGaussians2dScaleRot": projection.project_gaussians_2d_scale_rot,
    "RasterizeGaussians": rasterize_alpha.rasterize_gaussians_alpha,
    "RasterizeGaussiansSum": rasterize.rasterize_gaussians_sum,
    "SphericalHarmonics": sh.spherical_harmonics,
}


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _members(b):
    ids = np.asarray(b.sorted_gauss_ids)
    return [ids[s:s + c].tolist() for s, c in zip(np.asarray(b.tile_bin_start),
                                                  np.asarray(b.tile_counts))]


@pytest.mark.parametrize("name", sorted(FREE))
def test_shim_warns_and_matches(name):
    args, kw = _calls(torch)[name]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = getattr(legacy, name).apply(*args, **kw)
    assert [w.category for w in rec] == [DeprecationWarning], rec
    assert name in str(rec[0].message)
    want = FREE[name](*args, **kw)
    for a, b in zip(_flat(got), _flat(want), strict=True):
        assert torch.equal(a, b)
    jargs, jkw = _calls(jnp)[name]
    arrays = [i for i, a in enumerate(jargs) if isinstance(a, jax.Array)]

    def theirs_fn(*xs):  # gsvc_tpu's shim under jit, its non-array arguments fixed
        full = list(jargs)
        for i, x in zip(arrays, xs):
            full[i] = x
        return getattr(jlegacy, name).apply(*full, **jkw)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        theirs = jax.jit(theirs_fn)(*(jargs[i] for i in arrays))
    if name == "BinAndSortGaussians":  # the contract fields (no TPU row padding)
        for field in ("tile_counts", "num_intersects", "overflow", "gauss_slot_start",
                      "bbox_pack"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(theirs, field)), err_msg=field)
        assert _members(got) == _members(theirs)
        return
    for a, b in zip(_flat(got), _flat(theirs), strict=True):
        b = np.asarray(b)
        if b.dtype == np.int32:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shim,module", [
    ("train_video_Represent_torch.py", "gsvc_tpu_torch.drivers.represent"),
    ("train_video_Compress_torch.py", "gsvc_tpu_torch.drivers.compress"),
])
def test_root_shims_reach_the_port_mains(shim, module):
    code = (
        "import importlib, runpy, sys\n"
        f"mod = importlib.import_module({module!r})\n"
        "mod.main = lambda argv: print('main', mod.__name__, argv) or 3\n"
        f"sys.argv = [{shim!r}, '--width', '48']\n"
        "try:\n"
        f"    runpy.run_path({shim!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('exit', e.code)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gsvc_tpu')]\n"
        "print('jax', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [f"main {module} ['--width', '48']", "exit 3",
                                       "jax []"], out.stdout
