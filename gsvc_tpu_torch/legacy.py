"""Deprecated `.apply`-style API shims (PyTorch port of gsvc_tpu/legacy.py).

The reference keeps `torch.autograd.Function` classes whose `.apply`
forwards to the free functions with a DeprecationWarning
(gsplat/__init__.py:52-213). Each shim here is a class with a static
`apply` that warns and calls the port's free function with the same
arguments, so `ProjectGaussians2d.apply(...)`-style call sites port
unchanged.
"""

from __future__ import annotations

import warnings

from gsvc_tpu_torch.ops.binning import bin_gaussians
from gsvc_tpu_torch.ops.projection import (
    compute_cov2d_bounds,
    project_gaussians_2d,
    project_gaussians_2d_scale_rot,
)
from gsvc_tpu_torch.ops.projection3d import project_gaussians
from gsvc_tpu_torch.ops.rasterize import rasterize_gaussians_sum
from gsvc_tpu_torch.ops.rasterize_alpha import rasterize_gaussians_alpha
from gsvc_tpu_torch.ops.sh import spherical_harmonics

__all__ = [
    "ComputeCov2dBounds",
    "BinAndSortGaussians",
    "ProjectGaussians",
    "ProjectGaussians2d",
    "ProjectGaussians2dScaleRot",
    "RasterizeGaussians",
    "RasterizeGaussiansSum",
    "SphericalHarmonics",
]


def _warn(name: str, repl: str) -> None:
    warnings.warn(
        f"{name}.apply is deprecated, use {repl} instead",
        DeprecationWarning,
        stacklevel=3,
    )


class ComputeCov2dBounds:
    """gsplat/__init__.py:80-92 equivalent."""

    @staticmethod
    def apply(cov2d):
        _warn("ComputeCov2dBounds", "ops.projection.compute_cov2d_bounds")
        conic, radius, _ok = compute_cov2d_bounds(cov2d)
        return conic, radius


class BinAndSortGaussians:
    """gsplat/__init__.py:108-120 equivalent (static-shape CSR)."""

    @staticmethod
    def apply(xys, radii, num_tiles_hit, tile_bounds, block_w, block_h,
              max_intersects):
        _warn("BinAndSortGaussians", "ops.binning.bin_gaussians")
        return bin_gaussians(
            xys, radii, num_tiles_hit, tile_bounds, block_w, block_h,
            max_intersects,
        )


class ProjectGaussians:
    """gsplat/__init__.py:122-133 equivalent."""

    @staticmethod
    def apply(*args, **kwargs):
        _warn("ProjectGaussians", "ops.projection3d.project_gaussians")
        return project_gaussians(*args, **kwargs)


class ProjectGaussians2d:
    """gsplat/__init__.py:135-146 equivalent."""

    @staticmethod
    def apply(*args, **kwargs):
        _warn("ProjectGaussians2d", "ops.projection.project_gaussians_2d")
        return project_gaussians_2d(*args, **kwargs)


class ProjectGaussians2dScaleRot:
    """gsplat/__init__.py:148-160 equivalent."""

    @staticmethod
    def apply(*args, **kwargs):
        _warn(
            "ProjectGaussians2dScaleRot",
            "ops.projection.project_gaussians_2d_scale_rot",
        )
        return project_gaussians_2d_scale_rot(*args, **kwargs)


class RasterizeGaussians:
    """gsplat/__init__.py:162-173 equivalent."""

    @staticmethod
    def apply(*args, **kwargs):
        _warn(
            "RasterizeGaussians", "ops.rasterize_alpha.rasterize_gaussians_alpha"
        )
        return rasterize_gaussians_alpha(*args, **kwargs)


class RasterizeGaussiansSum:
    """gsplat/__init__.py:175-186 equivalent."""

    @staticmethod
    def apply(*args, **kwargs):
        _warn("RasterizeGaussiansSum", "ops.rasterize.rasterize_gaussians_sum")
        return rasterize_gaussians_sum(*args, **kwargs)


class SphericalHarmonics:
    """gsplat/__init__.py:201-213 equivalent."""

    @staticmethod
    def apply(*args, **kwargs):
        _warn("SphericalHarmonics", "ops.sh.spherical_harmonics")
        return spherical_harmonics(*args, **kwargs)
