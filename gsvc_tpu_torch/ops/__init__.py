from gsvc_tpu_torch.ops.projection import (  # noqa: F401
    project_gaussians_2d,
    project_gaussians_2d_scale_rot,
)
from gsvc_tpu_torch.ops.rasterize import rasterize_gaussians_sum  # noqa: F401
from gsvc_tpu_torch.ops.projection3d import (  # noqa: F401
    project_gaussians,
    quat_to_rotmat,
    scale_rot_to_cov3d,
)
from gsvc_tpu_torch.ops.rasterize_alpha import (  # noqa: F401
    rasterize_gaussians_alpha,
)
from gsvc_tpu_torch.ops.sh import (  # noqa: F401
    deg_from_sh,
    num_sh_bases,
    spherical_harmonics,
)
