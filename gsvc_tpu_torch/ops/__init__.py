from gsvc_tpu_torch.ops.projection import project_gaussians_2d  # noqa: F401
from gsvc_tpu_torch.ops.rasterize import rasterize_gaussians_sum  # noqa: F401
