from gsvc_tpu_torch.utils.losses import loss_fn  # noqa: F401
from gsvc_tpu_torch.utils.metrics import ms_ssim, psnr, ssim  # noqa: F401
from gsvc_tpu_torch.utils.logwriter import LogWriter  # noqa: F401
from gsvc_tpu_torch.utils.control import EarlyStopping, detect_outliers_mean_diff  # noqa: F401
from gsvc_tpu_torch.utils.geometry import (  # noqa: F401
    build_covariance_from_cholesky,
    build_covariance_from_scaling_rotation_2d,
    build_rotation,
    build_rotation_2d,
    build_scaling_rotation,
    build_scaling_rotation_2d,
    build_triangular,
    strip_lowerdiag,
    strip_symmetric,
)
from gsvc_tpu_torch.utils.profiling import StepTimer, time_fn, trace  # noqa: F401
