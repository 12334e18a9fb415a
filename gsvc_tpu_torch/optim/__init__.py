from gsvc_tpu_torch.optim.adan import (  # noqa: F401
    AdanState,
    adan_init,
    adan_reset_moments,
    adan_step,
)
from gsvc_tpu_torch.optim.schedule import step_lr  # noqa: F401
