from gsvc_tpu_torch.io.yuv import process_yuv_video, yuv420_to_rgb  # noqa: F401
from gsvc_tpu_torch.io.video import generate_video  # noqa: F401
