#!/usr/bin/env python
"""CLI entry point of the PyTorch/CUDA port, reference-compatible launch:

  python train_video_Compress_torch.py --dataset <video.yuv> \
      --model_path checkpoints/models/<name>/gmodels_state_dict.npz \
      --data_name Beauty --num_points 10000 --iterations 50000 --is_rm
"""

import sys

from gsvc_tpu_torch.drivers.compress import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
