#!/usr/bin/env python
"""CLI entry point of the PyTorch/CUDA port, reference-compatible launch:

  python train_video_Represent_torch.py --loss_type L2 --dataset <video.yuv> \
      --data_name Beauty --num_points 10000 --iterations 100000 --is_rm --is_ad
"""

import sys

from gsvc_tpu_torch.drivers.represent import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
