#!/usr/bin/env bash
# Sweep launcher of the PyTorch port: the representation stage over
# (video x num_points), the counterpart of scripts/sh_train_representation.sh
# (the reference SLURM sweep, sh_train_representation.sh:16-57). Each run is
# an independent one-card job; gsvc_tpu_torch/scripts/sh_train_multihost.sh
# shards GOPs across hosts instead.
#
# Usage: DATA_DIR=/path/to/uvg bash gsvc_tpu_torch/scripts/sh_train_representation.sh
# The same variables and defaults as the JAX sweep, and DEVICE (default
# cuda; cpu runs the port on the CPU), passed as --device. Arguments given
# to the script go to every run's CLI after the sweep's own. Checkpoints land
# in ./checkpoints/models/<video>/GaussianVideo_<ITERATIONS>_<num_points>/
# (the represent CLI's --checkpoint_dir default), where
# sh_train_compression.sh reads them.
set -euo pipefail
repo="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$repo${PYTHONPATH:+:$PYTHONPATH}"

DATA_DIR="${DATA_DIR:?set DATA_DIR to the directory holding the .yuv files}"
OUT_DIR="${OUT_DIR:-result}"
ITERATIONS="${ITERATIONS:-100000}"
IMAGE_LENGTH="${IMAGE_LENGTH:-50}"
WIDTH="${WIDTH:-1920}"
HEIGHT="${HEIGHT:-1080}"
DEVICE="${DEVICE:-cuda}"
VIDEOS=(${VIDEOS:-Beauty_1920x1080_120fps_420_8bit_YUV.yuv HoneyBee_1920x1080_120fps_420_8bit_YUV.yuv Jockey_1920x1080_120fps_420_8bit_YUV.yuv})
NUM_POINTS=(${NUM_POINTS:-10000 20000 30000 40000 50000})

for video in "${VIDEOS[@]}"; do
  name="$(basename "$video" .yuv)"
  for np in "${NUM_POINTS[@]}"; do
    echo ">>> representation: $name num_points=$np"
    python "$repo/train_video_Represent_torch.py" \
      --dataset "$DATA_DIR/$video" \
      --data_name "$name" \
      --width "$WIDTH" --height "$HEIGHT" \
      --num_points "$np" \
      --iterations "$ITERATIONS" \
      --image_length "$IMAGE_LENGTH" \
      --savdir "$OUT_DIR" \
      --is_rm --is_ad \
      --device "$DEVICE" \
      "$@"
  done
done
