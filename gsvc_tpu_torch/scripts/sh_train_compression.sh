#!/usr/bin/env bash
# Sweep launcher of the PyTorch port: the compression stage over
# (video x num_points), the counterpart of scripts/sh_train_compression.sh
# (the reference SLURM sweep, sh_train_compression.sh:28-72). Consumes the
# representation checkpoints that sh_train_representation.sh wrote.
#
# Usage: DATA_DIR=/path/to/uvg bash gsvc_tpu_torch/scripts/sh_train_compression.sh
# The same variables and defaults as the JAX sweep, and DEVICE (default
# cuda; cpu runs the port on the CPU), passed as --device. Each run reads
# $CKPT_DIR/$MODEL_SAVDIR/<video>/GaussianVideo_<REPR_ITERATIONS>_<num_points>/
# gmodels_state_dict.npz, the represent CLI's checkpoint.
set -euo pipefail
repo="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$repo${PYTHONPATH:+:$PYTHONPATH}"

DATA_DIR="${DATA_DIR:?set DATA_DIR to the directory holding the .yuv files}"
CKPT_DIR="${CKPT_DIR:-./checkpoints}"
MODEL_SAVDIR="${MODEL_SAVDIR:-models}"
OUT_DIR="${OUT_DIR:-result_compress}"
REPR_ITERATIONS="${REPR_ITERATIONS:-100000}"
ITERATIONS="${ITERATIONS:-50000}"
IMAGE_LENGTH="${IMAGE_LENGTH:-50}"
WIDTH="${WIDTH:-1920}"
HEIGHT="${HEIGHT:-1080}"
DEVICE="${DEVICE:-cuda}"
VIDEOS=(${VIDEOS:-Beauty_1920x1080_120fps_420_8bit_YUV.yuv HoneyBee_1920x1080_120fps_420_8bit_YUV.yuv Jockey_1920x1080_120fps_420_8bit_YUV.yuv})
NUM_POINTS=(${NUM_POINTS:-10000 20000 30000 40000 50000})

for video in "${VIDEOS[@]}"; do
  name="$(basename "$video" .yuv)"
  for np in "${NUM_POINTS[@]}"; do
    ckpt="$CKPT_DIR/$MODEL_SAVDIR/$name/GaussianVideo_${REPR_ITERATIONS}_${np}/gmodels_state_dict.npz"
    echo ">>> compression: $name num_points=$np model=$ckpt"
    python "$repo/train_video_Compress_torch.py" \
      --dataset "$DATA_DIR/$video" \
      --data_name "$name" \
      --width "$WIDTH" --height "$HEIGHT" \
      --num_points "$np" \
      --iterations "$ITERATIONS" \
      --image_length "$IMAGE_LENGTH" \
      --model_path "$ckpt" \
      --savdir "$OUT_DIR" \
      --device "$DEVICE"
  done
done
