#!/usr/bin/env bash
# Multi-host GOP-parallel representation training with the PyTorch port
# (the counterpart of scripts/sh_train_multihost.sh).
#
# K-frame chains (GOPs) are independent (gsvc_tpu_torch/parallel/multihost.py),
# so N hosts train disjoint GOP sets at once and host 0 merges the artifacts
# into the single-host run's layout, bit for bit. --checkpoint_dir must be on
# a filesystem every host shares.
#
# Under SLURM:
#   sbatch -N4 gsvc_tpu_torch/scripts/sh_train_multihost.sh <dataset.yuv> [args...]
# (srun starts one task a node; the SLURM_* variables drive the assignment.)
#
# Standalone, several processes (one card each where the machine has several):
#   GSVC_NUM_PROCS=2 GSVC_COORDINATOR=127.0.0.1:9911 GSVC_PROC_ID=0 \
#     gsvc_tpu_torch/scripts/sh_train_multihost.sh data.yuv ... &
#   GSVC_NUM_PROCS=2 GSVC_COORDINATOR=127.0.0.1:9911 GSVC_PROC_ID=1 \
#     gsvc_tpu_torch/scripts/sh_train_multihost.sh data.yuv ...
#
# GSVC_COORDINATOR brings up a torch.distributed gloo group whose barriers
# the hosts meet at; without it they meet through marker files in the shared
# checkpoint directory. Both paths give the same artifacts.
set -euo pipefail
repo="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$repo${PYTHONPATH:+:$PYTHONPATH}"

DATASET="${1:?usage: sh_train_multihost.sh <dataset.yuv> [train args...]}"
shift

# SLURM fills these in; standalone users export GSVC_* themselves.
# GSVC_RUN_NONCE namespaces the barrier's marker files a run (SLURM_JOB_ID
# is the same on every node of a job); standalone processes should export
# one shared GSVC_RUN_NONCE.
export GSVC_RUN_NONCE="${GSVC_RUN_NONCE:-${SLURM_JOB_ID:-}}"
export GSVC_NUM_PROCS="${GSVC_NUM_PROCS:-${SLURM_NTASKS:-1}}"
export GSVC_PROC_ID="${GSVC_PROC_ID:-${SLURM_PROCID:-0}}"
if [ -z "${GSVC_COORDINATOR:-}" ] && [ -n "${SLURM_JOB_NODELIST:-}" ]; then
    head_node="$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)"
    export GSVC_COORDINATOR="${head_node}:9911"
fi
# several host processes on one machine with several cards: one card each
# (by SLURM_LOCALID); a host never falls back to the CPU
if [ -z "${CUDA_VISIBLE_DEVICES:-}" ] && [ -n "${SLURM_LOCALID:-}" ]; then
    cards="$(nvidia-smi -L 2>/dev/null | wc -l)"
    if [ "$cards" -gt 1 ]; then
        export CUDA_VISIBLE_DEVICES="$(( SLURM_LOCALID % cards ))"
    fi
fi

exec python -m gsvc_tpu_torch.drivers.represent \
    -d "$DATASET" \
    --hosts "$GSVC_NUM_PROCS" \
    "$@"
