"""gsvc_tpu_torch — the PyTorch/CUDA port of gsvc_tpu for NVIDIA Hopper.

Mirrors the JAX package module by module (`gsvc_tpu` stays the reference
it is tested against) and never imports JAX. Plain tensor code is
PyTorch; every Pallas TPU kernel on a ported path is a hand-written CUDA
kernel in `csrc/`, built with nvcc at first use into `build/` and bound
with ctypes (`_build.py`). Each kernel's wrapper runs its plain PyTorch
version on CPU tensors, so the package imports and is tested on a CPU.

Ported so far: the decode / eval-render path (projection, binning with
kernels K1/K2, the forward rasterizer K4/K5, the bitstream decoder and
`python -m gsvc_tpu_torch.decode`), the training step (the backward
rasterizer K6 and the K3 reduction, Adan, splat control) and the encoder
(`python -m gsvc_tpu_torch.drivers.represent`, then
`python -m gsvc_tpu_torch.drivers.compress`: K-frame detection, the QAT
compress stage and the `.gsvc` bitstream encoder).
"""

__version__ = "0.1.0"

from gsvc_tpu_torch.core import GaussianFrame  # noqa: F401
