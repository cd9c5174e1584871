"""PyTorch + CUDA port of acmmp_spherical_tpu for one NVIDIA H100.

The JAX package beside this one is the reference: every module here mirrors
the module of the same name there (``ops/kernels`` mirrors ``ops/pallas``).
The three Pallas kernels of the rectified photometric pass are CUDA C++
kernels under ``csrc/``, built with ``nvcc`` at first use.  This package
imports torch and numpy, and never JAX: the hyper-parameters are shared by
importing ``acmmp_spherical_tpu.config``, which is plain dataclasses.

f32 matmuls and convolutions run in full float32 (the reference asks for
``Precision.HIGHEST`` on every contraction), so TF32 is switched off here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
