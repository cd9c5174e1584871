"""PyTorch + CUDA port of acmmp_spherical_tpu for one NVIDIA H100.

The JAX package beside this one is the reference: every module here mirrors
the module of the same name there (``ops/kernels`` mirrors ``ops/pallas``).
The Pallas kernels of the rectified photometric and geometric passes are
CUDA C++ kernels under ``csrc/``, built with ``nvcc`` at first use.  This
package imports torch and numpy, and nothing of JAX or of the JAX package:
it keeps its own copy of the hyper-parameters (``config.py``).  Entry points
run on the CUDA device unless the caller asks for the CPU.

f32 matmuls and convolutions run in full float32 (the reference asks for
``Precision.HIGHEST`` on every contraction), so TF32 is switched off here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
