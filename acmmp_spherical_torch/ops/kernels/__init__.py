"""Hand-written Hopper kernels (counterpart of acmmp_spherical_tpu/ops/pallas).

Each module holds a kernel's wrapper and its plain-torch version.  A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches the
kernel (built from ``csrc/`` at first use, see ``_lib``) or raises.
"""
