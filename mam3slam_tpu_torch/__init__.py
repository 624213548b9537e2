"""mam3slam_tpu_torch — the PyTorch + CUDA port of mam3slam_tpu.

Plain tensor code is PyTorch; each kernel the reference wrote in Pallas
for the TPU is a hand-written CUDA kernel for Hopper (``csrc/``), built
with nvcc at first use and bound with ctypes (``_build.py``).  A function
given CPU tensors runs the kernel's plain PyTorch version; given CUDA
tensors it launches the kernel.  The package never imports JAX.
"""

__version__ = "0.1.0"
