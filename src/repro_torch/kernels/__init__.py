"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` is the public door: a CUDA tensor launches the kernel, a CPU
tensor runs the plain version in ``ref``. ``_build`` compiles
``csrc/*.cu`` with nvcc at first launch and loads them with ctypes.
"""
