"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a, bound
with ctypes), each with its plain PyTorch version in ``ref.py`` and a
dispatching ``ops.py``: CPU tensors take the plain version, CUDA tensors
the kernel."""
