"""PyTorch/CUDA port of the dMath reproduction, for one NVIDIA H100.

It mirrors the JAX package ``repro`` module by module and never imports it
(nor JAX): framework-free modules are copied and pinned to their originals
by the tests.  Every Pallas kernel on a ported path becomes a CUDA C++
kernel written for Hopper (``kernels/csrc``), built with ``nvcc`` at first
use and bound with ``ctypes``.
"""
