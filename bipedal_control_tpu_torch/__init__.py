"""PyTorch/CUDA port of the bipedal NMPC stack.

Mirrors ``bipedal_control_tpu`` module by module (same subpackage and module
names) and is checked against it: the JAX package is the reference.  Plain
tensor code is PyTorch; every Pallas kernel the JAX package runs on the
slice's path is a hand-written CUDA kernel for Hopper (``csrc/``), built with
``nvcc`` on first use and bound with ``ctypes`` (``ops/cuda_build.py``).

The package never imports ``jax`` or ``bipedal_control_tpu``.  Importing it
builds nothing and touches no device.
"""
