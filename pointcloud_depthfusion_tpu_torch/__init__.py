"""PyTorch/CUDA port of pointcloud_depthfusion_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout module for module. Plain tensor code is
PyTorch; the kernels the JAX package wrote in Pallas are CUDA C++ under
``csrc/``, built with nvcc for sm_90a at first use (ops/cuda/_build.py).
This package never imports jax.
"""
