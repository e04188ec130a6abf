"""repro_torch: Design in Tiles (DiT) — automated GEMM deployment for
tile-based many-PE accelerators, ported to PyTorch and CUDA on an NVIDIA
H100. Mirrors the JAX package `repro` module for module; the one Pallas
kernel (`mmad`) is a hand-written CUDA kernel under `kernels/csrc/`."""
__version__ = "0.1.0"
