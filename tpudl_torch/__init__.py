"""tpudl_torch — the PyTorch/CUDA port of tpudl for one NVIDIA H100.

The package mirrors tpudl's layout and names, so each module has an
obvious counterpart; the JAX package stays the reference. It imports
torch, numpy and the standard library, never jax, flax or tpudl.

Every Pallas kernel on a ported path becomes a hand-written Hopper
kernel under ``tpudl_torch/ops/csrc`` (CUDA C++ for sm_90a, built with
nvcc on first use and bound with ctypes). Public ops dispatch by the
tensor's device: a CUDA tensor launches the kernel, a CPU tensor takes
the plain PyTorch version beside it.
"""
