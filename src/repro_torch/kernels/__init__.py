"""Kernels of the LLM scaffold: hand-written CUDA kernels (``csrc/``),
their wrappers, and the plain PyTorch versions in ``ref.py``."""
