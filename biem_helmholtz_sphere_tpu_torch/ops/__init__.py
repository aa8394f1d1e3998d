"""Solver and kernel ops: GMRES, the kernel build, and the kernel wrappers
with their plain PyTorch versions."""
