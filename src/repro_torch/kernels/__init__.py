"""Kernels of the port: hand-written CUDA for Hopper (`csrc/`), their
ctypes wrappers (`fused_read`, `sparse_write`, `usage_argmin`), the plain
PyTorch versions (`ref`) and the device dispatch (`ops`)."""
