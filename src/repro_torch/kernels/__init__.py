"""Kernels of the port: hand-written CUDA for Hopper (`csrc/`), their
ctypes wrappers (`flash_attention`, `fused_read`, `fused_read_candidates`,
`lsh_hash`, `scatter_rows`, `sparse_write`, `topk_read`, `usage_argmin`),
the plain PyTorch versions (`ref`) and the device dispatch (`ops`)."""
