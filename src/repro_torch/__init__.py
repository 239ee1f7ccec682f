"""PyTorch + CUDA port of the SAM reproduction (the JAX package `repro` is
the reference it is held against).

Slice 1: the SAM cell's forward path — exact read, f32 rows, one device —
running through three kernels written by hand for Hopper
(`repro_torch.kernels.csrc`). Entry points default to ``device="cuda"``;
a caller asks for the CPU explicitly, and CPU tensors take the plain
PyTorch versions in `repro_torch.kernels.ref`.
"""
