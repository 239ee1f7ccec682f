"""PyTorch + CUDA port of the SAM reproduction (the JAX package `repro` is
the reference it is held against).

The SAM cell (exact or LSH read; f32 rows forward and in training, bf16
and int8 rows forward), the dense baselines (DAM, the NTM, the LSTM) and
the SAM-augmented LM's serving forward for the dense GQA family
(`models/`, `configs/`, `launch/serve.py`), on one device, through kernels written by hand for Hopper
(`repro_torch.kernels.csrc`). Entry points default to ``device="cuda"``;
a caller asks for the CPU explicitly, and CPU tensors take the plain
PyTorch versions in `repro_torch.kernels.ref`.
"""
