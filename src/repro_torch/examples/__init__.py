"""The JAX package's `examples/` that drive the LM, as modules of the port
(`python -m repro_torch.examples.<name>`)."""
