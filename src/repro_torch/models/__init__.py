"""The LM of the port: config, layers, attention, the SAM memory layer,
the transformer block and the top-level model (`lm`)."""
