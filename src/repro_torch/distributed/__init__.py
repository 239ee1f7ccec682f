"""Distributed layers of the port: the slot-sharded SAM memory on
`torch.distributed` (`mem_shard`)."""
