"""The LM's steps and sharding rules (port of ``repro.distributed``): one
device, or a (data, model) device mesh on DTensor."""
