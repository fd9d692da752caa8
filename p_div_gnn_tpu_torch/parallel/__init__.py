"""The parallel tier on ``torch.distributed``: collectives with JAX's
transposes, data-parallel and edge-partitioned training, process-group
set-up and the weak-scaling harness. One process runs per card, each on
its own shard."""
