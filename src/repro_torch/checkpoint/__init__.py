"""Checksummed checkpoint blobs and shard leases (the sweep orchestrator's
and the scheduler's durable state), and the training state's pytree
checkpoints."""
