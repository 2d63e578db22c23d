"""Checksummed checkpoint blobs and shard leases (the sweep orchestrator's
and the scheduler's durable state)."""
