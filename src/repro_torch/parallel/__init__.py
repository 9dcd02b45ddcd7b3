"""Logical-axis sharding rules and the cuts of full tensors to shards."""
