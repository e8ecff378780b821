"""Logical-axis sharding rules (shardlib)."""
