"""Logical-axis sharding rules of the port (``distributed.sharding``)."""
