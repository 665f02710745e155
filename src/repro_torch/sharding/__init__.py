"""Sharding of the port: mesh axes and axis groups (``spec``), the
rules (``rules``) and the collectives of sharded training (``parallel``)."""
