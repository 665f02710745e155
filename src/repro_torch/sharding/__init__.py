"""Sharding of the port: mesh axes and axis groups (``spec``), rules (``rules``)."""
