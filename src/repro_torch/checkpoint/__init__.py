"""Checkpoints with an async commit and a retention policy (``ckpt``)."""
