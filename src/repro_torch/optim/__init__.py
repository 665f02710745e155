"""Optimizers (``adamw``: AdamW, Adafactor, the schedule and clipping) and
gradient compression (``compress``)."""
