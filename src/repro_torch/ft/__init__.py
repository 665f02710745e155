"""Fault tolerance: the step watchdog and the restart manager (``manager``)."""
