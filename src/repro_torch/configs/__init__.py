"""Model configurations: the port's copies of ``repro/configs``."""
