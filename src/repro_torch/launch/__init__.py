"""Launchers: the mesh from the live ranks (``mesh``) and training (``train``)."""
