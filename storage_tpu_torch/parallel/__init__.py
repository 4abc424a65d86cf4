"""Device-mesh scale-out over the paths axis (``parallel/mesh.py``)."""
