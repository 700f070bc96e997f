"""Data parallelism over cards: the ray mesh (mesh.py)."""
