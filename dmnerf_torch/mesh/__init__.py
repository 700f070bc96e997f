# Copied from dmnerf_tpu/mesh/__init__.py.
from dmnerf_torch.mesh.marching import marching_cubes, marching_tetrahedra
from dmnerf_torch.mesh.ply import read_ply, write_ply

__all__ = ["marching_cubes", "marching_tetrahedra", "read_ply", "write_ply"]
