"""Device meshes for bone batches (parallel/mesh.py)."""
