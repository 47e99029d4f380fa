"""Data parallelism over torch.distributed ranks (`parallel/mesh.py`)."""
