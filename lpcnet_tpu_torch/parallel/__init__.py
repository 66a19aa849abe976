"""Multi-GPU work over torch.distributed (parallel/mesh.py)."""
