"""PyTorch/CUDA port of the serving path (see README.md)."""
