"""The benchmark of tpurt_torch (the PyTorch + CUDA port): see README.md."""
