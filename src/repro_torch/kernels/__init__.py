"""Hand-written CUDA kernels (``csrc/``), their ctypes wrappers, the
plain PyTorch versions (``ref``) and the dispatch by device (``ops``)."""
