"""Device ops: plain PyTorch paths and the hand-written CUDA kernels beside them."""
