"""PyTorch reference models and the hand-written CUDA kernels they run."""
