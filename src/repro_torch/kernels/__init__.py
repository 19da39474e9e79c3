"""repro_torch.kernels — hand-written Hopper kernels (CUDA C++), their
plain PyTorch versions, and the registry that picks between them."""
