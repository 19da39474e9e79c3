"""segment_pool: CUDA kernel, wrapper and plain version."""
