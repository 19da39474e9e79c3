"""flash_attention: CUDA kernel, wrapper and plain version."""
