"""edge_mpnn: CUDA kernel, wrapper and plain version."""
