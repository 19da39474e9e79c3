"""repro_torch.serve — GNN inference serving on the GPU (counterpart of
`repro.serve.gnn` and `repro.serve.cache`)."""
