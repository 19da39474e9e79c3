"""repro_torch.core — the GraphTensor data model and modeling API in
PyTorch (counterpart of `repro.core`)."""
