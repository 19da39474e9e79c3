"""repro_torch.models — the architecture registry (counterpart of
`repro.models`)."""
