"""repro_torch.orchestration — tasks (counterpart of
`repro.orchestration`)."""
