"""repro_torch.orchestration — tasks, dataset providers, evaluation, the
Trainer and the `runner.run` shim (counterpart of
`repro.orchestration`)."""
