"""repro_torch.configs — architecture and shape configurations (copies
of `repro.configs`)."""
