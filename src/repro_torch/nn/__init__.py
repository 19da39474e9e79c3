"""repro_torch.nn — trainable layers (counterpart of `repro.nn`)."""
