"""repro_torch.train — the optimizer and the graph train/eval steps
(counterparts of `repro.train.optimizer` and `repro.train.train_loop`)."""
