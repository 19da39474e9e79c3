"""Entry points of the LM side (counterpart of `repro.launch`): the
training entry point `train` and, in `specs`, the optimizer policy by
model scale."""
