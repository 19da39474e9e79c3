"""repro_torch.data — host-side sampling, merge-and-pad batching and
synthetic data: numpy copies of `repro.data`, held to the originals by
tests/test_torch_host_parity.py."""
