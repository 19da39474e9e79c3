"""repro_torch.distributed — checkpointing and resume (counterpart of
`repro.distributed.fault_tolerance`); the mesh and its sharding come with
the parallelism slice."""
