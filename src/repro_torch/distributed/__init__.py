"""repro_torch.distributed — the mesh over torch.distributed ranks
(`partition`, `sharding`, `graph_sharding`, `collectives`, `launch`) and
checkpointing with resume (`fault_tolerance`); counterpart of
`repro.distributed`."""
