"""The port's offload client over port servers on a CUDA lane.

Two `BlsOffloadServer`s over one CUDA mesh (class 8 of the single-launch
graph captured first), the port's `BlsOffloadClient` routing to both
in-process (`local_transports`, a `FaultInjector` in front): jobs of 8
sets (valid, and with two swapped signatures) give the CPU oracle's
verdicts, each one replay of the class-8 graph; with one host cut, a
gossip job fails over to the other and is still right; every Fp kernel
is launched by those replays and none eagerly, and no graph is captured
while the client serves.

Tolerance: none (equal bools, equal counts). Every test carries the
`cuda` marker and skips where `torch.cuda.is_available()` is false. The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_offload_client_cuda.py -q
"""

import asyncio
import dataclasses
import time

import pytest
import torch

from lodestar_tpu_torch import graphs
from lodestar_tpu_torch.chain.bls import VerifySignatureOpts
from lodestar_tpu_torch.chain.bls.mesh import build_device_mesh, mesh_launch
from lodestar_tpu_torch.crypto.bls.api import verify_signature_sets as oracle
from lodestar_tpu_torch.models import batch_verify as bv
from lodestar_tpu_torch.offload import server as osrv
from lodestar_tpu_torch.offload.client import BlsOffloadClient
from lodestar_tpu_torch.ops import fp_cuda
from lodestar_tpu_torch.scheduler import PriorityClass
from lodestar_tpu_torch.testing import FaultInjector


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the offload client's hosts serve a CUDA mesh")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def mesh(cuda_device):
    prev = bv.configure_single_launch()
    bv.configure_single_launch("on")
    mesh = build_device_mesh("auto")
    bv.warm_single_launch([8], device=cuda_device)
    yield mesh
    bv.configure_single_launch(prev)


@pytest.mark.cuda
def test_client_over_two_cuda_hosts(cuda_device, mesh):
    def backend(sets):
        ok, _lane = mesh_launch(mesh, sets)
        return ok

    servers = {t: osrv.BlsOffloadServer(backend, tenant_slots=1, chip_status_fn=mesh.chip_table)
               for t in ("card-a", "card-b")}
    inj = FaultInjector()
    client = BlsOffloadClient(list(servers), tenant="a", probe_interval_s=3600.0,
                              transport_wrapper=osrv.local_transports(servers,
                                                                      wrap=inj.wrap_transport))
    deadline = time.monotonic() + 30.0  # the startup probe: tenant frames from then on
    while not all(s["tenant_capable"] for s in client.endpoint_states()):
        assert time.monotonic() < deadline, client.endpoint_states()
        time.sleep(0.01)
    sets = bv.make_synthetic_sets(8, seed=41)
    swapped = list(sets)
    swapped[0] = dataclasses.replace(sets[0], signature=sets[1].signature)
    swapped[1] = dataclasses.replace(sets[1], signature=sets[0].signature)
    want = [oracle(sets), oracle(swapped)]
    assert want == [True, False]
    cache = bv._SINGLE_LAUNCH_GRAPHS
    captures = cache.captures
    replays = cache.graphs[(cuda_device.index, 8)].replays
    fp_cuda.reset_launches()
    graphs.reset_replayed()
    try:
        async def go():
            api = VerifySignatureOpts(priority=PriorityClass.API)
            gossip = VerifySignatureOpts(priority=PriorityClass.GOSSIP_ATTESTATION)
            got = [await client.verify_signature_sets(sets, api),
                   await client.verify_signature_sets(swapped, api)]
            inj.partition("card-a")
            got += [await client.verify_signature_sets(sets, gossip),
                    await client.verify_signature_sets(swapped, gossip)]
            return got

        assert asyncio.run(go()) == want + want
    finally:
        asyncio.run(client.close())
        for srv in servers.values():
            srv.stop()
    assert cache.captures == captures, "a graph was captured while the client served"
    assert cache.graphs[(cuda_device.index, 8)].replays == replays + 4
    assert all(graphs.REPLAYED[k] > 0 for k in fp_cuda.KERNELS), graphs.REPLAYED
    assert not any(fp_cuda.LAUNCHES.values()), fp_cuda.LAUNCHES
    assert inj.calls_to("card-b", "verify") >= 2  # the cut host's jobs failed over
    assert sum(s.tenancy.served.get("a", 0) for s in servers.values()) == 4
    lane = mesh.lanes[0]
    assert lane.breaker.state().name == "CLOSED" and lane.breaker._failures == 0
