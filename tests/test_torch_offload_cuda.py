"""The port's offload host on a card, as its entry point builds it.

`build_server(["--bls-mesh", "auto", ...])` serves the CUDA mesh after
capturing every size class the pool launches (8-1,024). Through the
in-process seam (`LocalStub`): one frame of 8 valid sets verifies True and
one with two swapped signatures False, each one replay of the class-8
graph, every Fp kernel launched by those replays and none eagerly, and no
graph captured after `build_server`'s warm-up.

Tolerance: none (equal bools, equal counts). Every test carries the
`cuda` marker and skips where `torch.cuda.is_available()` is false. The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_offload_cuda.py -q
"""

import dataclasses

import pytest
import torch

from lodestar_tpu_torch import graphs
from lodestar_tpu_torch.chain.bls.pool import POOL_SIZE_CLASSES
from lodestar_tpu_torch.models import batch_verify as bv
from lodestar_tpu_torch.offload import decode_status, decode_verdict, encode_sets
from lodestar_tpu_torch.offload import server as osrv
from lodestar_tpu_torch.ops import fp_cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the offload host's mesh runs only on a GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def server(cuda_device):
    prev = bv.configure_single_launch()
    srv = osrv.build_server(["--bls-mesh", "auto", "--workers", "2", "--tenant-slots", "1"])
    yield srv
    srv.stop()
    bv.configure_single_launch(prev)


@pytest.mark.cuda
def test_frames_of_8_through_the_cuda_mesh(cuda_device, server):
    cache = bv._SINGLE_LAUNCH_GRAPHS
    assert len(server.mesh) == torch.cuda.device_count()
    assert all((cuda_device.index, c) in cache.graphs for c in POOL_SIZE_CLASSES)
    st = decode_status(server._status(b"", None))
    assert st.can_accept and st.tenant_capable and len(st.chips) == len(server.mesh)
    sets = bv.make_synthetic_sets(8, seed=41)
    swapped = list(sets)
    swapped[0] = dataclasses.replace(sets[0], signature=sets[1].signature)
    swapped[1] = dataclasses.replace(sets[1], signature=sets[0].signature)
    captures = cache.captures
    replays = cache.graphs[(cuda_device.index, 8)].replays
    fp_cuda.reset_launches()
    graphs.reset_replayed()
    stub = osrv.local_transports({"card": server})("card", "verify", None)
    for batch, want in ((sets, True), (swapped, False)):
        frame = encode_sets(batch, tenant="a")
        assert decode_verdict(stub(frame), request=frame) is want
    assert cache.captures == captures, "a graph was captured while serving"
    assert cache.graphs[(cuda_device.index, 8)].replays == replays + 2
    assert all(graphs.REPLAYED[k] > 0 for k in fp_cuda.KERNELS), graphs.REPLAYED
    assert not any(fp_cuda.LAUNCHES.values()), fp_cuda.LAUNCHES
    lane = server.mesh.lanes[0]
    assert lane.breaker.state().name == "CLOSED" and lane.breaker._failures == 0
    assert server.tenancy.served == {"a": 2}
