"""The KZG graphs on a card: the MSM graph (class 4,096, a mainnet blob)
and the pairing-check graph (class 2) replayed against the same bodies run
eagerly on the card, and the eager MSM body on the card against its plain
version on CPU tensors.

Tolerance: none (equal limbs and bools). The replay and the eager body on
the card take a random 255-bit bit matrix over the 4,096 setup points; the
card-versus-CPU check runs the same 4,096 points on the first 8 columns
of that matrix (the plain version on the CPU costs ~3 s a column at 4,096
rows). A second commitment replays its graph without a capture, also
when it names the card by default (`device=None`). Every
test here carries the `cuda` marker and skips where
`torch.cuda.is_available()` is false. The file imports neither JAX nor
the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kzg_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.crypto import kzg as K
from lodestar_tpu_torch.crypto.bls import curve as C
from lodestar_tpu_torch.ops import fp, msm, pairing as prg, tower as tw


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs capture and replay only on a GPU")
    return torch.device("cuda", torch.cuda.current_device())


def _bits(seed, n=K.FIELD_ELEMENTS_PER_BLOB_MAINNET):
    r = np.random.default_rng(seed)
    scalars = [int.from_bytes(r.bytes(32), "little") % K.R for _ in range(n)]
    scalars[5] = 0  # an exact-zero infinity row
    return msm.bits_msb(scalars, K.SCALAR_BITS)


def _setup_on(dev):
    g1, _ = K.load_trusted_setup()
    return K._points_on(tuple(g1), dev, len(g1))


@pytest.mark.cuda
def test_msm_replay_equals_eager_body(cuda_device):
    xs, ys = _setup_on(cuda_device)
    bits = _bits(1)
    replayed = K._MSM_GRAPHS(cuda_device, xs, ys, bits)
    eager = msm.msm_g1_body(xs, ys, torch.from_numpy(bits).to(cuda_device))
    assert all(torch.equal(r, e.cpu()) for r, e in zip(replayed, eager))
    assert not all(int(torch.count_nonzero(c)) == 0 for c in replayed)


@pytest.mark.cuda
def test_eager_msm_body_on_card_equals_plain_version_on_cpu(cuda_device):
    xs, ys = _setup_on(cuda_device)
    bits = torch.from_numpy(np.ascontiguousarray(_bits(2)[:, :8]))
    on_card = msm.msm_g1_body(xs, ys, bits.to(cuda_device))
    on_cpu = msm.msm_g1_body(xs.cpu(), ys.cpu(), bits)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))


@pytest.mark.cuda
def test_pairing_check_replay_equals_eager(cuda_device):
    p = C.g1_mul(C.G1_GEN, 5)
    px = np.stack([fp.mont_limbs_from_int(q[0]) for q in (p, C.g1_neg(p))])
    py = np.stack([fp.mont_limbs_from_int(q[1]) for q in (p, C.g1_neg(p))])
    qx = np.stack([tw._fp2_mont_limbs_host(*C.G2_GEN[0])] * 2)
    qy = np.stack([tw._fp2_mont_limbs_host(*C.G2_GEN[1])] * 2)
    for mask, want in (([True, True], True), ([True, False], False)):
        m = np.asarray(mask)
        (replayed,) = K._PAIRING_GRAPHS(cuda_device, px, py, qx, qy, m)
        verdicts = [bool(replayed)]
        for dev in (cuda_device, "cpu"):
            t = [torch.from_numpy(a).to(dev) for a in (px, py, qx, qy, m)]
            verdicts.append(bool(prg.multi_pairing_is_one((t[0], t[1]), (t[2], t[3]), mask=t[4])))
        assert verdicts == [want] * 3


@pytest.mark.cuda
def test_second_commitment_replays_without_capture(cuda_device):
    c = 0x1234567
    const = c.to_bytes(32, "little") * K.FIELD_ELEMENTS_PER_BLOB_MAINNET
    want = K.g1_to_bytes(C.g1_mul(C.G1_GEN, c))
    assert K.blob_to_kzg_commitment(const, device=cuda_device) == want
    g = K._MSM_GRAPHS.graphs[(cuda_device.index, K.FIELD_ELEMENTS_PER_BLOB_MAINNET)]
    captures, replays = K._MSM_GRAPHS.captures, g.replays
    assert K.blob_to_kzg_commitment(const, device=cuda_device) == want
    assert K._MSM_GRAPHS.captures == captures and g.replays == replays + 1
    # the default device names the same card: the same graph and setup tensors
    with torch.cuda.device(cuda_device):
        assert K.blob_to_kzg_commitment(const) == want
    assert K._MSM_GRAPHS.captures == captures and g.replays == replays + 2
    assert K.verify_kzg_proof(want, 99, c, K.G1_INFINITY_BYTES, device=cuda_device)
    assert not K.verify_kzg_proof(want, 99, c + 1, K.G1_INFINITY_BYTES, device=cuda_device)
