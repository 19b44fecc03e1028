"""The port's native host code (`lodestar_tpu_torch/native`): the C++ batch
SHA-256 pair hasher and the C++ host road of BLS input prep, held against
the JAX package's natives, `hashlib` and the port's pure-Python oracle.

* Both libraries build with g++ and load here (the container has g++):
  the port builds them into `native/_build/`, never beside the sources.
* The JAX package's own tests (`tests/native/test_sha256_batch.py`,
  `tests/native/test_bls_host.py`) run on the port with `port_copy`.
* `hash_pairs` is byte-equal to the JAX native's and to hashlib at 2 to
  10^5 pairs; `ssz.hash.hash_nodes_cpu` routes to it from 4 rows up, as
  `lodestar_tpu/ssz/hash.py` does.
* `prepare_sets_native` is limb-equal to the JAX native's and to the
  port's oracle (`prepare_sets_oracle`); both packages reject the same
  tampered, non-subgroup and infinity inputs; the port's `prepare_sets`
  takes the native road and fails fast on a set it rejects.

Tolerance: none (bytes and int32 limbs). Sizes: one size-8 batch per prep
comparison; seeded numpy inputs.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest
import torch

from .test_torch_utils_gaps import port_copy

torch.set_num_threads(1)

port_copy("tests.native.test_sha256_batch", globals())
port_copy("tests.native.test_bls_host", globals())


def _hashlib_pairs(data: np.ndarray) -> bytes:
    buf = data.tobytes()
    return b"".join(hashlib.sha256(buf[i * 64:(i + 1) * 64]).digest()
                    for i in range(data.shape[0] // 2))


def test_both_libraries_build_into_the_build_dir_and_load():
    from lodestar_tpu_torch import native
    from lodestar_tpu_torch.native import bls as nbls

    assert native.sha256_available() and native.sha256_backend() in ("shani", "scalar")
    assert nbls.available()
    assert native._SO.startswith(native.BUILD_DIR) and os.path.isfile(native._SO)
    assert nbls._SO.startswith(native.BUILD_DIR) and os.path.isfile(nbls._SO)
    assert os.path.basename(native.BUILD_DIR) == "_build"
    assert not [f for f in os.listdir(os.path.dirname(native.BUILD_DIR)) if f.endswith(".so")]


def test_warm_up_starts_one_thread_and_loads():
    from lodestar_tpu_torch.native import bls as nbls

    t = nbls.warm_up()
    assert nbls.warm_up() is t
    t.join(timeout=300)
    assert not t.is_alive() and nbls._lib is not None


@pytest.mark.parametrize("n", [2, 3, 17, 1000, 100_000])
def test_hash_pairs_equals_the_jax_native_and_hashlib(n):
    from lodestar_tpu import native as jnative
    from lodestar_tpu_torch import native

    data = np.random.default_rng(n).integers(0, 256, size=(2 * n, 32), dtype=np.uint8)
    got = native.hash_pairs(data).tobytes()
    assert got == jnative.hash_pairs(data).tobytes()
    if n <= 1000:
        assert got == _hashlib_pairs(data)
    else:  # a seeded sample of the rows against hashlib
        rows = np.random.default_rng(0).choice(n, size=512, replace=False)
        for i in rows:
            assert got[32 * i:32 * (i + 1)] == hashlib.sha256(data[2 * i:2 * i + 2].tobytes()).digest()


def test_hash_nodes_cpu_routes_to_native_from_four_rows(monkeypatch):
    from lodestar_tpu_torch.ssz import hash as ssz_hash

    calls = []
    real = ssz_hash._native()
    assert real is not None
    monkeypatch.setattr(ssz_hash, "_native_hash_pairs", lambda d: calls.append(len(d)) or real(d))
    rng = np.random.default_rng(3)
    for rows in (2, 4, 64):
        data = rng.integers(0, 256, size=(rows, 32), dtype=np.uint8)
        assert ssz_hash.hash_nodes_cpu(data).tobytes() == _hashlib_pairs(data)
        assert ssz_hash.hash_nodes_hashlib(data).tobytes() == _hashlib_pairs(data)
    assert calls == [4, 64]  # two rows (one pair) stay on hashlib, as in the JAX package


def _sets(n, seed):
    from lodestar_tpu_torch.models.batch_verify import make_synthetic_sets

    return make_synthetic_sets(n, seed=seed)


def _native_both(pks, msgs, sigs):
    from lodestar_tpu.native import bls as jn
    from lodestar_tpu_torch.native import bls as tn

    return tn.prepare_sets_native(pks, msgs, sigs), jn.prepare_sets_native(pks, msgs, sigs)


def _flat(prep):
    return [np.asarray(a) for pair in prep for a in pair]


def test_prepare_sets_native_is_limb_equal_to_the_jax_native_and_the_oracle():
    from lodestar_tpu_torch.models import batch_verify as bv

    sets = _sets(8, seed=11)
    raw = [(bytes(s.pubkey), bytes(s.message), bytes(s.signature)) for s in sets]
    got, jax = _native_both(*map(list, zip(*raw)))
    oracle = bv.prepare_sets_oracle(raw)
    for a, b, c in zip(_flat(got), _flat(jax), _flat(oracle)):
        assert a.dtype == np.int32 and a.shape == c.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for a, b in zip(_flat(bv.prepare_sets(sets)), _flat(got)):  # prepare_sets takes the native road
        np.testing.assert_array_equal(a, b)


def _tampered(sets):
    """Named batches of 8 that each package's native prep must reject."""
    from lodestar_tpu_torch.crypto.bls import curve as C
    from lodestar_tpu_torch.crypto.bls.api import G2_INFINITY
    from lodestar_tpu_torch.crypto.bls.serdes import g1_to_bytes, g2_to_bytes

    pks = [bytes(s.pubkey) for s in sets]
    msgs = [bytes(s.message) for s in sets]
    sigs = [bytes(s.signature) for s in sets]
    out = {}
    bad = bytearray(sigs[3])
    bad[5] ^= 0xFF
    out["signature byte"] = (pks, msgs, sigs[:3] + [bytes(bad)] + sigs[4:])
    bad = bytearray(pks[2])
    bad[-1] ^= 1
    out["pubkey byte"] = (pks[:2] + [bytes(bad)] + pks[3:], msgs, sigs)
    # a point on the curve outside the r-torsion subgroup (x = first x with
    # a y on E1, which has cofactor h1 > 1)
    x = 1
    while True:
        y2 = (pow(x, 3, C.P) + 4) % C.P
        y = pow(y2, (C.P + 1) // 4, C.P)
        if y * y % C.P == y2 and not C.g1_in_subgroup((x, y)):
            break
        x += 1
    out["pubkey off subgroup"] = (pks[:1] + [g1_to_bytes((x, y))] + pks[2:], msgs, sigs)
    out["pubkey infinity"] = (pks[:4] + [b"\xc0" + bytes(47)] + pks[5:], msgs, sigs)
    out["signature infinity"] = (pks, msgs, sigs[:6] + [G2_INFINITY] + sigs[7:])
    out["signature off subgroup"] = (pks, msgs, sigs[:7] + [g2_to_bytes(_g2_off_subgroup())])
    return out


def _g2_off_subgroup():
    """A point on the twist E2 outside the r-torsion subgroup (the first
    decodable x0 with x1 = 1)."""
    from lodestar_tpu_torch.crypto.bls import curve as C
    from lodestar_tpu_torch.crypto.bls.serdes import PointDecodeError, g2_from_bytes

    for x0 in range(1, 200):
        data = bytearray(96)
        data[0] = 0x80
        data[1:48] = (1).to_bytes(47, "big")  # x1 (c1) first in the encoding
        data[48:96] = x0.to_bytes(48, "big")
        try:
            pt = g2_from_bytes(bytes(data))
        except PointDecodeError:
            continue
        if pt is not None and not C.g2_in_subgroup(pt):
            return pt
    raise AssertionError("no off-subgroup twist point found")


def test_both_packages_reject_the_same_inputs():
    from lodestar_tpu.models import batch_verify as jbv
    from lodestar_tpu_torch.crypto.bls.api import SignatureSet
    from lodestar_tpu_torch.models import batch_verify as bv

    for name, (pks, msgs, sigs) in _tampered(_sets(8, seed=12)).items():
        got, jax = _native_both(pks, msgs, sigs)
        assert got is None and jax is None, name
        sets = [SignatureSet(pubkey=p, message=m, signature=s) for p, m, s in zip(pks, msgs, sigs)]
        assert bv.prepare_sets(sets) is None, name
        assert bv.prepare_sets_oracle([(p, m, s) for p, m, s in zip(pks, msgs, sigs)]) is None, name
        jsets = [jbv.SignatureSet(pubkey=p, message=m, signature=s) for p, m, s in zip(pks, msgs, sigs)]
        assert jbv.prepare_sets(jsets) is None, name


def test_prepare_sets_fails_fast_without_the_oracle(monkeypatch):
    """A set the loaded library rejects fails the batch at once: the oracle
    never runs (`lodestar_tpu/models/batch_verify.py:292-303`). A batch with
    a message that is not 32 bytes takes the oracle."""
    from lodestar_tpu_torch.crypto.bls.api import SignatureSet, sign
    from lodestar_tpu_torch.models import batch_verify as bv

    sets = _sets(8, seed=13)
    bad = bytearray(bytes(sets[0].signature))
    bad[9] ^= 0x40
    called = []
    real = bv.prepare_sets_oracle
    monkeypatch.setattr(bv, "prepare_sets_oracle", lambda raw: called.append(len(raw)) or real(raw))
    assert bv.prepare_sets([SignatureSet(sets[0].pubkey, sets[0].message, bytes(bad))] + sets[1:]) is None
    assert called == []
    from lodestar_tpu_torch.crypto.bls.api import SecretKey

    sk = SecretKey(7)
    long_msg = b"a message of forty bytes, not thirty-two"
    odd = [SignatureSet(sk.to_pubkey(), long_msg, sign(sk, long_msg))]
    assert bv.prepare_sets(odd) is not None and called == [1]
