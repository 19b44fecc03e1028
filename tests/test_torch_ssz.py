"""The port's SSZ layer (`lodestar_tpu_torch.ssz`, `.params`, `.types`) held
against the JAX package's on the CPU.

Tolerance: none (equal bytes). For every fork and both presets the
container schemas are equal field by field (names, types, lengths and
limits); a BeaconState made and serialized by the JAX package deserializes
into the port's type and serializes back to the same bytes, every field
equal; `merkleize`, `mix_in_length`, `ZERO_HASHES`, `pack_basic_chunks` and
`batch_container_roots` give the JAX package's bytes on numpy-seeded data.
The port hashes on the CPU device (`configure_device_htr(device="cpu")`);
the JAX side stays on its host hasher except for one 2,500-pair level.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lodestar_tpu import params as jparams
from lodestar_tpu import ssz as jssz
from lodestar_tpu.ssz import batch as jbatch
from lodestar_tpu.ssz import device_htr as jdh
from lodestar_tpu.types import ssz_types as jssz_types
from lodestar_tpu_torch import params, ssz
from lodestar_tpu_torch.ssz import batch
from lodestar_tpu_torch.ssz import device_htr as dh
from lodestar_tpu_torch.types import ssz_types

FORKS = ("phase0", "altair", "bellatrix", "capella", "deneb")
PRESETS = ("mainnet", "minimal")


@pytest.fixture(scope="module", autouse=True)
def _cpu_htr():
    """The port hashes on the CPU on one ATen thread; the JAX package's HTR
    mode is off, so its levels stay on its host hasher."""
    prev_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev_dev = dh._htr_device
    prev = dh.configure_device_htr(device="cpu")
    prev_j = jdh.configure_device_htr(mode="off")
    yield
    jdh.configure_device_htr(mode=prev_j)
    dh.configure_device_htr(mode=prev, device=prev_dev)
    torch.set_num_threads(prev_threads)


def describe(t):
    """A type descriptor as plain data: class, lengths, limits, fields."""
    name = type(t).__name__
    if name == "Container":
        return ("Container", t.name, tuple((f, describe(ft)) for f, ft in t.fields))
    attrs = sorted((k, describe(v) if hasattr(v, "is_fixed_size") else v)
                   for k, v in vars(t).items())
    return (name, tuple(attrs))


def containers(ns):
    """{dotted name: Container} of a types namespace, forks included."""
    out = {}
    for k, v in vars(ns).items():
        if isinstance(v, SimpleNamespace):
            out.update({f"{k}.{kk}": vv for kk, vv in containers(v).items()})
        elif type(v).__name__ == "Container":
            out[k] = v
    return out


def test_presets_equal():
    for name in PRESETS:
        assert dataclasses.asdict(params.PRESETS[name]) == dataclasses.asdict(jparams.PRESETS[name])
    assert params.FAR_FUTURE_EPOCH == jparams.FAR_FUTURE_EPOCH
    assert params.DOMAIN_BEACON_ATTESTER == jparams.DOMAIN_BEACON_ATTESTER


@pytest.mark.parametrize("preset", PRESETS)
def test_schemas_equal(preset):
    ours = containers(ssz_types(params.PRESETS[preset]))
    theirs = containers(jssz_types(jparams.PRESETS[preset]))
    assert ours.keys() == theirs.keys()
    assert {f"{fork}.BeaconState" for fork in FORKS} <= ours.keys()
    for name in ours:
        assert describe(ours[name]) == describe(theirs[name]), name


def plain(v):
    """An SSZ value as plain Python data (containers as field dicts)."""
    if hasattr(v, "_type"):
        return {n: plain(getattr(v, n)) for n in v._type._field_names}
    if isinstance(v, list):
        return [plain(x) for x in v]
    return v


def _jax_state(preset, fork, n=12):
    t = jssz_types(jparams.PRESETS[preset])
    state = getattr(t, fork).BeaconState.default()
    vs = []
    for i in range(n):
        v = t.Validator.default()
        v.pubkey = bytes([i % 251, (i * 7) % 251]) * 24
        v.withdrawal_credentials = bytes([i % 13]) * 32
        v.effective_balance = 32_000_000_000 - i
        v.activation_epoch = i
        v.exit_epoch = 2**64 - 1
        v.slashed = bool(i % 3 == 0)
        vs.append(v)
    state.validators = vs
    state.balances = [32_000_000_000 + i for i in range(n)]
    state.slot = 100 + n
    state.genesis_time = 1_600_000_000
    state.randao_mixes[3] = b"\x33" * 32
    state.justification_bits = [True, False, True, False]
    ed = t.Eth1Data.default()
    ed.deposit_count = 9
    state.eth1_data_votes = [ed]
    if fork == "phase0":
        att = t.PendingAttestation.default()
        att.aggregation_bits = [True, False, True]
        att.inclusion_delay = 2
        state.previous_epoch_attestations = [att]
    else:
        state.previous_epoch_participation = [1] * n
        state.current_epoch_participation = [i % 8 for i in range(n)]
        state.inactivity_scores = [i for i in range(n)]
    return state


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("fork", FORKS)
def test_beacon_state_bytes_round_trip(preset, fork):
    jstate = _jax_state(preset, fork)
    blob = jstate.type.serialize(jstate)
    ptype = getattr(ssz_types(params.PRESETS[preset]), fork).BeaconState
    state = ptype.deserialize(blob)
    assert ptype.serialize(state) == blob
    for (name, ft), (jname, jft) in zip(ptype.fields, jstate.type.fields):
        assert name == jname
        assert ft.serialize(getattr(state, name)) == jft.serialize(getattr(jstate, name)), name
        assert plain(getattr(state, name)) == plain(getattr(jstate, name)), name
    if preset == "minimal":
        assert ptype.hash_tree_root(state) == jstate.type.hash_tree_root(jstate)


@pytest.mark.parametrize("count,limit", [(0, None), (0, 8), (1, None), (3, None), (5, 64),
                                         (8, None), (13, 2**40), (5000, None)])
def test_merkleize_equal(count, limit):
    chunks = np.random.default_rng(count).integers(0, 256, size=(count, 32), dtype=np.uint8)
    assert ssz.merkleize(chunks, limit=limit) == jssz.merkleize(chunks, limit=limit)
    assert ssz.merkleize(chunks.tobytes(), limit=limit) == jssz.merkleize(chunks, limit=limit)


def test_merkle_helpers_equal():
    root = bytes(range(32))
    for length in (0, 1, 2**32 + 5):
        assert ssz.mix_in_length(root, length) == jssz.mix_in_length(root, length)
    assert ssz.ZERO_HASHES == jssz.ZERO_HASHES
    chunks = np.random.default_rng(9).integers(0, 256, size=(11, 32), dtype=np.uint8)
    for i in (0, 6, 10):
        proof = ssz.merkle_branch(chunks, i, limit=16)
        assert proof == jssz.merkle_branch(chunks, i, limit=16)
        assert ssz.verify_merkle_branch(chunks[i].tobytes(), proof, i, ssz.merkleize(chunks, 16))
    for elem, vals in ((ssz.uint64, [3, 2**64 - 1, 0, 7]), (ssz.uint8, list(range(70))),
                       (ssz.boolean, [True, False, True])):
        jelem = getattr(jssz, {1: "uint8", 8: "uint64"}.get(getattr(elem, "byte_len", 0),
                                                                "boolean"))
        assert np.array_equal(batch.pack_basic_chunks(elem, vals),
                              jbatch.pack_basic_chunks(jelem, vals))


@pytest.mark.parametrize("mode", ["off", "on"])
def test_batch_container_roots_equal(mode):
    """Validator roots of the port (device levels on the CPU device in mode
    "on", every level on it) against the JAX package's host roots."""
    p, jp = params.PRESETS["minimal"], jparams.PRESETS["minimal"]
    t, jt = ssz_types(p), jssz_types(jp)
    rng = np.random.default_rng(21)
    jvals = []
    for i in range(33):
        v = jt.Validator.default()
        v.pubkey = bytes(rng.integers(0, 256, size=48, dtype=np.uint8))
        v.withdrawal_credentials = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
        v.effective_balance = int(rng.integers(0, 2**40))
        v.slashed = bool(i % 2)
        v.exit_epoch = 2**64 - 1 - i
        jvals.append(v)
    vals = [t.Validator.deserialize(jt.Validator.serialize(v)) for v in jvals]
    prev = dh.configure_device_htr(mode=mode)
    prev_min = dh.DEVICE_MIN_FLUSH_PAIRS
    dh.DEVICE_MIN_FLUSH_PAIRS = 1
    launches = dh.launch_count()
    try:
        got = batch.batch_container_roots(t.Validator, vals)
    finally:
        dh.DEVICE_MIN_FLUSH_PAIRS = prev_min
        dh.configure_device_htr(mode=prev)
    # mode on: the pubkey's level and the container's 3 levels, one launch each
    assert dh.launch_count() - launches == (4 if mode == "on" else 0)
    want = jbatch.batch_container_roots(jt.Validator, jvals)
    assert np.array_equal(got, want)
    assert got[5].tobytes() == t.Validator.hash_tree_root(vals[5])
