"""The port's state hashTreeRoot (`lodestar_tpu_torch.state_transition.htr`)
against the JAX package's `state_hash_tree_root` on the CPU.

Tolerance: none (equal roots). States are made by the JAX package and
carried into the port through SSZ bytes (`Container.deserialize` of the
JAX type's `serialize`); after every round of numpy-seeded mutations the
port's incremental root (device levels run eagerly on the CPU device,
every level launched) equals the JAX package's root of the same bytes.
Also: the launch-count invariant, registry growth and shrink, `transient=`
and `drop_tracker`, and the port's departure from the reference: a device
or tracker error drops the tracker and raises, where the JAX package
serves its value path.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu import params as jparams
from lodestar_tpu.ssz import device_htr as jdh
from lodestar_tpu.state_transition.htr import state_hash_tree_root as jax_state_root
from lodestar_tpu.types import ssz_types as jssz_types
from lodestar_tpu_torch import params
from lodestar_tpu_torch.ssz import device_htr as dh
from lodestar_tpu_torch.state_transition import (
    StateRootTracker,
    drop_tracker,
    state_hash_tree_root,
)
from lodestar_tpu_torch.state_transition import htr as htr_mod
from lodestar_tpu_torch.types import ssz_types

FORKS = ("phase0", "altair", "bellatrix", "capella", "deneb")
P, JP = params.MINIMAL, jparams.MINIMAL


@pytest.fixture(scope="module", autouse=True)
def _cpu_setup():
    prev_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev_dev = dh._htr_device
    prev = dh.configure_device_htr(device="cpu")
    prev_j = jdh.configure_device_htr(mode="off")
    yield
    jdh.configure_device_htr(mode=prev_j)
    dh.configure_device_htr(mode=prev, device=prev_dev)
    torch.set_num_threads(prev_threads)


@pytest.fixture
def device_on():
    """Device hashing on (the CPU device) and the per-level floor at 1 pair,
    so minimal-preset state trees launch."""
    prev = dh.configure_device_htr(mode="on")
    prev_min = dh.DEVICE_MIN_FLUSH_PAIRS
    dh.DEVICE_MIN_FLUSH_PAIRS = 1
    yield
    dh.DEVICE_MIN_FLUSH_PAIRS = prev_min
    dh.configure_device_htr(mode=prev)


def _mk_validator(t, i):
    v = t.Validator.default()
    v.pubkey = bytes([i % 251, (i * 7) % 251]) * 24
    v.withdrawal_credentials = bytes([i % 13]) * 32
    v.effective_balance = 32_000_000_000
    v.activation_eligibility_epoch = i
    v.activation_epoch = i
    v.exit_epoch = 2**64 - 1
    v.withdrawable_epoch = 2**64 - 1
    return v


def _mk_state(fork, n=12):
    """A JAX-package state, carried into the port through its SSZ bytes."""
    t = jssz_types(JP)
    js = getattr(t, fork).BeaconState.default()
    js.validators = [_mk_validator(t, i) for i in range(n)]
    js.balances = [32_000_000_000 + i for i in range(n)]
    js.slot = 100
    js.genesis_time = 1_600_000_000
    if fork != "phase0":
        js.previous_epoch_participation = [1] * n
        js.current_epoch_participation = [3] * n
        js.inactivity_scores = [0] * n
    ptype = getattr(ssz_types(P), fork).BeaconState
    return ptype.deserialize(js.type.serialize(js))


def _jax_root(state, fork):
    """The JAX package's state_hash_tree_root of the port state's bytes."""
    jtype = getattr(jssz_types(JP), fork).BeaconState
    return jax_state_root(jtype.deserialize(state.type.serialize(state)))


def _mutate(state, t, rng, fork):
    """One random mutation of the shapes the transition performs (the
    reference test's `_mutate`)."""
    n = len(state.validators)
    op = int(rng.integers(0, 10))
    if op == 0:
        state.slot = int(state.slot) + 1
    elif op == 1:
        state.balances[int(rng.integers(0, n))] = int(rng.integers(0, 2**40))
    elif op == 2:
        state.balances = [int(x) for x in rng.integers(0, 2**40, size=n)]
    elif op == 3:
        v = state.validators[int(rng.integers(0, n))]
        v.effective_balance = int(rng.integers(0, 2**40))
        v.slashed = bool(rng.integers(0, 2))
    elif op == 4:
        idx = int(rng.integers(0, len(state.randao_mixes)))
        state.randao_mixes[idx] = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
    elif op == 5:
        idx = int(rng.integers(0, len(state.state_roots)))
        state.state_roots[idx] = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
    elif op == 6:
        state.validators.append(_mk_validator(t, int(rng.integers(0, 200))))
        state.balances.append(32_000_000_000)
        if fork != "phase0":
            state.previous_epoch_participation.append(0)
            state.current_epoch_participation.append(0)
            state.inactivity_scores.append(0)
    elif op == 7:
        cp = t.Checkpoint.default()
        cp.epoch = int(rng.integers(0, 1000))
        cp.root = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
        state.finalized_checkpoint = cp
    elif op == 8:
        ed = t.Eth1Data.default()
        ed.deposit_count = int(rng.integers(0, 1000))
        state.eth1_data_votes.append(ed)
    else:
        state.slashings[int(rng.integers(0, len(state.slashings)))] = int(rng.integers(0, 2**40))
        if fork != "phase0":
            state.current_epoch_participation[int(rng.integers(0, n))] = int(rng.integers(0, 8))


@pytest.mark.parametrize("fork", FORKS)
def test_mutation_fuzz_equals_the_jax_package(fork, device_on):
    t = ssz_types(P)
    rng = np.random.default_rng(FORKS.index(fork) + 70)
    state = _mk_state(fork)
    launches = dh.launch_count()
    for round_ in range(5):
        for _ in range(int(rng.integers(1, 6))):
            _mutate(state, t, np.random.default_rng(int(rng.integers(0, 2**31))), fork)
        assert state_hash_tree_root(state) == _jax_root(state, fork), (fork, round_)
    assert dh.launch_count() > launches
    assert htr_mod._TRACKER_KEY in state.__dict__


def test_launch_count_invariant(device_on):
    state = _mk_state("phase0")
    tracker = StateRootTracker(state.type)
    tracker.root(state)
    state.balances[2] = 7
    state.balances[9] = 8
    state.validators[1].effective_balance = 9
    state.randao_mixes[5] = b"\x42" * 32
    state.slot = 101
    before = dh.launch_count()
    root, stats = tracker.root(state)
    total = dh.launch_count() - before
    assert 0 < stats["launches"] <= stats["levels"]
    # the validator's re-rooting: 3 field levels and the pubkey's level
    assert total <= stats["levels"] + 4
    assert root == _jax_root(state, "phase0") == state.type.hash_tree_root(state)
    before = dh.launch_count()
    root2, stats2 = tracker.root(state)
    assert root2 == root
    assert stats2["launches"] == 0 and dh.launch_count() == before


def test_tracker_survives_registry_growth_and_shrink(device_on):
    t = ssz_types(P)
    state = _mk_state("phase0", n=7)
    assert state_hash_tree_root(state) == _jax_root(state, "phase0")
    # a DEFAULT validator serializes to zeros, like list padding: only the
    # forced-dirty length window finds it
    state.validators.append(t.Validator.default())
    state.balances.append(0)
    assert state_hash_tree_root(state) == _jax_root(state, "phase0")
    state.validators.append(_mk_validator(t, 77))  # 7 -> 9, past the pow2 boundary
    state.balances.append(1)
    assert state_hash_tree_root(state) == _jax_root(state, "phase0")
    ed = t.Eth1Data.default()
    ed.deposit_count = 5
    state.eth1_data_votes.append(ed)
    assert state_hash_tree_root(state) == _jax_root(state, "phase0")
    state.eth1_data_votes = []
    assert state_hash_tree_root(state) == _jax_root(state, "phase0")


def test_transient_root_builds_no_tracker(device_on):
    state = _mk_state("altair")
    expect = _jax_root(state, "altair")
    assert state_hash_tree_root(state, transient=True) == expect
    assert htr_mod._TRACKER_KEY not in state.__dict__
    state_hash_tree_root(state)
    assert htr_mod._TRACKER_KEY in state.__dict__
    state.slot = int(state.slot) + 1
    assert state_hash_tree_root(state, transient=True) == _jax_root(state, "altair")
    drop_tracker(state)
    assert htr_mod._TRACKER_KEY not in state.__dict__
    assert state_hash_tree_root(state) == _jax_root(state, "altair")


def test_off_mode_is_value_path():
    prev = dh.configure_device_htr(mode="off")
    try:
        state = _mk_state("capella")
        assert state_hash_tree_root(state) == _jax_root(state, "capella")
        assert htr_mod._TRACKER_KEY not in state.__dict__
    finally:
        dh.configure_device_htr(mode=prev)


def test_device_error_raises_and_drops_the_tracker(device_on, monkeypatch):
    state = _mk_state("altair")
    expect = _jax_root(state, "altair")
    state_hash_tree_root(state)
    state.balances[0] = 1

    def boom(data):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(dh, "_device_level", boom)
    with pytest.raises(RuntimeError, match="injected device fault"):
        state_hash_tree_root(state)
    assert htr_mod._TRACKER_KEY not in state.__dict__
    monkeypatch.undo()
    # the next root builds a fresh tracker from the values
    assert state_hash_tree_root(state) == _jax_root(state, "altair") != expect


def test_tracker_error_raises_and_drops_the_tracker(device_on, monkeypatch):
    """The JAX package serves the value path on a tracker error
    (`test_tracker_error_degrades_to_value_path`); the port re-raises."""
    state = _mk_state("phase0")
    state_hash_tree_root(state)

    def boom(self, s):
        raise RuntimeError("injected tracker bug")

    monkeypatch.setattr(StateRootTracker, "root", boom)
    with pytest.raises(RuntimeError, match="injected tracker bug"):
        state_hash_tree_root(state)
    assert htr_mod._TRACKER_KEY not in state.__dict__


def test_default_device_without_cuda_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    monkeypatch.setattr(dh, "_htr_device", torch.device("cuda"))
    monkeypatch.setattr(dh, "_htr_mode", "auto")
    monkeypatch.setattr(dh, "DEVICE_MIN_FLUSH_PAIRS", 1)
    state = _mk_state("capella")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state_hash_tree_root(state)
    assert htr_mod._TRACKER_KEY not in state.__dict__
