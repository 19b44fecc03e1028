"""The port's departure in `get_block_signature_sets` (ROADMAP Queue 3): as
Lodestar's `getBlockSignatureSets` does, the port's block sets hold, from
Altair on, the sync aggregate's set when it has a participant, and from
Capella on one set per BLS-to-execution change. The JAX package builds
neither, and both packages' `BeaconChain` verify a block through its sets
beside a transition run with `verify_signatures=False`: so the JAX chain
imports a block whose sync aggregate or BLS change is forged, and the
port's chain rejects it.

Tolerance: none. Minimal preset. Shown with blocks that the JAX package
builds (an Altair chain of 16 validators, the JAX test's `_altair_block`,
real sync aggregates) and with a Capella block carrying one BLS-to-execution
change (64 validators, capella at epoch 1, built on the port's host road by
`chip_smoke.py`'s block-building steps), each carried into the other package as SSZ
bytes:

* a forged block (one byte of its sync-aggregate signature changed, or its
  aggregate signed over another root, or its BLS change's signature made by
  another key; the proposer's signature made anew) imports in the JAX
  `BeaconChain` on `BlsSingleThreadVerifier`, and the port's chain rejects
  it `INVALID_SIGNATURES` on its oracle verifier and on
  `BlsDeviceVerifierPool(device="cpu")`, with its head unchanged;
* the valid block gives the same head and post-state root in both packages;
* the port's set list for it is the JAX list plus the sync-committee set,
  then the BLS change's set, last, each equal to the set the spec's check
  verifies; a block whose aggregate has no participant adds no set.

And the repair of an empty sync aggregate whose signature is not the point
at infinity (Lodestar's "Empty sync committee signature is not infinity"):
the JAX transition with `verify_signatures=True` refuses the block, the
JAX `BeaconChain` imports it, and the port's chain rejects it
INVALID_SIGNATURES, storing nothing.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import importlib

import pytest

from .test_torch_chain import ROOTS
from .test_torch_chain import minimal_cpu  # noqa: F401 - the minimal preset in both packages
from .test_torch_light_client import chain_bytes, pkg

J, T = ROOTS
N_CAPELLA = 64
CHANGE_VALIDATOR = 5


def _resign(P, signed, sks, state):
    """`signed` with its proposer's signature made anew over its message."""
    util = importlib.import_module(f"{P.root}.state_transition.util")
    api = importlib.import_module(f"{P.root}.crypto.bls.api")
    out = signed.copy()
    domain = util.get_domain(state, P.params.DOMAIN_BEACON_PROPOSER)
    out.signature = api.sign(sks[int(signed.message.proposer_index)],
                             util.compute_signing_root(signed.message.type, signed.message, domain))
    return out


@functools.lru_cache(maxsize=None)
def altair_blocks():
    """(genesis bytes, valid block 1, forged blocks 1) of the JAX Altair chain:
    the forgeries one signature byte changed, and signed over another root,
    each with its state root and proposer signature made anew."""
    from lodestar_tpu.crypto.bls import api as bls
    from lodestar_tpu.state_transition import EpochContext, process_block, process_slots
    from lodestar_tpu.state_transition.genesis import interop_secret_keys

    j = pkg(J)
    gbytes, bbytes = chain_bytes()
    genesis = j.t.altair.BeaconState.deserialize(gbytes)
    work = genesis.copy()
    process_slots(work, 1, j.p, j.cfg())
    sks = interop_secret_keys(16)
    valid = j.t.altair.SignedBeaconBlock.deserialize(bbytes[0])
    byte = valid.copy()
    sig = bytearray(bytes(byte.message.body.sync_aggregate.sync_committee_signature))
    sig[40] ^= 0x01
    byte.message.body.sync_aggregate.sync_committee_signature = bytes(sig)
    root = valid.copy()
    members = [sks[i] for i, pk in enumerate(genesis.validators)
               for k in work.current_sync_committee.pubkeys if bytes(k) == bytes(pk.pubkey)]
    wrong = hashlib.sha256(b"another root").digest()
    root.message.body.sync_aggregate.sync_committee_signature = bls.aggregate_signatures(
        [bls.sign(sk, wrong) for sk in members])
    for b in (byte, root):  # the body root is in the post-state's latest block header
        post = work.copy()
        process_block(post, b.message, EpochContext(post, j.p), verify_signatures=False)
        b.message.state_root = post.type.hash_tree_root(post)
    forged = {name: _resign(j, b, sks, work) for name, b in (("byte", byte), ("root", root))}
    return gbytes, bbytes[0], {k: v.type.serialize(v) for k, v in forged.items()}


@functools.lru_cache(maxsize=None)
def capella_blocks():
    """(genesis bytes, the valid slot-9 Capella block with one BLS change,
    the same block with the change signed by another key), built on the
    port's host road (`chip_smoke.build_block`'s steps)."""
    import chip_smoke
    from lodestar_tpu_torch import config, params
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.state_transition import (
        EpochContext,
        process_block,
        process_slots,
        state_hash_tree_root,
    )
    from lodestar_tpu_torch.state_transition.genesis import (
        create_interop_genesis_state,
        interop_secret_keys,
    )
    from lodestar_tpu_torch.state_transition.util import compute_signing_root

    t, p = pkg(T).t, params.MINIMAL
    cfg = chip_smoke.block_chain_config()
    sks = interop_secret_keys(N_CAPELLA)
    out = []
    with chip_smoke.host_only_htr():
        genesis = create_interop_genesis_state(N_CAPELLA, p=p,
                                               genesis_fork_version=cfg.GENESIS_FORK_VERSION)
        for signer in (CHANGE_VALIDATOR, CHANGE_VALIDATOR + 1):
            work = genesis.copy()
            ctx = process_slots(work, 9, p, cfg)
            block = chip_smoke.unsigned_block(work, ctx, sks, p, 9, attest_from=9)
            change = t.SignedBLSToExecutionChange.default()
            change.message.validator_index = CHANGE_VALIDATOR
            change.message.from_bls_pubkey = bytes(genesis.validators[CHANGE_VALIDATOR].pubkey)
            change.message.to_execution_address = b"\x11" * 20
            domain = config.compute_domain(params.DOMAIN_BLS_TO_EXECUTION_CHANGE,
                                           cfg.GENESIS_FORK_VERSION,
                                           bytes(genesis.genesis_validators_root))
            change.signature = bls.sign(sks[signer], compute_signing_root(
                t.BLSToExecutionChange, change.message, domain))
            block.body.bls_to_execution_changes = [change]
            post = work.copy()
            process_block(post, block, EpochContext(post, p), verify_signatures=False, cfg=cfg)
            block.state_root = state_hash_tree_root(post)
            signed = chip_smoke.sign_block(block, sks[block.proposer_index], work, p)
            out.append(signed.type.serialize(signed))
    return genesis.type.serialize(genesis), out[0], out[1]


def _capella_cfg(P):
    return P.config.mainnet_chain_config().replace(ALTAIR_FORK_EPOCH=1, BELLATRIX_FORK_EPOCH=1,
                                                   CAPELLA_FORK_EPOCH=1)


def _import(P, fork, gbytes, blocks, verifier, cfg, slot):
    """Each block (bytes) through a fresh chain of `P` on `verifier`, in
    order: per block "imported" or the reject's code, then the head root and
    the head state's root."""
    ns = getattr(P.t, fork)
    genesis = P.t.phase0.BeaconState.deserialize(gbytes) if fork == "capella" else \
        ns.BeaconState.deserialize(gbytes)
    chain = P.chain.BeaconChain(anchor_state=genesis, bls_verifier=verifier,
                                db=P.db.MemoryDbController(), cfg=cfg, current_slot=slot)

    async def go():
        out = []
        for raw in blocks:
            try:
                await chain.process_block(ns.SignedBeaconBlock.deserialize(raw))
                out.append("imported")
            except P.chain.BlockError as e:
                out.append(e.code)
        if hasattr(verifier, "close"):
            await verifier.close()
        head = chain.get_head_state()
        return out, chain.head_root, head.type.hash_tree_root(head)

    return asyncio.run(go())


def _verifiers(P, pool):
    if P.root == J:
        return [P.bls.BlsSingleThreadVerifier()]
    if pool:
        from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool

        return [P.bls.BlsSingleThreadVerifier(), BlsDeviceVerifierPool(device="cpu")]
    return [P.bls.BlsSingleThreadVerifier()]


@pytest.mark.parametrize("forgery", ["byte", "root"])
def test_forged_sync_aggregate_imports_in_jax_and_is_rejected_by_the_port(forgery):
    gbytes, valid, forged = altair_blocks()
    j, t = pkg(J), pkg(T)
    jax_out = _import(j, "altair", gbytes, [forged[forgery], valid], j.bls.BlsSingleThreadVerifier(),
                      j.cfg(), 1)
    assert jax_out[0] == ["imported", "imported"]  # the JAX chain never checks the aggregate
    for verifier in _verifiers(t, pool=forgery == "root"):
        got = _import(t, "altair", gbytes, [forged[forgery], valid], verifier, t.cfg(), 1)
        assert got[0] == ["INVALID_SIGNATURES", "imported"]
        valid_only = _import(j, "altair", gbytes, [valid], j.bls.BlsSingleThreadVerifier(),
                             j.cfg(), 1)
        assert got[1:] == valid_only[1:]


def test_forged_bls_change_imports_in_jax_and_is_rejected_by_the_port():
    gbytes, valid, forged = capella_blocks()
    j, t = pkg(J), pkg(T)
    jax_forged = _import(j, "capella", gbytes, [forged], j.bls.BlsSingleThreadVerifier(),
                         _capella_cfg(j), 9)
    assert jax_forged[0] == ["imported"]
    port_forged = _import(t, "capella", gbytes, [forged], t.bls.BlsSingleThreadVerifier(),
                          _capella_cfg(t), 9)
    assert port_forged[0] == ["INVALID_SIGNATURES"]
    want = _import(j, "capella", gbytes, [valid], j.bls.BlsSingleThreadVerifier(),
                   _capella_cfg(j), 9)
    got = _import(t, "capella", gbytes, [valid], t.bls.BlsSingleThreadVerifier(),
                  _capella_cfg(t), 9)
    assert got == want and got[0] == ["imported"]


def _sets(P, fork, gbytes, raw, slot, cfg):
    st = importlib.import_module(f"{P.root}.state_transition")
    ss = importlib.import_module(f"{P.root}.state_transition.signature_sets")
    ns = getattr(P.t, fork)
    state = (P.t.phase0 if fork == "capella" else ns).BeaconState.deserialize(gbytes)
    ctx = st.process_slots(state, slot, P.p, cfg)
    signed = ns.SignedBeaconBlock.deserialize(raw)
    kw = {"cfg": cfg} if P.root == T else {}
    return state, signed, [(bytes(s.pubkey), bytes(s.message), bytes(s.signature))
                           for s in ss.get_block_signature_sets(state, signed, ctx, **kw)]


def test_the_ports_sets_are_the_jax_sets_plus_the_new_ones_last():
    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.state_transition.util import get_block_root_at_slot, get_domain

    j, t = pkg(J), pkg(T)
    gbytes, valid, _ = altair_blocks()
    _, _, jsets = _sets(j, "altair", gbytes, valid, 1, j.cfg())
    state, signed, tsets = _sets(t, "altair", gbytes, valid, 1, t.cfg())
    assert tsets[:-1] == jsets and len(tsets) == len(jsets) + 1 == 3
    agg = signed.message.body.sync_aggregate
    members = [bytes(k) for k, b in zip(state.current_sync_committee.pubkeys,
                                        agg.sync_committee_bits) if b]
    domain = get_domain(state, params.DOMAIN_SYNC_COMMITTEE, 0)
    assert tsets[-1] == (bls.aggregate_pubkeys(members),
                         hashlib.sha256(get_block_root_at_slot(state, 0, t.p) + domain).digest(),
                         bytes(agg.sync_committee_signature))
    assert bls.verify_signature_sets([bls.SignatureSet(*tsets[-1])])

    gbytes, valid, forged = capella_blocks()
    _, _, jsets = _sets(j, "capella", gbytes, valid, 9, _capella_cfg(j))
    state, signed, tsets = _sets(t, "capella", gbytes, valid, 9, _capella_cfg(t))
    # the slot-9 block's aggregate is empty: no sync set; its one change last
    assert tsets[:-1] == jsets and len(tsets) == 3
    change = signed.message.body.bls_to_execution_changes[0]
    assert tsets[-1][0] == bytes(state.validators[CHANGE_VALIDATOR].pubkey)
    assert tsets[-1][2] == bytes(change.signature)
    assert bls.verify_signature_sets([bls.SignatureSet(*tsets[-1])])
    _, _, bad = _sets(t, "capella", gbytes, forged, 9, _capella_cfg(t))
    assert not bls.verify_signature_sets([bls.SignatureSet(*bad[-1])])


@functools.lru_cache(maxsize=None)
def empty_aggregate_block():
    """(genesis bytes, the JAX chain's valid slot-1 Altair block with its
    sync aggregate emptied and its signature left as it was: not infinity),
    state root and proposer signature made anew."""
    from lodestar_tpu.state_transition import EpochContext, process_block, process_slots
    from lodestar_tpu.state_transition.genesis import interop_secret_keys

    j = pkg(J)
    gbytes, bbytes = chain_bytes()
    work = j.t.altair.BeaconState.deserialize(gbytes)
    process_slots(work, 1, j.p, j.cfg())
    block = j.t.altair.SignedBeaconBlock.deserialize(bbytes[0])
    agg = block.message.body.sync_aggregate
    agg.sync_committee_bits = [False] * len(list(agg.sync_committee_bits))
    post = work.copy()
    process_block(post, block.message, EpochContext(post, j.p), verify_signatures=False)
    block.message.state_root = post.type.hash_tree_root(post)
    signed = _resign(j, block, interop_secret_keys(16), work)
    return gbytes, signed.type.serialize(signed)


def test_empty_sync_aggregate_not_infinity_is_rejected_by_the_port():
    from lodestar_tpu.crypto.bls.api import G2_INFINITY
    from lodestar_tpu.state_transition import (
        BlockProcessError,
        EpochContext,
        process_block,
        process_slots,
    )
    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool
    from lodestar_tpu_torch.state_transition import signature_sets as tss

    j, t = pkg(J), pkg(T)
    gbytes, raw = empty_aggregate_block()
    block = j.t.altair.SignedBeaconBlock.deserialize(raw)
    assert not any(block.message.body.sync_aggregate.sync_committee_bits)
    assert bytes(block.message.body.sync_aggregate.sync_committee_signature) != G2_INFINITY
    # the JAX transition refuses it when it checks signatures, and not without
    work = j.t.altair.BeaconState.deserialize(gbytes)
    process_slots(work, 1, j.p, j.cfg())
    with pytest.raises(BlockProcessError, match="sync aggregate"):
        process_block(work.copy(), block.message, EpochContext(work, j.p), verify_signatures=True)
    process_block(work.copy(), block.message, EpochContext(work, j.p), verify_signatures=False)
    # the JAX chain imports it (its transition runs without signatures)
    jax_out = _import(j, "altair", gbytes, [raw], j.bls.BlsSingleThreadVerifier(), j.cfg(), 1)
    assert jax_out[0] == ["imported"]
    # the port's set producer throws as Lodestar's does
    with pytest.raises(tss.SignatureSetError, match="Empty sync committee signature is not infinity"):
        _sets(t, "altair", gbytes, raw, 1, t.cfg())
    # the port's chain rejects it on its oracle and on the pool, head unmoved
    genesis_only = _import(t, "altair", gbytes, [], t.bls.BlsSingleThreadVerifier(), t.cfg(), 1)
    for verifier in (t.bls.BlsSingleThreadVerifier(), BlsDeviceVerifierPool(device="cpu")):
        got = _import(t, "altair", gbytes, [raw], verifier, t.cfg(), 1)
        assert got == (["INVALID_SIGNATURES"],) + genesis_only[1:]


def test_empty_sync_aggregate_with_infinity_adds_no_set():
    """The same empty aggregate with the infinity signature: no set, and the
    port's list is the JAX list."""
    from lodestar_tpu.crypto.bls.api import G2_INFINITY
    from lodestar_tpu.state_transition import process_slots
    from lodestar_tpu.state_transition.genesis import interop_secret_keys

    j, t = pkg(J), pkg(T)
    gbytes, raw = empty_aggregate_block()
    block = j.t.altair.SignedBeaconBlock.deserialize(raw)
    block.message.body.sync_aggregate.sync_committee_signature = G2_INFINITY
    work = j.t.altair.BeaconState.deserialize(gbytes)
    process_slots(work, 1, j.p, j.cfg())
    block = _resign(j, block, interop_secret_keys(16), work)
    raw = block.type.serialize(block)
    _, _, jsets = _sets(j, "altair", gbytes, raw, 1, j.cfg())
    _, _, tsets = _sets(t, "altair", gbytes, raw, 1, t.cfg())
    assert tsets == jsets and len(tsets) == 2
