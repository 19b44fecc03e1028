"""The port's fork state transitions (`lodestar_tpu_torch.state_transition`
`altair`, `bellatrix`, `capella`, `deneb`, the scheduled upgrades of
`process_slots`, and `config`) against the JAX package's, minimal preset.

Tolerance: none. Each scenario of the JAX package's
`tests/state_transition/test_{altair,execution_forks}.py` runs through both
packages (`Pkg` of `test_torch_state_transition.py`) with equal
observations: states and blocks as SSZ bytes, rejects as exception class
and message, signature sets field for field. The chains start from the JAX
package's interop genesis carried into the port as SSZ bytes and upgrade
through altair, bellatrix, capella and deneb at epoch 1. Also the port's
`config` against the JAX package's (fork schedules, domains, digests), and
a phase0 block's signature sets through the port's
`verify_signature_sets_device(..., device="cpu")` (one size-8 batch)
against the JAX package's `device_batch_verify` on the same blinding bits.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from .test_torch_state_transition import (  # noqa: F401 - minimal_cpu is autouse
    N_VALIDATORS,
    ROOTS,
    attested_block,
    both,
    genesis_bytes,
    minimal_cpu,
    observed,
    pkg,
    secret_keys,
)

N = 16
FAR = 2**64 - 1
ORDER = ("altair", "bellatrix", "capella", "deneb")


def chain_config(pk, **fork_epochs):
    base = dict(ALTAIR_FORK_EPOCH=FAR, BELLATRIX_FORK_EPOCH=FAR, CAPELLA_FORK_EPOCH=FAR,
                DENEB_FORK_EPOCH=FAR)
    base.update(fork_epochs)
    return pk.config.minimal_chain_config().replace(**base)


def state_at_fork(pk, fork):
    """Genesis advanced across epoch 1 with every upgrade up to `fork`
    scheduled there (the upgrades chain)."""
    epochs = {f"{f.upper()}_FORK_EPOCH": 1 for f in ORDER[: ORDER.index(fork) + 1]}
    cfg = chain_config(pk, **epochs)
    state = pk.state(genesis_bytes(N, cfg.GENESIS_FORK_VERSION))
    pk.st.process_slots(state, pk.p.SLOTS_PER_EPOCH, pk.p, cfg)
    return state, cfg


# --- config -------------------------------------------------------------------


def scenario_config(pk, obs):
    gvr = b"\x42" * 32
    for name in ("mainnet", "minimal", "gnosis", "goerli", "sepolia"):
        cfg = pk.config.NETWORKS[name]()
        obs.add(f"{name} chain", repr(cfg))
        bc = pk.config.create_beacon_config(cfg, gvr)
        obs.add(f"{name} forks", repr(bc.forks))
        for epoch in (0, 1, 50, 74240, 144896, 194048, FAR):
            obs.add(f"{name} fork at {epoch}", (bc.fork_name_at_epoch(epoch),
                                                pk.config.fork_name_at_epoch(cfg, epoch)))
            obs.add(f"{name} domain at {epoch}", bc.get_domain(b"\x00\x00\x00\x00", epoch))
        for fork in ("phase0",) + ORDER:
            obs.add(f"{name} digest {fork}", bc.fork_digest(fork))
    obs.add("fork data root", pk.config.compute_fork_data_root(b"\x01\x02\x03\x04", gvr))
    obs.add("domain", pk.config.compute_domain(b"\x07\x00\x00\x00", b"\x01\x00\x00\x00", gvr))
    obs.add("signing root", pk.config.compute_signing_root(pk.ssz.uint64, 5, b"\x09" * 32))


def test_config_matches():
    both(scenario_config)
    assert set(pkg(ROOTS[1]).config.__all__) == set(pkg(ROOTS[0]).config.__all__)


# --- altair -------------------------------------------------------------------


def scenario_scheduled_altair_upgrade(pk, obs):
    cfg = chain_config(pk, ALTAIR_FORK_EPOCH=1)
    state = pk.state(genesis_bytes(N, cfg.GENESIS_FORK_VERSION))
    obs.add("fork before", pk.block.fork_of(state))
    pk.st.process_slots(state, pk.p.SLOTS_PER_EPOCH, pk.p, cfg)
    obs.add("fork after", pk.block.fork_of(state))
    obs.add("upgraded", state)


def test_scheduled_upgrade_in_process_slots():
    seen = both(scenario_scheduled_altair_upgrade)
    assert observed(seen, "fork after") == ["altair"]


def sync_aggregate(pk, state, sks_by_pubkey):
    """A SyncAggregate over the previous slot's block root by the full
    current sync committee."""
    p, t = pk.p, pk.t
    prev_slot = state.slot - 1
    root = pk.util.get_block_root_at_slot(state, prev_slot, p)
    domain = pk.util.get_domain(state, pk.params.DOMAIN_SYNC_COMMITTEE,
                                prev_slot // p.SLOTS_PER_EPOCH)
    signing_root = hashlib.sha256(root + domain).digest()
    agg = t.SyncAggregate.default()
    bits, sigs = [], []
    for pubkey in state.current_sync_committee.pubkeys:
        sk = sks_by_pubkey.get(bytes(pubkey))
        bits.append(sk is not None)
        if sk is not None:
            sigs.append(pk.bls.sign(sk, signing_root))
    agg.sync_committee_bits = bits
    agg.sync_committee_signature = pk.bls.aggregate_signatures(sigs)
    return agg


def altair_block(pk, state, slot, sks, cfg):
    """A full valid signed altair block (randao and sync aggregate)."""
    p, t = pk.p, pk.t
    sks_by_pubkey = {sk.to_pubkey(): sk for sk in sks}
    work = state.copy()
    ctx = pk.st.process_slots(work, slot, p, cfg)
    proposer = ctx.get_beacon_proposer(slot)
    block = t.altair.BeaconBlock.default()
    block.slot = slot
    block.proposer_index = proposer
    block.parent_root = t.BeaconBlockHeader.hash_tree_root(work.latest_block_header)
    block.body.randao_reveal = pk.bls.sign(sks[proposer], pk.util.compute_signing_root(
        pk.ssz.uint64, slot // p.SLOTS_PER_EPOCH,
        pk.util.get_domain(work, pk.params.DOMAIN_RANDAO)))
    block.body.eth1_data = work.eth1_data
    block.body.sync_aggregate = sync_aggregate(pk, work, sks_by_pubkey)
    post = work.copy()
    pk.st.process_block(post, block, pk.cache.EpochContext(post, p), verify_signatures=False)
    block.state_root = post.type.hash_tree_root(post)
    signed = t.altair.SignedBeaconBlock.default()
    signed.message = block
    signed.signature = pk.bls.sign(sks[proposer], pk.util.compute_signing_root(
        t.altair.BeaconBlock, block, pk.util.get_domain(work, pk.params.DOMAIN_BEACON_PROPOSER)))
    return signed, work, ctx


def scenario_altair_block(pk, obs):
    p = pk.p
    cfg = chain_config(pk, ALTAIR_FORK_EPOCH=1)
    state = pk.state(genesis_bytes(N, cfg.GENESIS_FORK_VERSION))
    pk.st.process_slots(state, p.SLOTS_PER_EPOCH, p, cfg)
    signed, work, ctx = altair_block(pk, state, state.slot + 1, secret_keys(pk.root, N), cfg)
    obs.add("block", signed)
    sets = pk.sets.get_block_signature_sets(work, signed, ctx)
    if pk.root == ROOTS[1]:
        # the port's departure: the sync aggregate's set comes last, its
        # participants' pubkeys aggregated, over the previous slot's root
        sync_set = sets.pop()
        agg = signed.message.body.sync_aggregate
        members = [bytes(k) for k, bit in zip(work.current_sync_committee.pubkeys,
                                              agg.sync_committee_bits) if bit]
        prev_slot = work.slot - 1
        domain = pk.util.get_domain(work, pk.params.DOMAIN_SYNC_COMMITTEE,
                                    prev_slot // p.SLOTS_PER_EPOCH)
        root = pk.util.get_block_root_at_slot(work, prev_slot, p)
        assert sync_set == pk.bls.SignatureSet(
            pk.bls.aggregate_pubkeys(members), hashlib.sha256(root + domain).digest(),
            bytes(agg.sync_committee_signature))
        assert pk.bls.verify_signature_sets([sync_set])
    obs.add("sets", sets)
    post = obs.call("import", pk.st.state_transition, state, signed, p, cfg)
    obs.add("post", post)
    bad = signed.copy()
    bits = list(bad.message.body.sync_aggregate.sync_committee_bits)
    bits[0] = not bits[0]
    bad.message.body.sync_aggregate.sync_committee_bits = bits
    obs.call("tampered sync aggregate", pk.st.state_transition, state, bad, p, cfg,
             verify_state_root=False, verify_proposer_signature=False)
    empty = signed.copy()
    empty.message.body.sync_aggregate.sync_committee_bits = [False] * p.SYNC_COMMITTEE_SIZE
    empty.message.body.sync_aggregate.sync_committee_signature = pk.bls.G2_INFINITY
    obs.call("empty sync aggregate", pk.st.state_transition, state, empty, p, cfg,
             verify_state_root=False, verify_proposer_signature=False)


def test_altair_block_with_sync_aggregate():
    seen = both(scenario_altair_block)
    assert observed(seen, "import") == ["ok"]
    assert observed(seen, "tampered sync aggregate")[0][0] == "raises"
    assert observed(seen, "empty sync aggregate") == ["ok"]


def scenario_altair_attestations(pk, obs):
    p, t = pk.p, pk.t
    cfg = chain_config(pk, ALTAIR_FORK_EPOCH=1)
    state = pk.state(genesis_bytes(N, cfg.GENESIS_FORK_VERSION))
    pk.st.process_slots(state, 2 * p.SLOTS_PER_EPOCH - 1, p, cfg)
    ctx = pk.cache.EpochContext(state, p)
    for slot in range(p.SLOTS_PER_EPOCH, state.slot):
        for ci in range(ctx.get_committee_count_per_slot(slot // p.SLOTS_PER_EPOCH)):
            att = t.Attestation.default()
            att.aggregation_bits = [True] * len(ctx.get_beacon_committee(slot, ci))
            att.data.slot = slot
            att.data.index = ci
            att.data.beacon_block_root = pk.util.get_block_root_at_slot(state, slot, p)
            att.data.source = state.current_justified_checkpoint
            tgt = t.Checkpoint.default()
            tgt.epoch = 1
            tgt.root = pk.util.get_block_root(state, 1, p)
            att.data.target = tgt
            obs.add("flags", pk.altair.get_attestation_participation_flag_indices(
                state, att.data, int(state.slot) - slot, p))
            obs.call("attestation", pk.altair.process_attestation_altair, state, att, ctx,
                     verify_signatures=False)
    obs.add("flagged", state)
    pk.st.process_slots(state, 2 * p.SLOTS_PER_EPOCH, p, cfg)
    obs.add("rotated", state)
    pk.st.process_slots(state, 3 * p.SLOTS_PER_EPOCH + 1, p, cfg)
    obs.add("justified", int(state.current_justified_checkpoint.epoch))
    obs.add("state", state)


def test_altair_attestations_set_flags_and_justify():
    seen = both(scenario_altair_attestations)
    assert observed(seen, "justified")[0] >= 1


# --- bellatrix, capella, deneb ------------------------------------------------


def scenario_chained_upgrades(pk, obs):
    for fork in ORDER:
        state, _ = state_at_fork(pk, fork)
        obs.add(f"fork {fork}", pk.block.fork_of(state))
        obs.add(f"state {fork}", state)
    obs.add("merged", pk.bellatrix.is_merge_transition_complete(state, pk.p))


def test_chained_upgrades_to_deneb():
    seen = both(scenario_chained_upgrades)
    assert [v for k, v in seen if k.startswith("fork ")] == list(ORDER)


def payload_for(pk, state, cfg, fork):
    p = pk.p
    payload = getattr(pk.t, fork).ExecutionPayload.default()
    payload.parent_hash = b"\x11" * 32
    payload.block_hash = b"\x22" * 32
    payload.prev_randao = pk.util.get_randao_mix(state, int(state.slot) // p.SLOTS_PER_EPOCH, p)
    payload.timestamp = pk.bellatrix.compute_timestamp_at_slot(state, int(state.slot), cfg)
    return payload


def scenario_bellatrix_payload(pk, obs):
    p = pk.p
    state, cfg = state_at_fork(pk, "bellatrix")
    ctx = pk.cache.EpochContext(state, p)
    payload = payload_for(pk, state, cfg, "bellatrix")
    bad = payload.copy()
    bad.prev_randao = b"\x99" * 32
    obs.call("bad prev_randao", pk.bellatrix.process_execution_payload, state.copy(), bad, ctx, cfg)
    bad = payload.copy()
    bad.timestamp = int(payload.timestamp) + 1
    obs.call("bad timestamp", pk.bellatrix.process_execution_payload, state.copy(), bad, ctx, cfg)
    obs.call("engine says invalid", pk.bellatrix.process_execution_payload, state.copy(), payload,
             ctx, cfg, payload_status="invalid")
    work = state.copy()
    obs.call("merge payload", pk.bellatrix.process_execution_payload, work, payload, ctx, cfg)
    obs.add("merged", work)
    ctx2 = pk.cache.EpochContext(work, p)
    nxt = payload_for(pk, work, cfg, "bellatrix")
    nxt.parent_hash = b"\x33" * 32
    obs.call("bad parent_hash", pk.bellatrix.process_execution_payload, work.copy(), nxt, ctx2, cfg)
    nxt.parent_hash = b"\x22" * 32
    obs.call("next payload", pk.bellatrix.process_execution_payload, work, nxt, ctx2, cfg)
    obs.add("chained", work)
    body = pk.t.bellatrix.BeaconBlockBody.default()
    obs.add("pre-merge execution enabled", pk.bellatrix.is_execution_enabled(state, body, p))


def test_bellatrix_execution_payload():
    seen = both(scenario_bellatrix_payload)
    for label in ("bad prev_randao", "bad timestamp", "engine says invalid", "bad parent_hash"):
        assert observed(seen, label)[0][1] == "BlockProcessError", label
    assert observed(seen, "merge payload") == observed(seen, "next payload") == ["ok"]
    assert observed(seen, "pre-merge execution enabled") == [False]


def scenario_capella_withdrawals(pk, obs):
    p, t = pk.p, pk.t
    state, _ = state_at_fork(pk, "capella")
    ctx = pk.cache.EpochContext(state, p)
    v2 = state.validators[2]
    v2.withdrawal_credentials = b"\x01" + b"\x00" * 11 + b"\xaa" * 20
    v2.withdrawable_epoch = 0
    state.balances[2] = 7_000_000_000
    state.validators[5].withdrawal_credentials = b"\x01" + b"\x00" * 11 + b"\xbb" * 20
    state.balances[5] = p.MAX_EFFECTIVE_BALANCE + 123_456
    expected = pk.capella.get_expected_withdrawals(state, ctx)
    obs.add("expected", [w.type.serialize(w) for w in expected])
    payload = t.capella.ExecutionPayload.default()
    payload.withdrawals = expected
    work = state.copy()
    obs.call("withdrawals", pk.capella.process_withdrawals, work, payload, ctx)
    obs.add("withdrawn", work)
    tampered = t.capella.ExecutionPayload.default()
    wrong = [w.copy() for w in expected]
    wrong[0].amount = 1
    tampered.withdrawals = wrong
    obs.call("mismatch", pk.capella.process_withdrawals, state.copy(), tampered, ctx)
    summaries = state.copy()
    summaries.slot = (p.SLOTS_PER_HISTORICAL_ROOT // p.SLOTS_PER_EPOCH - 1) * p.SLOTS_PER_EPOCH
    pk.capella.process_historical_summaries_update(summaries, p)
    obs.add("historical summaries", summaries)


def test_capella_withdrawals_and_historical_summaries():
    seen = both(scenario_capella_withdrawals)
    assert len(observed(seen, "expected")[0]) == 2
    assert observed(seen, "withdrawals") == ["ok"]
    assert observed(seen, "mismatch")[0][1] == "BlockProcessError"


def scenario_bls_to_execution_change(pk, obs):
    p, t = pk.p, pk.t
    state, cfg = state_at_fork(pk, "capella")
    ctx = pk.cache.EpochContext(state, p)
    sks = secret_keys(pk.root, N)
    vi = 3
    from_pubkey = sks[vi].to_pubkey()
    creds = bytearray(hashlib.sha256(from_pubkey).digest())
    creds[0] = 0
    state.validators[vi].withdrawal_credentials = bytes(creds)
    change = t.BLSToExecutionChange.default()
    change.validator_index = vi
    change.from_bls_pubkey = from_pubkey
    change.to_execution_address = b"\xcc" * 20
    domain = pk.config.compute_domain(pk.params.DOMAIN_BLS_TO_EXECUTION_CHANGE,
                                      cfg.GENESIS_FORK_VERSION,
                                      bytes(state.genesis_validators_root))
    root = pk.config.compute_signing_root(t.BLSToExecutionChange, change, domain)
    signed = t.SignedBLSToExecutionChange.default()
    signed.message = change
    signed.signature = pk.bls.sign(sks[vi], root)
    work = state.copy()
    obs.call("change", pk.capella.process_bls_to_execution_change, work, signed, ctx,
             verify_signatures=True, cfg=cfg)
    obs.add("changed", work)
    bad = signed.copy()
    bad.signature = pk.bls.sign(sks[0], root)
    obs.call("wrong signer", pk.capella.process_bls_to_execution_change, state.copy(), bad, ctx,
             verify_signatures=True, cfg=cfg)
    obs.call("change again", pk.capella.process_bls_to_execution_change, work, signed, ctx,
             verify_signatures=False, cfg=cfg)

    # the change inside a capella block, through process_block
    block_state = state.copy()
    ctx = pk.st.process_slots(block_state, int(state.slot) + 1, p, cfg)
    block = t.capella.BeaconBlock.default()
    block.slot = block_state.slot
    block.proposer_index = ctx.get_beacon_proposer(int(block_state.slot))
    block.parent_root = t.BeaconBlockHeader.hash_tree_root(block_state.latest_block_header)
    block.body.eth1_data = block_state.eth1_data
    block.body.bls_to_execution_changes = [signed]
    obs.call("block with change", pk.st.process_block, block_state, block, ctx,
             verify_signatures=False, cfg=cfg)
    obs.add("block post", block_state)


def test_capella_bls_to_execution_change():
    seen = both(scenario_bls_to_execution_change)
    assert observed(seen, "change") == observed(seen, "block with change") == ["ok"]
    assert observed(seen, "wrong signer")[0][1] == "BlockProcessError"
    assert observed(seen, "change again")[0][1] == "BlockProcessError"


def blob_tx(pk, versioned_hashes):
    """An opaque SignedBlobTransaction with the hashes at the fixed offset."""
    d = pk.deneb
    header_len = d.OPAQUE_TX_BLOB_VERSIONED_HASHES_OFFSET + 4
    tx = bytearray(header_len)
    tx[0] = d.BLOB_TX_TYPE
    tx[d.OPAQUE_TX_BLOB_VERSIONED_HASHES_OFFSET:header_len] = (
        header_len - d.OPAQUE_TX_MESSAGE_OFFSET).to_bytes(4, "little")
    for h in versioned_hashes:
        tx += h
    return bytes(tx)


def scenario_deneb(pk, obs):
    p, t, d = pk.p, pk.t, pk.deneb
    commitments = [b"\x0c" * 48, b"\x0d" * 48]
    hashes = [d.kzg_commitment_to_versioned_hash(c) for c in commitments]
    obs.add("hashes", hashes)
    obs.add("consistent", d.verify_kzg_commitments_against_transactions(
        [blob_tx(pk, hashes)], commitments))
    body = t.deneb.BeaconBlockBody.default()
    body.execution_payload.transactions = [blob_tx(pk, hashes)]
    body.blob_kzg_commitments = commitments
    obs.call("body commitments", d.process_blob_kzg_commitments, body)
    obs.call("swapped hashes", d.verify_kzg_commitments_against_transactions,
             [blob_tx(pk, hashes[::-1])], commitments)
    obs.call("count mismatch", d.verify_kzg_commitments_against_transactions,
             [blob_tx(pk, hashes[:1])], commitments)
    obs.add("non-blob tx", d.verify_kzg_commitments_against_transactions(
        [b"\x02" + b"\x00" * 80], []))

    state, cfg = state_at_fork(pk, "deneb")
    ctx = pk.st.process_slots(state, state.slot + 1, p, cfg)
    commitment = b"\x0e" * 48
    payload = payload_for(pk, state, cfg, "deneb")
    payload.transactions = [blob_tx(pk, [d.kzg_commitment_to_versioned_hash(commitment)])]
    block = t.deneb.BeaconBlock.default()
    block.slot = state.slot
    block.proposer_index = ctx.get_beacon_proposer(int(state.slot))
    block.parent_root = t.BeaconBlockHeader.hash_tree_root(state.latest_block_header)
    block.body.eth1_data = state.eth1_data
    block.body.execution_payload = payload
    block.body.blob_kzg_commitments = [commitment]
    obs.call("deneb block", pk.st.process_block, state, block, ctx, verify_signatures=False,
             cfg=cfg)
    obs.add("post", state)


def test_deneb_blob_commitments_and_block():
    seen = both(scenario_deneb)
    assert observed(seen, "consistent") == [True]
    assert observed(seen, "swapped hashes")[0][1] == "BlockProcessError"
    assert observed(seen, "count mismatch")[0][1] == "BlockProcessError"
    assert observed(seen, "deneb block") == ["ok"]


@pytest.mark.parametrize("fork", ORDER)
def test_upgrade_functions_from_bytes(fork):
    """Each upgrade function alone, on the previous fork's state carried in
    as SSZ bytes: equal upgraded bytes."""
    def scenario(pk, obs):
        prior = ("phase0",) + ORDER
        prev = prior[prior.index(fork) - 1]
        if prev == "phase0":
            cfg = chain_config(pk, ALTAIR_FORK_EPOCH=1)
            state = pk.state(genesis_bytes(N, cfg.GENESIS_FORK_VERSION))
        else:
            state, cfg = state_at_fork(pk, prev)
            cfg = chain_config(pk, **{f"{f.upper()}_FORK_EPOCH": 1 for f in ORDER})
        upgraded = getattr(getattr(pk, fork), f"upgrade_to_{fork}")(state, cfg, pk.p)
        obs.add("upgraded", upgraded)
        obs.add("fork", pk.block.fork_of(upgraded))

    assert observed(both(scenario), "fork") == [fork]


def test_block_sets_through_the_ports_device_verify(monkeypatch):
    """The attested block's sets (one size-8 batch) through the port's
    `verify_signature_sets_device(..., device="cpu")` and the JAX package's
    `device_batch_verify`, on the same blinding bits: equal verdicts, True;
    with two attestations' signatures swapped, False."""
    from lodestar_tpu.crypto.bls.api import SignatureSet as JSet
    from lodestar_tpu.models import batch_verify as jbv
    from lodestar_tpu_torch.models import batch_verify as bv

    port = pkg(ROOTS[1])
    g = port.state(genesis_bytes(N_VALIDATORS))
    signed, work, ctx = attested_block(port, g, 4, secret_keys(port.root, N_VALIDATORS))
    sets = port.sets.get_block_signature_sets(work, signed, ctx)
    swapped = list(sets)
    swapped[2], swapped[3] = (bv.SignatureSet(sets[2].pubkey, sets[2].message, sets[3].signature),
                              bv.SignatureSet(sets[3].pubkey, sets[3].message, sets[2].signature))
    for batch, want in ((sets, True), (swapped, False)):
        jsets = [JSet(s.pubkey, s.message, s.signature) for s in batch]
        pk_, h, sig, bits, mask = jbv.build_device_inputs(jsets, size=8, prep="off")
        jax_verdict = bool(np.asarray(jbv.device_batch_verify(pk_, h, sig, bits, mask)))
        monkeypatch.setattr(bv, "_blinding_and_mask", lambda n, size: (bits.copy(), mask.copy()))
        assert bv.verify_signature_sets_device(batch, device="cpu") is jax_verdict is want
