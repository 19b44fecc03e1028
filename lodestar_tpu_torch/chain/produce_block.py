"""Block production: assemble a body from the pools + compute state root.

Reference `beacon-node/src/chain/produceBlock/produceBlockBody.ts` +
`computeNewStateRoot.ts`: op-pool selections (aggregated attestations
scored by fresh attesters, exits, slashings), randao reveal + graffiti
from the caller, eth1 vote passthrough, then one signature-free STF to
fill in the state root.

The port of `lodestar_tpu.chain.produce_block` (host Python and numpy, as there).
"""

from __future__ import annotations

from lodestar_tpu_torch import tracing
from lodestar_tpu_torch.state_transition import (
    EpochContext,
    process_block,
    process_slots,
    state_hash_tree_root,
)
from lodestar_tpu_torch.types import ssz_types

__all__ = ["produce_block", "compute_new_state_root", "dial_to_slot", "make_attestation_data"]


def dial_to_slot(state, slot: int, p, cfg=None):
    """(state', ctx) with state' advanced to `slot` (copy-on-advance)."""
    if slot > state.slot:
        work = state.copy()
        ctx = process_slots(work, slot, p, cfg)
        return work, ctx
    return state, EpochContext(state, p)


def make_attestation_data(chain, slot: int, committee_index: int):
    """AttestationData for (slot, committee) on the current head — shared
    by the validator duty loop and the REST producer (reference
    `api/impl/validator` produceAttestationData)."""
    from lodestar_tpu_torch.state_transition.util import get_block_root

    p = chain.p
    t = ssz_types(p)
    head_state = chain.get_state_by_block_root(chain.head_root)
    work, _ctx = dial_to_slot(head_state, slot, p, chain.cfg)
    epoch = slot // p.SLOTS_PER_EPOCH
    data = t.AttestationData.default()
    data.slot = slot
    data.index = committee_index
    data.beacon_block_root = chain.head_root
    data.source = work.current_justified_checkpoint
    tgt = t.Checkpoint.default()
    tgt.epoch = epoch
    try:
        tgt.root = get_block_root(work, epoch, p)
    except ValueError:
        tgt.root = chain.head_root
    data.target = tgt
    return data


def produce_block(
    chain,
    *,
    slot: int,
    randao_reveal: bytes,
    graffiti: bytes = b"",
    parent_root: bytes | None = None,
):
    """Unsigned BeaconBlock proposal for `slot` on the current head
    (reference `chain.produceBlock` -> produceBlockBody). Traced as its
    own root (`block_production` > state advance / op-pool packing /
    STF+htr) so a missed proposal's latency is attributable; the root
    carries the device scheduler's occupancy at production start — a
    proposal that raced a saturated verifier pool says so in its trace."""
    with tracing.root("block_production", slot=slot) as rsp:
        if rsp:
            occ = getattr(chain.bls, "occupancy", None)
            if occ is not None:
                rsp.set(sched_occupancy_permille=occ.occupancy_permille())
        return _produce_block_traced(
            chain,
            slot=slot,
            randao_reveal=randao_reveal,
            graffiti=graffiti,
            parent_root=parent_root,
        )


def _produce_block_traced(chain, *, slot, randao_reveal, graffiti, parent_root):
    p = chain.p
    t = ssz_types(p)
    head_root = parent_root if parent_root is not None else chain.head_root
    pre_state = chain.get_state_by_block_root(head_root)
    work = pre_state.copy()
    with tracing.span("produce_state_advance"):
        ctx = (
            process_slots(work, slot, p, chain.cfg)
            if slot > work.slot
            else EpochContext(work, p)
        )

    from lodestar_tpu_torch.state_transition.block import block_types_for

    block_type, _ = block_types_for(work, p)
    block = block_type.default()
    block.slot = slot
    block.proposer_index = ctx.get_beacon_proposer(slot)
    block.parent_root = head_root

    with tracing.span("produce_op_pool_packing") as psp:
        body = block.body
        body.randao_reveal = randao_reveal
        body.graffiti = (graffiti or b"").ljust(32, b"\x00")[:32]
        eth1 = getattr(chain, "eth1", None)
        if eth1 is not None:
            body.eth1_data, deposits = eth1.get_eth1_data_and_deposits(work)
            body.deposits = deposits[: p.MAX_DEPOSITS]
        else:
            body.eth1_data = work.eth1_data

        from lodestar_tpu_torch.state_transition.block import fork_of

        if fork_of(work) != "phase0":
            # sync aggregate over the parent root from the contribution pool;
            # with no contributions this yields empty bits + the G2 infinity
            # signature (the eth_fast_aggregate_verify empty-participation case)
            body.sync_aggregate = chain.sync_contribution_pool.get_sync_aggregate(
                slot - 1, bytes(head_root)
            )

        att_slashings, prop_slashings, exits = chain.op_pool.get_slashings_and_exits(work, p)
        body.proposer_slashings = prop_slashings
        body.attester_slashings = att_slashings
        body.voluntary_exits = exits
        body.attestations = chain.aggregated_attestation_pool.get_attestations_for_block(
            work, p, ctx=ctx
        )
        if psp:
            psp.set(attestations=len(body.attestations), exits=len(exits))

    block.state_root = compute_new_state_root(chain, work, block, ctx)
    return block


def compute_new_state_root(chain, dialed_state, block, ctx) -> bytes:
    """STF without signature verification, root only (reference
    `computeNewStateRoot.ts` — runs the transition on a throwaway clone)."""
    post = dialed_state.copy()
    with tracing.span("produce_stf"):
        process_block(post, block, ctx, verify_signatures=False, cfg=chain.cfg)
    with tracing.span("produce_hash_tree_root"):
        # transient: `post` is a throwaway clone — never cold-build
        # tracker snapshots just to discard them with it
        return state_hash_tree_root(post, transient=True)
