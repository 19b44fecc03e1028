"""One validator duty loop over REST through the port's
`BlsDeviceVerifierPool(device="cpu")`, and `chip_smoke.py` phase 10f's
scenario (`chip_smoke.rest_run`) on the CPU, minimal preset.

Tolerance: none.

* The pool: a phase0 chain on `BlsDeviceVerifierPool(device="cpu")`, run
  on an event loop on its own thread attached as `chain.loop` (as a node
  attaches its loop); the REST handler threads route the import onto it. A
  store with one proposer's key: its block is one pool job (one size-8
  batch), and the head and state root equal the JAX chain's after the same
  block's bytes.
* Phase 10f's scenario at the minimal preset on the port's oracle verifier
  (the on-card test is `tests/test_torch_api_cuda.py`): two slots of a
  `RestValidator`'s duties on a chain of 64 validators at Capella, each
  request's pool jobs, the forged attestation and block refused with HTTP
  400, the SSE stream's events, every signature True on the host oracle,
  and nothing left running.
"""

from __future__ import annotations

import asyncio
import threading

from .test_torch_chain import ROOTS
from .test_torch_chain import minimal_cpu  # noqa: F401 - the minimal preset in both packages
from .test_torch_api_cuda import rest_chain, rest_outcome
from .test_torch_rest_validator import FAR, N, genesis_bytes, pkg, ser

J, T = ROOTS


# --- one duty loop through the pool on the CPU -------------------------------------


def _loop_thread():
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    return loop, thread


def test_duty_loop_through_the_pool_on_the_cpu():
    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool
    from lodestar_tpu_torch.chain.produce_block import dial_to_slot

    Pt, Pj = pkg(T), pkg(J)
    cfg = Pt.cfg(FAR)
    genesis = Pt.t.phase0.BeaconState.deserialize(genesis_bytes(False))
    sks = Pt.gen.interop_secret_keys(N)
    # a slot whose proposer attests at another slot: the duty is its block alone
    for slot in range(1, Pt.p.SLOTS_PER_EPOCH):
        work, ctx = dial_to_slot(genesis, slot, Pt.p, cfg)
        proposer = int(ctx.get_beacon_proposer(slot))
        members = {int(v) for c in range(ctx.get_committee_count_per_slot(0))
                   for v in ctx.get_beacon_committee(slot, c)}
        if proposer not in members:
            break
    chain = Pt.chain.BeaconChain(anchor_state=genesis, bls_verifier=Pt.bls.BlsVerifierMock(True),
                                 db=Pt.db.MemoryDbController(), cfg=cfg, current_slot=slot)
    loop, thread = _loop_thread()
    jobs = []

    async def attach():
        pool = BlsDeviceVerifierPool(device="cpu")
        verify = pool.verify_signature_sets

        async def counted(sets, opts=None):
            jobs.append(len(sets))
            return await verify(sets, opts)

        pool.verify_signature_sets = counted
        chain.bls = pool

    asyncio.run_coroutine_threadsafe(attach(), loop).result()
    chain.loop = loop
    server = Pt.api.BeaconRestApiServer(Pt.api.BeaconApiImpl(chain), port=0)
    server.start()
    try:
        store = Pt.validator.ValidatorStore(
            Pt.config.create_beacon_config(cfg, bytes(genesis.genesis_validators_root)),
            Pt.validator.SlashingProtection(Pt.db.MemoryDbController()), [sks[proposer]], Pt.p)
        rv = Pt.rest.RestValidator(
            client=Pt.api.BeaconApiClient(f"http://127.0.0.1:{server.port}"), store=store, p=Pt.p)
        out = rv.run_slot_duties(slot)
    finally:
        server.stop()
        chain.loop = None
        asyncio.run_coroutine_threadsafe(chain.bls.close(), loop).result()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
    assert out["proposed"] is not None and out["attestations"] == []
    assert jobs == [2]  # proposer and randao: one job, one size-8 batch
    signed = out["proposed"]
    assert chain.head_root == Pt.t.phase0.BeaconBlock.hash_tree_root(signed.message)
    # the same block's bytes through the JAX chain: the same head and state root
    jchain = Pj.chain.BeaconChain(
        anchor_state=Pj.t.phase0.BeaconState.deserialize(genesis_bytes(False)),
        bls_verifier=Pj.bls.BlsSingleThreadVerifier(), db=Pj.db.MemoryDbController(),
        cfg=Pj.cfg(FAR), current_slot=slot)
    asyncio.run(jchain.process_block(Pj.t.phase0.SignedBeaconBlock.deserialize(ser(signed))))
    head, jhead = chain.get_head_state(), jchain.get_head_state()
    assert (chain.head_root, head.type.hash_tree_root(head)) == (
        jchain.head_root, jhead.type.hash_tree_root(jhead))


# --- chip_smoke.py phase 10f on the CPU -----------------------------------------------


def test_phase_10f_scenario_on_the_cpu():
    import chip_smoke
    from lodestar_tpu_torch.chain.bls import BlsSingleThreadVerifier

    assert (chip_smoke.REST_SLOTS, chip_smoke.REST_ATTESTERS) == (2, 4)
    chain, sks, p, cfg = rest_chain()
    out = chip_smoke.rest_run(chain, sks, p, cfg, range(12, 14), BlsSingleThreadVerifier)
    counts, per_request, forged_att, forged_block, sse, oracle = rest_outcome(out)
    assert oracle and sse == {"head": [12, 13], "block": [12, 13]}
    # slot 12's contributions land in block 13's sync aggregate
    assert [c[:3] for c in counts] == [(4, 5, 5)] * 2 and counts[1][3] > 0
    assert forged_att == "400: some attestations failed: [{'index': 0, 'message': " \
                         "'invalid attestation signature'}]"
    assert forged_block == ["400", " INVALID_SIGNATURES", " 0x" + forged_block[2][3:]]
    jobs = {}
    for slot, method, path, n in per_request:
        jobs.setdefault((slot, method, path), []).extend(n)
    assert jobs[(12, "POST", "/eth/v1/beacon/blocks")] == [2]
    assert jobs[(13, "POST", "/eth/v1/beacon/blocks")] == [3]  # + the sync aggregate's set
    for slot in (12, 13):
        assert jobs[(slot, "POST", "/eth/v1/beacon/pool/attestations")] == [1] * 4
        assert jobs[(slot, "POST", "/eth/v1/beacon/pool/sync_committees")] == [1] * 5
        assert jobs[(slot, "POST", "/eth/v1/validator/contribution_and_proofs")] == [3] * 5
    assert jobs[("c1", "POST", "/eth/v1/beacon/pool/attestations")] == [1]
    assert jobs[("c2", "POST", "/eth/v1/beacon/blocks")] == [3]
    assert chain.loop is None and not chip_smoke.server_threads()
