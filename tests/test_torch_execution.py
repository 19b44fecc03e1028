"""The port's `execution` package (the engine API mock and HTTP client with
JWT, the eth1 provider, the eth1 deposit tracker and the builder client),
held against `lodestar_tpu.execution`.

* The JAX package's own tests run on the port with `port_copy`:
  `tests/execution/test_execution.py`, `tests/execution/test_eth1_tracker.py`
  and the builder test of `tests/network/test_subnets_discovery_builder.py`.
* Across the packages on the same seeded inputs: deposit-tree roots and
  proofs, deposit-log ABI bytes (encoded in one package, parsed in the
  other), the engine client's JWT and JSON-RPC bodies at a fixed clock, the
  eth1 provider's votes, each package's tracker against the other
  package's `MockEth1Node` over JSON-RPC on 127.0.0.1, and the builder
  client's calls and results through one scripted transport.

Tolerance: none (bytes and values). Minimal preset in both packages.
"""

from __future__ import annotations

import asyncio
import importlib
import json

import pytest

from .test_torch_utils_gaps import port_copy

port_copy("tests.execution.test_execution", globals())
port_copy("tests.execution.test_eth1_tracker", globals())
port_copy("tests.network.test_subnets_discovery_builder", globals(),
          names={"test_builder_circuit_breaker_and_flow"})

J, T = "lodestar_tpu", "lodestar_tpu_torch"
N = 8


@pytest.fixture()
def minimal_both():
    mods = [importlib.import_module(f"{root}.params") for root in (J, T)]
    prev = [m.active_preset() for m in mods]
    for m in mods:
        m.set_active_preset("minimal")
    yield [m.active_preset() for m in mods]
    for m, p in zip(mods, prev):
        m.set_active_preset(p)


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def _deposit_datas(root, n, first=N):
    """`n` signed DepositData of `root`'s types for interop keys first.."""
    params = _mod(root, "params")
    t = _mod(root, "types").ssz_types()
    cfg = _mod(root, "config")
    bls = _mod(root, "crypto.bls")
    sks = _mod(root, "state_transition.genesis").interop_secret_keys(first + n)[first:]
    out = []
    for i, sk in enumerate(sks):
        dd = t.DepositData.default()
        dd.pubkey = sk.to_pubkey()
        dd.withdrawal_credentials = b"\x00" + bytes([0x70 + i]) * 31
        dd.amount = params.active_preset().MAX_EFFECTIVE_BALANCE
        msg = t.DepositMessage.default()
        msg.pubkey, msg.withdrawal_credentials, msg.amount = (
            dd.pubkey, dd.withdrawal_credentials, dd.amount)
        domain = cfg.compute_domain(params.DOMAIN_DEPOSIT, b"\x00" * 4, b"\x00" * 32)
        dd.signature = bls.sign(sk, cfg.compute_signing_root(t.DepositMessage, msg, domain))
        out.append(dd)
    return out


def test_deposit_tree_and_log_abi_across_packages(minimal_both):
    trees = {r: _mod(r, "execution.eth1_tracker").DepositTree() for r in (J, T)}
    datas = {r: _deposit_datas(r, 5) for r in (J, T)}
    for r in (J, T):
        t = _mod(r, "types").ssz_types()
        for dd in datas[r]:
            trees[r].push(t.DepositData.hash_tree_root(dd))
    for count in range(1, 6):
        assert trees[J].root_at(count) == trees[T].root_at(count)
        for i in range(count):
            assert trees[J].proof(i, count) == trees[T].proof(i, count)
    for i, (jd, td) in enumerate(zip(datas[J], datas[T])):
        args = (bytes(td.pubkey), bytes(td.withdrawal_credentials), int(td.amount),
                bytes(td.signature), i)
        raw = {r: _mod(r, "execution.eth1_tracker").encode_deposit_log_data(*args) for r in (J, T)}
        assert raw[J] == raw[T]
        for src, dst in ((J, T), (T, J)):
            out, index = _mod(dst, "execution.eth1_tracker").parse_deposit_log(raw[src])
            assert index == i and out.type.serialize(out) == jd.type.serialize(jd)


def test_engine_http_jwt_and_bodies_across_packages(monkeypatch, minimal_both):
    secret = b"\x42" * 32
    seen = {}
    for r in (J, T):
        engine = _mod(r, "execution.engine")
        monkeypatch.setattr(engine.time, "time", lambda: 1_700_000_000.25)
        t = _mod(r, "types").ssz_types()
        eng = engine.ExecutionEngineHttp("http://localhost:0", secret)
        bodies = []

        def fake_post(body, bodies=bodies, eng=eng):
            bodies.append((json.dumps(body, sort_keys=True), eng._jwt_token()))
            if body["method"].startswith("engine_newPayload"):
                return {"result": {"status": "INVALID", "latestValidHash": "0x" + "cd" * 32}}
            if body["method"].startswith("engine_forkchoiceUpdated"):
                return {"result": {"payloadStatus": {"status": "VALID"}, "payloadId": "0x0102"}}
            return {"result": {"error": "unexpected"}}

        monkeypatch.setattr(eng, "_post", fake_post)
        payload = t.bellatrix.ExecutionPayload.default()
        payload.block_number = 7
        payload.block_hash = b"\x07" * 32
        attrs = engine.PayloadAttributes(timestamp=12, prev_randao=b"\x05" * 32,
                                         suggested_fee_recipient=b"\x09" * 20)

        async def go(eng=eng, payload=payload, attrs=attrs):
            status, lvh = await eng.notify_new_payload(payload)
            pid = await eng.notify_forkchoice_update(b"\x07" * 32, b"\x06" * 32, b"\x05" * 32, attrs)
            return status.value, lvh, pid

        seen[r] = (asyncio.run(go()), bodies)
    assert seen[J] == seen[T]
    assert seen[T][0][0] == "INVALID" and len(seen[T][1]) == 2


def test_eth1_provider_votes_across_packages(minimal_both):
    outs = {}
    for r in (J, T):
        eth1 = _mod(r, "execution.eth1")
        t = _mod(r, "types").ssz_types()
        state = t.phase0.BeaconState.default()
        state.eth1_data.deposit_count = 5
        state.eth1_deposit_index = 5
        provider = eth1.Eth1MemoryProvider(follow_distance_sec=100)
        for n in range(1, 6):
            provider.feed_block(eth1.Eth1Block(n, 900 + 70 * n, bytes([n]) * 32,
                                               bytes([0x10 + n]) * 32, 4 + n))
        rows = []
        for fed in (None, 5, 6):
            if fed is not None:
                dep = t.Deposit.default()
                dep.data.amount = fed
                provider.feed_deposit(fed, dep)
            data, deps = provider.get_eth1_data_and_deposits(state, current_time=1300)
            rows.append((t.Eth1Data.serialize(data), [t.Deposit.serialize(d) for d in deps]))
        outs[r] = rows
    assert outs[J] == outs[T]


def _tracker_run(node_root, tracker_root):
    """`tracker_root`'s tracker over JSON-RPC against `node_root`'s
    MockEth1Node with 3 deposits: (new deposits, tree root, the deposits and
    the vote it serves, as bytes)."""
    nt = _mod(node_root, "execution.eth1_tracker")
    tt = _mod(tracker_root, "execution.eth1_tracker")
    genesis = _mod(tracker_root, "state_transition.genesis")
    t = _mod(tracker_root, "types").ssz_types()
    p = _mod(tracker_root, "params").active_preset()
    node = nt.MockEth1Node()
    node.start()
    try:
        for dd in _deposit_datas(node_root, 3):
            node.submit_deposit(dd)
        node.mine_blocks(20)
        tracker = tt.Eth1DepositDataTracker(
            tt.Eth1JsonRpcProvider(node.url), deposit_contract_address=nt.MockEth1Node.CONTRACT,
            cfg=_mod(tracker_root, "config").minimal_chain_config(), follow_distance_blocks=4)
        new = tracker.update()
        state = genesis.create_interop_genesis_state(N, p=p)
        state.eth1_deposit_index = 0
        state.eth1_data.deposit_root = tracker.tree.root_at(3)
        state.eth1_data.deposit_count = 3
        _, deposits = tracker.get_eth1_data_and_deposits(state)
        voter = genesis.create_interop_genesis_state(N, p=p)
        voter.genesis_time = 1_600_000_224
        voter.eth1_data.deposit_count = 0
        vote, _ = tracker.get_eth1_data_and_deposits(voter)
        return (new, tracker.tree.root_at(3), [t.Deposit.serialize(d) for d in deposits],
                t.Eth1Data.serialize(vote))
    finally:
        node.stop()


def test_trackers_against_either_packages_node(minimal_both):
    runs = {(n, k): _tracker_run(n, k) for n in (J, T) for k in (J, T)}
    first = runs[(J, J)]
    assert first[0] == 3 and len(first[2]) == 3
    assert all(v == first for v in runs.values())


def test_builder_client_across_packages(minimal_both):
    outs = {}
    for r in (J, T):
        builder = _mod(r, "execution.builder")
        sj = _mod(r, "ssz.json")
        t = _mod(r, "types").ssz_types()
        p = _mod(r, "params").active_preset()
        calls = []

        def transport(method, path, body=None, calls=calls, t=t, sj=sj):
            calls.append((method, path, json.dumps(body, sort_keys=True)))
            if path.startswith("/eth/v1/builder/header/"):
                bid = t.capella.SignedBuilderBid.default()
                bid.message.value = 77
                bid.message.header.block_hash = b"\x42" * 32
                return {"data": sj.to_json(t.capella.SignedBuilderBid, bid)}
            if path == "/eth/v1/builder/blinded_blocks":
                payload = t.capella.ExecutionPayload.default()
                payload.block_hash = b"\x42" * 32
                payload.block_number = 9
                return {"data": sj.to_json(t.capella.ExecutionPayload, payload)}
            return None

        b = builder.ExecutionBuilderHttp(transport, p, fault_inspection_window=8, allowed_faults=1)
        b.update_status(True)
        b.check_status()
        for slot in (3, 4):
            b.register_fault(slot)
        broken = [b.is_circuit_broken(s) for s in (5, 11, 13)]
        bid = b.get_header(5, b"\x01" * 32, b"\xaa" * 48)
        blinded = t.capella.SignedBlindedBeaconBlock.default()
        blinded.message.body.execution_payload_header.block_hash = b"\x42" * 32
        payload = b.submit_blinded_block(blinded)
        outs[r] = (calls, b.status, broken, t.capella.SignedBuilderBid.serialize(bid),
                   t.capella.ExecutionPayload.serialize(payload))
    assert outs[J] == outs[T]
