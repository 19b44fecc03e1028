"""Beacon API implementation over BeaconChain.

Reference `beacon-node/src/api/impl/` — each method returns plain JSON-
ready dicts ({"data": ...} envelopes per the Eth Beacon API spec), using
the generic eth2-JSON codecs over the registry types.

The port of `lodestar_tpu.api.impl`, with its imports rewritten.
"""

from __future__ import annotations

import asyncio

from lodestar_tpu_torch.chain.bls import VerifySignatureOpts
from lodestar_tpu_torch.scheduler import PriorityClass
from lodestar_tpu_torch.ssz.json import from_json, to_json
from lodestar_tpu_torch.state_transition import EpochContext, compute_epoch_at_slot, process_slots
from lodestar_tpu_torch.types import ssz_types

# REST-submitted objects verify under the API launch class: behind
# gossip work, ahead of sync bulk
_API_VERIFY_OPTS = VerifySignatureOpts(priority=PriorityClass.API)

__all__ = ["BeaconApiImpl", "ApiError"]

VERSION = "lodestar-tpu/0.3.0"


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class BeaconApiImpl:
    def __init__(self, chain):
        self.chain = chain
        self.p = chain.p
        self.t = ssz_types(chain.p)

    def _run_async(self, coro):
        """Run a chain-mutating coroutine on the NODE's event loop when
        one is attached (chain.loop, set by BeaconNode.init). REST
        handler threads must not drive loop-bound machinery (the device
        BLS pool's queues/timers live on the main loop) nor mutate chain
        structures concurrently with the gossip drain; routing through
        the loop restores the reference's single-threaded semantics.
        Library users without a node fall back to a private loop."""
        loop = getattr(self.chain, "loop", None)
        if loop is not None and loop.is_running():
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if running is not loop:
                return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=120)
        return asyncio.run(coro)

    # -- events namespace (SSE) -----------------------------------------------

    def stream_events(self, topics: list[str]) -> "EventStream":
        import queue as _queue

        for t in topics:
            if t not in EVENT_TOPICS:
                raise ApiError(400, f"unknown event topic {t!r}")
        if not topics:
            topics = list(EVENT_TOPICS)
        q: "_queue.Queue" = _queue.Queue(maxsize=1024)
        chain = self.chain

        def _put(event_type: str, payload: dict) -> None:
            try:
                q.put_nowait((event_type, payload))
            except _queue.Full:
                pass  # slow consumer: drop rather than stall the chain

        handlers = []
        if "block" in topics:

            def on_block(root, signed):
                _put(
                    "block",
                    {
                        "slot": str(int(signed.message.slot)),
                        "block": "0x" + bytes(root).hex(),
                        "execution_optimistic": False,
                    },
                )

            chain.on("block", on_block)
            handlers.append(("block", on_block))
        if "head" in topics:
            # baseline from the CURRENT HEAD's slot, not the wall clock: a
            # syncing node's clock epoch is far ahead of its head epoch and
            # would fire a spurious epoch_transition on the first event
            head_node = chain.fork_choice.proto_array.get_block(chain.fork_choice.head)
            prev_epoch = [(head_node.slot if head_node else 0) // chain.p.SLOTS_PER_EPOCH]

            def on_head(head_hex):
                node = chain.fork_choice.proto_array.get_block(head_hex)
                epoch = (node.slot if node else 0) // chain.p.SLOTS_PER_EPOCH
                transition = epoch != prev_epoch[0]
                prev_epoch[0] = epoch
                _put(
                    "head",
                    {
                        "slot": str(node.slot if node else 0),
                        "block": head_hex,
                        "state": node.state_root if node else "0x" + "00" * 32,
                        "epoch_transition": transition,
                        "execution_optimistic": False,
                    },
                )

            chain.on("head", on_head)
            handlers.append(("head", on_head))
        if "finalized_checkpoint" in topics:

            def on_finalized(cp):
                node = chain.fork_choice.proto_array.get_block("0x" + bytes(cp.root).hex())
                _put(
                    "finalized_checkpoint",
                    {
                        "block": "0x" + bytes(cp.root).hex(),
                        "state": node.state_root if node else "0x" + "00" * 32,
                        "epoch": str(int(cp.epoch)),
                        "execution_optimistic": False,
                    },
                )

            chain.on("finalized", on_finalized)
            handlers.append(("finalized", on_finalized))

        def unsubscribe():
            for event, fn in handlers:
                chain.off(event, fn)

        return EventStream(q, unsubscribe)



    # -- state resolution -----------------------------------------------------

    def _state_at(self, state_id: str):
        """Beacon API stateId: head | finalized | <slot> | 0x<state root>."""
        chain = self.chain
        if state_id == "head":
            return chain.get_head_state()
        if state_id == "genesis":
            raise ApiError(501, "genesis state queries need the archive")
        if state_id == "finalized":
            st = chain.get_finalized_state()
            if st is None:
                raise ApiError(404, "finalized state not found")
            return st
        if state_id.startswith("0x"):
            # hex stateId is a STATE root: fork choice nodes record their
            # block's state_root, so resolve through them to the block root
            for node in chain.fork_choice.proto_array.nodes:
                if node.state_root == state_id:
                    return chain.get_state_by_block_root(bytes.fromhex(node.block_root[2:]))
            raise ApiError(404, f"state {state_id} not found")
        if state_id.isdigit():
            return chain.get_state_by_block_root(self._block_root(state_id))
        raise ApiError(400, f"unsupported state id {state_id}")

    # -- beacon namespace -----------------------------------------------------

    def get_genesis(self) -> dict:
        st = self.chain.get_head_state()
        # fork version from the chain config when bound: the head state's
        # previous_version stops being the genesis version after any fork
        if self.chain.cfg is not None:
            version = self.chain.cfg.GENESIS_FORK_VERSION
        else:
            version = bytes(st.fork.previous_version)
        return {
            "data": {
                "genesis_time": str(st.genesis_time),
                "genesis_validators_root": "0x" + bytes(st.genesis_validators_root).hex(),
                "genesis_fork_version": "0x" + version.hex(),
            }
        }

    def get_block_header(self, block_id: str) -> dict:
        root = self._block_root(block_id)
        signed = self.chain.get_block_by_root(root)
        if signed is None:
            raise ApiError(404, f"block {block_id} not found")
        header = self.t.BeaconBlockHeader.default()
        msg = signed.message
        header.slot = msg.slot
        header.proposer_index = msg.proposer_index
        header.parent_root = bytes(msg.parent_root)
        header.state_root = bytes(msg.state_root)
        header.body_root = self.t.phase0.BeaconBlockBody.hash_tree_root(msg.body)
        return {
            "data": {
                "root": "0x" + root.hex(),
                "canonical": True,
                "header": {
                    "message": to_json(self.t.BeaconBlockHeader, header),
                    "signature": "0x" + bytes(signed.signature).hex(),
                },
            }
        }

    def _block_root(self, block_id: str) -> bytes:
        if block_id == "head":
            return self.chain.head_root
        if block_id.startswith("0x"):
            return bytes.fromhex(block_id[2:])
        # numeric slot: resolve through fork choice chain from head
        slot = int(block_id)
        node = self.chain.fork_choice.proto_array.get_block(self.chain.fork_choice.head)
        while node is not None and node.slot > slot:
            parent = node.parent
            node = self.chain.fork_choice.proto_array.nodes[parent] if parent is not None else None
        if node is None or node.slot != slot:
            raise ApiError(404, f"no canonical block at slot {slot}")
        return bytes.fromhex(node.block_root[2:])

    def get_block_v2(self, block_id: str) -> dict:
        from lodestar_tpu_torch.state_transition.block import fork_of

        root = self._block_root(block_id)
        signed = self.chain.get_block_by_root(root)
        if signed is None:
            raise ApiError(404, f"block {block_id} not found")
        fork = fork_of(signed.message)
        return {
            "version": fork,
            "execution_optimistic": False,
            "data": to_json(getattr(self.t, fork).SignedBeaconBlock, signed),
        }

    def publish_block(self, body: dict) -> dict:
        # decode with the fork active at the block's slot (the standard
        # API sends the version in a header the stdlib router doesn't
        # surface; the slot determines it just as well)
        try:
            slot = int(body["message"]["slot"])
        except (KeyError, TypeError, ValueError) as e:
            raise ApiError(400, f"malformed block body: {e}") from e
        fork = self.chain.fork_name_at_slot(slot)
        try:
            signed = from_json(getattr(self.t, fork).SignedBeaconBlock, body)
        except (KeyError, TypeError, ValueError) as e:
            raise ApiError(400, f"cannot decode {fork} block: {e}") from e
        from lodestar_tpu_torch.chain.chain import BlockError

        try:
            # the node's OWN proposal published over REST is the most
            # deadline-critical block it ever imports — it verifies at
            # gossip-block priority, not the API bulk class
            self._run_async(
                self.chain.process_block(signed, priority=PriorityClass.GOSSIP_BLOCK)
            )
        except BlockError as e:
            raise ApiError(400, str(e)) from e
        return {}

    def get_state_finality_checkpoints(self, state_id: str) -> dict:
        st = self._state_at(state_id)
        return {
            "data": {
                "previous_justified": to_json(self.t.Checkpoint, st.previous_justified_checkpoint),
                "current_justified": to_json(self.t.Checkpoint, st.current_justified_checkpoint),
                "finalized": to_json(self.t.Checkpoint, st.finalized_checkpoint),
            }
        }

    def get_state_fork(self, state_id: str) -> dict:
        st = self._state_at(state_id)
        return {"data": to_json(self.t.Fork, st.fork)}

    def get_state_validators(self, state_id: str) -> dict:
        st = self._state_at(state_id)
        epoch = compute_epoch_at_slot(st.slot, self.p)
        out = []
        for i, v in enumerate(st.validators):
            status = _validator_status(v, epoch)
            out.append(
                {
                    "index": str(i),
                    "balance": str(st.balances[i]),
                    "status": status,
                    "validator": to_json(self.t.Validator, v),
                }
            )
        return {"data": out}

    def submit_pool_attestations(self, body: list) -> dict:
        from lodestar_tpu_torch.chain.validation import GossipValidationError, validate_gossip_attestation

        from lodestar_tpu_torch.network.processor import import_verified_attestation

        errors = []

        async def run_batch():
            for i, att_json in enumerate(body):
                att = from_json(self.t.Attestation, att_json)
                try:
                    res = validate_gossip_attestation(self.chain, att)
                except GossipValidationError as e:
                    errors.append({"index": i, "message": str(e)})
                    continue
                if not await self.chain.bls.verify_signature_sets(res.signature_sets, _API_VERIFY_OPTS):
                    errors.append({"index": i, "message": "invalid attestation signature"})
                    continue
                import_verified_attestation(self.chain, res, att)

        self._run_async(run_batch())
        if errors:
            raise ApiError(400, f"some attestations failed: {errors}")
        return {}

    # -- validator namespace --------------------------------------------------

    def get_proposer_duties(self, epoch: int) -> dict:
        from lodestar_tpu_torch.chain.produce_block import dial_to_slot

        st = self.chain.get_head_state()
        target_slot = epoch * self.p.SLOTS_PER_EPOCH
        work, ctx = dial_to_slot(st, max(target_slot, st.slot), self.p, self.chain.cfg)
        if ctx.current_epoch != epoch:
            raise ApiError(400, f"cannot compute duties for epoch {epoch}")
        duties = []
        for i, proposer in enumerate(ctx.proposers):
            duties.append(
                {
                    "pubkey": "0x" + bytes(work.validators[proposer].pubkey).hex(),
                    "validator_index": str(proposer),
                    "slot": str(target_slot + i),
                }
            )
        return {"data": duties, "dependent_root": self.chain.fork_choice.head}

    def get_attester_duties(self, epoch: int, indices: list[int]) -> dict:
        from lodestar_tpu_torch.chain.produce_block import dial_to_slot

        st = self.chain.get_head_state()
        work, ctx = dial_to_slot(
            st, max(epoch * self.p.SLOTS_PER_EPOCH, st.slot), self.p, self.chain.cfg
        )
        want = set(indices)
        duties = []
        sh = ctx._shuffling_at(epoch)
        for slot_i in range(self.p.SLOTS_PER_EPOCH):
            for c_idx, committee in enumerate(sh.committees[slot_i]):
                for pos, vi in enumerate(committee):
                    if int(vi) in want:
                        duties.append(
                            {
                                "pubkey": "0x" + bytes(work.validators[int(vi)].pubkey).hex(),
                                "validator_index": str(int(vi)),
                                "committee_index": str(c_idx),
                                "committee_length": str(len(committee)),
                                "committees_at_slot": str(sh.committees_per_slot),
                                "validator_committee_index": str(pos),
                                "slot": str(epoch * self.p.SLOTS_PER_EPOCH + slot_i),
                            }
                        )
        return {"data": duties, "dependent_root": self.chain.fork_choice.head}

    def produce_block_v2(self, slot: int, randao_reveal: str, graffiti: str = "") -> dict:
        from lodestar_tpu_torch.chain.produce_block import produce_block

        block = produce_block(
            self.chain,
            slot=slot,
            randao_reveal=bytes.fromhex(randao_reveal[2:]),
            graffiti=bytes.fromhex(graffiti[2:]) if graffiti.startswith("0x") else graffiti.encode(),
        )
        from lodestar_tpu_torch.state_transition.block import fork_of

        fork = fork_of(block)
        return {"version": fork, "data": to_json(getattr(self.t, fork).BeaconBlock, block)}

    def produce_attestation_data(self, slot: int, committee_index: int) -> dict:
        from lodestar_tpu_torch.chain.produce_block import make_attestation_data

        data = make_attestation_data(self.chain, slot, committee_index)
        return {"data": to_json(self.t.AttestationData, data)}

    def get_validator_liveness(self, epoch: int, indices: list[int]) -> dict:
        """POST /eth/v1/validator/liveness/{epoch}: whether each index
        showed on-chain activity in the epoch (doppelganger data source;
        the reference reads its validator monitor — here the seen-attester
        cache carries the same signal)."""
        chain = self.chain

        def is_live(i: int) -> bool:
            return (
                chain.seen_attesters.is_known(int(epoch), i)
                or chain.seen_block_attesters.is_known(int(epoch), i)
                or chain.seen_aggregators.is_known(int(epoch), i)
                or chain.seen_block_proposers.is_known(int(epoch), i)
            )

        return {
            "data": [
                {"index": str(int(i)), "is_live": bool(is_live(int(i)))} for i in indices
            ]
        }

    # -- node namespace -------------------------------------------------------

    def get_health(self) -> int:
        return 200

    def get_version(self) -> dict:
        return {"data": {"version": VERSION}}

    def get_syncing_status(self) -> dict:
        head = self.chain.fork_choice.proto_array.get_block(self.chain.fork_choice.head)
        head_slot = head.slot if head else 0
        current = self.chain.fork_choice.current_slot
        return {
            "data": {
                "head_slot": str(head_slot),
                "sync_distance": str(max(0, current - head_slot)),
                "is_syncing": current - head_slot > 3,
                "is_optimistic": False,
            }
        }

    # -- debug / config -------------------------------------------------------

    def get_debug_state_v2(self, state_id: str) -> dict:
        from lodestar_tpu_torch.state_transition.block import fork_of

        st = self._state_at(state_id)
        return {"version": fork_of(st), "data": to_json(st.type, st)}

    def get_spec(self) -> dict:
        """Preset constants PLUS the chain config's fork schedule and
        timing — validator clients derive their signing domains from
        this (reference config/spec includes *_FORK_VERSION/_EPOCH)."""
        p = self.p
        fields = {
            name: str(getattr(p, name))
            for name in type(p).__dataclass_fields__  # type: ignore[attr-defined]
        }
        cfg = self.chain.cfg
        if cfg is not None:
            for name in type(cfg).__dataclass_fields__:  # type: ignore[attr-defined]
                value = getattr(cfg, name)
                fields[name] = "0x" + value.hex() if isinstance(value, bytes) else str(value)
        return {"data": fields}

    def get_fork_schedule(self) -> dict:
        from lodestar_tpu_torch.config import FORK_ORDER

        cfg = self.chain.cfg
        if cfg is None:
            raise ApiError(501, "no chain config bound")
        out = []
        prev = cfg.GENESIS_FORK_VERSION
        for fork in FORK_ORDER:
            epoch = cfg.fork_epoch(fork)
            version = cfg.fork_version(fork)
            out.append(
                {
                    "previous_version": "0x" + prev.hex(),
                    "current_version": "0x" + version.hex(),
                    "epoch": str(epoch),
                }
            )
            prev = version
        return {"data": out}

    def get_deposit_contract(self) -> dict:
        cfg = self.chain.cfg
        chain_id = getattr(cfg, "DEPOSIT_CHAIN_ID", 0) if cfg else 0
        address = getattr(cfg, "DEPOSIT_CONTRACT_ADDRESS", b"\x00" * 20) if cfg else b"\x00" * 20
        if isinstance(address, bytes):
            address = "0x" + address.hex()
        return {"data": {"chain_id": str(chain_id), "address": address}}

    # -- beacon/state extras ---------------------------------------------------

    def get_state_root(self, state_id: str) -> dict:
        st = self._state_at(state_id)
        return {"data": {"root": "0x" + st.type.hash_tree_root(st).hex()}}

    def get_epoch_committees(self, state_id: str, query: dict) -> dict:
        from lodestar_tpu_torch.state_transition import EpochContext

        st = self._state_at(state_id)
        ctx = EpochContext(st, self.p)
        epoch = int(query.get("epoch", ctx.current_epoch))
        if epoch not in (ctx.current_epoch, ctx.previous_epoch, ctx.current_epoch + 1):
            raise ApiError(400, f"epoch {epoch} out of shuffling range")
        want_index = query.get("index")
        want_slot = query.get("slot")
        try:
            sh = ctx._shuffling_at(epoch)
        except ValueError as e:
            raise ApiError(400, f"no shuffling cached for epoch {epoch}: {e}") from e
        out = []
        for slot_i in range(self.p.SLOTS_PER_EPOCH):
            slot = epoch * self.p.SLOTS_PER_EPOCH + slot_i
            if want_slot is not None and int(want_slot) != slot:
                continue
            for c_idx, committee in enumerate(sh.committees[slot_i]):
                if want_index is not None and int(want_index) != c_idx:
                    continue
                out.append(
                    {
                        "index": str(c_idx),
                        "slot": str(slot),
                        "validators": [str(int(v)) for v in committee],
                    }
                )
        return {"data": out, "execution_optimistic": False}

    def get_epoch_sync_committees(self, state_id: str, query: dict) -> dict:
        from lodestar_tpu_torch.state_transition import EpochContext

        st = self._state_at(state_id)
        if not hasattr(st, "current_sync_committee"):
            raise ApiError(400, "state has no sync committees (pre-altair)")
        from lodestar_tpu_torch.params import SYNC_COMMITTEE_SUBNET_COUNT

        idx_map = EpochContext(st, self.p).pubkey_to_index(st)
        indices = []
        for pk in st.current_sync_committee.pubkeys:
            vi = idx_map.get(bytes(pk))
            if vi is None:
                raise ApiError(500, "sync committee pubkey not in validator set")
            indices.append(str(vi))
        sub = self.p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
        return {
            "data": {
                "validators": indices,
                "validator_aggregates": [
                    indices[i : i + sub] for i in range(0, len(indices), sub)
                ],
            },
            "execution_optimistic": False,
        }

    def get_state_validator(self, state_id: str, validator_id: str) -> dict:
        st = self._state_at(state_id)
        epoch = compute_epoch_at_slot(st.slot, self.p)
        if validator_id.startswith("0x"):
            pk = bytes.fromhex(validator_id[2:])
            index = next(
                (i for i, v in enumerate(st.validators) if bytes(v.pubkey) == pk), None
            )
        elif validator_id.isdigit():
            index = int(validator_id)
            if index >= len(st.validators):
                index = None
        else:
            raise ApiError(400, f"bad validator id {validator_id!r}")
        if index is None:
            raise ApiError(404, f"validator {validator_id} not found")
        v = st.validators[index]
        return {
            "data": {
                "index": str(index),
                "balance": str(st.balances[index]),
                "status": _validator_status(v, epoch),
                "validator": to_json(self.t.Validator, v),
            },
            "execution_optimistic": False,
        }

    def get_state_validator_balances(self, state_id: str, query: dict) -> dict:
        st = self._state_at(state_id)
        want = query.get("id")
        if want:
            ids = []
            for token in want.split(","):
                if token.startswith("0x"):
                    pk = bytes.fromhex(token[2:])
                    idx = next(
                        (i for i, v in enumerate(st.validators) if bytes(v.pubkey) == pk),
                        None,
                    )
                    if idx is not None:
                        ids.append(idx)
                elif token.isdigit():
                    ids.append(int(token))
                else:
                    raise ApiError(400, f"bad validator id {token!r}")
            ids = sorted(set(ids))
        else:
            ids = range(len(st.validators))
        return {
            "data": [
                {"index": str(i), "balance": str(st.balances[i])}
                for i in ids
                if i < len(st.validators)
            ]
        }

    # -- beacon/block extras ---------------------------------------------------

    def get_block_root(self, block_id: str) -> dict:
        return {
            "data": {"root": "0x" + self._block_root(block_id).hex()},
            "execution_optimistic": False,
        }

    def get_block_attestations(self, block_id: str) -> dict:
        signed = self.chain.get_block_by_root(self._block_root(block_id))
        if signed is None:
            raise ApiError(404, f"block {block_id} not found")
        return {
            "data": [
                to_json(self.t.Attestation, a) for a in signed.message.body.attestations
            ],
            "execution_optimistic": False,
        }

    def get_block_headers(self, query: dict) -> dict:
        """GET /eth/v1/beacon/headers?slot=&parent_root= — canonical chain
        walk filtered by the query (reference block.ts getBlockHeaders)."""
        slot = query.get("slot")
        parent_root = query.get("parent_root")
        fc = self.chain.fork_choice.proto_array
        node = fc.get_block(self.chain.fork_choice.head)
        out = []
        while node is not None:
            keep = True
            if slot is not None and node.slot != int(slot):
                keep = False
            if parent_root is not None and node.parent_root != parent_root:
                keep = False
            if keep:
                try:
                    out.append(self.get_block_header(node.block_root)["data"])
                except ApiError:
                    pass  # anchor node: no stored block behind the root
            if slot is not None and node.slot < int(slot):
                break
            node = fc.nodes[node.parent] if node.parent is not None else None
        return {"data": out, "execution_optimistic": False}

    # -- beacon/pool full surface ----------------------------------------------

    def get_pool_attestations(self) -> dict:
        pool = self.chain.attestation_pool
        out = []
        for slot, by_root in pool._by_slot.items():
            for root in by_root:
                agg = pool.get_aggregate(slot, root)
                if agg is not None:
                    out.append(to_json(self.t.Attestation, agg))
        return {"data": out}

    def get_pool_attester_slashings(self) -> dict:
        return {
            "data": [
                to_json(self.t.AttesterSlashing, s)
                for s in self.chain.op_pool._attester_slashings.values()
            ]
        }

    def get_pool_proposer_slashings(self) -> dict:
        return {
            "data": [
                to_json(self.t.ProposerSlashing, s)
                for s in self.chain.op_pool._proposer_slashings.values()
            ]
        }

    def get_pool_voluntary_exits(self) -> dict:
        return {
            "data": [
                to_json(self.t.SignedVoluntaryExit, e)
                for e in self.chain.op_pool._exits.values()
            ]
        }

    def get_pool_bls_changes(self) -> dict:
        return {
            "data": [
                to_json(self.t.SignedBLSToExecutionChange, c)
                for c in self.chain.op_pool._bls_changes.values()
            ]
        }

    def _submit_pool_op(self, body, type_name: str, apply_fn, insert) -> dict:
        """Decode, validate by applying the operation (with signature
        verification) to a COPY of the head state — the reference's pool
        routes run the same state-transition checks — then insert."""
        t = getattr(self.t, type_name, None)
        if t is None:
            raise ApiError(400, f"{type_name} not supported by the active fork set")
        try:
            op = from_json(t, body)
        except (KeyError, TypeError, ValueError) as e:
            raise ApiError(400, f"malformed {type_name}: {e}") from e
        from lodestar_tpu_torch.state_transition import EpochContext

        st = self.chain.get_head_state().copy()
        try:
            apply_fn(st, op, EpochContext(st, self.p))
        except Exception as e:
            raise ApiError(400, f"invalid {type_name}: {e}") from e
        insert(op)
        return {}

    def submit_pool_attester_slashing(self, body) -> dict:
        from lodestar_tpu_torch.state_transition.block import process_attester_slashing

        def insert(op):
            root = self.t.AttesterSlashing.hash_tree_root(op)
            self.chain.op_pool.insert_attester_slashing(op, root)

        return self._submit_pool_op(
            body, "AttesterSlashing",
            lambda s, op, ctx: process_attester_slashing(
                s, op, ctx, verify_signatures=True, cfg=self.chain.cfg
            ),
            insert,
        )

    def submit_pool_proposer_slashing(self, body) -> dict:
        from lodestar_tpu_torch.state_transition.block import process_proposer_slashing

        return self._submit_pool_op(
            body, "ProposerSlashing",
            lambda s, op, ctx: process_proposer_slashing(
                s, op, ctx, verify_signatures=True, cfg=self.chain.cfg
            ),
            self.chain.op_pool.insert_proposer_slashing,
        )

    def submit_pool_voluntary_exit(self, body) -> dict:
        from lodestar_tpu_torch.state_transition.block import process_voluntary_exit

        return self._submit_pool_op(
            body, "SignedVoluntaryExit",
            lambda s, op, ctx: process_voluntary_exit(
                s, op, ctx, verify_signatures=True, cfg=self.chain.cfg
            ),
            self.chain.op_pool.insert_voluntary_exit,
        )

    def submit_pool_bls_change(self, body) -> dict:
        from lodestar_tpu_torch.state_transition.capella import process_bls_to_execution_change

        return self._submit_pool_op(
            body, "SignedBLSToExecutionChange",
            lambda s, op, ctx: process_bls_to_execution_change(
                s, op, ctx, cfg=self.chain.cfg
            ),
            self.chain.op_pool.insert_bls_to_execution_change,
        )

    def submit_pool_sync_committees(self, body: list) -> dict:
        """POST /eth/v1/beacon/pool/sync_committees (validator client
        submits SyncCommitteeMessages). Subnet is derived from the
        validator's subcommittee membership."""
        from lodestar_tpu_torch.chain.validation import (
            GossipValidationError,
            validate_sync_committee_message,
        )
        from lodestar_tpu_torch.params import SYNC_COMMITTEE_SUBNET_COUNT

        errors = []

        async def run():
            for i, msg_json in enumerate(body):
                try:
                    msg = from_json(self.t.SyncCommitteeMessage, msg_json)
                except (KeyError, TypeError, ValueError) as e:
                    errors.append({"index": i, "message": f"malformed message: {e}"})
                    continue
                # a validator can hold seats in SEVERAL subcommittees
                # (sampled with replacement): record every subnet it
                # belongs to; duplicate submissions dedupe via the
                # seen-cache and are not errors
                accepted = seen_dup = False
                last_err = "validator not in any subcommittee"
                for subnet in range(SYNC_COMMITTEE_SUBNET_COUNT):
                    try:
                        res = validate_sync_committee_message(self.chain, msg, subnet)
                    except GossipValidationError as e:
                        if "already seen" in str(e):
                            seen_dup = True
                        else:
                            last_err = str(e)
                        continue
                    if not await self.chain.bls.verify_signature_sets(res.signature_sets, _API_VERIFY_OPTS):
                        last_err = "invalid signature"
                        break
                    res.register_seen()
                    for pos in res.indices_in_subcommittee:
                        self.chain.sync_committee_message_pool.add(subnet, msg, pos)
                    accepted = True
                if not accepted and not seen_dup:
                    errors.append({"index": i, "message": last_err})

        self._run_async(run())
        if errors:
            raise ApiError(400, f"some messages failed: {errors}")
        return {}

    # -- node namespace extras -------------------------------------------------

    def _network(self):
        return getattr(self.chain, "network", None)

    def get_node_identity(self) -> dict:
        net = self._network()
        peer_id = net.peer_id if net else "unknown"
        addrs = (
            [f"/ip4/127.0.0.1/tcp/{net.host.listen_port}/p2p/{peer_id}"] if net else []
        )
        return {
            "data": {
                "peer_id": peer_id,
                "enr": "",
                "p2p_addresses": addrs,
                "discovery_addresses": [],
                "metadata": {"seq_number": "0", "attnets": "0x" + "00" * 8},
            }
        }

    def get_node_peers(self, query: dict) -> dict:
        net = self._network()
        peers = []
        if net is not None:
            for pid, conn in net.host.connections.items():
                peers.append(
                    {
                        "peer_id": pid,
                        "enr": "",
                        "last_seen_p2p_address": f"/ip4/{conn.addr[0]}/tcp/{conn.addr[1]}"
                        if conn.addr
                        else "",
                        "state": "connected",
                        "direction": "outbound" if conn.mux._initiator else "inbound",
                    }
                )
        return {"data": peers, "meta": {"count": len(peers)}}

    def get_node_peer(self, peer_id: str) -> dict:
        peers = self.get_node_peers({})["data"]
        for p in peers:
            if p["peer_id"] == peer_id:
                return {"data": p}
        raise ApiError(404, f"peer {peer_id} not known")

    def get_node_peer_count(self) -> dict:
        net = self._network()
        n = len(net.host.connections) if net else 0
        return {
            "data": {
                "disconnected": "0",
                "connecting": "0",
                "connected": str(n),
                "disconnecting": "0",
            }
        }

    # -- light-client REST (reference routes/lightclient.ts) -------------------

    def _lc(self):
        server = self.chain.light_client_server
        if server is None:
            raise ApiError(404, "light-client server not enabled")
        return server

    def get_lc_bootstrap(self, block_root: str) -> dict:
        bootstrap = self._lc().get_bootstrap(bytes.fromhex(block_root[2:]))
        if bootstrap is None:
            raise ApiError(404, "bootstrap unavailable for that root")
        return {"data": to_json(self.t.LightClientBootstrap, bootstrap)}

    def get_lc_updates(self, query: dict) -> dict:
        start = int(query.get("start_period", 0))
        count = min(int(query.get("count", 1)), 128)
        updates = self._lc().get_updates(start, count)
        return {
            "data": [
                {"version": "altair", "data": to_json(self.t.LightClientUpdate, u)}
                for u in updates
            ]
        }

    def get_lc_optimistic_update(self) -> dict:
        u = self._lc().get_optimistic_update()
        if u is None:
            raise ApiError(404, "no optimistic update")
        return {"version": "altair", "data": to_json(self.t.LightClientOptimisticUpdate, u)}

    def get_lc_finality_update(self) -> dict:
        u = self._lc().get_finality_update()
        if u is None:
            raise ApiError(404, "no finality update")
        return {"version": "altair", "data": to_json(self.t.LightClientFinalityUpdate, u)}

    # -- proof namespace (reference routes/proof.ts, v0) -----------------------

    def get_state_proof(self, state_id: str, query: dict) -> dict:
        """Single-leaf merkle proofs by generalized index
        (?gindex=N[,N...]), from the state's merkle tree."""
        from lodestar_tpu_torch.ssz.tree import merkle_proof

        st = self._state_at(state_id)
        gindices = [int(g) for g in str(query.get("gindex", "")).split(",") if g]
        if not gindices:
            raise ApiError(400, "gindex query parameter required")
        proofs = []
        for g in gindices:
            leaf, branch = merkle_proof(st.type, st, g)
            proofs.append(
                {
                    "gindex": str(g),
                    "leaf": "0x" + leaf.hex(),
                    "branch": ["0x" + b.hex() for b in branch],
                }
            )
        return {"data": {"root": "0x" + st.type.hash_tree_root(st).hex(), "proofs": proofs}}

    # -- validator namespace extras --------------------------------------------

    def get_sync_committee_duties(self, epoch: int, indices: list[int]) -> dict:
        """POST /eth/v1/validator/duties/sync/{epoch} — one entry per
        validator carrying ALL its committee positions. An epoch in the
        NEXT sync-committee period serves from next_sync_committee (the
        lookahead clients use to subscribe subnets before the boundary)."""
        from lodestar_tpu_torch.state_transition import EpochContext

        st = self.chain.get_head_state()
        if not hasattr(st, "current_sync_committee"):
            return {"data": []}
        period_epochs = self.p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
        head_period = (int(st.slot) // self.p.SLOTS_PER_EPOCH) // period_epochs
        req_period = int(epoch) // period_epochs
        if req_period == head_period:
            committee = st.current_sync_committee
        elif req_period == head_period + 1:
            committee = st.next_sync_committee
        else:
            raise ApiError(400, f"epoch {epoch} outside the known committee periods")
        want = set(int(i) for i in indices)
        positions: dict[int, list[int]] = {}
        pk_of: dict[int, bytes] = {}
        idx_map = EpochContext(st, self.p).pubkey_to_index(st)
        for pos, pk in enumerate(bytes(p) for p in committee.pubkeys):
            vi = idx_map.get(pk)
            if vi is not None and vi in want:
                positions.setdefault(vi, []).append(pos)
                pk_of[vi] = pk
        return {
            "data": [
                {
                    "pubkey": "0x" + pk_of[vi].hex(),
                    "validator_index": str(vi),
                    "validator_sync_committee_indices": [str(p) for p in poss],
                }
                for vi, poss in sorted(positions.items())
            ]
        }

    def get_aggregated_attestation(self, query: dict) -> dict:
        slot = int(query["slot"])
        root = bytes.fromhex(str(query["attestation_data_root"])[2:])
        agg = self.chain.attestation_pool.get_aggregate(slot, root)
        if agg is None:
            raise ApiError(404, "no aggregate for that attestation data")
        return {"data": to_json(self.t.Attestation, agg)}

    def publish_aggregate_and_proofs(self, body: list) -> dict:
        from lodestar_tpu_torch.chain.validation import (
            GossipValidationError,
            validate_gossip_aggregate_and_proof,
        )
        from lodestar_tpu_torch.network.processor import import_verified_attestation

        errors = []

        async def run():
            for i, item in enumerate(body):
                agg = from_json(self.t.SignedAggregateAndProof, item)
                try:
                    res = validate_gossip_aggregate_and_proof(self.chain, agg)
                except GossipValidationError as e:
                    errors.append({"index": i, "message": str(e)})
                    continue
                if not await self.chain.bls.verify_signature_sets(res.signature_sets, _API_VERIFY_OPTS):
                    errors.append({"index": i, "message": "invalid signatures"})
                    continue
                import_verified_attestation(
                    self.chain, res, agg.message.aggregate, aggregated=True
                )

        self._run_async(run())
        if errors:
            raise ApiError(400, f"some aggregates failed: {errors}")
        return {}

    def produce_sync_committee_contribution(self, query: dict) -> dict:
        slot = int(query["slot"])
        subnet = int(query["subcommittee_index"])
        root = bytes.fromhex(str(query["beacon_block_root"])[2:])
        contribution = self.chain.sync_committee_message_pool.get_contribution(
            subnet, slot, root
        )
        if contribution is None:
            raise ApiError(404, "no contribution available")
        return {"data": to_json(self.t.SyncCommitteeContribution, contribution)}

    def publish_contribution_and_proofs(self, body: list) -> dict:
        from lodestar_tpu_torch.chain.validation import (
            GossipValidationError,
            validate_sync_committee_contribution,
        )

        errors = []

        async def run():
            for i, item in enumerate(body):
                signed = from_json(self.t.SignedContributionAndProof, item)
                try:
                    res = validate_sync_committee_contribution(self.chain, signed)
                except GossipValidationError as e:
                    errors.append({"index": i, "message": str(e)})
                    continue
                if not await self.chain.bls.verify_signature_sets(res.signature_sets, _API_VERIFY_OPTS):
                    errors.append({"index": i, "message": "invalid signatures"})
                    continue
                res.register_seen()
                self.chain.sync_contribution_pool.add(signed.message)

        self._run_async(run())
        if errors:
            raise ApiError(400, f"some contributions failed: {errors}")
        return {}

    def prepare_beacon_committee_subnet(self, body: list) -> dict:
        subnets = getattr(self.chain, "attnets", None)
        if subnets is not None:
            for sub in body:
                try:
                    subnets.subscribe_committee_subnet(
                        int(sub["committee_index"]),
                        int(sub["slot"]),
                        bool(sub.get("is_aggregator", False)),
                    )
                except (AttributeError, KeyError, TypeError):
                    pass
        return {}

    def prepare_sync_committee_subnets(self, body: list) -> dict:
        return {}

    def prepare_beacon_proposer(self, body: list) -> dict:
        store = getattr(self.chain, "proposer_preparation", None)
        if store is None:
            store = self.chain.proposer_preparation = {}
        for item in body:
            store[int(item["validator_index"])] = item["fee_recipient"]
        return {}

    def register_validator(self, body: list) -> dict:
        store = getattr(self.chain, "validator_registrations", None)
        if store is None:
            store = self.chain.validator_registrations = {}
        for item in body:
            pk = item.get("message", {}).get("pubkey")
            if pk:
                store[pk] = item
        return {}

    # -- debug extras ----------------------------------------------------------

    def get_debug_chain_heads(self) -> dict:
        fc = self.chain.fork_choice.proto_array
        heads = []
        children = {n.parent for n in fc.nodes if n.parent is not None}
        for i, node in enumerate(fc.nodes):
            if i not in children:
                heads.append(
                    {"root": node.block_root, "slot": str(node.slot),
                     "execution_optimistic": False}
                )
        return {"data": heads}

    def get_slot_traces(self, slot: str, fmt: str = "json") -> dict:
        """Completed pipeline traces for a slot from the tracer's ring
        buffer (`lodestar_tpu_torch/tracing`). fmt="chrome" returns one Chrome
        `trace_event` document — UNWRAPPED (no {"data"} envelope), so a
        curl'd response loads in chrome://tracing/Perfetto as-is."""
        from lodestar_tpu_torch import tracing

        traces = tracing.get_tracer().traces_for_slot(int(slot))
        if fmt == "chrome":
            from lodestar_tpu_torch.tracing.export import to_chrome_trace

            return to_chrome_trace(traces)
        return {"data": [t.to_dict() for t in traces]}

    def get_recent_traces(self, count: int = 16) -> dict:
        """The newest completed traces in the ring, oldest first."""
        from lodestar_tpu_torch import tracing

        traces = tracing.get_tracer().recent_traces(count)
        return {"data": [t.to_dict() for t in traces]}

    def get_debug_launches(self, count: int = 64, program: str | None = None) -> dict:
        """The device launch ledger (`lodestar_tpu_torch/telemetry.py`): the
        trailing `count` dispatches at the counted launch seams, plus
        the cumulative totals — a slow slot's launches by name without
        waiting for a Prometheus scrape. `program` narrows the ledger
        view to one dispatch seam (chip-run triage of a single program);
        an unknown name is a 400, not an empty list — a typo'd filter
        must not read as 'that program never launched'."""
        from lodestar_tpu_torch import telemetry

        entries = telemetry.launch_ledger(max(0, count))
        if program is not None:
            known = telemetry.known_programs()
            if program not in known:
                raise ApiError(
                    400,
                    f"unknown program {program!r}; launched so far: "
                    f"{sorted(known) or '(none)'}",
                )
            entries = [e for e in entries if e["program"] == program]
        return {
            "data": {
                "mode_active": telemetry.launch_telemetry_active(),
                "totals": telemetry.launch_totals(),
                "launches": entries,
            }
        }

    def get_debug_slo(self) -> dict:
        """The slot-deadline SLO view (`lodestar_tpu_torch/slo`): per-class
        wait-budget decomposition (buffer/queue/stage/launch quantiles
        whose legs partition the end-to-end span), SLI counters, and
        the live per-class slack snapshot — the machine-readable
        wait-budget profile the batch former consumes
        (`tools/wait_budget_profile.py`)."""
        from lodestar_tpu_torch import slo

        return {"data": slo.debug_view()}

    def get_fork_choice_nodes(self) -> dict:
        fc = self.chain.fork_choice.proto_array
        return {
            "data": [
                {
                    "slot": str(n.slot),
                    "block_root": n.block_root,
                    "parent_root": fc.nodes[n.parent].block_root
                    if n.parent is not None
                    else None,
                    "justified_epoch": str(n.justified_epoch),
                    "finalized_epoch": str(n.finalized_epoch),
                    "weight": str(getattr(n, "weight", 0)),
                    "best_child": None,
                    "best_descendant": None,
                }
                for n in fc.nodes
            ]
        }


def _validator_status(v, epoch: int) -> str:
    from lodestar_tpu_torch.params import FAR_FUTURE_EPOCH

    if v.activation_epoch > epoch:
        return "pending_queued" if v.activation_eligibility_epoch != FAR_FUTURE_EPOCH else "pending_initialized"
    if epoch < v.exit_epoch:
        return "active_slashed" if v.slashed else "active_ongoing"
    if epoch < v.withdrawable_epoch:
        return "exited_slashed" if v.slashed else "exited_unslashed"
    return "withdrawal_possible"


# --- events namespace (SSE) ---------------------------------------------------
# Reference `beacon-node/src/api/impl/events/index.ts`: subscribe chain
# emitter topics, forward as Server-Sent Events. The REST server streams
# an EventStream return value instead of JSON-encoding it.

EVENT_TOPICS = ("head", "block", "finalized_checkpoint")


class EventStream:
    """Thread-safe queue of (event_type, payload_dict) fed by chain
    events; the HTTP handler drains it as an SSE body. `close()`
    detaches the chain subscriptions."""

    def __init__(self, queue, unsubscribe):
        self.queue = queue
        self._unsubscribe = unsubscribe

    def close(self) -> None:
        self._unsubscribe()

