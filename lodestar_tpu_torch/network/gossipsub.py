"""Gossipsub v1.1 over the libp2p host (reference `network/gossip/
gossipsub.ts:74` — js-libp2p-gossipsub with lodestar's eth2 tuning).

Wire: the pubsub RPC protobuf on `/meshsub/1.1.0` streams, one
varint-length-delimited RPC per frame. Eth2 runs StrictNoSign: messages
carry only (topic, data); the message id is the SHA-256 spec id of
`network/gossip.py::compute_message_id`.

Mechanics implemented (the v1.1 core the reference relies on):

* per-topic MESH of D peers (D=8, D_lo=6, D_hi=12 — lodestar's
  gossipsub defaults), maintained by a 700 ms heartbeat
* GRAFT/PRUNE control messages with PRUNE backoff
* gossip: IHAVE of recent message ids to D_lazy non-mesh peers each
  heartbeat; IWANT answering from the message cache
* message cache: `mcache_gossip`=3 windows advertised, `mcache_len`=6
  kept for IWANT service
* seen-id dedup with TTL
* PER-TOPIC peer scoring (decaying counters): P1 time-in-mesh, P2
  first deliveries, P3 mesh-delivery-rate deficit (squared) with
  activation + duplicate window, P3b sticky mesh-failure penalty
  captured at prune, P4 invalid messages — each weighted by
  `TopicScoreParams` (eth2 kinds via `eth2_topic_score_params`,
  reference `scoringParameters.ts:124-148`) — plus the global P7
  behaviour penalty and the gossip/publish/graylist thresholds.
  Scores gate mesh admission, gossip emission and (below graylist)
  RPC processing.

Validation: the node wires `set_validator(fn)`; `fn(topic, raw_payload,
peer) -> (verdict, ssz_bytes)` with verdict in "accept" | "ignore" |
"reject" decides propagation exactly like the reference's
validate-then-propagate pipeline ("reject" applies the P4
invalid-message penalty); the returned ssz bytes (decompressed by the
validator) are what subscribers receive.

The port of `lodestar_tpu.network.gossipsub` (host Python, as there).
"""

from __future__ import annotations

import asyncio
import time

from lodestar_tpu_torch.logger import get_logger
from lodestar_tpu_torch.utils.snappy import compress

from .gossip import compute_message_id

__all__ = ["GossipSub", "GossipParams", "TopicScoreParams", "eth2_topic_score_params"]

PROTOCOL_ID = "/meshsub/1.1.0"


# --- minimal protobuf codec for the pubsub RPC --------------------------------


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _rv(buf: bytes, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _field(num: int, data: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(data)) + data


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _rv(buf, pos)
        num, wt = tag >> 3, tag & 7
        if wt == 2:
            ln, pos = _rv(buf, pos)
            yield num, buf[pos : pos + ln]
            pos += ln
        elif wt == 0:
            val, pos = _rv(buf, pos)
            yield num, val
        else:
            raise ValueError(f"unsupported wire type {wt}")


def encode_rpc(
    subscriptions: list[tuple[bool, str]] = (),
    publish: list[tuple[str, bytes]] = (),
    ihave: list[tuple[str, list[bytes]]] = (),
    iwant: list[bytes] = (),
    graft: list[str] = (),
    prune: list[tuple[str, int]] = (),
) -> bytes:
    out = b""
    for sub, topic in subscriptions:
        body = (b"\x08\x01" if sub else b"\x08\x00") + _field(2, topic.encode())
        out += _field(1, body)
    for topic, data in publish:
        # Message{data=2, topic=4}; from/seqno/signature absent (StrictNoSign)
        out += _field(2, _field(2, data) + _field(4, topic.encode()))
    control = b""
    for topic, ids in ihave:
        body = _field(1, topic.encode()) + b"".join(_field(2, i) for i in ids)
        control += _field(1, body)
    if iwant:
        control += _field(2, b"".join(_field(1, i) for i in iwant))
    for topic in graft:
        control += _field(3, _field(1, topic.encode()))
    for topic, backoff in prune:
        control += _field(4, _field(1, topic.encode()) + b"\x18" + _varint(backoff))
    if control:
        out += _field(3, control)
    return out


def decode_rpc(buf: bytes) -> dict:
    out = {"subscriptions": [], "publish": [], "ihave": [], "iwant": [], "graft": [], "prune": []}
    for num, val in _iter_fields(buf):
        if num == 1:  # SubOpts
            sub, topic = True, ""
            for fn, fv in _iter_fields(val):
                if fn == 1:
                    sub = bool(fv)
                elif fn == 2:
                    topic = fv.decode()
            out["subscriptions"].append((sub, topic))
        elif num == 2:  # Message
            topic, data = "", b""
            for fn, fv in _iter_fields(val):
                if fn == 2:
                    data = fv
                elif fn == 4:
                    topic = fv.decode()
            out["publish"].append((topic, data))
        elif num == 3:  # ControlMessage
            for fn, fv in _iter_fields(val):
                if fn == 1:  # IHAVE
                    topic, ids = "", []
                    for gn, gv in _iter_fields(fv):
                        if gn == 1:
                            topic = gv.decode()
                        elif gn == 2:
                            ids.append(gv)
                    out["ihave"].append((topic, ids))
                elif fn == 2:  # IWANT
                    for gn, gv in _iter_fields(fv):
                        if gn == 1:
                            out["iwant"].append(gv)
                elif fn == 3:  # GRAFT
                    for gn, gv in _iter_fields(fv):
                        if gn == 1:
                            out["graft"].append(gv.decode())
                elif fn == 4:  # PRUNE
                    topic, backoff = "", 60
                    for gn, gv in _iter_fields(fv):
                        if gn == 1:
                            topic = gv.decode()
                        elif gn == 3:
                            backoff = gv
                    out["prune"].append((topic, backoff))
    return out


# --- scoring ------------------------------------------------------------------


class GossipParams:
    """Lodestar's gossipsub tuning (`gossipsub.ts` + `scoringParameters.ts`)."""

    D = 8
    D_LO = 6
    D_HI = 12
    D_LAZY = 6
    HEARTBEAT_SEC = 0.7
    MCACHE_LEN = 6  # windows kept for IWANT service
    MCACHE_GOSSIP = 3  # windows advertised in IHAVE
    SEEN_TTL_SEC = 385.0  # SLOTS_PER_EPOCH * SECONDS_PER_SLOT on mainnet
    RETAIN_SCORE_SEC = 3600.0  # hour-scale (reference retainScore): a
    # penalized peer must not wash its score by briefly disconnecting
    PRUNE_BACKOFF_SEC = 60
    # score thresholds (scoringParameters.ts gossipThreshold etc.)
    GOSSIP_THRESHOLD = -4000.0
    PUBLISH_THRESHOLD = -8000.0
    GRAYLIST_THRESHOLD = -16000.0
    # weights/decay for the implemented counters
    TIME_IN_MESH_WEIGHT = 0.03333
    TIME_IN_MESH_CAP = 300.0
    FIRST_DELIVERY_WEIGHT = 1.0
    FIRST_DELIVERY_CAP = 100.0
    INVALID_MESSAGE_WEIGHT = -100.0
    BEHAVIOUR_PENALTY_WEIGHT = -15.9
    DECAY = 0.96


class TopicScoreParams:
    """Per-topic scoring weights (reference `scoringParameters.ts`
    TopicScoreParams, computed per topic kind at `:124-148`). Defaults
    reproduce the pre-r5 global behavior (no mesh-delivery penalty)."""

    __slots__ = (
        "topic_weight",
        "time_in_mesh_weight", "time_in_mesh_cap",
        "first_deliveries_weight", "first_deliveries_cap", "first_deliveries_decay",
        "mesh_deliveries_weight", "mesh_deliveries_threshold",
        "mesh_deliveries_cap", "mesh_deliveries_decay",
        "mesh_deliveries_activation_sec", "mesh_deliveries_window_sec",
        "mesh_failure_weight", "mesh_failure_decay",
        "invalid_weight", "invalid_decay",
    )

    def __init__(self, **kw):
        self.topic_weight = 1.0
        self.time_in_mesh_weight = 0.03333
        self.time_in_mesh_cap = 300.0
        self.first_deliveries_weight = 1.0
        self.first_deliveries_cap = 100.0
        self.first_deliveries_decay = 0.96
        # P3 mesh message delivery rate: a mesh peer that delivers fewer
        # than `threshold` messages per decay window (after `activation`
        # seconds in mesh) accrues a squared deficit penalty
        self.mesh_deliveries_weight = 0.0  # off unless a kind enables it
        self.mesh_deliveries_threshold = 0.0
        self.mesh_deliveries_cap = 100.0
        self.mesh_deliveries_decay = 0.96
        self.mesh_deliveries_activation_sec = 10.0
        self.mesh_deliveries_window_sec = 2.0
        # P3b sticky mesh-failure penalty (deficit^2 captured at prune)
        self.mesh_failure_weight = 0.0
        self.mesh_failure_decay = 0.9
        self.invalid_weight = -100.0
        self.invalid_decay = 0.96
        for k, v in kw.items():
            setattr(self, k, v)


def eth2_topic_score_params(kind: str) -> TopicScoreParams:
    """Eth2 per-kind params, shaped after the reference's generated table
    (`scoringParameters.ts:124-148`): block/aggregate topics carry heavy
    weight with mesh-delivery penalties; the 64 attestation subnets split
    one unit of weight; ephemeral low-rate topics score deliveries only."""
    if kind in ("beacon_block", "beacon_block_and_blobs_sidecar"):
        return TopicScoreParams(
            topic_weight=0.5,
            mesh_deliveries_weight=-0.5, mesh_deliveries_threshold=3.0,
            mesh_failure_weight=-0.5,
        )
    if kind == "beacon_aggregate_and_proof":
        return TopicScoreParams(
            topic_weight=0.5,
            mesh_deliveries_weight=-0.1, mesh_deliveries_threshold=8.0,
            mesh_failure_weight=-0.1,
        )
    if kind.startswith("beacon_attestation"):
        return TopicScoreParams(
            topic_weight=1.0 / 64.0,
            mesh_deliveries_weight=-0.02, mesh_deliveries_threshold=4.0,
            mesh_failure_weight=-0.02,
        )
    if kind.startswith("sync_committee"):
        return TopicScoreParams(topic_weight=1.0 / 4.0)
    # voluntary_exit / slashings / light-client: rare messages, P2 only
    return TopicScoreParams(topic_weight=0.05)


class _TopicStats:
    __slots__ = ("mesh_since", "first_deliveries", "mesh_deliveries", "mesh_failure", "invalid")

    def __init__(self):
        self.mesh_since: float | None = None
        self.first_deliveries = 0.0
        self.mesh_deliveries = 0.0
        self.mesh_failure = 0.0
        self.invalid = 0.0


_DEFAULT_TOPIC_PARAMS = TopicScoreParams()


class _PeerScore:
    def __init__(self):
        self.topics: dict[str, _TopicStats] = {}
        self.behaviour = 0.0
        self.disconnected_at: float | None = None

    def topic(self, t: str) -> _TopicStats:
        ts = self.topics.get(t)
        if ts is None:
            ts = self.topics[t] = _TopicStats()
        return ts

    def graft(self, topic: str, now: float) -> None:
        ts = self.topic(topic)
        if ts.mesh_since is None:
            ts.mesh_since = now
            ts.mesh_deliveries = 0.0

    def prune(self, topic: str, params: TopicScoreParams, now: float) -> None:
        """Leave the mesh for `topic`, capturing the P3b sticky penalty if
        the peer was under-delivering (gossipsub v1.1 spec / reference
        meshFailurePenalty)."""
        ts = self.topics.get(topic)
        if ts is None or ts.mesh_since is None:
            return
        if (
            params.mesh_deliveries_weight != 0.0
            and now - ts.mesh_since >= params.mesh_deliveries_activation_sec
        ):
            deficit = max(0.0, params.mesh_deliveries_threshold - ts.mesh_deliveries)
            ts.mesh_failure += deficit * deficit
        ts.mesh_since = None
        ts.mesh_deliveries = 0.0

    def decay(self, p: GossipParams, params_for: "callable") -> None:
        self.behaviour *= p.DECAY
        for t, ts in self.topics.items():
            tp = params_for(t)
            ts.first_deliveries *= tp.first_deliveries_decay
            ts.mesh_deliveries *= tp.mesh_deliveries_decay
            ts.mesh_failure *= tp.mesh_failure_decay
            ts.invalid *= tp.invalid_decay

    def value(self, p: GossipParams, now: float, params_for: "callable") -> float:
        s = 0.0
        for t, ts in self.topics.items():
            tp = params_for(t)
            topic_score = 0.0
            if ts.mesh_since is not None:
                topic_score += (
                    min(now - ts.mesh_since, tp.time_in_mesh_cap)
                    * tp.time_in_mesh_weight
                )
                # P3: squared delivery deficit while activated in mesh
                if (
                    tp.mesh_deliveries_weight != 0.0
                    and now - ts.mesh_since >= tp.mesh_deliveries_activation_sec
                    and ts.mesh_deliveries < tp.mesh_deliveries_threshold
                ):
                    deficit = tp.mesh_deliveries_threshold - ts.mesh_deliveries
                    topic_score += deficit * deficit * tp.mesh_deliveries_weight
            topic_score += (
                min(ts.first_deliveries, tp.first_deliveries_cap)
                * tp.first_deliveries_weight
            )
            topic_score += ts.mesh_failure * tp.mesh_failure_weight  # P3b
            topic_score += ts.invalid * ts.invalid * tp.invalid_weight  # P4
            s += topic_score * tp.topic_weight
        s += self.behaviour * self.behaviour * p.BEHAVIOUR_PENALTY_WEIGHT  # P7
        return s


# --- the router ---------------------------------------------------------------


class GossipSub:
    def __init__(self, host, *, params: GossipParams | None = None, time_fn=time.monotonic):
        self.host = host
        self.p = params or GossipParams()
        self.now = time_fn
        self.log = get_logger(name="lodestar.network.gossipsub")
        self.topics: set[str] = set()  # our subscriptions
        self.peer_topics: dict[str, set[str]] = {}  # peer -> their subscriptions
        self.mesh: dict[str, set[str]] = {}  # topic -> grafted peers
        self.fanout: dict[str, set[str]] = {}
        self.backoff: dict[tuple[str, str], float] = {}  # (topic, peer) -> until
        self.scores: dict[str, _PeerScore] = {}
        self.topic_params: dict[str, TopicScoreParams] = {}
        self.seen: dict[bytes, float] = {}  # msg id -> first-seen time
        self.mcache: list[list[tuple[bytes, str, bytes]]] = [[]]  # windows of (id, topic, raw)
        self.mcache_index: dict[bytes, tuple[str, bytes]] = {}
        self._streams: dict[str, object] = {}  # peer -> outbound stream
        self._validator = None  # fn(topic, ssz_bytes, peer) -> accept|ignore|reject
        self._subscribers: dict[str, list] = {}  # topic -> [async handler(ssz, peer)]
        self._hb_task: asyncio.Task | None = None
        self.metrics = {"delivered": 0, "duplicates": 0, "rejected": 0, "iwant_served": 0}

        host.set_handler(PROTOCOL_ID, self._on_inbound_stream)
        prev_connect = host.on_peer_connect

        async def on_connect(peer_id):
            if prev_connect is not None:
                await prev_connect(peer_id)
            await self._on_peer(peer_id)

        host.on_peer_connect = on_connect
        prev_dc = host.on_peer_disconnect

        async def on_dc(peer_id):
            if prev_dc is not None:
                await prev_dc(peer_id)
            self._drop_peer(peer_id)

        host.on_peer_disconnect = on_dc

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        if self._hb_task is None:
            self._hb_task = asyncio.ensure_future(self._heartbeat_loop())

    async def stop(self) -> None:
        if self._hb_task is not None:
            self._hb_task.cancel()
            try:
                await self._hb_task
            except (asyncio.CancelledError, Exception):
                pass
            self._hb_task = None

    def set_validator(self, fn) -> None:
        self._validator = fn

    # -- peer/stream plumbing --------------------------------------------------

    async def _on_peer(self, peer_id: str) -> None:
        """New connection: open our outbound RPC stream, announce subs."""
        sc = self.scores.setdefault(peer_id, _PeerScore())
        sc.disconnected_at = None
        try:
            stream = await self.host.new_stream(peer_id, PROTOCOL_ID)
        except Exception as e:
            self.log.debug(f"gossipsub stream to {peer_id[:8]} failed: {e}")
            return
        self._streams[peer_id] = stream
        if self.topics:
            await self._send_rpc(peer_id, encode_rpc(
                subscriptions=[(True, t) for t in sorted(self.topics)]
            ))

    def _drop_peer(self, peer_id: str) -> None:
        self._streams.pop(peer_id, None)
        self.peer_topics.pop(peer_id, None)
        for topic, peers in self.mesh.items():
            if peer_id in peers:
                # P3b capture + mesh_since reset: without the prune() the
                # score would keep charging a frozen delivery deficit and
                # permanently reject the peer on reconnect
                self._mesh_remove(peer_id, topic)
        for peers in self.fanout.values():
            peers.discard(peer_id)
        sc = self.scores.get(peer_id)
        if sc is not None:
            sc.disconnected_at = self.now()

    async def _send_rpc(self, peer_id: str, rpc: bytes) -> bool:
        stream = self._streams.get(peer_id)
        if stream is None:
            return False
        try:
            stream.write(_varint(len(rpc)) + rpc)
            await stream.drain()
            return True
        except (ConnectionError, OSError):
            self._drop_peer(peer_id)
            return False

    async def _on_inbound_stream(self, stream, peer_id: str) -> None:
        """Pump the peer's RPC stream until EOF."""
        self.scores.setdefault(peer_id, _PeerScore())
        buf = b""
        while True:
            try:
                chunk = await stream.read()
            except (ConnectionError, OSError):
                break
            if not chunk:
                break
            buf += chunk
            while True:
                try:
                    ln, pos = _rv(buf, 0)
                except IndexError:
                    break
                if len(buf) - pos < ln:
                    break
                rpc = buf[pos : pos + ln]
                buf = buf[pos + ln :]
                try:
                    await self._handle_rpc(peer_id, decode_rpc(rpc))
                except Exception as e:
                    self.log.warn(f"rpc handling error from {peer_id[:8]}: {e!r}")
                    self._penalize(peer_id, 1.0)

    # -- RPC handling ----------------------------------------------------------

    def set_topic_params(self, topic: str, params: TopicScoreParams) -> None:
        self.topic_params[str(topic)] = params

    def _params_for(self, topic: str) -> TopicScoreParams:
        return self.topic_params.get(topic, _DEFAULT_TOPIC_PARAMS)

    def _score(self, peer_id: str) -> float:
        sc = self.scores.get(peer_id)
        return sc.value(self.p, self.now(), self._params_for) if sc else 0.0

    def _mesh_remove(self, peer_id: str, topic: str) -> None:
        """Drop a peer from a topic mesh, applying the P3b capture."""
        self.mesh.get(topic, set()).discard(peer_id)
        sc = self.scores.get(peer_id)
        if sc:
            sc.prune(topic, self._params_for(topic), self.now())

    def _penalize(self, peer_id: str, units: float) -> None:
        self.scores.setdefault(peer_id, _PeerScore()).behaviour += units

    async def _handle_rpc(self, peer_id: str, rpc: dict) -> None:
        if self._score(peer_id) < self.p.GRAYLIST_THRESHOLD:
            return  # graylisted: ignore everything
        for sub, topic in rpc["subscriptions"]:
            topics = self.peer_topics.setdefault(peer_id, set())
            (topics.add if sub else topics.discard)(topic)
        for topic in rpc["graft"]:
            await self._on_graft(peer_id, topic)
        for topic, backoff in rpc["prune"]:
            self._mesh_remove(peer_id, topic)
            self.backoff[(topic, peer_id)] = self.now() + int(backoff)
        for topic, data in rpc["publish"]:
            await self._on_message(peer_id, topic, data)
        if rpc["ihave"]:
            await self._on_ihave(peer_id, rpc["ihave"])
        if rpc["iwant"]:
            await self._on_iwant(peer_id, rpc["iwant"])

    async def _on_graft(self, peer_id: str, topic: str) -> None:
        if topic not in self.topics:
            await self._send_rpc(peer_id, encode_rpc(prune=[(topic, self.p.PRUNE_BACKOFF_SEC)]))
            return
        if self.now() < self.backoff.get((topic, peer_id), 0.0):
            self._penalize(peer_id, 1.0)  # grafting inside backoff
            await self._send_rpc(peer_id, encode_rpc(prune=[(topic, self.p.PRUNE_BACKOFF_SEC)]))
            return
        if self._score(peer_id) < 0:
            await self._send_rpc(peer_id, encode_rpc(prune=[(topic, self.p.PRUNE_BACKOFF_SEC)]))
            return
        self.mesh.setdefault(topic, set()).add(peer_id)
        self.scores.setdefault(peer_id, _PeerScore()).graft(topic, self.now())

    async def _on_message(self, peer_id: str, topic: str, raw: bytes) -> None:
        msg_id = compute_message_id(raw)
        now = self.now()
        first = self.seen.get(msg_id)
        if first is not None:
            first_time, first_topic, first_accepted = first
            self.metrics["duplicates"] += 1
            # P3 counts near-duplicate deliveries from mesh peers: a peer
            # forwarding within the delivery window is doing its mesh job
            # even when another peer was first (gossipsub v1.1 spec).
            # Credit requires the first delivery to have VALIDATED on the
            # SAME topic — else colluders could farm credit by echoing
            # junk or replaying ids across topics.
            tp = self._params_for(topic)
            if (
                first_accepted
                and first_topic == topic
                and topic in self.topics
                and peer_id in self.mesh.get(topic, set())
                and now - first_time <= tp.mesh_deliveries_window_sec
            ):
                ts = self.scores.setdefault(peer_id, _PeerScore()).topic(topic)
                ts.mesh_deliveries = min(ts.mesh_deliveries + 1.0, tp.mesh_deliveries_cap)
            return
        self.seen[msg_id] = (now, topic, False)
        verdict = "accept"
        ssz = raw
        if self._validator is not None:
            verdict, ssz = await self._validator(topic, raw, peer_id)
        if verdict == "reject":
            self.metrics["rejected"] += 1
            sc = self.scores.setdefault(peer_id, _PeerScore())
            if topic in self.topics:
                sc.topic(topic).invalid += 1.0
            else:
                # unknown/junk topic strings must not allocate per-topic
                # stats (unbounded attacker-controlled keys): charge the
                # global behaviour penalty instead
                sc.behaviour += 1.0
            return
        if verdict == "ignore":
            return
        self.seen[msg_id] = (now, topic, True)  # validated first delivery
        sc = self.scores.setdefault(peer_id, _PeerScore())
        ts = sc.topic(topic)
        tp = self._params_for(topic)
        ts.first_deliveries = min(ts.first_deliveries + 1.0, tp.first_deliveries_cap)
        if peer_id in self.mesh.get(topic, set()):
            ts.mesh_deliveries = min(ts.mesh_deliveries + 1.0, tp.mesh_deliveries_cap)
        self.metrics["delivered"] += 1
        self._mcache_put(msg_id, topic, raw)
        await self._forward(topic, raw, exclude={peer_id})
        for handler in self._subscribers.get(topic, []):
            try:
                await handler(ssz, peer_id)
            except Exception as e:
                self.log.warn(f"subscriber error on {topic}: {e!r}")

    async def _on_ihave(self, peer_id: str, ihave) -> None:
        if self._score(peer_id) < self.p.GOSSIP_THRESHOLD:
            return
        want = []
        for topic, ids in ihave:
            if topic not in self.topics:
                continue
            want.extend(i for i in ids if i not in self.seen)
        if want:
            await self._send_rpc(peer_id, encode_rpc(iwant=want[:500]))

    async def _on_iwant(self, peer_id: str, ids) -> None:
        msgs = []
        for i in ids[:500]:
            entry = self.mcache_index.get(i)
            if entry is not None:
                msgs.append(entry)
        if msgs:
            self.metrics["iwant_served"] += len(msgs)
            await self._send_rpc(peer_id, encode_rpc(publish=msgs))

    # -- app surface -----------------------------------------------------------

    async def subscribe(self, topic: str, handler=None) -> None:
        topic = str(topic)
        self.topics.add(topic)
        if handler is not None:
            self._subscribers.setdefault(topic, []).append(handler)
        self.mesh.setdefault(topic, set())
        for peer_id in list(self._streams):
            await self._send_rpc(peer_id, encode_rpc(subscriptions=[(True, topic)]))

    async def unsubscribe(self, topic: str) -> None:
        topic = str(topic)
        self.topics.discard(topic)
        self._subscribers.pop(topic, None)
        peers = self.mesh.pop(topic, set())
        for peer_id in list(self._streams):
            rpc = encode_rpc(
                subscriptions=[(False, topic)],
                prune=[(topic, self.p.PRUNE_BACKOFF_SEC)] if peer_id in peers else [],
            )
            await self._send_rpc(peer_id, rpc)

    async def publish(self, topic: str, ssz_bytes: bytes) -> int:
        """Compress, id, cache and send to the mesh (or fanout). Returns
        the number of peers the message went to."""
        topic = str(topic)
        raw = compress(ssz_bytes)
        msg_id = compute_message_id(raw)
        if msg_id in self.seen:
            return 0
        self.seen[msg_id] = (self.now(), topic, True)
        self._mcache_put(msg_id, topic, raw)
        return await self._forward(topic, raw, exclude=set(), flood=True)

    async def _forward(self, topic: str, raw: bytes, exclude: set, flood: bool = False) -> int:
        if flood:
            # own publishes flood to every subscribed peer above the
            # publish threshold (js-libp2p-gossipsub floodPublish, the
            # eth2 configuration) — robust delivery regardless of mesh
            # state, at publish-amplification cost only for own messages
            peers = set(self._topic_peers(topic))
        else:
            peers = self.mesh.get(topic)
            if not peers and topic not in self.topics:
                # fanout publish to a topic we don't subscribe to
                peers = self.fanout.setdefault(topic, set())
                if not peers:
                    peers |= set(self._topic_peers(topic)[: self.p.D])
        rpc = encode_rpc(publish=[(topic, raw)])
        n = 0
        for peer_id in list(peers or ()):
            if peer_id in exclude:
                continue
            if self._score(peer_id) < self.p.PUBLISH_THRESHOLD:
                continue
            if await self._send_rpc(peer_id, rpc):
                n += 1
        return n

    def _topic_peers(self, topic: str) -> list[str]:
        return [p for p, ts in self.peer_topics.items() if topic in ts and p in self._streams]

    # -- heartbeat -------------------------------------------------------------

    def _mcache_put(self, msg_id: bytes, topic: str, raw: bytes) -> None:
        self.mcache[0].append((msg_id, topic, raw))
        self.mcache_index[msg_id] = (topic, raw)

    async def _heartbeat_loop(self) -> None:
        while True:
            await asyncio.sleep(self.p.HEARTBEAT_SEC)
            try:
                await self.heartbeat()
            except Exception as e:
                self.log.warn(f"heartbeat error: {e!r}")

    async def heartbeat(self) -> None:
        now = self.now()
        # mesh maintenance
        for topic in list(self.topics):
            mesh = self.mesh.setdefault(topic, set())
            # kick negative-score peers
            for peer_id in [pid for pid in mesh if self._score(pid) < 0]:
                self._mesh_remove(peer_id, topic)
                await self._send_rpc(peer_id, encode_rpc(prune=[(topic, self.p.PRUNE_BACKOFF_SEC)]))
            if len(mesh) < self.p.D_LO:
                candidates = [
                    pid
                    for pid in self._topic_peers(topic)
                    if pid not in mesh
                    and now >= self.backoff.get((topic, pid), 0.0)
                    and self._score(pid) >= 0
                ]
                for pid in candidates[: self.p.D - len(mesh)]:
                    mesh.add(pid)
                    self.scores.setdefault(pid, _PeerScore()).graft(topic, now)
                    await self._send_rpc(pid, encode_rpc(graft=[topic]))
            elif len(mesh) > self.p.D_HI:
                # prune down to D, lowest scores first
                ranked = sorted(mesh, key=self._score)
                for pid in ranked[: len(mesh) - self.p.D]:
                    self._mesh_remove(pid, topic)
                    await self._send_rpc(pid, encode_rpc(prune=[(topic, self.p.PRUNE_BACKOFF_SEC)]))
        # gossip: IHAVE recent ids to D_LAZY non-mesh peers per topic
        window = self.mcache[: self.p.MCACHE_GOSSIP]
        ids_by_topic: dict[str, list[bytes]] = {}
        for w in window:
            for msg_id, topic, _ in w:
                ids_by_topic.setdefault(topic, []).append(msg_id)
        for topic, ids in ids_by_topic.items():
            mesh = self.mesh.get(topic, set())
            lazy = [
                pid
                for pid in self._topic_peers(topic)
                if pid not in mesh and self._score(pid) >= self.p.GOSSIP_THRESHOLD
            ][: self.p.D_LAZY]
            for pid in lazy:
                await self._send_rpc(pid, encode_rpc(ihave=[(topic, ids[:5000])]))
        # rotate mcache
        self.mcache.insert(0, [])
        while len(self.mcache) > self.p.MCACHE_LEN:
            for msg_id, _, _ in self.mcache.pop():
                self.mcache_index.pop(msg_id, None)
        # decay scores, expire seen + backoff
        for sc in self.scores.values():
            sc.decay(self.p, self._params_for)
        # evict score state of long-disconnected peers (reference
        # retainScore): bounds memory against peer-id churn without
        # letting graylisted peers reset via quick reconnects
        retain = self.p.RETAIN_SCORE_SEC
        for pid in list(self.scores):
            sc = self.scores[pid]
            if (
                pid not in self._streams
                and sc.disconnected_at is not None
                and now - sc.disconnected_at > retain
            ):
                del self.scores[pid]
        cutoff = now - self.p.SEEN_TTL_SEC
        self.seen = {k: v for k, v in self.seen.items() if v[0] >= cutoff}
        self.backoff = {k: v for k, v in self.backoff.items() if v > now}
