"""Eth1 deposit tracking over JSON-RPC (reference
`eth1/eth1DepositDataTracker.ts:52`, `eth1/eth1MergeBlockTracker.ts`,
`eth1/provider/`).

Components:

* `Eth1JsonRpcProvider` — the thin JSON-RPC client (eth_blockNumber,
  eth_getBlockByNumber, eth_getLogs filtered on the DepositEvent topic).
* `DepositTree` — incremental depth-32 sparse merkle tree of DepositData
  roots with the length mix-in and branch extraction (the
  `@chainsafe/persistent-merkle-tree` role for deposits).
* `Eth1DepositDataTracker` — polls the provider, parses DepositEvent ABI
  logs into DepositData, maintains the deposits + eth1Data caches, and
  serves `get_eth1_data_and_deposits(state)`: spec eth1-data voting
  (follow distance + voting-period majority) and deposit inclusion with
  proofs against the state's eth1_data root.
* `Eth1MergeBlockTracker` — scans for the first block whose
  total_difficulty crosses TERMINAL_TOTAL_DIFFICULTY (bellatrix merge
  readiness; reference eth1MergeBlockTracker.ts).
* `MockEth1Node` — an in-process HTTP JSON-RPC execution-layer stub with
  a simulated deposit contract: `submit_deposit` appends a DepositEvent
  log and advances blocks, giving dev chains real deposit ingestion.

DepositEvent ABI layout (deposit contract): five dynamic `bytes` fields
(pubkey, withdrawal_credentials, amount[8 LE], signature, index[8 LE])
— parsed with plain offset arithmetic, no ABI library.

The port of `lodestar_tpu.execution.eth1_tracker`, with its imports rewritten.
"""

from __future__ import annotations

import hashlib
import json
import threading
import urllib.request

from lodestar_tpu_torch.logger import get_logger
from lodestar_tpu_torch.types import ssz_types

__all__ = [
    "DEPOSIT_EVENT_TOPIC",
    "DepositTree",
    "Eth1JsonRpcProvider",
    "Eth1DepositDataTracker",
    "Eth1MergeBlockTracker",
    "MockEth1Node",
    "encode_deposit_log_data",
    "parse_deposit_log",
]

# keccak256("DepositEvent(bytes,bytes,bytes,bytes,bytes)") — the fixed
# public topic of the deposit contract. Precomputed constant (no keccak
# dependency at runtime; pinned in tests against the known value).
DEPOSIT_EVENT_TOPIC = "0x649bbc62d0e31342afea4e5cd82d4049e7e1ee912fc0889aa790803be39038c5"

DEPOSIT_CONTRACT_TREE_DEPTH = 32


def _sha256(x: bytes) -> bytes:
    return hashlib.sha256(x).digest()


# --- incremental deposit tree -------------------------------------------------


class DepositTree:
    """Incremental sparse merkle tree of DepositData roots, depth 32 with
    uint64 length mix-in (spec get_deposit_root)."""

    def __init__(self) -> None:
        self._zeros = [b"\x00" * 32]
        for _ in range(DEPOSIT_CONTRACT_TREE_DEPTH):
            self._zeros.append(_sha256(self._zeros[-1] + self._zeros[-1]))
        self._leaves: list[bytes] = []

    def push(self, leaf: bytes) -> None:
        self._leaves.append(bytes(leaf))

    def __len__(self) -> int:
        return len(self._leaves)

    def _layer(self, depth: int, count: int) -> list[bytes]:
        """Nodes of `depth` covering the first `count` leaves."""
        nodes = self._leaves[:count]
        for d in range(depth):
            if len(nodes) % 2:
                nodes.append(self._zeros[d])
            nodes = [_sha256(nodes[i] + nodes[i + 1]) for i in range(0, len(nodes), 2)]
        return nodes

    def root_at(self, count: int) -> bytes:
        """Deposit root with only the first `count` leaves (historic
        roots for eth1 voting)."""
        node = self._layer(DEPOSIT_CONTRACT_TREE_DEPTH, count)
        top = node[0] if node else self._zeros[DEPOSIT_CONTRACT_TREE_DEPTH]
        return _sha256(top + count.to_bytes(32, "little"))

    def root(self) -> bytes:
        return self.root_at(len(self._leaves))

    def proof(self, index: int, count: int) -> list[bytes]:
        """Branch for leaf `index` in the `count`-leaf tree, plus the
        length mix-in — the 33-element proof process_deposit verifies."""
        if not 0 <= index < count <= len(self._leaves):
            raise IndexError("deposit proof out of range")
        branch = []
        nodes = self._leaves[:count]
        idx = index
        for d in range(DEPOSIT_CONTRACT_TREE_DEPTH):
            if len(nodes) % 2:
                nodes.append(self._zeros[d])
            sibling = nodes[idx ^ 1]
            branch.append(sibling)
            nodes = [_sha256(nodes[i] + nodes[i + 1]) for i in range(0, len(nodes), 2)]
            idx //= 2
        branch.append(count.to_bytes(32, "little"))
        return branch


# --- DepositEvent ABI codec ---------------------------------------------------


def _abi_bytes(data: bytes) -> bytes:
    padded_len = (len(data) + 31) // 32 * 32
    return len(data).to_bytes(32, "big") + data.ljust(padded_len, b"\x00")


def encode_deposit_log_data(
    pubkey: bytes, withdrawal_credentials: bytes, amount_gwei: int, signature: bytes, index: int
) -> bytes:
    """ABI-encode the DepositEvent's five dynamic bytes fields."""
    fields = [
        pubkey,
        withdrawal_credentials,
        amount_gwei.to_bytes(8, "little"),
        signature,
        index.to_bytes(8, "little"),
    ]
    head = b""
    tail = b""
    offset = 32 * 5
    for f in fields:
        head += offset.to_bytes(32, "big")
        enc = _abi_bytes(f)
        tail += enc
        offset += len(enc)
    return head + tail


def parse_deposit_log(data: bytes) -> tuple[object, int]:
    """ABI log data -> (DepositData, deposit index)."""
    t = ssz_types()

    def read_bytes(field_i: int) -> bytes:
        offset = int.from_bytes(data[32 * field_i : 32 * field_i + 32], "big")
        ln = int.from_bytes(data[offset : offset + 32], "big")
        return data[offset + 32 : offset + 32 + ln]

    dd = t.DepositData.default()
    dd.pubkey = read_bytes(0)
    dd.withdrawal_credentials = read_bytes(1)
    dd.amount = int.from_bytes(read_bytes(2), "little")
    dd.signature = read_bytes(3)
    index = int.from_bytes(read_bytes(4), "little")
    return dd, index


# --- JSON-RPC provider --------------------------------------------------------


class Eth1JsonRpcProvider:
    def __init__(self, url: str, *, timeout_sec: float = 5.0):
        self.url = url
        self.timeout = timeout_sec
        self._id = 0

    def _call(self, method: str, params: list):
        self._id += 1
        payload = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()
        req = urllib.request.Request(
            self.url, data=payload, headers={"Content-Type": "application/json"}
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            out = json.loads(r.read())
        if "error" in out:
            raise RuntimeError(f"eth1 rpc error: {out['error']}")
        return out["result"]

    def block_number(self) -> int:
        return int(self._call("eth_blockNumber", []), 16)

    def chain_id(self) -> int:
        return int(self._call("eth_chainId", []), 16)

    def get_block_by_number(self, number: int | str) -> dict | None:
        tag = hex(number) if isinstance(number, int) else number
        return self._call("eth_getBlockByNumber", [tag, False])

    def get_deposit_logs(self, from_block: int, to_block: int, address: str) -> list[dict]:
        return self._call(
            "eth_getLogs",
            [
                {
                    "fromBlock": hex(from_block),
                    "toBlock": hex(to_block),
                    "address": address,
                    "topics": [DEPOSIT_EVENT_TOPIC],
                }
            ],
        )


# --- deposit tracker ----------------------------------------------------------

MAX_BLOCKS_PER_LOG_QUERY = 1000


class Eth1DepositDataTracker:
    """Deposit-log ingestion + eth1Data voting + deposit inclusion
    (reference eth1DepositDataTracker.ts). Drive with `update()` (poll)
    from the node's slot loop or a background task."""

    def __init__(
        self,
        provider: Eth1JsonRpcProvider,
        *,
        deposit_contract_address: str,
        cfg=None,
        follow_distance_blocks: int = 16,
        seconds_per_eth1_block: int = 14,
    ):
        self.provider = provider
        self.address = deposit_contract_address
        self.cfg = cfg
        self.follow_distance = follow_distance_blocks
        self.seconds_per_eth1_block = seconds_per_eth1_block
        self.tree = DepositTree()
        self.deposits: list = []  # DepositData by index
        self.eth1_blocks: list[dict] = []  # {number, hash, timestamp, deposit_count, deposit_root}
        self._last_processed_block = -1
        self.log = get_logger(name="lodestar.eth1")

    # -- ingestion ------------------------------------------------------------

    def update(self) -> int:
        """Fetch new deposit logs + block metadata up to head-follow.
        Returns the number of new deposits ingested."""
        head = self.provider.block_number()
        target = head - self.follow_distance
        if target <= self._last_processed_block:
            return 0
        new = 0
        frm = self._last_processed_block + 1
        while frm <= target:
            to = min(frm + MAX_BLOCKS_PER_LOG_QUERY - 1, target)
            for log_entry in self.provider.get_deposit_logs(frm, to, self.address):
                data = bytes.fromhex(log_entry["data"][2:])
                dd, index = parse_deposit_log(data)
                if index != len(self.deposits):
                    raise RuntimeError(
                        f"non-consecutive deposit index {index} (have {len(self.deposits)})"
                    )
                t = ssz_types()
                self.deposits.append(dd)
                self.tree.push(t.DepositData.hash_tree_root(dd))
                new += 1
            frm = to + 1
        # block metadata for voting (batched head range; dev scale keeps
        # this simple — the reference dynamically adjusts batch sizes)
        for n in range(max(0, self._last_processed_block + 1), target + 1):
            blk = self.provider.get_block_by_number(n)
            if blk is None:
                continue
            self.eth1_blocks.append(
                {
                    "number": int(blk["number"], 16),
                    "hash": bytes.fromhex(blk["hash"][2:]),
                    "timestamp": int(blk["timestamp"], 16),
                    "deposit_count": len(self.deposits),
                    "deposit_root": self.tree.root_at(len(self.deposits)),
                }
            )
        self._last_processed_block = target
        return new

    # -- voting + inclusion (spec get_eth1_vote / getEth1DataAndDeposits) ------

    def _votes_to_consider(self, state) -> list[dict]:
        from lodestar_tpu_torch.params import active_preset

        pr = active_preset()
        period_start = self._voting_period_start_time(state, pr)
        follow_sec = self.follow_distance * self.seconds_per_eth1_block
        return [
            b
            for b in self.eth1_blocks
            if period_start - 2 * follow_sec <= b["timestamp"] <= period_start - follow_sec
            and b["deposit_count"] >= int(state.eth1_data.deposit_count)
        ]

    def _voting_period_start_time(self, state, pr) -> int:
        seconds_per_slot = self.cfg.SECONDS_PER_SLOT if self.cfg else 12
        period_slots = pr.EPOCHS_PER_ETH1_VOTING_PERIOD * pr.SLOTS_PER_EPOCH
        start_slot = int(state.slot) - int(state.slot) % period_slots
        return int(state.genesis_time) + start_slot * seconds_per_slot

    def get_eth1_data_and_deposits(self, state):
        """(eth1_data vote, deposits for inclusion) — the produce-block
        seam (reference IEth1ForBlockProduction)."""
        t = ssz_types()
        votes = self._votes_to_consider(state)
        if votes:
            # majority among existing state votes restricted to valid
            # candidates, else the most recent candidate
            counts: dict[bytes, int] = {}
            by_hash = {v["hash"]: v for v in votes}
            for vote in state.eth1_data_votes:
                h = bytes(vote.block_hash)
                if h in by_hash:
                    counts[h] = counts.get(h, 0) + 1
            if counts:
                best = max(counts.items(), key=lambda kv: kv[1])[0]
                chosen = by_hash[best]
            else:
                chosen = max(votes, key=lambda b: b["number"])
            eth1_data = t.Eth1Data.default()
            eth1_data.deposit_root = chosen["deposit_root"]
            eth1_data.deposit_count = chosen["deposit_count"]
            eth1_data.block_hash = chosen["hash"]
        else:
            eth1_data = state.eth1_data

        deposits = self._deposits_for_inclusion(state, eth1_data)
        return eth1_data, deposits

    def _deposits_for_inclusion(self, state, eth1_data) -> list:
        from lodestar_tpu_torch.params import active_preset

        pr = active_preset()
        t = ssz_types()
        # if the vote would win this block, deposits verify against ITS
        # root; conservatively include only up to the CURRENT state's
        # eth1_data (the reference does the same: deposits are proven
        # against state.eth1_data at processing time)
        count = int(state.eth1_data.deposit_count)
        start = int(state.eth1_deposit_index)
        if start >= count or start >= len(self.deposits):
            return []
        n = min(count - start, pr.MAX_DEPOSITS, len(self.deposits) - start)
        out = []
        for i in range(start, start + n):
            dep = t.Deposit.default()
            dep.proof = self.tree.proof(i, count)
            dep.data = self.deposits[i]
            out.append(dep)
        return out


# --- merge block tracker ------------------------------------------------------


class Eth1MergeBlockTracker:
    """Find the terminal PoW block: first block with
    total_difficulty >= TTD whose parent is below (reference
    eth1MergeBlockTracker.ts getTerminalPowBlock)."""

    def __init__(self, provider: Eth1JsonRpcProvider, *, ttd: int):
        self.provider = provider
        self.ttd = ttd
        self._terminal: dict | None = None

    def get_terminal_pow_block(self) -> dict | None:
        if self._terminal is not None:
            return self._terminal
        head = self.provider.block_number()
        # walk back from head to find the crossing block
        candidate = None
        for n in range(head, -1, -1):
            blk = self.provider.get_block_by_number(n)
            if blk is None:
                break
            td = int(blk.get("totalDifficulty", "0x0"), 16)
            if td >= self.ttd:
                candidate = blk
            else:
                break
        if candidate is not None:
            self._terminal = {
                "block_hash": bytes.fromhex(candidate["hash"][2:]),
                "number": int(candidate["number"], 16),
                "total_difficulty": int(candidate.get("totalDifficulty", "0x0"), 16),
            }
        return self._terminal


# --- mock execution layer -----------------------------------------------------


class MockEth1Node:
    """In-process HTTP JSON-RPC EL with a simulated deposit contract.

    `submit_deposit(DepositData)` mines a block carrying the
    DepositEvent log; `mine_blocks(n)` advances empty blocks (so the
    follow distance can be satisfied in tests/dev chains)."""

    CONTRACT = "0x" + "42" * 20

    def __init__(self, *, start_difficulty_per_block: int = 1):
        self._blocks: list[dict] = []
        self._logs: list[dict] = []  # {blockNumber, data}
        self._deposit_count = 0
        self._difficulty = start_difficulty_per_block
        self._httpd = None
        self._thread = None
        self.port = 0
        self._lock = threading.Lock()
        self._mine(b"")  # genesis

    # -- chain building --------------------------------------------------------

    def _mine(self, extra: bytes) -> dict:
        n = len(self._blocks)
        prev_td = self._blocks[-1]["td"] if self._blocks else 0
        h = _sha256(b"mock-eth1" + n.to_bytes(8, "big") + extra)
        blk = {
            "number": n,
            "hash": h,
            "timestamp": 1_600_000_000 + n * 14,
            "td": prev_td + self._difficulty,
        }
        self._blocks.append(blk)
        return blk

    def mine_blocks(self, n: int) -> None:
        with self._lock:
            for _ in range(n):
                self._mine(b"")

    def submit_deposit(self, deposit_data) -> int:
        """Append a DepositEvent in a fresh block; returns the index."""
        t = ssz_types()
        with self._lock:
            index = self._deposit_count
            self._deposit_count += 1
            data = encode_deposit_log_data(
                bytes(deposit_data.pubkey),
                bytes(deposit_data.withdrawal_credentials),
                int(deposit_data.amount),
                bytes(deposit_data.signature),
                index,
            )
            blk = self._mine(data)
            self._logs.append({"blockNumber": blk["number"], "data": data})
            return index

    # -- JSON-RPC server -------------------------------------------------------

    def _rpc(self, method: str, params: list):
        with self._lock:
            if method == "eth_blockNumber":
                return hex(len(self._blocks) - 1)
            if method == "eth_chainId":
                return "0x1"
            if method == "eth_getBlockByNumber":
                tag = params[0]
                if tag in ("latest", "pending"):
                    n = len(self._blocks) - 1
                else:
                    n = int(tag, 16)
                if not 0 <= n < len(self._blocks):
                    return None
                b = self._blocks[n]
                return {
                    "number": hex(b["number"]),
                    "hash": "0x" + b["hash"].hex(),
                    "parentHash": "0x"
                    + (self._blocks[n - 1]["hash"].hex() if n else "00" * 32),
                    "timestamp": hex(b["timestamp"]),
                    "totalDifficulty": hex(b["td"]),
                }
            if method == "eth_getLogs":
                flt = params[0]
                frm = int(flt["fromBlock"], 16)
                to = int(flt["toBlock"], 16)
                if flt.get("topics") and flt["topics"][0] != DEPOSIT_EVENT_TOPIC:
                    return []
                return [
                    {
                        "blockNumber": hex(lg["blockNumber"]),
                        "data": "0x" + lg["data"].hex(),
                        "topics": [DEPOSIT_EVENT_TOPIC],
                        "address": self.CONTRACT,
                    }
                    for lg in self._logs
                    if frm <= lg["blockNumber"] <= to
                ]
            raise ValueError(f"mock eth1: unsupported method {method}")

    def start(self) -> None:
        import http.server

        node = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(length))
                try:
                    result = node._rpc(req["method"], req.get("params", []))
                    payload = {"jsonrpc": "2.0", "id": req.get("id"), "result": result}
                except Exception as e:  # mock-level error frame
                    payload = {
                        "jsonrpc": "2.0",
                        "id": req.get("id"),
                        "error": {"code": -32601, "message": str(e)},
                    }
                raw = json.dumps(payload).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def log_message(self, *a):  # quiet
                pass

        import socketserver

        class Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
            daemon_threads = True

        self._httpd = Server(("127.0.0.1", 0), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"
