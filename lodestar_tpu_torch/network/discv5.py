"""discv5 v5.1 node discovery over UDP (reference
`network/discv5/worker.ts` — the @chainsafe/discv5 DHT the reference
runs in a worker thread).

Implements the protocol's real mechanics natively on asyncio UDP:

* ENRs: RLP-encoded, v4-identity secp256k1-signed records with
  ip/udp/tcp endpoints and arbitrary payload keys (eth2, attnets,
  syncnets); node id = keccak256(uncompressed pubkey).
* Packet format per the v5.1 wire spec: 16-byte masking IV, AES-CTR
  header masking keyed by the destination node id, AES-GCM message
  encryption with the header as associated data.
* Session establishment: random packet -> WHOAREYOU (id-nonce
  challenge) -> handshake packet carrying the id-signature
  ("discovery v5 identity proof") + ephemeral key; session keys via
  HKDF-SHA256 over the challenge data.
* Messages: PING/PONG/FINDNODE/NODES (RLP bodies, log2-distance
  buckets), a flat routing table with distance queries, and a
  bootstrap/refresh loop.

The ECDH secret is the spec's COMPRESSED SHARED POINT (33 bytes,
parity prefix + x) — `cryptography` only exposes the x-coordinate, so
`_ecdh_compressed` runs the secp256k1 scalar multiplication itself to
recover the y parity; the key schedule passes the discv5 v5.1 spec
test vectors byte-exact (tests/network/test_discv5.py).

The port of `lodestar_tpu.network.discv5` (host Python, as there).
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac as hmac_mod
import ipaddress
import os
import secrets
import time

from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.asymmetric.utils import (
    Prehashed,
    decode_dss_signature,
    encode_dss_signature,
)
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives.ciphers.aead import AESGCM
from cryptography.hazmat.primitives.hashes import SHA256
from cryptography.hazmat.primitives.serialization import (
    Encoding,
    PublicFormat,
)

from lodestar_tpu_torch.logger import get_logger
from lodestar_tpu_torch.prover.mpt import keccak256, rlp_decode, rlp_encode

__all__ = ["Enr", "Discv5Node", "log2_distance"]

# secp256k1 parameters for the compressed-point ECDH (the spec secret is
# the 33-byte compressed shared point; the `cryptography` ECDH API yields
# only x, losing the parity byte)
_SECP_P = 2**256 - 2**32 - 977
_SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


def _ecdh_compressed(private_key, public_key) -> bytes:
    """discv5 v5.1 ECDH: compressed point of k*P on secp256k1.

    The double-and-add below is variable-time Python; the recipient side
    runs it with the node's long-term static key against attacker-chosen
    points, so the scalar is BLINDED per call (k + r*n for random 128-bit
    r): timing varies with the blinded scalar, which is independent of
    the key, defeating remote timing accumulation."""
    import secrets as _secrets

    k = private_key.private_numbers().private_value % _SECP_N
    k = k + (_secrets.randbits(128) + 1) * _SECP_N
    nums = public_key.public_numbers()
    px, py = nums.x, nums.y
    # jacobian double-and-add (a = 0)
    X, Y, Z = 1, 1, 0  # infinity
    qx, qy, qz = px, py, 1
    for bit in bin(k)[2:]:
        # double
        if Z != 0:
            A = X * X % _SECP_P
            B = Y * Y % _SECP_P
            C = B * B % _SECP_P
            D = 2 * ((X + B) * (X + B) - A - C) % _SECP_P
            E = 3 * A % _SECP_P
            X2 = (E * E - 2 * D) % _SECP_P
            Y2 = (E * (D - X2) - 8 * C) % _SECP_P
            Z2 = 2 * Y * Z % _SECP_P
            X, Y, Z = X2, Y2, Z2
        if bit == "1":
            if Z == 0:
                X, Y, Z = qx, qy, qz
            else:
                Z1Z1 = Z * Z % _SECP_P
                U2 = qx * Z1Z1 % _SECP_P
                S2 = qy * Z * Z1Z1 % _SECP_P
                H = (U2 - X) % _SECP_P
                r = (S2 - Y) % _SECP_P
                if H == 0:
                    if r != 0:
                        X, Y, Z = 1, 1, 0
                        continue
                    # doubling case unreachable for k < n with P of order n
                H2 = H * H % _SECP_P
                H3 = H * H2 % _SECP_P
                XH2 = X * H2 % _SECP_P
                X3 = (r * r - H3 - 2 * XH2) % _SECP_P
                Y3 = (r * (XH2 - X3) - Y * H3) % _SECP_P
                Z3 = Z * H % _SECP_P
                X, Y, Z = X3, Y3, Z3
    assert Z != 0, "ECDH with identity result"
    zi = pow(Z, -1, _SECP_P)
    zi2 = zi * zi % _SECP_P
    ax = X * zi2 % _SECP_P
    ay = Y * zi * zi2 % _SECP_P
    return bytes([0x02 | (ay & 1)]) + ax.to_bytes(32, "big")


PROTOCOL_ID = b"discv5"
VERSION = b"\x00\x01"
FLAG_MESSAGE, FLAG_WHOAREYOU, FLAG_HANDSHAKE = 0, 1, 2
ID_SIGNATURE_TEXT = b"discovery v5 identity proof"
KDF_INFO = b"discovery v5 key agreement"

MSG_PING, MSG_PONG, MSG_FINDNODE, MSG_NODES = 1, 2, 3, 4

_ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


def _int_be(x: int, n: int) -> bytes:
    return x.to_bytes(n, "big")


def _compact_sig(der: bytes) -> bytes:
    r, s = decode_dss_signature(der)
    if s > _ORDER // 2:
        s = _ORDER - s
    return _int_be(r, 32) + _int_be(s, 32)


def _der_sig(compact: bytes):
    r = int.from_bytes(compact[:32], "big")
    s = int.from_bytes(compact[32:], "big")
    return encode_dss_signature(r, s)


class Enr:
    """Ethereum Node Record (EIP-778), v4 identity scheme."""

    def __init__(self, seq: int, pairs: dict[bytes, bytes], signature: bytes = b""):
        self.seq = seq
        self.pairs = dict(pairs)
        self.signature = signature

    # -- construction ----------------------------------------------------------

    @classmethod
    def create(cls, private_key, *, ip: str, udp_port: int, tcp_port: int = 0, extra=None):
        pub = private_key.public_key().public_bytes(
            Encoding.X962, PublicFormat.CompressedPoint
        )
        pairs = {
            b"id": b"v4",
            b"secp256k1": pub,
            b"ip": ipaddress.ip_address(ip).packed,
            b"udp": _int_be(udp_port, 2),
        }
        if tcp_port:
            pairs[b"tcp"] = _int_be(tcp_port, 2)
        for k, v in (extra or {}).items():
            pairs[k if isinstance(k, bytes) else k.encode()] = v
        enr = cls(seq=1, pairs=pairs)
        enr.sign(private_key)
        return enr

    def _content(self) -> list:
        items: list = [_int_be(self.seq, 8).lstrip(b"\x00") or b""]
        for k in sorted(self.pairs):
            items += [k, self.pairs[k]]
        return items

    def sign(self, private_key) -> None:
        # EIP-778 v4: the secp256k1 signature is over keccak256(content)
        # DIRECTLY (Prehashed — no second hash)
        digest = keccak256(rlp_encode(self._content()))
        der = private_key.sign(digest, ec.ECDSA(Prehashed(SHA256())))
        self.signature = _compact_sig(der)

    def verify(self) -> bool:
        pub_bytes = self.pairs.get(b"secp256k1")
        if not pub_bytes:
            return False
        try:
            pub = ec.EllipticCurvePublicKey.from_encoded_point(
                ec.SECP256K1(), pub_bytes
            )
            digest = keccak256(rlp_encode(self._content()))
            pub.verify(_der_sig(self.signature), digest, ec.ECDSA(Prehashed(SHA256())))
            return True
        except Exception:
            return False

    # -- codec -----------------------------------------------------------------

    def encode(self) -> bytes:
        return rlp_encode([self.signature] + self._content())

    @classmethod
    def decode(cls, raw: bytes) -> "Enr":
        items = rlp_decode(raw)
        signature = items[0]
        seq = int.from_bytes(items[1], "big") if items[1] else 0
        pairs = {items[i]: items[i + 1] for i in range(2, len(items) - 1, 2)}
        return cls(seq=seq, pairs=pairs, signature=signature)

    # -- accessors -------------------------------------------------------------

    @property
    def node_id(self) -> bytes:
        pub = ec.EllipticCurvePublicKey.from_encoded_point(
            ec.SECP256K1(), self.pairs[b"secp256k1"]
        )
        raw = pub.public_bytes(Encoding.X962, PublicFormat.UncompressedPoint)
        return keccak256(raw[1:])  # drop the 0x04 prefix

    @property
    def udp_endpoint(self) -> tuple[str, int] | None:
        ip = self.pairs.get(b"ip")
        udp = self.pairs.get(b"udp")
        if not ip or not udp:
            return None
        return str(ipaddress.ip_address(ip)), int.from_bytes(udp, "big")


def log2_distance(a: bytes, b: bytes) -> int:
    x = int.from_bytes(a, "big") ^ int.from_bytes(b, "big")
    return x.bit_length()


# --- crypto helpers -----------------------------------------------------------


def _hkdf(secret: bytes, salt: bytes, info: bytes, length: int) -> bytes:
    prk = hmac_mod.new(salt, secret, hashlib.sha256).digest()
    out, t, i = b"", b"", 1
    while len(out) < length:
        t = hmac_mod.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def _mask(dest_node_id: bytes, iv: bytes, data: bytes) -> bytes:
    c = Cipher(algorithms.AES(dest_node_id[:16]), modes.CTR(iv)).encryptor()
    return c.update(data) + c.finalize()


def _session_keys(secret: bytes, nid_a: bytes, nid_b: bytes, challenge: bytes):
    kdata = _hkdf(secret, challenge, KDF_INFO + nid_a + nid_b, 32)
    return kdata[:16], kdata[16:]  # initiator-key, recipient-key


class _Session:
    def __init__(self, send_key: bytes, recv_key: bytes):
        self.send_key = send_key
        self.recv_key = recv_key


# --- the node -----------------------------------------------------------------


class Discv5Node:
    def __init__(
        self,
        *,
        ip: str = "127.0.0.1",
        port: int = 0,
        tcp_port: int = 0,
        private_key=None,
        enr_extra: dict | None = None,
        bootnodes: list[Enr] | None = None,
    ):
        self.key = private_key or ec.generate_private_key(ec.SECP256K1())
        self.ip = ip
        self.port = port
        self.tcp_port = tcp_port
        self.enr_extra = enr_extra or {}
        self.enr: Enr | None = None
        self.node_id: bytes = b""
        self.table: dict[bytes, Enr] = {}  # node_id -> ENR
        self.bootnodes = list(bootnodes or [])
        self.sessions: dict[bytes, _Session] = {}
        self._pending_challenges: dict[bytes, tuple[bytes, bytes]] = {}
        #   dest node id -> (challenge-data, their WHOAREYOU nonce)
        self._unanswered: dict[bytes, tuple[bytes, tuple]] = {}
        #   nonce -> (plaintext message to retry, addr)
        self._waiters: dict[bytes, asyncio.Future] = {}  # request-id -> future
        self._fail_counts: dict[bytes, int] = {}  # node id -> consecutive dead sweeps
        self._transport = None
        self._refresh_task: asyncio.Task | None = None
        self.log = get_logger(name="lodestar.discv5")

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        node = self

        class Proto(asyncio.DatagramProtocol):
            def datagram_received(self, data, addr):
                try:
                    node._on_datagram(data, addr)
                except Exception as e:
                    node.log.debug(f"bad datagram from {addr}: {e!r}")

        self._transport, _ = await loop.create_datagram_endpoint(
            Proto, local_addr=(self.ip, self.port)
        )
        self.port = self._transport.get_extra_info("sockname")[1]
        self.enr = Enr.create(
            self.key, ip=self.ip, udp_port=self.port, tcp_port=self.tcp_port,
            extra=self.enr_extra,
        )
        self.node_id = self.enr.node_id
        for b in self.bootnodes:
            self.table[b.node_id] = b

    async def stop(self) -> None:
        if self._refresh_task is not None:
            self._refresh_task.cancel()
            self._refresh_task = None
        if self._transport is not None:
            self._transport.close()
            self._transport = None

    # -- wire helpers ----------------------------------------------------------

    def _header(self, flag: int, nonce: bytes, authdata: bytes) -> bytes:
        return (
            PROTOCOL_ID + VERSION + bytes([flag]) + nonce + len(authdata).to_bytes(2, "big") + authdata
        )

    def _send_packet(self, dest_id: bytes, addr, flag: int, nonce: bytes,
                     authdata: bytes, message: bytes) -> None:
        iv = os.urandom(16)
        header = self._header(flag, nonce, authdata)
        packet = iv + _mask(dest_id, iv, header) + message
        self._transport.sendto(packet, addr)

    def _parse_packet(self, data: bytes):
        iv = data[:16]
        # unmask with OUR node id (we are the destination)
        rest = _mask(self.node_id, iv, data[16:])
        if rest[:6] != PROTOCOL_ID:
            raise ValueError("bad protocol id")
        flag = rest[8]
        nonce = rest[9:21]
        authsize = int.from_bytes(rest[21:23], "big")
        authdata = rest[23 : 23 + authsize]
        header_len = 23 + authsize
        # ciphertext is NOT masked; recompute its offset in the original
        message = data[16 + header_len :]
        header = rest[:header_len]
        return iv, header, flag, nonce, authdata, message

    # -- outgoing messages -----------------------------------------------------

    def _encrypt_send(self, enr: Enr, message: bytes) -> None:
        dest = enr.node_id
        addr = enr.udp_endpoint
        if addr is None:
            return  # record carries no reachable UDP endpoint
        sess = self.sessions.get(dest)
        nonce = os.urandom(12)
        if sess is None:
            # random packet: junk ciphertext to elicit WHOAREYOU; bound
            # the retry buffer (dead peers would otherwise grow it by a
            # few entries per discovery sweep forever)
            if len(self._unanswered) > 256:
                for k in list(self._unanswered)[:128]:
                    del self._unanswered[k]
            self._unanswered[nonce] = (message, addr)
            self._send_packet(dest, addr, FLAG_MESSAGE, nonce, self.node_id, os.urandom(16))
            return
        iv = os.urandom(16)
        header = self._header(FLAG_MESSAGE, nonce, self.node_id)
        ct = AESGCM(sess.send_key).encrypt(nonce, message, iv + header)
        # remember the nonce: if the peer lost its session (restart), it
        # answers WHOAREYOU and _on_whoareyou both drops our stale
        # session and re-handshakes with this same message
        if len(self._unanswered) > 256:
            for k in list(self._unanswered)[:128]:
                del self._unanswered[k]
        self._unanswered[nonce] = (message, addr)
        self._transport.sendto(iv + _mask(dest, iv, header) + ct, addr)

    async def _request(self, enr: Enr, message: bytes, request_id: bytes, timeout=3.0):
        fut = asyncio.get_running_loop().create_future()
        self._waiters[request_id] = fut
        try:
            self._encrypt_send(enr, message)
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._waiters.pop(request_id, None)

    # -- ingress ---------------------------------------------------------------

    def _on_datagram(self, data: bytes, addr) -> None:
        iv, header, flag, nonce, authdata, message = self._parse_packet(data)
        if flag == FLAG_WHOAREYOU:
            self._on_whoareyou(iv, header, nonce, authdata, addr)
        elif flag == FLAG_HANDSHAKE:
            self._on_handshake(iv, header, nonce, authdata, message, addr)
        else:
            self._on_message(iv, header, nonce, authdata, message, addr)

    # WHOAREYOU: we (initiator) answer with a handshake packet
    def _on_whoareyou(self, iv, header, req_nonce, authdata, addr) -> None:
        entry = self._unanswered.pop(bytes(req_nonce), None)
        if entry is None:
            return
        message, dest_addr = entry
        dest = next(
            (nid for nid, e in self.table.items() if e.udp_endpoint == addr), None
        )
        if dest is None:
            return
        # any WHOAREYOU for this peer invalidates a stale session
        self.sessions.pop(dest, None)
        enr = self.table[dest]
        challenge_data = iv + header
        eph = ec.generate_private_key(ec.SECP256K1())
        eph_pub = eph.public_key().public_bytes(
            Encoding.X962, PublicFormat.CompressedPoint
        )
        remote_pub = ec.EllipticCurvePublicKey.from_encoded_point(
            ec.SECP256K1(), enr.pairs[b"secp256k1"]
        )
        secret = _ecdh_compressed(eph, remote_pub)
        send_key, recv_key = _session_keys(secret, self.node_id, dest, challenge_data)
        self.sessions[dest] = _Session(send_key, recv_key)
        id_digest = hashlib.sha256(
            ID_SIGNATURE_TEXT + challenge_data + eph_pub + dest
        ).digest()
        id_sig = _compact_sig(self.key.sign(id_digest, ec.ECDSA(SHA256())))
        enr_rlp = self.enr.encode()
        auth = (
            self.node_id + bytes([len(id_sig)]) + bytes([len(eph_pub)]) + id_sig + eph_pub + enr_rlp
        )
        msg_nonce = os.urandom(12)
        iv2 = os.urandom(16)
        hs_header = self._header(FLAG_HANDSHAKE, msg_nonce, auth)
        ct = AESGCM(send_key).encrypt(msg_nonce, message, iv2 + hs_header)
        self._transport.sendto(iv2 + _mask(dest, iv2, hs_header) + ct, addr)

    # handshake received: we are the responder who sent WHOAREYOU
    def _on_handshake(self, iv, header, nonce, authdata, message, addr) -> None:
        src_id = bytes(authdata[:32])
        sig_len = authdata[32]
        eph_len = authdata[33]
        pos = 34
        id_sig = authdata[pos : pos + sig_len]
        pos += sig_len
        eph_pub_bytes = authdata[pos : pos + eph_len]
        pos += eph_len
        enr_rlp = authdata[pos:]
        challenge = self._pending_challenges.pop(src_id, None)
        if challenge is None:
            return
        challenge_data, _ = challenge
        if enr_rlp:
            enr = Enr.decode(bytes(enr_rlp))
            if not enr.verify() or enr.node_id != src_id:
                return
            self.table[src_id] = enr
        enr = self.table.get(src_id)
        if enr is None:
            return
        # verify the id signature with the ENR's static key
        id_digest = hashlib.sha256(
            ID_SIGNATURE_TEXT + challenge_data + bytes(eph_pub_bytes) + self.node_id
        ).digest()
        try:
            pub = ec.EllipticCurvePublicKey.from_encoded_point(
                ec.SECP256K1(), enr.pairs[b"secp256k1"]
            )
            pub.verify(_der_sig(bytes(id_sig)), id_digest, ec.ECDSA(SHA256()))
        except Exception:
            return
        eph_pub = ec.EllipticCurvePublicKey.from_encoded_point(
            ec.SECP256K1(), bytes(eph_pub_bytes)
        )
        secret = _ecdh_compressed(self.key, eph_pub)
        # keys derived with (initiator, recipient) = (them, us)
        their_send, our_send = _session_keys(secret, src_id, self.node_id, challenge_data)
        self.sessions[src_id] = _Session(our_send, their_send)
        try:
            pt = AESGCM(their_send).decrypt(bytes(nonce), bytes(message), bytes(iv) + bytes(header))
        except Exception:
            return
        self._dispatch(src_id, pt, addr)

    def _on_message(self, iv, header, nonce, authdata, message, addr) -> None:
        src_id = bytes(authdata[:32])
        sess = self.sessions.get(src_id)
        if sess is not None:
            try:
                pt = AESGCM(sess.recv_key).decrypt(
                    bytes(nonce), bytes(message), bytes(iv) + bytes(header)
                )
                self._dispatch(src_id, pt, addr)
                return
            except Exception:
                pass  # stale session: fall through to WHOAREYOU
        # unknown/undecryptable: challenge with WHOAREYOU
        iv2 = os.urandom(16)
        id_nonce = os.urandom(16)
        enr_seq = self.table[src_id].seq if src_id in self.table else 0
        auth = id_nonce + _int_be(enr_seq, 8)
        wa_header = self._header(FLAG_WHOAREYOU, bytes(nonce), auth)
        if len(self._pending_challenges) > 256:  # bound abandoned handshakes
            for k in list(self._pending_challenges)[:128]:
                del self._pending_challenges[k]
        self._pending_challenges[src_id] = (iv2 + wa_header, bytes(nonce))
        self._transport.sendto(iv2 + _mask(src_id, iv2, wa_header), addr)

    # -- message handling ------------------------------------------------------

    def _dispatch(self, src_id: bytes, plaintext: bytes, addr) -> None:
        mtype = plaintext[0]
        body = rlp_decode(plaintext[1:])
        if mtype == MSG_PING:
            req_id = body[0]
            pong = bytes([MSG_PONG]) + rlp_encode(
                [req_id, _int_be(self.enr.seq, 8),
                 ipaddress.ip_address(addr[0]).packed, _int_be(addr[1], 2)]
            )
            enr = self.table.get(src_id)
            if enr is not None:
                self._encrypt_send(enr, pong)
        elif mtype == MSG_PONG:
            self._resolve(bytes(body[0]), body)
        elif mtype == MSG_FINDNODE:
            req_id = body[0]
            distances = [int.from_bytes(d, "big") if d else 0 for d in body[1]]
            found = [
                e.encode()
                for nid, e in self.table.items()
                if log2_distance(self.node_id, nid) in distances
            ]
            if 0 in distances:
                # explicitly-requested own record goes FIRST so the
                # response cap can never drop it
                found.insert(0, self.enr.encode())
            nodes = bytes([MSG_NODES]) + rlp_encode([req_id, b"\x01", found[:16]])
            enr = self.table.get(src_id)
            if enr is not None:
                self._encrypt_send(enr, nodes)
        elif mtype == MSG_NODES:
            self._resolve(bytes(body[0]), body)

    def _resolve(self, request_id: bytes, body) -> None:
        fut = self._waiters.get(request_id)
        if fut is not None and not fut.done():
            fut.set_result(body)

    # -- client API ------------------------------------------------------------

    async def ping(self, enr: Enr) -> bool:
        req_id = secrets.token_bytes(8)
        self.table.setdefault(enr.node_id, enr)
        msg = bytes([MSG_PING]) + rlp_encode([req_id, _int_be(self.enr.seq, 8)])
        try:
            await self._request(enr, msg, req_id)
            return True
        except asyncio.TimeoutError:
            return False

    async def find_node(self, enr: Enr, distances: list[int]) -> list[Enr]:
        req_id = secrets.token_bytes(8)
        self.table.setdefault(enr.node_id, enr)
        msg = bytes([MSG_FINDNODE]) + rlp_encode(
            [req_id, [_int_be(d, 2).lstrip(b"\x00") or b"" for d in distances]]
        )
        try:
            body = await self._request(enr, msg, req_id)
        except asyncio.TimeoutError:
            return []
        out = []
        for raw in body[2]:
            try:
                e = Enr.decode(bytes(raw))
                if e.verify():
                    out.append(e)
                    # only REACHABLE records enter the table: bootstrap
                    # sweeps query every entry, and an endpoint-less ENR
                    # would make those queries unroutable
                    if e.node_id != self.node_id and e.udp_endpoint is not None:
                        self.table[e.node_id] = e
            except Exception:
                continue
        return out

    async def bootstrap(self, rounds: int = 3) -> int:
        """Ping bootnodes then iterative FINDNODE sweeps. Each query asks
        for the top distance band (random 256-bit ids sit at log2
        distance >= 253 from anything with ~94% probability) plus our own
        distance to the target, which is how the neighborhood fills.
        Returns the table size."""
        await asyncio.gather(*(self.ping(b) for b in list(self.bootnodes)))
        for _ in range(rounds):
            targets = list(self.table.values())

            async def sweep(enr):
                dist = log2_distance(self.node_id, enr.node_id)
                distances = sorted({256, 255, 254, 253, dist, max(1, dist - 1)})
                got = await self.find_node(enr, distances)
                # evict entries that repeatedly never answer — dead ENRs
                # would otherwise add a full timeout to every pass forever
                nid = enr.node_id
                if not got and nid not in (b.node_id for b in self.bootnodes):
                    self._fail_counts[nid] = self._fail_counts.get(nid, 0) + 1
                    if self._fail_counts[nid] >= 3:
                        self.table.pop(nid, None)
                        self._fail_counts.pop(nid, None)
                else:
                    self._fail_counts.pop(nid, None)

            await asyncio.gather(*(sweep(e) for e in targets))
        return len(self.table)

    def enr_source(self):
        """Candidate records for PeerDiscovery (network/discovery.py)."""
        return list(self.table.values())
