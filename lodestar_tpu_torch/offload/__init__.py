"""Offload channel: the wire format between a beacon node and the device
host (SURVEY §2d — "gRPC over DCN for job submission: BlsWorkReq
batches, hash batches").

The PyTorch port's copy of ``lodestar_tpu/offload/__init__.py``: frames
are bytes-equal to the JAX package's on the same inputs, so a client of
either package talks to a server of either package. The package holds:

* this module — the frames, `OffloadError` and `OffloadShed`
* `server.BlsOffloadServer` — hosts a verify backend (the port's device
  mesh, or the CPU oracle when asked for) behind two RPCs, with a
  multi-tenant admission front-end (`offload/tenancy.py`)
* `client.BlsOffloadClient` — an `IBlsVerifier` that ships signature-set
  frames to one or more hosts: routing by the Status frame, class
  deadlines, hedging, digest-checked replies, per-endpoint breakers;
  transport errors FAIL CLOSED (the job rejects, never resolves valid)
* `audit.OffloadAuditor` — sampled re-verification of the client's
  verdicts off the hot path, trust scores and quarantine of a lying host
* `resilience` — the circuit breaker (the lanes' and the client's) and
  the class deadline budgets

Transport errors without grpc (a departure): `TransportError` is the
port's base class of a failed call, with a `code()` from `StatusCode`,
whose member names are gRPC's status-code names. The client catches
`transport_errors()`: `TransportError`, plus `grpc.RpcError` once grpc
has been imported (a dialed stub imports it on its first call), so a
host without grpc serves in-process and the fault harness
(`testing/faults.py`) raises `TransportError`s. These three are not in
`__all__`, which stays the JAX package's. Stdlib only: importing this
package loads no torch and no grpc.

Wire format (framed, no codegen needed — grpc carries opaque bytes):
  request:  u32le count || count * (pubkey48 || message32 || signature96)
            [|| 0xC3 || u8 version || u8 priority ||
                u16le tenant_len || tenant utf-8]
            (tenant trailer: per-tenant identity + launch class on the
            wire. The client appends it ONLY once the server's Status
            advertised the capability — a legacy server keeps seeing
            the exact legacy frame; a legacy CLIENT omits it and the
            server accounts the work to the default tenant. Unknown
            trailing bytes fail closed, like every frame error.)
  response: u8 ok(1)/invalid(0) || 0xB7 || u8 version ||
            sha256(request || verdict_byte)[:8]
            (digest-checked verdict: the client rejects any reply whose
            digest doesn't bind this request to this verdict, so a
            corrupted, truncated, or cross-spliced frame fails CLOSED
            instead of decoding as a verdict. Legacy 1-byte verdicts
            still parse; error replies stay u8 2 || error utf-8 — an
            error already fails closed, corruption can't weaken it.)
            A multi-tenant server may also answer u8 3 ||
            u8 admission || u8 reason_len || reason utf-8 ||
            sha256(request || 0x03 || admission)[:8] — an ADMISSION
            SHED (quota/overload, not an endpoint fault): a new client
            fails the job closed but does NOT count the endpoint sick;
            a legacy client rejects the frame outright (fail closed
            either way). The digest is mandatory when the decoder
            holds the request: a shed records breaker SUCCESS, so a
            forged/corrupt shed must not manufacture health evidence.
  status:   u8 can_accept || 0xA5 || u8 version ||
            u8 admission(0 accept/1 shed_bulk/2 reject) ||
            u16le occupancy_permille || u32le queue_depth
            [|| 0xC4 || u8 version || u8 flags ||
                u8 n_chips || n_chips * (u16le occ_permille || u8 chip_flags)]
            (legacy servers reply with the bare can_accept byte; legacy
            clients read byte 0 — or the 10-byte v1 prefix — of the new
            frame and see exactly the old semantics. The mesh trailer
            aggregates PER-CHIP occupancy so client routing sees fleet
            headroom, not one die: chip_flags bit0 = wedged (the chip
            drops out of advertised capacity), frame flags bit0 =
            "tenant trailer accepted on verify frames". A malformed or
            future-version trailer degrades to the v1 view instead of
            failing the probe.)
"""

from __future__ import annotations

import enum
import hashlib
import sys
from dataclasses import dataclass

from ..crypto.bls.api import SignatureSet
from ..scheduler import AdmissionState, PriorityClass

__all__ = [
    "encode_sets",
    "encode_tenant_trailer",
    "validate_tenant",
    "decode_sets",
    "decode_sets_ex",
    "SetsTrailer",
    "encode_verdict",
    "encode_shed",
    "shed_digest",
    "decode_verdict",
    "verdict_digest",
    "encode_status",
    "decode_status",
    "StatusFrame",
    "ChipStatus",
    "OffloadError",
    "OffloadShed",
    "DEFAULT_TENANT",
    "SET_BYTES",
    "STATUS_FRAME_BYTES",
    "VERDICT_FRAME_BYTES",
]

SET_BYTES = 48 + 32 + 96

STATUS_MAGIC = 0xA5
STATUS_VERSION = 1
STATUS_FRAME_BYTES = 10

# mesh trailer on Status frames (fleet headroom + capability bits)
STATUS_MESH_MAGIC = 0xC4
STATUS_MESH_VERSION = 1
STATUS_FLAG_TENANT_CAPABLE = 0x01
CHIP_FLAG_WEDGED = 0x01

# tenant trailer on request frames
SETS_TRAILER_MAGIC = 0xC3
SETS_TRAILER_VERSION = 1
MAX_TENANT_BYTES = 255

VERDICT_MAGIC = 0xB7
VERDICT_VERSION = 1
VERDICT_DIGEST_BYTES = 8
VERDICT_FRAME_BYTES = 3 + VERDICT_DIGEST_BYTES

#: tenant identity accounted to frames that carry no trailer (legacy
#: clients, single-tenant deployments)
DEFAULT_TENANT = "default"


class OffloadError(Exception):
    pass


class OffloadShed(OffloadError):
    """The server refused admission (tenant quota / overload) — the job
    still fails CLOSED at the caller, but the endpoint is NOT sick:
    routing may immediately try a sibling and the breaker records the
    (live, responsive) endpoint as healthy."""

    def __init__(self, message: str, state: AdmissionState = AdmissionState.REJECT):
        super().__init__(message)
        self.state = state


class StatusCode(enum.Enum):
    """The status codes a failed call carries: the names (and the str,
    `StatusCode.UNAVAILABLE`) of gRPC's `grpc.StatusCode` members, with
    no grpc needed to name them."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class TransportError(Exception):
    """A call that failed on its transport (the shape of `grpc.RpcError`
    the client reads: `code()` and `details()`), raised where no grpc is
    involved: the fault harness's injected errors."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(code, details)
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details

    def __str__(self) -> str:
        return f"{type(self).__name__}({self._code}, {self._details!r})"


def transport_errors() -> tuple[type[BaseException], ...]:
    """The exception types a failed call raises: `TransportError`, and
    `grpc.RpcError` when grpc is already imported (nothing imports it
    here). Read at catch time, so a stub that dialed after the client
    was built is covered."""
    grpc = sys.modules.get("grpc")
    rpc_error = getattr(grpc, "RpcError", None)
    if isinstance(rpc_error, type) and issubclass(rpc_error, BaseException):
        return (TransportError, rpc_error)
    return (TransportError,)


@dataclass(frozen=True)
class SetsTrailer:
    """Decoded request-frame tenant trailer."""

    tenant: str
    priority: PriorityClass


def validate_tenant(tenant: str) -> bytes:
    """The trailer-encodable form of a tenant id, or OffloadError —
    exposed so configuration surfaces (client ctor, node options) can
    reject a bad identity at STARTUP instead of failing every verify."""
    tb = tenant.encode() if isinstance(tenant, str) else bytes(tenant)
    if not tb or len(tb) > MAX_TENANT_BYTES:
        raise OffloadError(f"tenant id must be 1..{MAX_TENANT_BYTES} utf-8 bytes")
    return tb


def encode_tenant_trailer(
    tenant: str, priority: PriorityClass | int | None = None
) -> bytes:
    """The tenant trailer as a pure frame SUFFIX — appending it to an
    already-encoded legacy frame yields the stamped frame, so callers
    holding both variants don't serialize the set bytes twice."""
    tb = validate_tenant(tenant)
    pr = int(PriorityClass(priority) if priority is not None else PriorityClass.API)
    return (
        bytes([SETS_TRAILER_MAGIC, SETS_TRAILER_VERSION, pr])
        + len(tb).to_bytes(2, "little")
        + tb
    )


def encode_sets(
    sets: list[SignatureSet],
    *,
    tenant: str | None = None,
    priority: PriorityClass | int | None = None,
) -> bytes:
    """Request frame. Without `tenant` this is the bit-exact legacy
    frame; with it, the tenant trailer is appended (callers gate on the
    server's advertised capability — see BlsOffloadClient)."""
    out = bytearray(len(sets).to_bytes(4, "little"))
    for s in sets:
        pk, msg, sig = bytes(s.pubkey), bytes(s.message), bytes(s.signature)
        if len(pk) != 48 or len(msg) != 32 or len(sig) != 96:
            raise OffloadError("malformed signature set")
        out += pk + msg + sig
    if tenant is not None:
        out += encode_tenant_trailer(tenant, priority)
    return bytes(out)


def decode_sets_ex(data: bytes) -> tuple[list[SignatureSet], SetsTrailer | None]:
    """Sets + optional tenant trailer. Unknown or malformed trailing
    bytes fail closed — only the exact legacy frame or the exact
    trailer format parses."""
    if len(data) < 4:
        raise OffloadError("short frame")
    count = int.from_bytes(data[:4], "little")
    base = 4 + count * SET_BYTES
    if len(data) < base:
        raise OffloadError(f"frame length mismatch for {count} sets")
    sets = []
    off = 4
    for _ in range(count):
        pk = data[off : off + 48]
        msg = data[off + 48 : off + 80]
        sig = data[off + 80 : off + 176]
        sets.append(SignatureSet(pubkey=pk, message=msg, signature=sig))
        off += SET_BYTES
    rest = data[base:]
    if not rest:
        return sets, None
    if len(rest) < 5 or rest[0] != SETS_TRAILER_MAGIC or rest[1] != SETS_TRAILER_VERSION:
        raise OffloadError(f"frame length mismatch for {count} sets")
    try:
        priority = PriorityClass(rest[2])
    except ValueError:
        raise OffloadError(f"tenant trailer names unknown priority class {rest[2]}")
    tlen = int.from_bytes(rest[3:5], "little")
    if len(rest) != 5 + tlen or tlen == 0:
        raise OffloadError("tenant trailer length mismatch")
    try:
        tenant = rest[5:].decode()
    except UnicodeDecodeError:
        raise OffloadError("tenant trailer is not utf-8")
    return sets, SetsTrailer(tenant=tenant, priority=priority)


def decode_sets(data: bytes) -> list[SignatureSet]:
    return decode_sets_ex(data)[0]


@dataclass(frozen=True)
class ChipStatus:
    """One mesh lane in the Status frame's chip table."""

    occupancy_permille: int
    wedged: bool


@dataclass(frozen=True)
class StatusFrame:
    """Decoded Status reply. `extended=False` means the server spoke the
    legacy single-byte protocol: occupancy/queue depth are unknown and
    admission is synthesized from the binary gate. `chips` is the mesh
    trailer's per-chip table (empty for pre-mesh servers);
    `tenant_capable` advertises that verify frames may carry the tenant
    trailer."""

    can_accept: bool
    admission: AdmissionState
    occupancy_permille: int | None = None
    queue_depth: int | None = None
    extended: bool = False
    chips: tuple[ChipStatus, ...] = ()
    tenant_capable: bool = False

    @property
    def capacity(self) -> int:
        """Advertised serving capacity in chips: non-wedged entries of
        the chip table (a quarantined/wedged chip drops out), 1 for
        servers that advertise no mesh."""
        if not self.chips:
            return 1
        return sum(1 for c in self.chips if not c.wedged)


def encode_status(
    *,
    occupancy_permille: int,
    queue_depth: int,
    admission: AdmissionState | int,
    chips: list[tuple[int, bool]] | None = None,
    tenant_capable: bool = False,
) -> bytes:
    adm = AdmissionState(admission)
    occ = max(0, min(1000, int(occupancy_permille)))
    depth = max(0, min(0xFFFFFFFF, int(queue_depth)))
    out = bytearray(
        bytes([0 if adm is AdmissionState.REJECT else 1, STATUS_MAGIC, STATUS_VERSION, adm])
        + occ.to_bytes(2, "little")
        + depth.to_bytes(4, "little")
    )
    if chips is not None or tenant_capable:
        table = list(chips or ())[:255]
        flags = STATUS_FLAG_TENANT_CAPABLE if tenant_capable else 0
        out += bytes([STATUS_MESH_MAGIC, STATUS_MESH_VERSION, flags, len(table)])
        for chip_occ, wedged in table:
            out += max(0, min(1000, int(chip_occ))).to_bytes(2, "little")
            out += bytes([CHIP_FLAG_WEDGED if wedged else 0])
    return bytes(out)


def _decode_mesh_trailer(rest: bytes) -> tuple[tuple[ChipStatus, ...], bool] | None:
    """Parse the optional mesh trailer; None on anything unexpected —
    v1 status decoding has always tolerated unknown trailing bytes, so
    a future-version (or corrupt) trailer degrades to the v1 view
    instead of failing the probe."""
    if len(rest) < 4 or rest[0] != STATUS_MESH_MAGIC or rest[1] != STATUS_MESH_VERSION:
        return None
    flags, n = rest[2], rest[3]
    if len(rest) != 4 + 3 * n:
        return None
    chips = []
    off = 4
    for _ in range(n):
        occ = int.from_bytes(rest[off : off + 2], "little")
        chips.append(ChipStatus(occ, bool(rest[off + 2] & CHIP_FLAG_WEDGED)))
        off += 3
    return tuple(chips), bool(flags & STATUS_FLAG_TENANT_CAPABLE)


def decode_status(data: bytes) -> StatusFrame:
    if not data:
        raise OffloadError("empty status frame")
    can_accept = data[0] == 1
    if (
        len(data) >= STATUS_FRAME_BYTES
        and data[1] == STATUS_MAGIC
        and data[2] == STATUS_VERSION
    ):
        try:
            admission = AdmissionState(data[3])
        except ValueError:
            admission = AdmissionState.ACCEPT if can_accept else AdmissionState.REJECT
        mesh = _decode_mesh_trailer(data[STATUS_FRAME_BYTES:])
        chips, tenant_capable = mesh if mesh is not None else ((), False)
        return StatusFrame(
            can_accept=can_accept,
            admission=admission,
            occupancy_permille=int.from_bytes(data[4:6], "little"),
            queue_depth=int.from_bytes(data[6:10], "little"),
            extended=True,
            chips=chips,
            tenant_capable=tenant_capable,
        )
    # legacy single-byte reply (or an unknown future version's prefix:
    # byte 0 keeps the binary-gate meaning in every version)
    return StatusFrame(
        can_accept=can_accept,
        admission=AdmissionState.ACCEPT if can_accept else AdmissionState.REJECT,
    )


def verdict_digest(request: bytes, verdict_byte: int) -> bytes:
    """Binds a verdict to the exact request frame it answers. Covering
    the verdict byte means flipping invalid→ok invalidates the digest —
    random/faulty corruption cannot mint a True verdict (a helper that
    RECOMPUTES the digest is byzantine; that threat needs the
    degradation chain's independent re-verification, not framing)."""
    return hashlib.sha256(request + bytes([verdict_byte])).digest()[:VERDICT_DIGEST_BYTES]


def encode_verdict(ok: bool | None, error: str = "", request: bytes | None = None) -> bytes:
    if error:
        return b"\x02" + error.encode()
    v = 1 if ok else 0
    if request is None:
        return bytes([v])  # legacy 1-byte verdict
    return bytes([v, VERDICT_MAGIC, VERDICT_VERSION]) + verdict_digest(request, v)


def shed_digest(request: bytes, state_byte: int) -> bytes:
    """Binds a shed reply to the request it refuses. A shed records
    breaker SUCCESS at the client — the one reply class where forged
    frames would manufacture positive health evidence — so unlike the
    legacy verdict byte it is digest-bound from day one (both ends of
    the shed protocol are new; there is no compat constraint)."""
    return hashlib.sha256(request + bytes([3, state_byte])).digest()[:VERDICT_DIGEST_BYTES]


def encode_shed(
    state: AdmissionState | int, reason: str = "", request: bytes | None = None
) -> bytes:
    """Admission-shed reply: the server is alive but refuses this job
    (tenant quota, overload). Distinct from an error frame so clients
    can fail over without charging the endpoint's breaker. `request`
    binds the digest; a digest-less shed only parses when the decoder
    has no request to check against (unit tests)."""
    rb = reason.encode()[:255]
    out = bytes([3, int(AdmissionState(state)), len(rb)]) + rb
    if request is not None:
        out += shed_digest(request, int(AdmissionState(state)))
    return out


def decode_verdict(
    data: bytes, request: bytes | None = None, *, require_digest: bool = False
) -> bool:
    """True/False, or raises OffloadError for a server-side error or a
    frame that fails strict validation. When `request` is given and the
    server spoke the digest-checked format, the digest must bind this
    request to this verdict. Decoding is strict: only the exact legacy
    1-byte frame, the exact digest frame, or the exact shed frame
    parses — trailing garbage or unknown leading bytes fail closed
    instead of decoding as a verdict.

    An admission-shed frame raises `OffloadShed` (a subclass of
    OffloadError): still fail-closed, but distinguishable so routing
    can fail over without counting the endpoint sick.

    `require_digest=True` rejects the legacy 1-byte frame entirely: the
    client sets it once an endpoint has spoken the digest format, so a
    fault (or active downgrade) that truncates replies to the bare
    verdict byte cannot strip the integrity check afterwards."""
    if not data:
        raise OffloadError("empty verdict frame")
    if data[0] == 2:
        raise OffloadError(data[1:].decode(errors="replace") or "server error")
    if data[0] == 3:
        base = 3 + data[2] if len(data) >= 3 else -1
        if base > 0 and len(data) in (base, base + VERDICT_DIGEST_BYTES):
            if request is not None:
                # a shed records breaker SUCCESS — the digest is what
                # stops a corrupting path from forging health evidence;
                # an unbound or mismatched shed fails closed as a
                # malformed (breaker-charging) frame instead
                if len(data) != base + VERDICT_DIGEST_BYTES or bytes(
                    data[base:]
                ) != shed_digest(request, data[1]):
                    raise OffloadError("shed frame digest mismatch (corrupt or forged)")
            try:
                state = AdmissionState(data[1])
            except ValueError:
                state = AdmissionState.REJECT
            reason = data[3:base].decode(errors="replace") or "admission shed"
            raise OffloadShed(reason, state)
        raise OffloadError("malformed shed frame")
    if data[0] not in (0, 1):
        raise OffloadError(f"malformed verdict frame (lead byte {data[0]})")
    if len(data) == 1:
        # legacy server: no digest to check (verdict-flip detection
        # requires both ends on the digest format)
        if require_digest:
            raise OffloadError(
                "bare legacy verdict from a digest-speaking server (truncation or downgrade)"
            )
        return data[0] == 1
    if (
        len(data) == VERDICT_FRAME_BYTES
        and data[1] == VERDICT_MAGIC
        and data[2] == VERDICT_VERSION
    ):
        if request is not None and bytes(data[3:]) != verdict_digest(request, data[0]):
            raise OffloadError("verdict digest mismatch (corrupt or cross-spliced reply)")
        return data[0] == 1
    raise OffloadError(f"malformed verdict frame ({len(data)} bytes)")
