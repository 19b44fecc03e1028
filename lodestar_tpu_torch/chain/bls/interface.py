"""The BLS verifier seam — the narrow boundary the whole offload design
hangs on.

The PyTorch port's copy of ``lodestar_tpu/chain/bls/interface.py``.

Counterpart of `IBlsVerifier` (reference
`beacon-node/src/chain/bls/interface.ts:20`): three methods —
verify_signature_sets / can_accept_work / close — proven sufficient by the
reference, where a mock (`test/utils/mocks/bls.ts:3`), a single-thread
impl and the worker pool all swap freely behind it
(`chain/chain.ts:200-202`). Here the impls are the CPU-oracle verifier
and the device pool (`pool.py`); the device program replaces the worker
boundary at `multithread/index.ts:348`.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass

from ...crypto.bls.api import SignatureSet

__all__ = ["VerifySignatureOpts", "IBlsVerifier", "BlsSingleThreadVerifier", "BlsVerifierMock"]


@dataclass(frozen=True)
class VerifySignatureOpts:
    """Reference `VerifySignatureOpts` (`interface.ts:3-18`).

    batchable: the set MAY be held up to the buffer window and verified
    together with others (random-linear-combination). Only non-time-
    critical gossip objects should set it.
    verify_on_main_thread: bypass the pool entirely (cheap single sets on
    the hot path where the job round-trip costs more than the pairing).
    priority: scheduler launch class (`scheduler.PriorityClass`) carried
    from the call site — gossip block > gossip attestation > API >
    range sync > backfill. None means API (the neutral middle class);
    verifiers without a scheduler ignore it.
    slot: the subject slot of the work (a block's slot), anchoring the
    SLO layer's deadline math (`lodestar_tpu_torch/slo.py`). None anchors at the
    wall-clock slot when the job is enqueued — right for work with no
    subject slot (attestation aggregates, API batches); verifiers
    without slack accounting ignore it.
    """

    batchable: bool = False
    verify_on_main_thread: bool = False
    priority: "int | None" = None
    slot: "int | None" = None


class IBlsVerifier(abc.ABC):
    @abc.abstractmethod
    async def verify_signature_sets(
        self, sets: list[SignatureSet], opts: VerifySignatureOpts | None = None
    ) -> bool:
        """Verify 1+ signature sets (signatures untrusted wire bytes)."""

    @abc.abstractmethod
    def can_accept_work(self) -> bool:
        """True if the verifier is ready for more jobs — the gossip
        processor gates queue draining on this (reference
        `processor/index.ts:316-330`)."""

    @abc.abstractmethod
    async def close(self) -> None:
        """Drain/abort outstanding jobs and release the backend."""


class BlsSingleThreadVerifier(IBlsVerifier):
    """Inline oracle verification (reference `singleThread.ts`)."""

    def __init__(self) -> None:
        self._closed = False

    async def verify_signature_sets(
        self, sets: list[SignatureSet], opts: VerifySignatureOpts | None = None
    ) -> bool:
        from ...crypto.bls.api import verify_signature_sets

        return verify_signature_sets(sets)

    def can_accept_work(self) -> bool:
        return not self._closed

    async def close(self) -> None:
        self._closed = True


class BlsVerifierMock(IBlsVerifier):
    """Fixed-verdict mock (reference `test/utils/mocks/bls.ts:3`) — proof
    the seam stays mockable."""

    def __init__(self, verdict: bool = True) -> None:
        self.verdict = verdict
        self.calls: list[int] = []

    async def verify_signature_sets(
        self, sets: list[SignatureSet], opts: VerifySignatureOpts | None = None
    ) -> bool:
        self.calls.append(len(sets))
        return self.verdict

    def can_accept_work(self) -> bool:
        return True

    async def close(self) -> None:
        return None
