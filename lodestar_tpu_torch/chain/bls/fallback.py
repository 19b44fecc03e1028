"""Verified degradation chain: offload → local device pool → CPU oracle.

The PyTorch port's copy of ``lodestar_tpu/chain/bls/fallback.py``. The
chain is explicit: the caller names its layers, every downgrade is
counted (`metrics.fallback_*` of a `ResilienceMetrics`) and traced (`bls_fallback`);
nothing in the port degrades on its own.

The offload leg fails CLOSED — correct, but availability-hostile: with
the accelerator host down, every block import rejects until it returns.
`DegradingBlsVerifier` restores availability WITHOUT weakening the
fail-closed invariant: each layer in the chain is a full `IBlsVerifier`
that actually RE-VERIFIES the signature sets (`crypto/bls/api.py` is
the oracle); a layer's *error* hands the same
sets to the next layer, a layer's *False* is final (an invalid-set
verdict is an answer, not a failure — falling through on False would
let a strict layer be shopped around for a lenient one).

So across every layer: no path resolves True except a layer genuinely
verifying the sets, and the chain only raises when every layer erred —
exactly the old single-verifier fail-closed semantics, now reached far
less often. Layers that report `is_down()` (offload with every breaker
open, a wedged device pool) are skipped without an attempt, so
degradation costs no RPC timeout. Down is deliberately distinct from
busy: a saturated-but-alive layer is still attempted and still governs
`can_accept_work()`, so gossip backpressure keeps shedding instead of
silently funneling every verify onto a slower fallback layer.

Every downgrade records a `bls_fallback` trace span and a
`lodestar_resilience_fallback_*` metric. The layer that served a
verdict is reported per-CALL through a contextvar (`serving_layer()`),
so two imports interleaving at the event loop each stamp THEIR OWN
`verifier_layer` on the `bls_verify` span — `last_layer` (one shared
slot, kept for dashboards/tests that want "most recent") is explicitly
not call-accurate under concurrency.

`in_outage()` reports the all-layers-erred terminal state (telemetry /
notifier signal; any layer serving a verdict clears it). Peer-scoring
does NOT read this shared flag — the chain stamps `verifier_outage`
on the rejection exception itself, so classification is per-call and
cannot race a concurrently recovering import."""

from __future__ import annotations

from contextvars import ContextVar

from ... import tracing
from ...crypto.bls.api import SignatureSet
from ...logger import get_logger

from .interface import IBlsVerifier, VerifySignatureOpts

__all__ = ["DegradingBlsVerifier"]

#: the layer that served the CURRENT task's most recent verdict. A
#: contextvar, not an attribute: concurrent imports run in separate
#: asyncio tasks (separate contexts), so each caller reads the layer
#: that served ITS verdict, never a sibling's.
_serving_layer: ContextVar[str | None] = ContextVar("bls_serving_layer", default=None)


class DegradingBlsVerifier(IBlsVerifier):
    def __init__(self, layers: list[tuple[str, IBlsVerifier]], *, metrics=None) -> None:
        """`layers`: ordered (name, verifier) pairs, preferred first.
        The degrader owns them — `close()` closes every layer."""
        if not layers:
            raise ValueError("at least one verifier layer required")
        self.layers = list(layers)
        self.last_layer: str | None = None  # guarded by: advisory-only (shared slot; per-call truth is the serving_layer() contextvar)
        self._outage = False  # guarded by: advisory-only (telemetry slot; scoring rides the per-rejection verifier_outage mark)
        self._metrics = metrics
        self._log = get_logger(name="lodestar.bls-degrade")

    async def verify_signature_sets(
        self, sets: list[SignatureSet], opts: VerifySignatureOpts | None = None
    ) -> bool:
        last_err: Exception | None = None
        primary = self.layers[0][0]
        for name, layer in self.layers:
            if _layer_down(layer):
                self._note_skip(name)
                continue
            if name != primary or last_err is not None:
                self._note_fallback(name, last_err)
            try:
                verdict = await layer.verify_signature_sets(sets, opts)
            except Exception as e:  # this layer erred: degrade, re-verify
                last_err = e
                self._log.warn(
                    "bls verifier layer failed, degrading",
                    {"layer": name, "error": str(e)[:120]},
                )
                continue
            self.last_layer = name
            _serving_layer.set(name)
            self._outage = False  # some layer answers: not an outage
            if self._metrics is not None:
                self._metrics.fallback_active.set(0 if name == primary else 1)
                if name != primary:
                    # counted on SERVE, not attempt: a fallback layer that
                    # also errs must not show up as having served verdicts
                    self._metrics.fallback_verifications.labels(name).inc()
            return verdict
        # every layer erred or refused: fail closed with the last error.
        # This IS the verifier outage. The flag is advisory telemetry
        # only — scoring reads the per-rejection `verifier_outage` mark
        # the chain stamps on the exception, never this shared slot.
        self._outage = True
        if last_err is not None:
            raise last_err
        raise RuntimeError("no bls verifier layer accepts work")

    def serving_layer(self) -> str | None:
        """The layer that served THIS task's most recent verdict
        (call-accurate under concurrent imports, unlike `last_layer`)."""
        return _serving_layer.get()

    def in_outage(self) -> bool:
        """True after a verify had every layer err/refuse, until any
        layer serves again. Advisory (dashboards, notifier, tests): a
        shared slot, so concurrent imports can flip it — scoring
        decisions ride the rejection exception instead (chain.py sets
        `verifier_outage` per call)."""
        return self._outage

    def _note_skip(self, name: str) -> None:
        if self._metrics is not None:
            self._metrics.fallback_skipped.labels(name).inc()

    def _note_fallback(self, name: str, err: Exception | None) -> None:
        parent = tracing.current()
        if parent is not None:
            import time

            now = time.monotonic_ns()
            attrs = {"layer": name}
            if err is not None:
                attrs["after_error"] = str(err)[:120]
            tracing.record(parent, "bls_fallback", now, now, attrs)

    def can_accept_work(self) -> bool:
        """The first layer still in rotation governs admission: a DOWN
        primary hands the decision to its fallback, but a merely
        SATURATED primary's refusal stands — the gossip processor must
        shed (the pre-degradation backpressure contract) rather than
        drain every queue into the slowest layer."""
        for _, layer in self.layers:
            if _layer_down(layer):
                continue
            return layer.can_accept_work()
        return False

    async def close(self) -> None:
        for _, layer in self.layers:
            try:
                await layer.close()
            except Exception:
                pass


def _layer_down(layer: IBlsVerifier) -> bool:
    """A layer is out of rotation only when it SAYS it's down (offload
    client / device pool expose `is_down`); verifiers without the
    concept are always attempted — their errors degrade anyway, and
    inferring down from can_accept_work would reintroduce the
    silent-degradation-on-saturation this module exists to prevent."""
    is_down = getattr(layer, "is_down", None)
    return bool(is_down()) if callable(is_down) else False
