"""Deterministic fleet chaos harness: N beacon verification stacks
against M offload hosts, one seed, one replayable ledger.

Each simulated node is the REAL stack wired end to end — gossip
processor (`network/processor.py`) → priority scheduler
(`scheduler/core.py`) → degradation chain (`chain/bls/fallback.py`) →
`BlsOffloadClient` — and each simulated host is a real
`BlsOffloadServer` served over the in-process transport
(`offload/server.local_transports`), with a seeded `FaultInjector` on
every node→host edge and on every host's verify backend. No sockets, no
real BLS: signature sets carry a synthetic deterministic "signature"
(`make_set` / `oracle_verify`) so verdict correctness is checkable by
construction, at simulation speed.

Determinism contract: with `virtual_time=True` (the default) one
`SimClock` drives every clock seam — the SLO accountant's wall and
monotonic clocks, the scheduler queue's aging stamps, every breaker's
reset schedule (jitter pinned to 0), the local transports'
`time_remaining`, and every injector's latency sleeps — and the run loop
runs each node's slot work sequentially. `run_fleet(cfg)` with the same
config therefore produces the byte-identical verdict ledger
(`FleetResult.ledger_lines`) and fault schedule
(`FleetResult.fault_schedule`, per-edge `FaultInjector.export_trace()`)
on every run; a failed run replays via `FaultInjector.from_trace`.
`virtual_time=False` trades byte-determinism for real concurrency —
the mode the true-hedge latency experiments use, where the hedge delay
must race a genuinely in-flight RPC.

Scenario matrix (`SCENARIOS` / `build_scenario`): smoke (tier-1 CI),
partition_storm, lying_helper, latency_ramp, chip_wedge, tenant_flood.
`check_invariants` encodes the properties every scenario must hold:
zero wrong verdicts (an invalid set NEVER resolves True, under any
fault class), block import alive within its slot deadline through a
full offload partition (the degradation chain's availability claim),
and every job's SLI counted exactly once (good + miss == total).

The port of `lodestar_tpu.testing.fleet`, over the port's copies of the
stack it wires (host Python and asyncio; no device work).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import random
import time
from dataclasses import dataclass, replace
from types import SimpleNamespace

from lodestar_tpu_torch import slo
from lodestar_tpu_torch.chain.bls.fallback import DegradingBlsVerifier
from lodestar_tpu_torch.chain.bls.interface import IBlsVerifier, VerifySignatureOpts
from lodestar_tpu_torch.crypto.bls.api import SignatureSet
from lodestar_tpu_torch.network.processor import NetworkProcessor
from lodestar_tpu_torch.offload.audit import AuditSampler, OffloadAuditor
from lodestar_tpu_torch.offload.client import BlsOffloadClient
from lodestar_tpu_torch.offload.server import BlsOffloadServer, local_transports
from lodestar_tpu_torch.scheduler import PriorityClass, PriorityWorkQueue

from .clock import SimClock
from .faults import FaultInjector, FaultKind, FaultRule

__all__ = [
    "FleetConfig",
    "FleetEvent",
    "FleetResult",
    "MetricsStub",
    "SCENARIOS",
    "SyntheticCpuVerifier",
    "build_scenario",
    "check_invariants",
    "make_set",
    "oracle_verify",
    "run_fleet",
]


# -- synthetic deterministic crypto -------------------------------------------


def _synthetic_signature(pubkey: bytes, message: bytes) -> bytes:
    """The harness's stand-in pairing: 96 'signature' bytes derived from
    (pubkey, message). Valid by construction iff untampered — verdict
    correctness is decidable without real BLS, at hash speed."""
    return hashlib.sha256(pubkey + message).digest() * 3


def make_set(rng: random.Random, valid: bool = True) -> SignatureSet:
    """One deterministic synthetic signature set from `rng`'s stream."""
    pubkey = rng.randbytes(48)
    message = rng.randbytes(32)
    sig = _synthetic_signature(pubkey, message)
    if not valid:
        sig = bytes([sig[0] ^ 0x01]) + sig[1:]
    return SignatureSet(pubkey=pubkey, message=message, signature=sig)


def oracle_verify(sets: list[SignatureSet]) -> bool:
    """Ground truth for synthetic sets (the harness's CPU oracle and the
    audit reference both bind to this)."""
    return all(
        s.signature == _synthetic_signature(s.pubkey, s.message) for s in sets
    )


class SyntheticCpuVerifier(IBlsVerifier):
    """The degradation chain's always-alive last layer: inline oracle
    verification, with an optional virtual-time cost per call so the
    fallback path is visibly slower than offload in the ledger."""

    def __init__(self, clock: SimClock | None = None, cost_s: float = 0.0) -> None:
        self._clock = clock
        self._cost_s = cost_s

    async def verify_signature_sets(
        self, sets: list[SignatureSet], opts: VerifySignatureOpts | None = None
    ) -> bool:
        if self._clock is not None and self._cost_s:
            self._clock.advance(self._cost_s)
        return oracle_verify(list(sets))

    def can_accept_work(self) -> bool:
        return True

    async def close(self) -> None:
        return None


# -- duck-typed metrics capture ------------------------------------------------


class _Cell:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def set(self, v: float) -> None:
        self.value = float(v)

    def observe(self, v: float) -> None:
        self.value += v


class _Metric:
    def __init__(self) -> None:
        self.cells: dict[tuple[str, ...], _Cell] = {}

    def labels(self, *labels) -> _Cell:
        return self.cells.setdefault(tuple(str(x) for x in labels), _Cell())

    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def total(self) -> float:
        return sum(c.value for c in self.cells.values())


class MetricsStub:
    """Autovivifying stand-in for any labeled-metrics family the client
    touches (`routed`, `hedges`, `hedge_wins`, `failovers`, `shed`,
    breaker gauges, ...) — records values instead of exporting them."""

    def __init__(self) -> None:
        object.__setattr__(self, "_metrics", {})

    def __getattr__(self, name: str) -> _Metric:
        if name.startswith("_"):
            raise AttributeError(name)
        return self._metrics.setdefault(name, _Metric())

    def total(self, name: str) -> float:
        m = self._metrics.get(name)
        return m.total() if m is not None else 0.0

    def snapshot(self) -> dict:
        return {
            name: {"|".join(k) or "_": c.value for k, c in m.cells.items()}
            for name, m in sorted(self._metrics.items())
        }


# -- config / events -----------------------------------------------------------


#: actions that START a degradation window
_DEGRADE_ACTIONS = {"partition": "partition", "latency": "latency",
                    "wedge": "wedge", "lie": "lie"}
#: actions that END one (mapped to the window kind they clear)
_HEAL_ACTIONS = {"heal": "partition", "clear_latency": "latency",
                 "heal_wedge": "wedge", "clear_lie": "lie"}


@dataclass(frozen=True)
class FleetEvent:
    """One scheduled fault-state change, applied at the start of `slot`.

    `node`/`host` select edges (None = every node / every host);
    `wedge`/`heal_wedge` are host-scoped (the backend seam).
    `latency` REPLACES any prior latency level on the selected edges
    (so a ramp is a sequence of latency events), `lie` adds a
    probabilistic byzantine LIE_VERDICT rule."""

    slot: int
    action: str  # partition|heal|latency|clear_latency|wedge|heal_wedge|lie|clear_lie
    node: int | None = None
    host: int | None = None
    delay_s: float = 0.0
    probability: float = 1.0


@dataclass
class FleetConfig:
    """One seeded simulation: fleet shape, workload scale, fault plan."""

    name: str = "custom"
    nodes: int = 2
    hosts: int = 1
    slots: int = 5
    validators: int = 512
    seed: int = 0
    seconds_per_slot: int = 12
    virtual_time: bool = True
    hedge_delay_ms: float | None = None
    audit_rate: float = 0.0
    invalid_rate: float = 0.0  # fraction of att/api packages made invalid
    api_burst: int = 0  # extra CONCURRENT api jobs per slot (tenant_flood)
    range_sync_every: int = 0  # bulk batch every N slots (0 = off)
    tenant_quota_depth: int | None = None  # host-side per-tenant shed depth
    backend_latency_s: float = 0.0  # per-launch backend hold time (real or virtual)
    cpu_cost_s: float = 0.050  # virtual cost of a fallback-layer verdict
    offload_cost_s: float = 0.002  # virtual cost of an offload verdict
    timeout_s: float = 10.0
    events: tuple[FleetEvent, ...] = ()

    def att_packages_per_slot(self) -> int:
        return max(1, min(8, self.validators // 256))


@dataclass
class FleetResult:
    config: FleetConfig
    ledger: list[dict]
    ledger_lines: list[str]  # JSON lines, byte-stable under virtual time
    fault_schedule: dict  # edge name -> FaultInjector.export_trace()
    summary: dict
    metrics: dict  # node index (str) -> MetricsStub.snapshot()
    sli: dict  # slo.wait_budget() at end of run
    endpoint_states: dict  # node index (str) -> client.endpoint_states()


# -- jobs ----------------------------------------------------------------------


@dataclass
class _Job:
    node: int
    slot: int
    jid: str
    cls: PriorityClass
    sets: list[SignatureSet]
    valid: bool
    js: object = None
    enqueued_at: float = 0.0


class _SimHost:
    """One offload host: real `BlsOffloadServer` on a fake target, its
    backend behind a seeded injector (the chip-wedge / backend-fault
    seam), chip table reflecting the wedge flag."""

    def __init__(self, index: int, cfg: FleetConfig, clock: SimClock | None) -> None:
        self.index = index
        self.target = f"sim-host-{index}:9"
        self.wedged = False
        rules = []
        if cfg.backend_latency_s > 0:
            # baseline per-launch hold time: with real time this is what
            # makes tenant service slots actually contended (quota sheds
            # need queue depth, and depth needs occupancy)
            rules.append(
                FaultRule(kind=FaultKind.LATENCY, delay_s=cfg.backend_latency_s)
            )
        self.backend_injector = FaultInjector(
            rules,
            seed=cfg.seed * 104729 + index,
            sleep_fn=clock.sleep if clock is not None else None,
        )
        backend = self.backend_injector.wrap_backend(
            oracle_verify, target=f"host{index}-backend"
        )
        kwargs = {}
        if cfg.tenant_quota_depth is not None:
            # cap EVERY class at the quota depth (reject == shed): the
            # flood scenario floods the API class, which per-tenant
            # grading only turns away at reject_depth
            kwargs["tenant_shed_depth"] = cfg.tenant_quota_depth
            kwargs["tenant_reject_depth"] = cfg.tenant_quota_depth
        self.server = BlsOffloadServer(
            backend, chip_status_fn=self._chip_table, **kwargs
        )

    def _chip_table(self):
        return [(self.server.occupancy.occupancy_permille(), self.wedged)]

    def set_wedged(self, wedged: bool) -> None:
        """Chip wedge: the backend errors every launch (ERROR_FRAME at
        the reply layer) and the Status mesh trailer advertises the
        wedged chip, so routing sees capacity drop within one probe."""
        self.wedged = wedged
        inj = self.backend_injector
        inj.rules = [r for r in inj.rules if r.kind is not FaultKind.ERROR_FRAME]
        if wedged:
            inj.rules.append(FaultRule(kind=FaultKind.ERROR_FRAME))


class _SimNode:
    """One beacon node's verification stack, wired end to end."""

    def __init__(
        self,
        index: int,
        cfg: FleetConfig,
        clock: SimClock | None,
        hosts: list[_SimHost],
    ) -> None:
        self.index = index
        self.cfg = cfg
        self.clock = clock
        self.rng = random.Random((cfg.seed << 16) ^ (index * 7919 + 1))
        self.metrics = MetricsStub()
        self.ledger: list[dict] = []
        # one injector per node->host edge: its seed (and therefore its
        # probabilistic draws AND its exported schedule) is a pure
        # function of (fleet seed, node, host)
        self.edge_injectors: dict[str, FaultInjector] = {
            h.target: FaultInjector(
                seed=cfg.seed * 7919 + index * 101 + h.index,
                sleep_fn=clock.sleep if clock is not None else None,
            )
            for h in hosts
        }
        servers = {h.target: h.server for h in hosts}
        base = local_transports(
            servers, clock=clock.monotonic if clock is not None else None
        )

        def wrapper(target: str, method: str, fn):
            return self.edge_injectors[target].wrap_transport(
                target, method, base(target, method, fn)
            )

        self.auditor = None
        if cfg.audit_rate > 0.0:
            self.auditor = OffloadAuditor(
                sampler=AuditSampler(
                    rate=cfg.audit_rate, seed=cfg.seed * 31 + index
                ),
                reference=lambda sets, exclude: (oracle_verify(sets), None),
                budget=1.0,
            )
        self.client = BlsOffloadClient(
            [h.target for h in hosts],
            timeout_s=cfg.timeout_s,
            # the run loop probes synchronously at every slot start; the probe
            # thread fires once at startup and then sleeps out the run
            probe_interval_s=3600.0,
            metrics=self.metrics,
            transport_wrapper=wrapper,
            auditor=self.auditor,
            hedge_delay_ms=cfg.hedge_delay_ms,
            tenant=f"node{index}",
            quarantine_cooloff_s=None,  # lying helpers stay out
            breaker_clock=clock.monotonic if clock is not None else None,
        )
        for ep in self.client._endpoints:
            ep.breaker.jitter = 0.0  # reset schedule must replay exactly
        cpu = SyntheticCpuVerifier(clock, cfg.cpu_cost_s)
        self.deg = DegradingBlsVerifier([("offload", self.client), ("cpu", cpu)])
        self.queue = PriorityWorkQueue(
            time_fn=clock.monotonic_ns if clock is not None else time.monotonic_ns
        )
        chain = SimpleNamespace(bls=self.deg)
        self.processor = NetworkProcessor(
            chain,
            handlers={
                "beacon_block": self._gossip_handler(),
                "beacon_attestation": self._gossip_handler(),
            },
        )
        self._jid = 0

    # -- workload ---------------------------------------------------------------

    def _gossip_handler(self):
        async def handler(job: _Job, peer: str) -> None:
            self._enqueue(job)

        return handler

    def _enqueue(self, job: _Job) -> None:
        job.js = slo.job_begin(job.cls, job.slot)
        job.enqueued_at = self._now()
        self.queue.put_nowait(job, job.cls)

    def _now(self) -> float:
        return self.clock.time() if self.clock is not None else time.time()

    def _new_job(self, slot: int, cls: PriorityClass, n_sets: int, valid: bool) -> _Job:
        self._jid += 1
        return _Job(
            node=self.index,
            slot=slot,
            jid=f"n{self.index}-s{slot}-j{self._jid}",
            cls=cls,
            sets=[make_set(self.rng, valid) for _ in range(n_sets)],
            valid=valid,
        )

    def push_slot_workload(self, slot: int) -> None:
        """Mainnet-shaped synthetic slot: one gossip block, a validator-
        scaled burst of attestation packages, one API call, periodic
        range-sync bulk. Blocks are always valid (their liveness is the
        invariant under test); attestation/api validity draws from the
        node's seeded stream at `invalid_rate`."""
        cfg = self.cfg
        self.processor.push(
            "beacon_block",
            self._new_job(slot, PriorityClass.GOSSIP_BLOCK, 2, True),
            peer=f"peer{self.index}",
        )
        for _ in range(cfg.att_packages_per_slot()):
            valid = self.rng.random() >= cfg.invalid_rate
            self.processor.push(
                "beacon_attestation",
                self._new_job(slot, PriorityClass.GOSSIP_ATTESTATION, 4, valid),
                peer=f"peer{self.index}",
            )
        valid = self.rng.random() >= cfg.invalid_rate
        self._enqueue(self._new_job(slot, PriorityClass.API, 1, valid))
        if cfg.range_sync_every and slot and slot % cfg.range_sync_every == 0:
            self._enqueue(self._new_job(slot, PriorityClass.RANGE_SYNC, 16, True))

    # -- drive ------------------------------------------------------------------

    def probe(self) -> None:
        """Synchronous per-slot endpoint probe — the deterministic stand-
        in for the client's background probe loop (parked on a one-hour
        interval). Keeps `ep.healthy` converging with the fault state at
        slot granularity, and fires `note_probe_success` on recovery so
        a healed endpoint's breaker grants its half-open trial."""
        for ep in self.client._endpoints:
            if self.client._probe_one(ep):
                ep.consecutive_failures = 0
            else:
                ep.consecutive_failures += 1

    async def run_job(self, job: _Job, waited_ns: int) -> dict:
        slo.job_dequeued(job.js, waited_ns)
        slo.job_launch(job.js)
        error = None
        verdict: bool | None = None
        layer = None
        try:
            verdict = await self.deg.verify_signature_sets(
                job.sets, VerifySignatureOpts(priority=job.cls, slot=job.slot)
            )
            layer = self.deg.serving_layer()
        except Exception as e:  # every layer erred: fail closed
            error = f"{type(e).__name__}: {e}"[:120]
        if self.clock is not None:
            self.clock.advance(
                self.cfg.offload_cost_s if layer == "offload" else self.cfg.cpu_cost_s
            )
        slo.job_verdict(job.js, bool(verdict))
        line = {
            "node": job.node,
            "slot": job.slot,
            "jid": job.jid,
            "cls": job.cls.label,
            "n_sets": len(job.sets),
            "valid": job.valid,
            "verdict": verdict,
            "layer": layer,
            "error": error,
            "t_enqueue": round(job.enqueued_at, 6),
            "t_verdict": round(self._now(), 6),
            "slack_ms": (
                round((job.js.deadline_s - self._now()) * 1000.0, 3)
                if job.js is not None
                else None
            ),
        }
        self.ledger.append(line)
        return line

    async def drain(self) -> int:
        """One slot's service: processor tick into the scheduler queue,
        then stride-fair dequeue until empty."""
        await self.processor.execute_work()
        served = 0
        while True:
            out = self.queue.get_nowait()
            if out is None:
                return served
            job, _cls, waited_ns = out
            await self.run_job(job, waited_ns)
            served += 1

    async def api_flood(self, slot: int) -> None:
        """`api_burst` CONCURRENT same-tenant API jobs — the tenant-
        quota pressure source (tenant_flood scenario). Concurrency is
        real (executor threads), so this path is invariant-checked, not
        byte-compared."""
        jobs = []
        for _ in range(self.cfg.api_burst):
            job = self._new_job(slot, PriorityClass.API, 1, True)
            job.js = slo.job_begin(job.cls, job.slot)
            job.enqueued_at = self._now()
            jobs.append(job)
        await asyncio.gather(*(self.run_job(j, 0) for j in jobs))

    def drain_audit(self) -> None:
        if self.auditor is not None:
            self.auditor.drain(timeout_s=10.0)

    async def close(self) -> None:
        await self.deg.close()


# -- the run loop --------------------------------------------------------------


def _expand_edges(ev: FleetEvent, n_nodes: int, n_hosts: int):
    nodes = [ev.node] if ev.node is not None else list(range(n_nodes))
    hosts = [ev.host] if ev.host is not None else list(range(n_hosts))
    for n in nodes:
        for h in hosts:
            yield n, h


def _apply_event(
    ev: FleetEvent,
    nodes: list[_SimNode],
    hosts: list[_SimHost],
    active: set[tuple],
) -> None:
    if ev.action in ("wedge", "heal_wedge"):
        sel = [ev.host] if ev.host is not None else list(range(len(hosts)))
        for h in sel:
            hosts[h].set_wedged(ev.action == "wedge")
            for n in range(len(nodes)):
                key = ("wedge", n, h)
                active.add(key) if ev.action == "wedge" else active.discard(key)
        return
    for n, h in _expand_edges(ev, len(nodes), len(hosts)):
        inj = nodes[n].edge_injectors[hosts[h].target]
        target = hosts[h].target
        if ev.action == "partition":
            inj.partition(target)
        elif ev.action == "heal":
            inj.heal(target)
        elif ev.action == "latency":
            # replace-not-stack: a ramp is successive latency levels
            inj.rules = [r for r in inj.rules if r.kind is not FaultKind.LATENCY]
            if ev.delay_s > 0:
                inj.rules.append(
                    FaultRule(
                        kind=FaultKind.LATENCY,
                        delay_s=ev.delay_s,
                        targets=frozenset({target}),
                        methods=frozenset({"verify"}),
                    )
                )
        elif ev.action == "clear_latency":
            inj.rules = [r for r in inj.rules if r.kind is not FaultKind.LATENCY]
        elif ev.action == "lie":
            inj.rules.append(
                FaultRule(
                    kind=FaultKind.LIE_VERDICT,
                    probability=ev.probability,
                    targets=frozenset({target}),
                    methods=frozenset({"verify"}),
                )
            )
        elif ev.action == "clear_lie":
            inj.rules = [r for r in inj.rules if r.kind is not FaultKind.LIE_VERDICT]
        else:
            raise ValueError(f"unknown fleet event action: {ev.action!r}")
        kind = _DEGRADE_ACTIONS.get(ev.action) or _HEAL_ACTIONS.get(ev.action)
        key = (kind, n, h)
        if ev.action in _DEGRADE_ACTIONS and (
            ev.action != "latency" or ev.delay_s > 0
        ):
            active.add(key)
        else:
            active.discard(key)


async def _run_fleet(cfg: FleetConfig) -> FleetResult:
    clock = SimClock(0.0) if cfg.virtual_time else None
    genesis = 0.0 if clock is not None else time.time()
    slo.reset_slo()
    slo.configure_slo(
        genesis_time=genesis,
        seconds_per_slot=cfg.seconds_per_slot,
        time_fn=clock.time if clock is not None else time.time,
        monotonic_ns_fn=clock.monotonic_ns if clock is not None else time.monotonic_ns,
    )
    hosts = [_SimHost(i, cfg, clock) for i in range(cfg.hosts)]
    nodes = [_SimNode(i, cfg, clock, hosts) for i in range(cfg.nodes)]
    events_by_slot: dict[int, list[FleetEvent]] = {}
    for ev in cfg.events:
        events_by_slot.setdefault(ev.slot, []).append(ev)
    active: set[tuple] = set()
    degraded_slots: list[bool] = []
    heal_slots = [
        ev.slot for ev in cfg.events if ev.action in _HEAL_ACTIONS
    ]
    try:
        for slot in range(cfg.slots):
            if clock is not None:
                clock.advance_to(genesis + slot * cfg.seconds_per_slot)
            for ev in events_by_slot.get(slot, ()):
                _apply_event(ev, nodes, hosts, active)
            degraded_slots.append(bool(active))
            for node in nodes:
                node.probe()
                node.push_slot_workload(slot)
            for node in nodes:
                await node.drain()
                if cfg.api_burst:
                    await node.api_flood(slot)
                node.drain_audit()
        # leftovers (work a backpressured tick deferred): serve them so
        # every begun job reaches its exactly-once verdict accounting
        for node in nodes:
            for _ in range(3):
                if await node.drain() == 0 and node.processor.pending == 0:
                    break
            node.drain_audit()
        endpoint_states = {
            str(n.index): n.client.endpoint_states() for n in nodes
        }
        sli = slo.wait_budget()
    finally:
        for node in nodes:
            await node.close()
        slo.reset_slo()

    ledger: list[dict] = []
    for node in nodes:
        ledger.extend(node.ledger)
    ledger.sort(key=lambda ln: (ln["slot"], ln["node"], ln["jid"]))
    ledger_lines = [json.dumps(ln, sort_keys=True) for ln in ledger]
    fault_schedule = {
        f"node{n.index}->{target}": inj.export_trace()
        for n in nodes
        for target, inj in sorted(n.edge_injectors.items())
    }
    for h in hosts:
        fault_schedule[f"{h.target}-backend"] = h.backend_injector.export_trace()
    summary = _summarize(
        cfg, ledger, degraded_slots, heal_slots, nodes, endpoint_states, sli
    )
    return FleetResult(
        config=cfg,
        ledger=ledger,
        ledger_lines=ledger_lines,
        fault_schedule=fault_schedule,
        summary=summary,
        metrics={str(n.index): n.metrics.snapshot() for n in nodes},
        sli=sli,
        endpoint_states=endpoint_states,
    )


def _summarize(
    cfg: FleetConfig,
    ledger: list[dict],
    degraded_slots: list[bool],
    heal_slots: list[int],
    nodes: list[_SimNode],
    endpoint_states: dict,
    sli: dict,
) -> dict:
    per_slot: dict[int, int] = {s: 0 for s in range(cfg.slots)}
    wrong = 0
    served = {"offload": 0, "cpu": 0, "none": 0}
    for ln in ledger:
        per_slot[ln["slot"]] = per_slot.get(ln["slot"], 0) + 1
        if not ln["valid"] and ln["verdict"] is True:
            wrong += 1
        served[ln["layer"] if ln["layer"] in served else "none"] += 1
    base = [per_slot[s] for s in range(cfg.slots) if not degraded_slots[s]]
    degr = [per_slot[s] for s in range(cfg.slots) if degraded_slots[s]]
    baseline_tput = sum(base) / len(base) if base else 0.0
    degraded_tput = sum(degr) / len(degr) if degr else baseline_tput
    retention = (
        100.0 * degraded_tput / baseline_tput if baseline_tput > 0 else 100.0
    )
    recovery = 0
    if heal_slots:
        last_heal = max(heal_slots)
        recovery = max(0, cfg.slots - last_heal)
        for s in range(last_heal, cfg.slots):
            blocks = [
                ln
                for ln in ledger
                if ln["slot"] == s and ln["cls"] == "gossip_block"
            ]
            if blocks and all(ln["layer"] == "offload" for ln in blocks):
                recovery = s - last_heal
                break
    quarantined = [
        (node_idx, st["target"])
        for node_idx, states in sorted(endpoint_states.items())
        for st in states
        if st.get("quarantined")
    ]
    misses = sum(c["sli"]["miss"] for c in sli.get("classes", {}).values())
    lat = [
        (ln["t_verdict"] - ln["t_enqueue"]) * 1000.0
        for ln in ledger
        if ln["t_verdict"] is not None
    ]
    mean_latency = sum(lat) / len(lat) if lat else 0.0
    return {
        "scenario": cfg.name,
        "seed": cfg.seed,
        "total_jobs": len(ledger),
        "wrong_verdicts": wrong,
        "served_by_layer": served,
        "baseline_throughput_per_slot": round(baseline_tput, 3),
        "degraded_throughput_per_slot": round(degraded_tput, 3),
        "throughput_retention_pct": round(retention, 2),
        "recovery_slots": recovery,
        "degraded_slot_count": sum(degraded_slots),
        "sli_misses": misses,
        "mean_latency_ms": round(mean_latency, 3),
        "quarantined": quarantined,
        "hedges": sum(n.metrics.total("hedges") for n in nodes),
        "hedge_wins": sum(n.metrics.total("hedge_wins") for n in nodes),
        "failovers": sum(n.metrics.total("failovers") for n in nodes),
        "sheds": sum(n.metrics.total("shed") for n in nodes),
        "byzantine_events": sum(
            len(n.auditor.byzantine_events) for n in nodes if n.auditor is not None
        ),
    }


def run_fleet(cfg: FleetConfig) -> FleetResult:
    """Run one seeded fleet simulation to completion (blocking)."""
    return asyncio.run(_run_fleet(cfg))


# -- invariants ----------------------------------------------------------------


def check_invariants(result: FleetResult) -> list[str]:
    """The properties every scenario must hold, as violation strings
    (empty list == green):

    1. ZERO WRONG VERDICTS: no invalid set ever resolves True, under
       any fault class (fail-closed end to end).
    2. BLOCK IMPORT ALIVE: every gossip block reaches a True verdict
       with slot-deadline slack to spare — through partitions, the
       degradation chain must keep serving.
    3. EXACTLY-ONCE SLI: every job is counted once (good + miss ==
       total == ledger jobs); a retried or hedged job must not double-
       count its miss.
    """
    v: list[str] = []
    for ln in result.ledger:
        if not ln["valid"] and ln["verdict"] is True:
            v.append(f"WRONG VERDICT: invalid job {ln['jid']} resolved True")
    # a byzantine helper's True->False flip is an availability miss the
    # audit layer contains (quarantine) — under lie scenarios liveness
    # means a timely fail-closed answer; everywhere else the valid
    # block must actually import
    lies_injected = any(ev.action == "lie" for ev in result.config.events)
    for ln in result.ledger:
        if ln["cls"] != "gossip_block":
            continue
        if ln["error"] is not None or ln["verdict"] is None:
            v.append(
                f"BLOCK IMPORT DEAD: {ln['jid']} verdict={ln['verdict']} "
                f"error={ln['error']}"
            )
        elif ln["verdict"] is not True and not lies_injected:
            v.append(f"BLOCK REJECTED: valid block {ln['jid']} resolved False")
        elif ln["slack_ms"] is not None and ln["slack_ms"] < 0:
            v.append(
                f"BLOCK DEADLINE MISSED: {ln['jid']} slack_ms={ln['slack_ms']}"
            )
    # exactly-once SLI accounting, reconciled against the ledger: each
    # job contributes ONE total; good iff it resolved True with slack,
    # miss iff its slack went negative (an in-time False verdict is
    # neither — it met the deadline with an answer of 'invalid')
    classes = result.sli.get("classes", {})
    want: dict[str, dict[str, int]] = {}
    for ln in result.ledger:
        w = want.setdefault(ln["cls"], {"total": 0, "good": 0, "miss": 0})
        w["total"] += 1
        slack = ln["slack_ms"]
        met = slack is None or slack >= 0
        if ln["verdict"] is True and met:
            w["good"] += 1
        if not met:
            w["miss"] += 1
    for label, stats in classes.items():
        sli = stats["sli"]
        w = want.get(label, {"total": 0, "good": 0, "miss": 0})
        for k in ("total", "good", "miss"):
            if sli[k] != w[k]:
                v.append(
                    f"SLI MISCOUNT: {label} {k}={sli[k]} != ledger-expected "
                    f"{w[k]} (counted other than exactly once per job)"
                )
    return v


# -- scenario matrix -----------------------------------------------------------


def _smoke(seed: int) -> FleetConfig:
    """Tier-1 CI scenario: 2 nodes, 1 host, 5 virtual slots, full
    offload partition at slot 2, heal at slot 4."""
    return FleetConfig(
        name="smoke",
        nodes=2,
        hosts=1,
        slots=5,
        validators=512,
        seed=seed,
        events=(
            FleetEvent(slot=2, action="partition"),
            FleetEvent(slot=4, action="heal"),
        ),
    )


def _partition_storm(seed: int) -> FleetConfig:
    """Rolling partitions across both hosts, ending in a full blackout
    and a heal — failover, breaker recovery and CPU-fallback liveness
    in one run."""
    return FleetConfig(
        name="partition_storm",
        nodes=3,
        hosts=2,
        slots=12,
        validators=1024,
        seed=seed,
        invalid_rate=0.1,
        range_sync_every=4,
        events=(
            FleetEvent(slot=2, action="partition", host=0),
            FleetEvent(slot=4, action="heal", host=0),
            FleetEvent(slot=5, action="partition", host=1),
            FleetEvent(slot=7, action="heal", host=1),
            FleetEvent(slot=8, action="partition"),
            FleetEvent(slot=10, action="heal"),
        ),
    )


def _lying_helper(seed: int) -> FleetConfig:
    """Host 1 turns byzantine (LIE_VERDICT: re-signed lies the framing
    cannot catch) with the audit layer on at rate 1.0. The workload is
    all-valid, so every lie is a True→False flip: containment (audit
    quarantine) is observable and the zero-wrong-verdict invariant is
    meaningful — nothing invalid is in flight for a lie to whitewash."""
    return FleetConfig(
        name="lying_helper",
        nodes=2,
        hosts=2,
        slots=10,
        validators=512,
        seed=seed,
        audit_rate=1.0,
        # host 0 is the tie-break-preferred route: the liar is the host
        # actually SERVING, so every lie is observable and the audit
        # quarantine must visibly shift traffic to host 1
        events=(FleetEvent(slot=2, action="lie", host=0, probability=1.0),),
    )


def _latency_ramp(seed: int) -> FleetConfig:
    """Host 0's verify latency ramps 50ms → 400ms → 1.5s, then clears.
    Virtual-time: the ramp exercises deadline budgets and failover; the
    real-concurrency hedge race lives in the offload hedge tests."""
    return FleetConfig(
        name="latency_ramp",
        nodes=2,
        hosts=2,
        slots=10,
        validators=512,
        seed=seed,
        events=(
            FleetEvent(slot=2, action="latency", host=0, delay_s=0.05),
            FleetEvent(slot=4, action="latency", host=0, delay_s=0.4),
            FleetEvent(slot=6, action="latency", host=0, delay_s=1.5),
            FleetEvent(slot=8, action="clear_latency", host=0),
        ),
    )


def _chip_wedge(seed: int) -> FleetConfig:
    """Host 0's chip wedges (backend errors + wedged chip advertised);
    traffic must shift to host 1 and return after the heal."""
    return FleetConfig(
        name="chip_wedge",
        nodes=2,
        hosts=2,
        slots=8,
        validators=512,
        seed=seed,
        events=(
            FleetEvent(slot=2, action="wedge", host=0),
            FleetEvent(slot=5, action="heal_wedge", host=0),
        ),
    )


def _tenant_flood(seed: int) -> FleetConfig:
    """Node 1 floods the single shared host with concurrent API bursts
    against a tight per-tenant quota: sheds must hit the flooding
    tenant while gossip classes stay alive. Real concurrency —
    invariant-checked, not byte-compared."""
    return FleetConfig(
        name="tenant_flood",
        nodes=2,
        hosts=1,
        slots=6,
        validators=512,
        seed=seed,
        api_burst=8,
        tenant_quota_depth=2,
        # real time + a real backend hold: quota sheds need genuine
        # service-slot contention, which virtual sleeps cannot create
        virtual_time=False,
        backend_latency_s=0.02,
    )


def _hedge_race(seed: int) -> FleetConfig:
    """Real-time hedge-tuning arm: host 0 holds every verify 250ms from
    slot 1 on while host 1 stays fast. The hedge-delay sweep runs here
    because virtual sleeps return instantly in wall-clock terms — a
    wall-clock hedge timer can only race wall-clock latency. Scored on
    mean verdict latency; invariant-checked, not byte-compared."""
    return FleetConfig(
        name="hedge_race",
        nodes=2,
        hosts=2,
        slots=4,
        validators=512,
        seed=seed,
        virtual_time=False,
        hedge_delay_ms=30.0,
        events=(FleetEvent(slot=1, action="latency", host=0, delay_s=0.25),),
    )


SCENARIOS = {
    "smoke": _smoke,
    "partition_storm": _partition_storm,
    "lying_helper": _lying_helper,
    "latency_ramp": _latency_ramp,
    "chip_wedge": _chip_wedge,
    "tenant_flood": _tenant_flood,
    "hedge_race": _hedge_race,
}


def build_scenario(name: str, seed: int = 0, **overrides) -> FleetConfig:
    """A scenario config by name, with per-experiment knob overrides
    (the chaos experiment runner's sweep entry point)."""
    try:
        make = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}"
        ) from None
    cfg = make(seed)
    return replace(cfg, **overrides) if overrides else cfg
