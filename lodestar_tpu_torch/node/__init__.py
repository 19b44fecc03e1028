"""BeaconNode composition root (reference `beacon-node/src/node/nodejs.ts:141`).

`BeaconNode.init` wires the full runtime in the reference's order: db →
metrics (+ scrape server) → chain (BLS verifier pool + fork choice +
pools) → clock → REST API → status notifier. `close()` runs the abort
cascade in reverse (`nodejs.ts:146-152`).

The port of `lodestar_tpu.node`, with its imports rewritten and four
departures (ROADMAP Queue 3):

* `BeaconNodeOptions.device` ("cuda" by default, or "cpu") names the
  device the node verifies and hashes on. On "cuda" the node checks for
  CUDA first, and raises `RuntimeError` before it opens a db, binds a
  server or starts a thread; nothing falls back to the CPU.
* `use_device_verifier` defaults to None, "the device's default": with no
  offload endpoints the verifier is `BlsDeviceVerifierPool` on "cuda" and
  the host oracle `BlsSingleThreadVerifier` on "cpu" (the JAX node's
  default everywhere). An explicit True gives the pool on the node's
  device, an explicit False the oracle. Every pool the node builds, the
  offload chain's "device" layer too, runs on the node's device, and so
  does the state root (`configure_device_htr(device=)`).
* `offload_fallback="device"` on "cuda" ends the offload chain at the
  card's pool: no host oracle follows it, so an error there fails closed.
  On "cpu" the chain keeps the JAX package's "cpu" layer, and
  `offload_fallback="cpu"` still means offload, then the host oracle.
* No KZG fallback counter is configured: the port's KZG raises where the
  JAX package's falls back, so `lodestar_kzg_device_fallback_total` stays
  registered (scrapes keep the JAX package's text) and stays at zero.
"""

from __future__ import annotations

import asyncio

from lodestar_tpu_torch.api import BeaconApiImpl, BeaconRestApiServer
from lodestar_tpu_torch.chain.bls import BlsSingleThreadVerifier, IBlsVerifier
from lodestar_tpu_torch.chain.chain import BeaconChain
from lodestar_tpu_torch.chain.clock import Clock
from lodestar_tpu_torch.db import DbController, FileDbController, MemoryDbController
from lodestar_tpu_torch.logger import get_logger
from lodestar_tpu_torch.metrics import BeaconMetrics, MetricsServer, create_metrics
from lodestar_tpu_torch.params import BeaconPreset, active_preset

__all__ = ["BeaconNode", "BeaconNodeOptions", "NODE_DEVICES"]

#: the devices a node runs its verifier and state root on
NODE_DEVICES = ("cuda", "cpu")


class BeaconNodeOptions:
    def __init__(
        self,
        *,
        db_path: str | None = None,
        rest_port: int = 9596,
        rest_enabled: bool = True,
        metrics_port: int = 8008,
        metrics_enabled: bool = False,
        device: str = "cuda",
        use_device_verifier: bool | None = None,
        manual_clock: bool = False,
        p2p_enabled: bool = False,
        p2p_port: int = 0,
        bootnodes: list[tuple[str, int]] | None = None,
        on_shutdown_request=None,
        tracing_enabled: bool = False,
        tracing_slow_slot_ms: float = 2000.0,
        tracing_export_dir: str | None = None,
        tracing_export_max_files: int = 256,
        tracing_export_max_age_s: float | None = None,
        offload_endpoints: list[str] | None = None,
        offload_breaker_threshold: int | None = None,
        offload_breaker_reset_s: float | None = None,
        offload_hedge_delay_ms: float | None = None,
        offload_fallback: str = "cpu",
        offload_audit_rate: float | None = None,
        offload_audit_budget: float | None = None,
        offload_audit_via: str = "cpu",
        offload_audit_seed: int | None = None,
        offload_quarantine_cooloff_s: float | None = None,
        offload_unquarantine: list[str] | None = None,
        scheduler_enabled: bool = True,
        bls_device_prep: str = "auto",
        bls_pipeline: str = "auto",
        bls_single_launch: str = "auto",
        htr_device: str = "auto",
        bls_mesh: str = "auto",
        offload_tenant: str | None = None,
        launch_telemetry: str = "auto",
        slo_enabled: bool = True,
        slo_slack_floor_ms: float = 0.0,
    ):
        self.db_path = db_path
        self.rest_port = rest_port
        self.rest_enabled = rest_enabled
        self.metrics_port = metrics_port
        self.metrics_enabled = metrics_enabled
        if device not in NODE_DEVICES:
            raise ValueError(f"device must be one of {NODE_DEVICES}, got {device!r}")
        self.device = device
        self.use_device_verifier = use_device_verifier
        self.manual_clock = manual_clock
        self.p2p_enabled = p2p_enabled
        self.p2p_port = p2p_port
        self.bootnodes = list(bootnodes or [])
        # fatal-error callback (reference ProcessShutdownCallback): the
        # embedding process decides how to die; None = log only
        self.on_shutdown_request = on_shutdown_request
        # per-slot pipeline tracing (lodestar_tpu_torch.tracing): off by default
        self.tracing_enabled = tracing_enabled
        self.tracing_slow_slot_ms = tracing_slow_slot_ms
        self.tracing_export_dir = tracing_export_dir
        self.tracing_export_max_files = tracing_export_max_files
        self.tracing_export_max_age_s = tracing_export_max_age_s
        # BLS offload endpoints (host:port); non-empty routes the chain's
        # verifier through BlsOffloadClient with load-aware routing
        self.offload_endpoints = list(offload_endpoints or [])
        # per-endpoint circuit breaker tuning; None = the resilience
        # module's defaults (the one definition of those numbers)
        from lodestar_tpu_torch.offload.resilience import (
            DEFAULT_FAILURE_THRESHOLD,
            DEFAULT_RESET_TIMEOUT_S,
        )

        self.offload_breaker_threshold = (
            DEFAULT_FAILURE_THRESHOLD
            if offload_breaker_threshold is None
            else offload_breaker_threshold
        )
        self.offload_breaker_reset_s = (
            DEFAULT_RESET_TIMEOUT_S
            if offload_breaker_reset_s is None
            else offload_breaker_reset_s
        )
        # true hedged requests: a concurrent second RPC fires when the
        # primary is silent past this delay (first verdict wins, the
        # loser's verdict is discarded). None/<=0 = sequential
        # split-budget retry (the legacy hedge). The shipped default
        # lives in resilience.py with TUNING.md provenance.
        self.offload_hedge_delay_ms = (
            None
            if offload_hedge_delay_ms is None or offload_hedge_delay_ms <= 0
            else float(offload_hedge_delay_ms)
        )
        # degradation chain below the offload client: "cpu" (offload →
        # CPU oracle), "device" (offload → local device pool → CPU), or
        # "none" (offload errors reject blocks until the host returns)
        if offload_fallback not in ("none", "cpu", "device"):
            raise ValueError(f"offload_fallback must be none|cpu|device, got {offload_fallback!r}")
        self.offload_fallback = offload_fallback
        # Byzantine audit (offload/audit.py): randomized cross-checking
        # of offload verdicts against an independent verifier. rate 0
        # disables; "helper" re-verifies on a second endpoint (CPU
        # arbitration) when more than one is configured.
        from lodestar_tpu_torch.offload.audit import DEFAULT_AUDIT_BUDGET, DEFAULT_AUDIT_RATE
        from lodestar_tpu_torch.offload.resilience import DEFAULT_QUARANTINE_COOLOFF_S

        self.offload_audit_rate = (
            DEFAULT_AUDIT_RATE if offload_audit_rate is None else offload_audit_rate
        )
        self.offload_audit_budget = (
            DEFAULT_AUDIT_BUDGET if offload_audit_budget is None else offload_audit_budget
        )
        if offload_audit_via not in ("cpu", "helper"):
            raise ValueError(f"offload_audit_via must be cpu|helper, got {offload_audit_via!r}")
        self.offload_audit_via = offload_audit_via
        self.offload_audit_seed = offload_audit_seed
        # quarantine cool-off after a Byzantine event; 0 = until the
        # operator lifts it (--offload-unquarantine)
        self.offload_quarantine_cooloff_s = (
            DEFAULT_QUARANTINE_COOLOFF_S
            if offload_quarantine_cooloff_s is None
            else offload_quarantine_cooloff_s
        )
        self.offload_unquarantine = list(offload_unquarantine or [])
        # device work scheduler (lodestar_tpu_torch.scheduler) for the in-process
        # pool; False restores FIFO launches (debug/comparison only)
        self.scheduler_enabled = scheduler_enabled
        # batch-verify input prep placement (models/batch_verify prep
        # modes): "auto" runs decompression/subgroup/hash-to-G2 on the
        # device only on a CUDA device; "on"/"off" force. Validated
        # against the model layer's canonical mode set (cli.py keeps a
        # literal copy — argparse choices must not import torch)
        from lodestar_tpu_torch.models.batch_verify import PREP_MODES

        if bls_device_prep not in PREP_MODES:
            raise ValueError(
                f"bls_device_prep must be one of {PREP_MODES}, got {bls_device_prep!r}"
            )
        self.bls_device_prep = bls_device_prep
        # prep→verify double buffering (chain/bls/pool.py): "auto"
        # overlaps prep of batch k+1 with verify of batch k only when
        # the mesh has a sibling lane; "on"/"off" force. Validated
        # against the pool's canonical mode set (cli.py keeps a literal
        # copy — argparse choices must not import the chain.bls package)
        from lodestar_tpu_torch.chain.bls.pool import PIPELINE_MODES

        if bls_pipeline not in PIPELINE_MODES:
            raise ValueError(
                f"bls_pipeline must be one of {PIPELINE_MODES}, got {bls_pipeline!r}"
            )
        self.bls_pipeline = bls_pipeline
        # single-launch verification (models/batch_verify.py): "auto"
        # verifies each batch as ONE CUDA graph replay on a CUDA device
        # (an explicit device-prep "off" pin keeps the split schedule);
        # "on"/"off" force. A single-launch error raises (no fallback).
        # Validated against the model layer's canonical mode set (cli.py
        # keeps a literal copy — argparse choices must not import torch)
        from lodestar_tpu_torch.models.batch_verify import SINGLE_LAUNCH_MODES

        if bls_single_launch not in SINGLE_LAUNCH_MODES:
            raise ValueError(
                f"bls_single_launch must be one of {SINGLE_LAUNCH_MODES}, "
                f"got {bls_single_launch!r}"
            )
        self.bls_single_launch = bls_single_launch
        # state hashTreeRoot placement (ssz/device_htr.py collector):
        # "auto" flushes dirty subtrees through the device SHA-256
        # levels only on a CUDA device (the node's `device`); "on"/"off"
        # force. A device error raises (no fallback).
        from lodestar_tpu_torch.ssz.device_htr import HTR_MODES

        if htr_device not in HTR_MODES:
            raise ValueError(
                f"htr_device must be one of {HTR_MODES}, got {htr_device!r}"
            )
        self.htr_device = htr_device
        # verifier mesh placement (chain/bls/mesh.py): "auto" serves the
        # local pool on per-GPU launch lanes when more than one CUDA
        # device is visible; "on"/"off" force.
        # A wedged chip degrades the pool to the remaining lanes.
        from lodestar_tpu_torch.chain.bls.mesh import MESH_MODES

        if bls_mesh not in MESH_MODES:
            raise ValueError(f"bls_mesh must be one of {MESH_MODES}, got {bls_mesh!r}")
        self.bls_mesh = bls_mesh
        # tenant identity for the offload client (multi-tenant serving
        # hosts meter quotas and stride-fair shares per tenant) —
        # validated here so a config typo is a startup error, not a
        # per-verify offload outage
        if offload_tenant is not None:
            from lodestar_tpu_torch.offload import validate_tenant

            try:
                validate_tenant(offload_tenant)
            except Exception as e:
                raise ValueError(f"offload_tenant: {e}") from e
        self.offload_tenant = offload_tenant
        # device launch telemetry (lodestar_tpu_torch/telemetry.py): per-
        # dispatch wall time / program / size class / compile detection
        # at the counted launch seams. "auto" records once the node
        # installs the metric sink (i.e. on every node); "off" leaves
        # the seams one flag check from free. Validated against the
        # telemetry module's canonical tuple (cli.py keeps a literal
        # copy per the argparse-import doctrine)
        from lodestar_tpu_torch.telemetry import TELEMETRY_MODES

        if launch_telemetry not in TELEMETRY_MODES:
            raise ValueError(
                f"launch_telemetry must be one of {TELEMETRY_MODES}, got {launch_telemetry!r}"
            )
        self.launch_telemetry = launch_telemetry
        # slot-deadline SLO accounting (lodestar_tpu_torch/slo): per-priority-
        # class deadline slack at enqueue/dispatch/verdict plus the
        # good/total SLI pairs. The slack floor widens the miss margin
        # (0 = miss only when the deadline is actually blown); negative
        # would silently forgive real misses, so it is a startup error
        if slo_slack_floor_ms < 0:
            raise ValueError(
                f"slo_slack_floor_ms must be >= 0, got {slo_slack_floor_ms!r}"
            )
        self.slo_enabled = slo_enabled
        self.slo_slack_floor_ms = slo_slack_floor_ms


class BeaconNode:
    def __init__(
        self, *, chain, clock, db, metrics, rest_server, metrics_server, bls, processor=None
    ):
        self.chain = chain
        self.clock = clock
        self.db = db
        self.metrics = metrics
        self.rest_server = rest_server
        self.metrics_server = metrics_server
        self.bls = bls
        self.processor = processor
        self.network = None  # Libp2pBeaconNetwork when p2p is enabled
        self._drain_task = None
        self.log = get_logger(name="lodestar.node")

    def on_gossip(self, topic: str, message, peer: str = "") -> bool:
        """Ingress point for the network layer: enqueue a gossip message
        for validated processing (reference network -> NetworkProcessor)."""
        return self.processor.push(topic, message, peer) if self.processor else False

    def start_gossip_drain(self, interval_s: float = 0.05) -> None:
        """Background drain loop over the processor's queues (reference
        NetworkProcessor executeWork scheduling)."""
        if self.processor is None or self._drain_task is not None:
            return

        async def loop():
            while True:
                try:
                    n = await self.processor.execute_work()
                except Exception as e:  # keep draining through handler storms
                    self.log.warn("gossip drain error", {"error": str(e)[:120]})
                    n = 0
                await asyncio.sleep(0 if n else interval_s)

        self._drain_task = asyncio.ensure_future(loop())

    @classmethod
    async def init(
        cls,
        *,
        anchor_state,
        chain_config=None,
        opts: BeaconNodeOptions | None = None,
        p: BeaconPreset | None = None,
        time_fn=None,
        db: DbController | None = None,
    ) -> "BeaconNode":
        opts = opts or BeaconNodeOptions()
        p = p or active_preset()

        # 0. the device: CUDA asked for and missing raises here, before
        # any db is opened, server bound or thread started
        from lodestar_tpu_torch.models.batch_verify import resolve_device

        resolve_device(opts.device)

        # 1. db (a pre-opened controller — e.g. from the restart-from-db
        # anchor probe — takes precedence; the WAL replays only once)
        if db is None:
            if opts.db_path:
                db = FileDbController(opts.db_path)
            else:
                db = MemoryDbController()

        # 2. metrics
        metrics: BeaconMetrics = create_metrics()
        metrics_server = None
        if opts.metrics_enabled:
            metrics_server = MetricsServer(metrics, port=opts.metrics_port)
            metrics_server.start()

        # 2b. pipeline tracing: the span tracer is process-global (the
        # pipeline crosses layers that never see the node object); only
        # an explicit opt-in reconfigures it, so embedded/test tracers
        # set up by the caller are left alone
        if opts.tracing_enabled:
            from lodestar_tpu_torch import tracing as _tracing

            _tracing.configure(
                enabled=True,
                slow_slot_ms=opts.tracing_slow_slot_ms,
                export_dir=opts.tracing_export_dir,
                export_max_files=opts.tracing_export_max_files,
                export_max_age_s=opts.tracing_export_max_age_s,
                metrics=metrics.trace,
            )

        # 2c. event-loop lag sampler: a fixed-interval sleep whose
        # overshoot IS the scheduling lag — feeds the (previously
        # unobserved) lodestar_event_loop_lag_seconds histogram and the
        # slow-slot dumps, separating loop starvation from device slowness
        from lodestar_tpu_torch.metrics.monitoring import EventLoopLagSampler

        lag_sampler = EventLoopLagSampler(metrics.process.event_loop_lag)
        if opts.tracing_enabled:
            from lodestar_tpu_torch import tracing as _tracing

            _tracing.configure(lag_ms_supplier=lag_sampler.last_lag_ms)

        # 2d. batch-verify input prep placement + lodestar_bls_prep_*
        # metrics: process-global like the tracer (the prep runs inside
        # the model layer, below any node object)
        from lodestar_tpu_torch.models.batch_verify import (
            configure_device_prep,
            configure_single_launch,
        )

        configure_device_prep(mode=opts.bls_device_prep, metrics=metrics.bls_prep)
        # single-launch verification mode rides the same process-global
        # seam (the router lives in the model layer, below any node
        # object); metrics are shared with the prep family above
        configure_single_launch(mode=opts.bls_single_launch)

        # 2e. state hashTreeRoot placement + lodestar_ssz_htr_* metrics:
        # process-global like the prep mode (the collector runs inside
        # the ssz/state-transition layers, below any node object)
        from lodestar_tpu_torch.ssz.device_htr import configure_device_htr

        configure_device_htr(
            mode=opts.htr_device, metrics=metrics.ssz_htr, device=opts.device
        )

        # (no KZG fallback counter: the port's crypto/kzg.py raises where
        # the JAX package's degrades, so metrics.kzg.device_fallbacks
        # stays registered at zero)

        # 2f. device launch telemetry: mode + the lodestar_device_launch_*
        # sink (process-global — the dispatch seams live in ops/ssz/mesh
        # layers below any node object); the slow-slot dump hook makes a
        # slow slot name its launches inline
        from lodestar_tpu_torch import telemetry as _telemetry

        _telemetry.configure_launch_telemetry(
            mode=opts.launch_telemetry, metrics=metrics.device_launch
        )
        if opts.tracing_enabled:
            from lodestar_tpu_torch import tracing as _tracing

            _tracing.configure(launches_supplier=_telemetry.slow_slot_launches)

        # 3. bls verifier — offload endpoints get the resilience stack:
        # breaker-guarded client, then the verified degradation chain
        # (every layer re-verifies; errors degrade, verdicts are final)
        # The pool's device: None on CUDA, so that --bls-mesh lays one lane
        # on each visible GPU; "cpu" pins one lane to the plain path
        bls: IBlsVerifier
        pool_device = None if opts.device == "cuda" else opts.device
        use_device = (
            opts.device == "cuda"
            if opts.use_device_verifier is None
            else opts.use_device_verifier
        )
        if opts.offload_endpoints:
            from lodestar_tpu_torch.offload.client import BlsOffloadClient

            # 3a. Byzantine audit: seeded sampler + background
            # re-verification. Forensics + quarantine persistence:
            # prefer the tracing export dir (next to the slow-slot
            # dumps), else a subdirectory of the data dir — only a
            # fully in-memory node runs without persistence
            audit_dir = opts.tracing_export_dir
            if audit_dir is None and opts.db_path:
                import os as _os

                # db_path is the WAL *file* (cli passes <dir>/wal.log):
                # persist beside it, inside the data directory
                audit_dir = _os.path.join(
                    _os.path.dirname(_os.path.abspath(opts.db_path)), "offload-audit"
                )
            from lodestar_tpu_torch.offload.audit import AuditSampler, OffloadAuditor

            # ALWAYS constructed: with --offload-audit-rate 0 it is
            # passive (no sampling thread) but still owns quarantine
            # persistence, gauges and rehabilitation — a standing
            # Byzantine verdict keeps its lifecycle regardless of the
            # sampling knob
            auditor = OffloadAuditor(
                sampler=AuditSampler(
                    opts.offload_audit_rate, seed=opts.offload_audit_seed
                ),
                budget=opts.offload_audit_budget,
                dump_dir=audit_dir,
                quarantine_cooloff_s=opts.offload_quarantine_cooloff_s or None,
                metrics=metrics.audit,
                start=opts.offload_audit_rate > 0,
            )
            client = BlsOffloadClient(
                opts.offload_endpoints,
                breaker_threshold=opts.offload_breaker_threshold,
                breaker_reset_s=opts.offload_breaker_reset_s,
                hedge_delay_ms=opts.offload_hedge_delay_ms,
                metrics=metrics.resilience,
                auditor=auditor,
                quarantine_cooloff_s=opts.offload_quarantine_cooloff_s or None,
                tenant=opts.offload_tenant,
            )
            if opts.offload_audit_via == "helper" and len(opts.offload_endpoints) > 1:
                from lodestar_tpu_torch.offload.audit import cross_helper_reference

                auditor.set_reference(cross_helper_reference(client))
            # operator lifts first, then re-apply persisted Byzantine
            # quarantines — a restart must not silently re-trust a caught
            # liar, and that holds even at --offload-audit-rate 0 (the
            # passive auditor still reads/writes the quarantine file)
            persisted_before = set(auditor.load_quarantined())
            for target in opts.offload_unquarantine:
                if target not in opts.offload_endpoints and target not in persisted_before:
                    # a typo'd lift silently no-opping would leave the
                    # operator believing the quarantine was cleared
                    client.log.warn(
                        "--offload-unquarantine target matches no configured "
                        "endpoint and no persisted quarantine record",
                        {"target": target},
                    )
                    continue
                # clears breaker state AND (via the bound auditor) the
                # persisted record — the lift logic lives in one place
                client.unquarantine_endpoint(target)
            import time as _time

            from lodestar_tpu_torch.offload.audit import remaining_cooloff

            cool = opts.offload_quarantine_cooloff_s or None
            now = _time.time()
            for target, rec in auditor.load_quarantined().items():
                if target in opts.offload_endpoints:
                    client.quarantine_endpoint(
                        target,
                        cooloff_s=remaining_cooloff(rec, cool, now),
                        reason="persisted_byzantine",
                    )
            if opts.offload_fallback == "none":
                bls = client
            else:
                from lodestar_tpu_torch.chain.bls import DegradingBlsVerifier

                layers: list = [("offload", client)]
                if opts.offload_fallback == "device":
                    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool

                    layers.append(
                        (
                            "device_pool",
                            BlsDeviceVerifierPool(
                                scheduler_enabled=opts.scheduler_enabled,
                                sched_metrics=metrics.sched,
                                mesh_mode=opts.bls_mesh,
                                pipeline=opts.bls_pipeline,
                                pipeline_metrics=metrics.bls_pipeline,
                                device=pool_device,
                            ),
                        )
                    )
                # the card's pool fails closed: on "cuda" no host oracle
                # follows it, and its error is the chain's error
                if opts.offload_fallback != "device" or opts.device != "cuda":
                    layers.append(("cpu", BlsSingleThreadVerifier()))
                bls = DegradingBlsVerifier(layers, metrics=metrics.resilience)
        elif use_device:
            from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool

            bls = BlsDeviceVerifierPool(
                scheduler_enabled=opts.scheduler_enabled,
                sched_metrics=metrics.sched,
                mesh_mode=opts.bls_mesh,
                pipeline=opts.bls_pipeline,
                pipeline_metrics=metrics.bls_pipeline,
                device=pool_device,
            )
        else:
            bls = BlsSingleThreadVerifier()

        # 4. clock from genesis time
        clock_kwargs = dict(
            genesis_time=anchor_state.genesis_time,
            seconds_per_slot=chain_config.SECONDS_PER_SLOT if chain_config else 12,
            slots_per_epoch=p.SLOTS_PER_EPOCH,
        )
        if time_fn is not None:
            clock_kwargs["time_fn"] = time_fn
        clock = Clock(**clock_kwargs)

        # 4b. slot-deadline SLO accounting: process-global like the
        # tracer (the verify pool and gossip processor live below any
        # node object). Configured here because this is the first point
        # where genesis_time is known; shares the clock's time_fn so a
        # manual/dev clock keeps the deadline math deterministic
        from lodestar_tpu_torch import slo as _slo

        slo_kwargs = dict(
            enabled=opts.slo_enabled,
            genesis_time=anchor_state.genesis_time,
            seconds_per_slot=clock_kwargs["seconds_per_slot"],
            slots_per_epoch=p.SLOTS_PER_EPOCH,
            metrics=metrics.slo,
            slack_floor_ms=opts.slo_slack_floor_ms,
        )
        if time_fn is not None:
            slo_kwargs["time_fn"] = time_fn
        _slo.configure_slo(**slo_kwargs)

        # 5. chain
        chain = BeaconChain(
            anchor_state=anchor_state,
            bls_verifier=bls,
            db=db,
            p=p,
            cfg=chain_config,
            current_slot=max(clock.current_slot, anchor_state.slot),
            metrics=metrics,
        )
        # light-client server: serves bootstraps/updates once the chain
        # runs altair+ (reference chain/lightClient/index.ts wired in
        # BeaconChain's constructor)
        from lodestar_tpu_torch.params import FAR_FUTURE_EPOCH

        if chain_config is not None and chain_config.ALTAIR_FORK_EPOCH != FAR_FUTURE_EPOCH:
            from lodestar_tpu_torch.chain.light_client_server import LightClientServer

            chain.light_client_server = LightClientServer(chain)
        clock.on_slot(chain.on_slot)
        if not opts.manual_clock:
            clock.start()

        # 6. gossip processor (network ingress -> validated dispatch);
        # the chain remembers the node's loop so REST handler threads can
        # route mutations onto it (single-threaded chain semantics)
        import asyncio as _asyncio

        chain.loop = _asyncio.get_running_loop()
        from lodestar_tpu_torch.network.processor import NetworkProcessor

        processor = NetworkProcessor(chain, metrics=metrics)

        # 7. REST API
        rest_server = None
        if opts.rest_enabled:
            rest_server = BeaconRestApiServer(BeaconApiImpl(chain), port=opts.rest_port)
            rest_server.start()

        node = cls(
            chain=chain, clock=clock, db=db, metrics=metrics,
            rest_server=rest_server, metrics_server=metrics_server, bls=bls,
            processor=processor,
        )

        # status notifier + fatal-error policy (reference node/notifier.ts
        # + chain/chain.ts processShutdownCallback)
        from lodestar_tpu_torch.node.notifier import ProcessFaultPolicy, StatusNotifier

        node.fault = ProcessFaultPolicy(opts.on_shutdown_request)
        chain.fault = node.fault
        node.notifier = StatusNotifier(chain)
        node.lag_sampler = lag_sampler
        if not opts.manual_clock:
            clock.on_slot(node.notifier.on_slot)
            node.start_gossip_drain()
            lag_sampler.start()

        # 8. P2P network (TCP + noise + mplex + gossipsub + reqresp)
        if opts.p2p_enabled:
            from lodestar_tpu_torch.network.service import Libp2pBeaconNetwork

            node.network = Libp2pBeaconNetwork(
                node=node,
                chain=chain,
                listen_port=opts.p2p_port,
                bootnodes=opts.bootnodes,
            )
            await node.network.start()
            node.notifier.network = node.network
            # reqresp + router metric bridges (ReqRespMetrics hook; the
            # notifier's per-slot tick snapshots router/peer gauges)
            node.network.reqresp.metrics = metrics.reqresp
        node.log.info(
            f"beacon node up: slot {clock.current_slot}, "
            f"rest {'on :' + str(rest_server.port) if rest_server else 'off'}"
        )
        return node

    async def close(self) -> None:
        """Abort cascade, reverse init order (nodejs.ts:146-152)."""
        if self.network is not None:
            try:
                await self.network.stop()
            except Exception:
                pass
            self.network = None
        if self._drain_task is not None:
            self._drain_task.cancel()
            try:
                await self._drain_task  # let a mid-import handler finish/unwind
            except BaseException:
                pass
            self._drain_task = None
        if self.rest_server is not None:
            self.rest_server.stop()
        if getattr(self, "lag_sampler", None) is not None:
            await self.lag_sampler.stop()
        await self.clock.stop()
        await self.bls.close()
        if self.metrics_server is not None:
            self.metrics_server.stop()
        self.db.close()
