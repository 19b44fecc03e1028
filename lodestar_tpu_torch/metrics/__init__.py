"""Metrics registry + beacon metric taxonomy + scrape server.

Reference `beacon-node/src/metrics/` — `RegistryMetricCreator`
(`utils/registryMetricCreator.ts`), the lodestar metric groups
(`metrics/lodestar.ts`, incl. the blsThreadPool.* latency decomposition
at :358-430 and the state-transition timers at :279,302), and the HTTP
scrape server (`server/http.ts:14`). Built on prometheus_client (in
image); metric names keep the reference's so existing Grafana dashboards
(`dashboards/lodestar_bls_thread_pool.json`, ...) read unmodified.

The port of `lodestar_tpu.metrics`, with its imports rewritten and one
change: `prometheus_client` is imported when the first registry is built,
not with the module, so every module of the port imports without it. The
families, their names, types, label names, help strings and buckets are
the JAX package's, so the repo's `dashboards/` and `alerts/` read the
port's scrape as they read the JAX package's.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Sequence

from .validator_monitor import ValidatorMonitor

if TYPE_CHECKING:
    from prometheus_client import Counter, Gauge, Histogram

__all__ = [
    "RegistryMetricCreator",
    "BeaconMetrics",
    "BlsPrepMetrics",
    "BlsPipelineMetrics",
    "DeviceLaunchMetrics",
    "TraceMetrics",
    "SloMetrics",
    "SchedulerMetrics",
    "ResilienceMetrics",
    "AuditMetrics",
    "TenantMetrics",
    "create_tenant_metrics",
    "create_metrics",
    "MetricsServer",
    "ValidatorMonitor",
]


class RegistryMetricCreator:
    """Typed factory bound to one registry (reference
    `registryMetricCreator.ts`)."""

    def __init__(self) -> None:
        import prometheus_client

        self._prom = prometheus_client
        self.registry = prometheus_client.CollectorRegistry()

    def gauge(self, name: str, help_: str, labels: Sequence[str] = ()) -> Gauge:
        return self._prom.Gauge(name, help_, labelnames=list(labels), registry=self.registry)

    def counter(self, name: str, help_: str, labels: Sequence[str] = ()) -> Counter:
        return self._prom.Counter(name, help_, labelnames=list(labels), registry=self.registry)

    def histogram(
        self, name: str, help_: str, buckets: Sequence[float], labels: Sequence[str] = ()
    ) -> Histogram:
        return self._prom.Histogram(
            name, help_, labelnames=list(labels), buckets=list(buckets), registry=self.registry
        )

    def scrape(self) -> bytes:
        return self._prom.generate_latest(self.registry)


@dataclass
class BlsPoolMetrics:
    """blsThreadPool.* (reference `metrics/lodestar.ts:358-430`) — the
    worker-pool latency decomposition retargeted at the device pipeline."""

    job_wait_time: Histogram
    jobs_started: Counter
    sig_sets_started: Counter
    success_sets: Counter
    error_sets: Counter
    batch_retries: Counter
    batch_sigs_success: Counter
    time_per_sig_set: Histogram
    latency_to_device: Histogram
    latency_from_device: Histogram


@dataclass
class StateTransitionMetrics:
    epoch_transition_time: Histogram
    process_block_time: Histogram
    state_hash_tree_root_time: Histogram


@dataclass
class GossipMetrics:
    queue_length: Gauge
    queue_dropped: Counter
    accepted: Counter
    rejected: Counter


@dataclass
class ForkChoiceMetrics:
    find_head_time: Histogram
    requests: Counter
    errors: Counter
    reorgs: Counter


@dataclass
class NetworkMetrics:
    peers_by_direction: Gauge
    peer_disconnects: Counter
    gossip_mesh_peers: Gauge
    gossip_received: Counter
    gossip_duplicates: Counter


@dataclass
class SyncMetrics:
    range_sync_batches: Counter
    range_sync_blocks: Counter
    range_sync_errors: Counter
    backfill_blocks: Counter
    unknown_block_requests: Counter


@dataclass
class DbMetrics:
    reads: Counter
    writes: Counter
    size_bytes: Gauge


@dataclass
class RegenMetrics:
    state_cache_hits: Counter
    state_cache_misses: Counter
    checkpoint_cache_hits: Counter
    regen_queue_length: Gauge
    regen_time: Histogram


@dataclass
class OpPoolMetrics:
    attestation_pool_size: Gauge
    aggregated_pool_size: Gauge
    exits: Gauge
    proposer_slashings: Gauge
    attester_slashings: Gauge
    sync_messages: Gauge


@dataclass
class ApiMetrics:
    rest_requests: Counter
    rest_errors: Counter
    rest_response_time: Histogram


@dataclass
class ReqRespMetrics:
    """beacon_reqresp_* detail (reference metrics/lodestar.ts reqresp
    family): per-protocol streams, bytes, timing and rate limiting."""

    requests_sent: Counter
    requests_received: Counter
    request_errors: Counter
    response_time: Histogram
    response_chunks_sent: Counter
    response_chunks_received: Counter
    rate_limited: Counter
    dial_timeouts: Counter
    streams_reset: Counter


@dataclass
class PeerMetrics:
    """lodestar_peers_* detail (reference peerManager metrics)."""

    peer_count: Gauge
    peers_by_client: Gauge
    peer_score: Histogram
    peer_action_count: Counter
    goodbye_sent: Counter
    goodbye_received: Counter
    dials_attempted: Counter
    dials_succeeded: Counter
    long_lived_subnets: Gauge
    discv5_sessions: Gauge
    discv5_findnode_sent: Counter
    discv5_enrs_discovered: Counter


@dataclass
class GossipDetailMetrics:
    """gossipsub router internals (reference gossipsub metrics)."""

    mesh_grafts: Counter
    mesh_prunes: Counter
    ihave_sent: Counter
    iwant_received: Counter
    iwant_served: Counter
    mcache_size: Gauge
    peer_score_by_topic: Gauge
    flood_publishes: Counter
    backoff_violations: Counter


@dataclass
class SyncDetailMetrics:
    """lodestar_sync_* detail (reference sync metrics)."""

    status: Gauge
    peers_by_status: Gauge
    batch_download_time: Histogram
    batch_processing_time: Histogram
    batches_downloaded: Counter
    batch_download_retries: Counter
    head_distance: Gauge
    backfill_earliest_slot: Gauge
    unknown_block_queue_length: Gauge


@dataclass
class DbDetailMetrics:
    read_items: Counter
    write_items: Counter
    batch_write_time: Histogram
    wal_size_bytes: Gauge
    archived_states: Counter
    archived_blocks: Counter
    pruned_blocks: Counter


@dataclass
class ChainDetailMetrics:
    """block pipeline + caches (reference chain metrics)."""

    block_import_time: Histogram
    block_production_time: Histogram
    blocks_imported: Counter
    blocks_rejected: Counter
    attestations_imported: Counter
    seen_attesters_size: Gauge
    seen_aggregators_size: Gauge
    checkpoint_state_cache_size: Gauge
    state_cache_size: Gauge
    light_client_updates_served: Counter
    light_client_bootstraps_served: Counter
    eth1_block_height: Gauge
    eth1_deposits_fetched: Counter
    eth1_requests: Counter
    engine_api_requests: Counter
    engine_api_time: Histogram
    builder_requests: Counter
    builder_circuit_open: Gauge


@dataclass
class ProcessMetrics:
    event_loop_lag: Histogram
    start_time: Gauge
    offload_outstanding: Gauge
    offload_healthy: Gauge


@dataclass
class SchedulerMetrics:
    """lodestar_sched_* — the device work scheduler
    (`lodestar_tpu_torch/scheduler`): per-class launch queue depth/wait/serve
    counts, starvation-aging promotions, EWMA device occupancy and the
    graded admission state backing the occupancy dashboard."""

    queue_depth: Gauge  # labeled by launch class
    queue_wait: Histogram  # labeled by launch class
    jobs_dequeued: Counter  # labeled by launch class
    starvation_promotions: Counter
    occupancy_permille: Gauge  # mesh aggregate over available lanes
    admission_state: Gauge  # 0 accept / 1 shed_bulk / 2 reject
    shed_total: Counter  # labeled by launch class
    lane_occupancy: Gauge  # per-device EWMA occupancy, labeled by device
    lane_launches: Counter  # device launches, labeled by device + mode (single/sharded)
    lane_wedge_trips: Counter  # per-chip wedge-breaker trips, labeled by device
    mesh_lanes: Gauge  # non-wedged lanes currently serving


@dataclass
class ResilienceMetrics:
    """lodestar_resilience_* — the offload resilience layer
    (`offload/resilience.py`, `chain/bls/fallback.py`): per-endpoint
    routing/failover/hedge counts, circuit-breaker states, and the
    degradation-chain fallback counters."""

    routed: Counter  # verify RPCs issued, labeled by endpoint
    shed: Counter  # client-side admission sheds, labeled by reason
    failovers: Counter  # failed attempts per endpoint (breaker input)
    hedges: Counter  # hedged retries issued, labeled by launch class
    hedge_wins: Counter  # hedged retries that returned the verdict
    breaker_state: Gauge  # 0 closed / 1 half-open / 2 open, per endpoint
    breaker_transitions: Counter  # labeled by endpoint and new state
    fallback_verifications: Counter  # degraded verifications served, by layer
    fallback_skipped: Counter  # layers skipped (not accepting), by layer
    fallback_active: Gauge  # 1 while a non-primary layer served last
    outage_unscored: Counter  # outage-caused rejections spared from peer scoring


@dataclass
class AuditMetrics:
    """lodestar_offload_audit_* — the Byzantine audit subsystem
    (`offload/audit.py`): sampled/re-verified verdict counts, audit CPU
    spend against its budget, per-endpoint trust EWMA, Byzantine events
    and quarantine states."""

    sampled: Counter  # verdicts picked for re-verification, by launch class
    verified: Counter  # completed re-verifications, by outcome agree/disagree
    dropped: Counter  # sampled-but-not-audited, by reason (queue_full/queue_bytes/audit_error)
    byzantine: Counter  # Byzantine events (re-check contradicted), by endpoint
    trust_score: Gauge  # audit trust EWMA per endpoint (1.0 = never contradicted)
    quarantined: Gauge  # 1 while the endpoint is quarantined
    queue_depth: Gauge  # audit queue backlog
    cpu_seconds: Counter  # audit re-verification CPU time (budget accounting)


@dataclass
class TenantMetrics:
    """lodestar_offload_tenant_* — the offload server's multi-tenant
    front-end (`offload/tenancy.py`): per-tenant admitted/served work,
    quota sheds by reason, in-flight grants and configured stride
    weights. Registered by the serving host (`create_tenant_metrics`),
    not the beacon node — the node is a tenant, the server meters them."""

    served_sets: Counter  # signature sets served, labeled by tenant
    shed: Counter  # admission sheds, labeled by tenant + reason (quota/slot_timeout)
    inflight: Gauge  # granted service slots, labeled by tenant
    quota_weight: Gauge  # configured stride weight, labeled by tenant
    slack: Histogram  # remaining slot-deadline slack at verdict, by tenant + class


def create_tenant_metrics(creator: "RegistryMetricCreator | None" = None) -> TenantMetrics:
    """Tenant families for an offload serving host (its own registry by
    default — the server runs in its own process)."""
    c = creator or RegistryMetricCreator()
    return TenantMetrics(
        served_sets=c.counter(
            "lodestar_offload_tenant_served_sets_total",
            "Signature sets served per tenant",
            ["tenant"],
        ),
        shed=c.counter(
            "lodestar_offload_tenant_shed_total",
            "Admission sheds per tenant (quota = depth grading, "
            "slot_timeout = stride queue wait expired)",
            ["tenant", "reason"],
        ),
        inflight=c.gauge(
            "lodestar_offload_tenant_inflight",
            "Granted service slots per tenant",
            ["tenant"],
        ),
        quota_weight=c.gauge(
            "lodestar_offload_tenant_quota_weight",
            "Configured stride-fair service weight per tenant",
            ["tenant"],
        ),
        slack=c.histogram(
            "lodestar_offload_tenant_slack_seconds",
            "Remaining slot-deadline slack at verdict per tenant and "
            "priority class (negative = the verdict landed past the "
            "class deadline) — requires the server to be launched with "
            "--genesis-time so it shares the tenants' slot clock",
            _SEC_SLACK,
            ["tenant", "class"],
        ),
    )


@dataclass
class BlsPrepMetrics:
    """lodestar_bls_prep_* — batch-verify input preparation
    (`models/batch_verify.py` prep modes, `ops/prep.py` device stages):
    sets prepared per layer (device on-chip pipeline vs host
    native/python), prep wall time, device→host fallbacks and
    structurally-rejected batches."""

    sets: Counter  # sets prepared, labeled by layer (device/host/single_launch)
    seconds: Histogram  # per-call prep wall time, labeled by layer
    fallbacks: Counter  # device-prep errors degraded to host prep
    single_launch_fallbacks: Counter  # single-launch errors degraded to the split schedule
    rejected: Counter  # prep calls that rejected a structurally invalid batch
    launches: Counter  # ALL dispatches at ops/prep.py's seam (prep legs AND single-launch verifies)


@dataclass
class BlsPipelineMetrics:
    """lodestar_bls_pipeline_* — the prep→verify double buffer
    (`chain/bls/pool.py` `_OverlapTracker`/`pipeline_stats()`): live
    gauges over the pool's pipeline accounting, evaluated at scrape
    time via `set_function` (the same pattern as the occupancy gauges)
    so the previously process-trapped `pipeline_stats()` numbers are
    dashboard-readable during a run, not only from bench harnesses."""

    overlap_occupancy_pct: Gauge  # % of verify busy time with a prep stage in flight
    staged_packages: Gauge  # packages staged through the double buffer (cumulative)
    prep_seconds: Gauge  # cumulative prep-stage busy seconds
    verify_seconds: Gauge  # cumulative verify-stage busy seconds


@dataclass
class DeviceLaunchMetrics:
    """lodestar_device_launch_* / lodestar_device_compile_* — the launch
    telemetry layer (`lodestar_tpu_torch/telemetry.py`): per-dispatch wall
    time by program and size class at the counted dispatch seams
    (ops/prep `_dispatch`, ssz/device_htr `_device_level`, mesh lane
    launches, the batch-verify jit-cache seams), plus first-call
    compile-detection counters — the compile-vs-dispatch decomposition
    the hardware measurement campaign reads."""

    launch_seconds: Histogram  # dispatch wall time, labeled by program + size_class
    compile_seconds: Counter  # wall time of first-call (trace+compile) dispatches
    compile_hits: Counter  # dispatches whose (program, size_class) was already compiled
    compile_misses: Counter  # first-call dispatches per (program, size_class) key


@dataclass
class SszHtrMetrics:
    """lodestar_ssz_htr_* — device hashTreeRoot (`ssz/device_htr.py`
    collector, `state_transition/htr.py` tracker): dirty-subtree
    flushes per backend, dirty chunk volume, batched hash launches
    (the one-per-level invariant's observable), flush wall time, and
    device→CPU degradations."""

    flushes: Counter  # collector flushes served, labeled by backend (device/cpu)
    dirty_chunks: Counter  # dirty leaf chunks re-hashed across flushes
    launches: Counter  # ALL device hash_pairs dispatches (collector flush levels + shared-hook batch levels)
    seconds: Histogram  # per-flush wall time, labeled by backend
    fallbacks: Counter  # degradations, by leg (flush: device err → CPU hasher; tracker: bug → value path)


@dataclass
class KzgMetrics:
    """lodestar_kzg_* — KZG blob verification (`crypto/kzg.py`): the
    degrade-and-count observable for the device pairing check (device
    error → CPU oracle verdict, counted where the degradation is
    served)."""

    device_fallbacks: Counter  # device pairing errors served by the CPU oracle


@dataclass
class TraceMetrics:
    """lodestar_trace_* — span-duration summaries derived from the
    per-slot pipeline tracer (`lodestar_tpu_torch/tracing`): every completed
    trace feeds its spans here so the block-pipeline-trace dashboard
    renders from Prometheus without scraping the debug trace API."""

    span_duration: Histogram  # labeled by span name
    block_pipeline_time: Histogram  # root-trace (block import) duration
    traces_completed: Counter
    slow_slots: Counter


@dataclass
class SloMetrics:
    """lodestar_slo_* — slot-deadline SLO accounting (`lodestar_tpu_torch/slo`):
    remaining-slack histograms per priority class at each lifecycle
    stage (enqueue/dispatch/verdict), deadline-miss counters, and the
    good/total SLI pair the generated multi-window burn-rate alerts
    (`tools/gen_alerts.py`) consume as numerator/denominator."""

    slack_seconds: Histogram  # remaining slack (negative = past deadline), by class + stage
    deadline_miss: Counter  # verdicts that landed under the slack floor, by class
    sli_good: Counter  # SLI numerator: ok verdicts inside the deadline, by class
    sli_total: Counter  # SLI denominator: all verdicts, by class


@dataclass
class BeaconMetrics:
    creator: RegistryMetricCreator
    bls_pool: BlsPoolMetrics
    bls_prep: "BlsPrepMetrics"
    bls_pipeline: "BlsPipelineMetrics"
    device_launch: "DeviceLaunchMetrics"
    ssz_htr: "SszHtrMetrics"
    kzg: "KzgMetrics"
    state_transition: StateTransitionMetrics
    gossip: GossipMetrics
    fork_choice: ForkChoiceMetrics
    network: "NetworkMetrics"
    sync: "SyncMetrics"
    db: "DbMetrics"
    regen: "RegenMetrics"
    op_pool: "OpPoolMetrics"
    api: "ApiMetrics"
    reqresp: "ReqRespMetrics"
    peer: "PeerMetrics"
    gossip_detail: "GossipDetailMetrics"
    sync_detail: "SyncDetailMetrics"
    db_detail: "DbDetailMetrics"
    chain: "ChainDetailMetrics"
    process: "ProcessMetrics"
    trace: "TraceMetrics"
    slo: "SloMetrics"
    sched: "SchedulerMetrics"
    resilience: "ResilienceMetrics"
    audit: "AuditMetrics"
    head_slot: Gauge
    finalized_epoch: Gauge
    justified_epoch: Gauge
    clock_slot: Gauge
    peers: Gauge
    validator_monitor: "ValidatorMonitor"

    def scrape(self) -> bytes:
        return self.creator.scrape()


_SEC_SMALL = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5)
_SEC_TINY = (0.0001, 0.001, 0.01, 0.1, 1)
#: launch-latency ladder: dense below 5 ms (steady-state dispatches all
#: land there — the old ladder jumped 1→5→50 ms and folded every
#: healthy launch into two buckets), then stretching to slot length and
#: the worst trace+compile stall
_SEC_LAUNCH = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1, 2, 5, 12, 30, 120,
)
#: slack ladder: symmetric around the deadline — negative buckets size
#: the miss (how late), positive buckets the margin, bounded at ±slot
#: lengths (a backfill job can hold multi-slot slack)
_SEC_SLACK = (
    -12, -4, -1, -0.25, -0.05, 0, 0.05, 0.1, 0.25, 0.5, 1, 2, 4, 8, 12, 48, 384,
)


def create_metrics() -> BeaconMetrics:
    """Reference `createMetrics` (`metrics/metrics.ts:14`)."""
    c = RegistryMetricCreator()
    bls = BlsPoolMetrics(
        job_wait_time=c.histogram(
            "lodestar_bls_thread_pool_queue_job_wait_time_seconds",
            "Time a job waited in queue before execution", _SEC_SMALL,
        ),
        jobs_started=c.counter(
            "lodestar_bls_thread_pool_jobs_started_total", "Jobs started"
        ),
        sig_sets_started=c.counter(
            "lodestar_bls_thread_pool_sig_sets_started_total", "Signature sets started"
        ),
        success_sets=c.counter(
            "lodestar_bls_thread_pool_success_jobs_signature_sets_count", "Successful sets"
        ),
        error_sets=c.counter(
            "lodestar_bls_thread_pool_error_jobs_signature_sets_count", "Errored sets"
        ),
        batch_retries=c.counter(
            "lodestar_bls_thread_pool_batch_retries_total", "Invalid batches retried individually"
        ),
        batch_sigs_success=c.counter(
            "lodestar_bls_thread_pool_batch_sigs_success_total", "Sets verified in successful batches"
        ),
        time_per_sig_set=c.histogram(
            "lodestar_bls_thread_pool_time_per_sig_set_seconds", "Device time per set", _SEC_TINY,
        ),
        latency_to_device=c.histogram(
            "lodestar_bls_thread_pool_latency_to_worker", "Dispatch latency", _SEC_TINY,
        ),
        latency_from_device=c.histogram(
            "lodestar_bls_thread_pool_latency_from_worker", "Result latency", _SEC_TINY,
        ),
    )
    bls_prep = BlsPrepMetrics(
        sets=c.counter(
            "lodestar_bls_prep_sets_total",
            "Signature sets prepared (decompress + subgroup + hash-to-G2), by layer",
            ["layer"],
        ),
        seconds=c.histogram(
            "lodestar_bls_prep_seconds",
            "Input-prep wall time per batch, by layer (device/host)",
            _SEC_SMALL,
            ["layer"],
        ),
        fallbacks=c.counter(
            "lodestar_bls_prep_fallback_total",
            "Device input-prep errors degraded to the host prep path",
        ),
        single_launch_fallbacks=c.counter(
            "lodestar_bls_single_launch_fallback_total",
            "Single-launch verify errors (device fault or verdict-shape "
            "anomaly) degraded to the split prep-then-verify schedule",
        ),
        rejected=c.counter(
            "lodestar_bls_prep_rejected_total",
            "Prep calls that rejected a structurally invalid batch",
        ),
        launches=c.counter(
            "lodestar_bls_prep_launches_total",
            "Device program dispatches at the ops/prep.py launch seam "
            "(plain dispatch counter: fused-stage, per-leg, hash-to-G2 "
            "AND single-launch verify dispatches all count — per-schedule "
            "rates come from lodestar_device_launch_seconds{program}; the "
            "per-batch budget invariant is asserted in tests against the "
            "same seam)",
        ),
    )
    bls_pipeline = BlsPipelineMetrics(
        overlap_occupancy_pct=c.gauge(
            "lodestar_bls_pipeline_overlap_occupancy_pct",
            "Percent of verify-stage busy time with a prep stage in flight "
            "(the pool's pipeline_stats overlap accounting, scrape-time)",
        ),
        staged_packages=c.gauge(
            "lodestar_bls_pipeline_staged_packages",
            "Packages staged through the prep→verify double buffer "
            "(cumulative; 0 = the pipeline never engaged)",
        ),
        prep_seconds=c.gauge(
            "lodestar_bls_pipeline_prep_seconds_total",
            "Cumulative wall seconds some prep stage was in flight",
        ),
        verify_seconds=c.gauge(
            "lodestar_bls_pipeline_verify_seconds_total",
            "Cumulative wall seconds some verify stage was in flight",
        ),
    )
    device_launch = DeviceLaunchMetrics(
        launch_seconds=c.histogram(
            "lodestar_device_launch_seconds",
            "Device dispatch wall time at the counted launch seams, by "
            "program and pow-2 size class (host-observed: includes device "
            "execution on synchronous backends and trace+compile on the "
            "first call per class)",
            _SEC_LAUNCH,
            ["program", "size_class"],
        ),
        compile_seconds=c.counter(
            "lodestar_device_compile_seconds_total",
            "Wall seconds spent in first-call-per-(program,size_class) "
            "dispatches — the trace+compile (or persistent-cache load) tax",
        ),
        compile_hits=c.counter(
            "lodestar_device_compile_hits_total",
            "Dispatches whose (program, size_class) executable was already "
            "compiled in this process",
            ["program"],
        ),
        compile_misses=c.counter(
            "lodestar_device_compile_misses_total",
            "First-call dispatches per (program, size_class) — each paid "
            "trace+compile or a persistent-cache load",
            ["program"],
        ),
    )
    ssz_htr = SszHtrMetrics(
        flushes=c.counter(
            "lodestar_ssz_htr_flushes_total",
            "Dirty-subtree collector flushes, by backend (device/cpu)",
            ["backend"],
        ),
        dirty_chunks=c.counter(
            "lodestar_ssz_htr_dirty_chunks_total",
            "Dirty leaf chunks re-hashed by collector flushes",
        ),
        launches=c.counter(
            "lodestar_ssz_htr_launches_total",
            "Device hash_pairs dispatches issued, counted at the dispatch site "
            "(collector flush levels plus shared-hook batch levels; the per-flush "
            "launch-count invariant itself is asserted by tests)",
        ),
        seconds=c.histogram(
            "lodestar_ssz_htr_seconds",
            "Collector flush wall time, by backend",
            _SEC_SMALL,
            ["backend"],
        ),
        fallbacks=c.counter(
            "lodestar_ssz_htr_fallback_total",
            "HTR degradations, by leg (flush: device error to CPU hasher; tracker: tracker error to value path)",
            ["leg"],
        ),
    )
    kzg = KzgMetrics(
        device_fallbacks=c.counter(
            "lodestar_kzg_device_fallback_total",
            "KZG device pairing failures served by the CPU oracle verdict "
            "(counted where the degradation is served, crypto/kzg.py)",
        ),
    )
    st = StateTransitionMetrics(
        epoch_transition_time=c.histogram(
            "lodestar_stfn_epoch_transition_seconds", "Epoch transition time", _SEC_SMALL
        ),
        process_block_time=c.histogram(
            "lodestar_stfn_process_block_seconds", "Block processing time", _SEC_SMALL
        ),
        state_hash_tree_root_time=c.histogram(
            "lodestar_stfn_hash_tree_root_seconds", "State hashTreeRoot time", _SEC_SMALL
        ),
    )
    gossip = GossipMetrics(
        queue_length=c.gauge(
            "lodestar_gossip_validation_queue_length", "Gossip queue length", ["topic"]
        ),
        queue_dropped=c.counter(
            "lodestar_gossip_validation_queue_dropped_jobs_total", "Dropped gossip jobs", ["topic"]
        ),
        accepted=c.counter(
            "lodestar_gossip_validation_accept_total", "Accepted gossip objects", ["topic"]
        ),
        rejected=c.counter(
            "lodestar_gossip_validation_reject_total", "Rejected gossip objects", ["topic"]
        ),
    )
    fc = ForkChoiceMetrics(
        find_head_time=c.histogram(
            "lodestar_fork_choice_find_head_seconds", "findHead time", _SEC_TINY
        ),
        requests=c.counter("lodestar_fork_choice_requests_total", "findHead calls"),
        errors=c.counter("lodestar_fork_choice_errors_total", "fork choice errors"),
        reorgs=c.counter("lodestar_fork_choice_reorg_events_total", "reorg events"),
    )
    network = NetworkMetrics(
        peers_by_direction=c.gauge(
            "lodestar_peers_by_direction_count", "Connected peers by direction", ["direction"]
        ),
        peer_disconnects=c.counter(
            "lodestar_peer_disconnects_total", "Peer disconnects", ["reason"]
        ),
        gossip_mesh_peers=c.gauge(
            "lodestar_gossip_mesh_peers_by_type_count", "Gossip mesh peers", ["type"]
        ),
        gossip_received=c.counter(
            "lodestar_gossip_peer_received_messages_total", "Gossip messages received"
        ),
        gossip_duplicates=c.counter(
            "lodestar_gossipsub_seen_cache_duplicates_total", "Duplicate gossip messages"
        ),
    )
    sync = SyncMetrics(
        range_sync_batches=c.counter(
            "lodestar_sync_range_batches_total", "Range-sync batches processed", ["status"]
        ),
        range_sync_blocks=c.counter(
            "lodestar_sync_range_blocks_total", "Blocks imported by range sync"
        ),
        range_sync_errors=c.counter(
            "lodestar_sync_range_errors_total", "Range sync batch failures"
        ),
        backfill_blocks=c.counter(
            "lodestar_backfill_sync_blocks_total", "Blocks verified by backfill"
        ),
        unknown_block_requests=c.counter(
            "lodestar_sync_unknown_block_requests_total", "Unknown-block sync triggers"
        ),
    )
    db = DbMetrics(
        reads=c.counter("lodestar_db_read_req_total", "DB read requests", ["bucket"]),
        writes=c.counter("lodestar_db_write_req_total", "DB write requests", ["bucket"]),
        size_bytes=c.gauge("lodestar_db_size_bytes", "Approximate DB size"),
    )
    regen = RegenMetrics(
        state_cache_hits=c.counter("lodestar_state_cache_hits_total", "State cache hits"),
        state_cache_misses=c.counter(
            "lodestar_state_cache_misses_total", "State cache misses"
        ),
        checkpoint_cache_hits=c.counter(
            "lodestar_cp_state_cache_hits_total", "Checkpoint state cache hits"
        ),
        regen_queue_length=c.gauge(
            "lodestar_regen_queue_length", "Queued regen requests"
        ),
        regen_time=c.histogram(
            "lodestar_regen_fn_call_duration_seconds", "State regen time", _SEC_SMALL
        ),
    )
    op_pool = OpPoolMetrics(
        attestation_pool_size=c.gauge(
            "lodestar_op_pool_attestation_pool_size", "Unaggregated attestation pool size"
        ),
        aggregated_pool_size=c.gauge(
            "lodestar_op_pool_aggregated_attestation_pool_size", "Aggregated pool size"
        ),
        exits=c.gauge("lodestar_op_pool_voluntary_exit_pool_size", "Voluntary exits pooled"),
        proposer_slashings=c.gauge(
            "lodestar_op_pool_proposer_slashing_pool_size", "Proposer slashings pooled"
        ),
        attester_slashings=c.gauge(
            "lodestar_op_pool_attester_slashing_pool_size", "Attester slashings pooled"
        ),
        sync_messages=c.gauge(
            "lodestar_op_pool_sync_committee_message_pool_size", "Sync messages pooled"
        ),
    )
    api = ApiMetrics(
        rest_requests=c.counter(
            "lodestar_api_rest_requests_total", "REST API requests", ["method", "status"]
        ),
        rest_errors=c.counter("lodestar_api_rest_errors_total", "REST API 5xx errors"),
        rest_response_time=c.histogram(
            "lodestar_api_rest_response_time_seconds", "REST response time", _SEC_SMALL
        ),
    )
    reqresp = ReqRespMetrics(
        requests_sent=c.counter(
            "beacon_reqresp_outgoing_requests_total", "Outgoing requests", ["protocol"]
        ),
        requests_received=c.counter(
            "beacon_reqresp_incoming_requests_total", "Incoming requests", ["protocol"]
        ),
        request_errors=c.counter(
            "beacon_reqresp_incoming_errors_total", "Incoming request errors", ["protocol"]
        ),
        response_time=c.histogram(
            "beacon_reqresp_response_time_seconds", "Full response time", _SEC_SMALL, ["protocol"]
        ),
        response_chunks_sent=c.counter(
            "beacon_reqresp_outgoing_response_chunks_total", "Response chunks sent", ["protocol"]
        ),
        response_chunks_received=c.counter(
            "beacon_reqresp_incoming_response_chunks_total", "Response chunks received", ["protocol"]
        ),
        rate_limited=c.counter(
            "beacon_reqresp_rate_limited_total", "Rate-limited requests", ["protocol"]
        ),
        dial_timeouts=c.counter("beacon_reqresp_dial_timeouts_total", "Dial timeouts"),
        streams_reset=c.counter("beacon_reqresp_streams_reset_total", "Streams reset"),
    )
    peer = PeerMetrics(
        peer_count=c.gauge("lodestar_peers_count", "Connected peer count"),
        peers_by_client=c.gauge("lodestar_peers_by_client_count", "Peers by client", ["client"]),
        peer_score=c.histogram(
            "lodestar_app_peer_score", "Application peer scores", (-100, -50, -10, 0, 10, 50, 100)
        ),
        peer_action_count=c.counter(
            "lodestar_peers_report_peer_count_total", "Peer score actions", ["action"]
        ),
        goodbye_sent=c.counter("lodestar_peer_goodbye_sent_total", "Goodbyes sent", ["reason"]),
        goodbye_received=c.counter(
            "lodestar_peer_goodbye_received_total", "Goodbyes received", ["reason"]
        ),
        dials_attempted=c.counter("lodestar_peers_dial_attempts_total", "Dial attempts"),
        dials_succeeded=c.counter("lodestar_peers_dial_success_total", "Successful dials"),
        long_lived_subnets=c.gauge(
            "lodestar_peers_long_lived_attnets_count", "Long-lived attnet subscriptions"
        ),
        discv5_sessions=c.gauge("lodestar_discv5_active_sessions_count", "discv5 sessions"),
        discv5_findnode_sent=c.counter(
            "lodestar_discv5_findnode_sent_total", "FINDNODE queries sent"
        ),
        discv5_enrs_discovered=c.counter(
            "lodestar_discv5_discovered_enrs_total", "ENRs discovered"
        ),
    )
    gossip_detail = GossipDetailMetrics(
        mesh_grafts=c.counter("lodestar_gossip_mesh_graft_total", "Mesh grafts", ["topic"]),
        mesh_prunes=c.counter("lodestar_gossip_mesh_prune_total", "Mesh prunes", ["topic"]),
        ihave_sent=c.counter("lodestar_gossip_ihave_sent_total", "IHAVE control messages sent"),
        iwant_received=c.counter("lodestar_gossip_iwant_received_total", "IWANT requests received"),
        iwant_served=c.counter("lodestar_gossip_iwant_served_total", "IWANT messages served"),
        mcache_size=c.gauge("lodestar_gossip_mcache_size", "Message cache entries"),
        peer_score_by_topic=c.gauge(
            "lodestar_gossip_score_by_topic", "Mean peer score per topic", ["topic"]
        ),
        flood_publishes=c.counter("lodestar_gossip_flood_publish_total", "Flood publishes"),
        backoff_violations=c.counter(
            "lodestar_gossip_graft_backoff_violations_total", "Grafts inside backoff"
        ),
    )
    sync_detail = SyncDetailMetrics(
        status=c.gauge("lodestar_sync_status", "0=stalled 1=syncing 2=synced"),
        peers_by_status=c.gauge(
            "lodestar_sync_peers_by_status_count", "Peers by sync usefulness", ["status"]
        ),
        batch_download_time=c.histogram(
            "lodestar_sync_range_batch_download_seconds", "Batch download time", _SEC_SMALL
        ),
        batch_processing_time=c.histogram(
            "lodestar_sync_range_batch_processing_seconds", "Batch processing time", _SEC_SMALL
        ),
        batches_downloaded=c.counter(
            "lodestar_sync_range_batches_downloaded_total", "Batches downloaded"
        ),
        batch_download_retries=c.counter(
            "lodestar_sync_range_download_retries_total", "Batch download retries"
        ),
        head_distance=c.gauge("lodestar_sync_head_distance_slots", "Slots behind the clock"),
        backfill_earliest_slot=c.gauge(
            "lodestar_backfill_earliest_slot", "Earliest backfilled slot"
        ),
        unknown_block_queue_length=c.gauge(
            "lodestar_sync_unknown_block_pending_count", "Pending unknown-block roots"
        ),
    )
    db_detail = DbDetailMetrics(
        read_items=c.counter("lodestar_db_read_items_total", "Items read", ["bucket"]),
        write_items=c.counter("lodestar_db_write_items_total", "Items written", ["bucket"]),
        batch_write_time=c.histogram(
            "lodestar_db_batch_write_seconds", "Batch write latency", _SEC_TINY
        ),
        wal_size_bytes=c.gauge("lodestar_db_wal_size_bytes", "Write-ahead log size"),
        archived_states=c.counter("lodestar_db_archived_states_total", "States archived"),
        archived_blocks=c.counter("lodestar_db_archived_blocks_total", "Blocks archived"),
        pruned_blocks=c.counter("lodestar_db_pruned_blocks_total", "Hot blocks pruned"),
    )
    chain = ChainDetailMetrics(
        block_import_time=c.histogram(
            "lodestar_block_processor_import_seconds", "Full block import time", _SEC_SMALL
        ),
        block_production_time=c.histogram(
            "lodestar_block_production_seconds", "Block production time", _SEC_SMALL
        ),
        blocks_imported=c.counter("lodestar_blocks_imported_total", "Blocks imported", ["source"]),
        blocks_rejected=c.counter("lodestar_blocks_rejected_total", "Blocks rejected", ["reason"]),
        attestations_imported=c.counter(
            "lodestar_attestations_imported_total", "Attestations applied to fork choice"
        ),
        seen_attesters_size=c.gauge("lodestar_seen_cache_attesters_size", "Seen attesters"),
        seen_aggregators_size=c.gauge("lodestar_seen_cache_aggregators_size", "Seen aggregators"),
        checkpoint_state_cache_size=c.gauge(
            "lodestar_cp_state_cache_size", "Checkpoint state cache entries"
        ),
        state_cache_size=c.gauge("lodestar_state_cache_size", "Hot state cache entries"),
        light_client_updates_served=c.counter(
            "lodestar_light_client_updates_served_total", "LC updates served"
        ),
        light_client_bootstraps_served=c.counter(
            "lodestar_light_client_bootstraps_served_total", "LC bootstraps served"
        ),
        eth1_block_height=c.gauge("lodestar_eth1_latest_block_number", "Latest eth1 block seen"),
        eth1_deposits_fetched=c.counter("lodestar_eth1_deposit_events_total", "Deposit logs fetched"),
        eth1_requests=c.counter("lodestar_eth1_requests_total", "Eth1 JSON-RPC requests", ["method"]),
        engine_api_requests=c.counter(
            "lodestar_execution_engine_requests_total", "Engine API requests", ["method"]
        ),
        engine_api_time=c.histogram(
            "lodestar_execution_engine_request_seconds", "Engine API latency", _SEC_SMALL
        ),
        builder_requests=c.counter(
            "lodestar_builder_requests_total", "Builder API requests", ["method", "status"]
        ),
        builder_circuit_open=c.gauge(
            "lodestar_builder_circuit_breaker_open", "Builder circuit breaker state"
        ),
    )
    process = ProcessMetrics(
        event_loop_lag=c.histogram(
            "lodestar_event_loop_lag_seconds", "Event loop scheduling lag", _SEC_TINY
        ),
        start_time=c.gauge("process_start_time_seconds", "Process start unix time"),
        offload_outstanding=c.gauge(
            "lodestar_offload_outstanding_jobs", "Offload jobs in flight"
        ),
        offload_healthy=c.gauge("lodestar_offload_healthy", "Offload channel health bit"),
    )
    trace = TraceMetrics(
        span_duration=c.histogram(
            "lodestar_trace_span_duration_seconds",
            "Pipeline trace span duration by span name",
            _SEC_SMALL,
            ["span"],
        ),
        block_pipeline_time=c.histogram(
            "lodestar_trace_block_pipeline_seconds",
            "Root block-pipeline trace duration",
            _SEC_SMALL,
        ),
        traces_completed=c.counter(
            "lodestar_trace_completed_total", "Completed pipeline traces"
        ),
        slow_slots=c.counter(
            "lodestar_trace_slow_slot_total", "Slow-slot trace dumps emitted"
        ),
    )
    resilience = ResilienceMetrics(
        routed=c.counter(
            "lodestar_resilience_routed_total",
            "Offload verify RPCs issued per endpoint",
            ["endpoint"],
        ),
        shed=c.counter(
            "lodestar_resilience_shed_total",
            "Gossip work deferred because the offload verifier refused admission",
            ["reason"],
        ),
        failovers=c.counter(
            "lodestar_resilience_failover_total",
            "Failed offload attempts per endpoint (feeds the breaker)",
            ["endpoint"],
        ),
        hedges=c.counter(
            "lodestar_resilience_hedge_total",
            "Hedged retries issued to a second endpoint, by launch class",
            ["class"],
        ),
        hedge_wins=c.counter(
            "lodestar_resilience_hedge_win_total",
            "Hedged retries that returned the verdict, by launch class",
            ["class"],
        ),
        breaker_state=c.gauge(
            "lodestar_resilience_breaker_state",
            "Offload circuit breaker per endpoint: 0 closed / 1 half-open / 2 open",
            ["endpoint"],
        ),
        breaker_transitions=c.counter(
            "lodestar_resilience_breaker_transitions_total",
            "Breaker state transitions per endpoint and new state",
            ["endpoint", "state"],
        ),
        fallback_verifications=c.counter(
            "lodestar_resilience_fallback_total",
            "Verifications served after degrading to this layer",
            ["layer"],
        ),
        fallback_skipped=c.counter(
            "lodestar_resilience_fallback_skipped_total",
            "Verifier layers skipped because they refused work",
            ["layer"],
        ),
        fallback_active=c.gauge(
            "lodestar_resilience_fallback_active",
            "1 while the most recent verification was served by a non-primary layer",
        ),
        outage_unscored=c.counter(
            "lodestar_resilience_outage_unscored_total",
            "Gossip rejections caused by a local verifier outage, spared from peer downscoring",
        ),
    )
    audit = AuditMetrics(
        sampled=c.counter(
            "lodestar_offload_audit_sampled_total",
            "Offload verdicts sampled for independent re-verification, by class",
            ["class"],
        ),
        verified=c.counter(
            "lodestar_offload_audit_verified_total",
            "Completed audit re-verifications by outcome (agree/disagree)",
            ["outcome"],
        ),
        dropped=c.counter(
            "lodestar_offload_audit_dropped_total",
            "Sampled verdicts not audited (queue_full/queue_bytes/audit_error)",
            ["reason"],
        ),
        byzantine=c.counter(
            "lodestar_offload_audit_byzantine_total",
            "Byzantine events: helper verdicts contradicted by re-verification",
            ["endpoint"],
        ),
        trust_score=c.gauge(
            "lodestar_offload_audit_trust_score",
            "Per-endpoint audit trust EWMA (1.0 = never contradicted)",
            ["endpoint"],
        ),
        quarantined=c.gauge(
            "lodestar_offload_audit_quarantined",
            "1 while the endpoint is quarantined for a Byzantine event",
            ["endpoint"],
        ),
        queue_depth=c.gauge(
            "lodestar_offload_audit_queue_depth", "Audit re-verification backlog"
        ),
        cpu_seconds=c.counter(
            "lodestar_offload_audit_cpu_seconds_total",
            "CPU time spent re-verifying sampled verdicts (budget accounting)",
        ),
    )
    slo = SloMetrics(
        slack_seconds=c.histogram(
            "lodestar_slo_slack_seconds",
            "Remaining slot-deadline slack per priority class at each "
            "lifecycle stage (enqueue/dispatch/verdict); negative = the "
            "stage happened past the class deadline",
            _SEC_SLACK,
            ["class", "stage"],
        ),
        deadline_miss=c.counter(
            "lodestar_slo_deadline_miss_total",
            "Verdicts that landed with less slack than the configured "
            "floor (--slo-slack-floor-ms), counted once per job",
            ["class"],
        ),
        sli_good=c.counter(
            "lodestar_slo_sli_good_total",
            "SLI numerator: verdicts that were ok AND inside the class "
            "deadline (pairs with lodestar_slo_sli_total for burn rates)",
            ["class"],
        ),
        sli_total=c.counter(
            "lodestar_slo_sli_total",
            "SLI denominator: all verdicts, counted once per job",
            ["class"],
        ),
    )
    sched = SchedulerMetrics(
        queue_depth=c.gauge(
            "lodestar_sched_queue_depth", "Device scheduler queue depth", ["class"]
        ),
        queue_wait=c.histogram(
            "lodestar_sched_queue_wait_seconds",
            "Launch-queue wait (enqueue to dequeue) by class",
            _SEC_SMALL,
            ["class"],
        ),
        jobs_dequeued=c.counter(
            "lodestar_sched_jobs_dequeued_total", "Jobs dequeued for launch", ["class"]
        ),
        starvation_promotions=c.counter(
            "lodestar_sched_starvation_promotions_total",
            "Jobs served by aging ahead of the fair order",
        ),
        occupancy_permille=c.gauge(
            "lodestar_sched_occupancy_permille", "EWMA device busy-ns per wall-ns (0-1000)"
        ),
        admission_state=c.gauge(
            "lodestar_sched_admission_state", "0 accept / 1 shed bulk / 2 reject"
        ),
        shed_total=c.counter(
            "lodestar_sched_shed_total", "Work deferred by backpressure/admission", ["class"]
        ),
        lane_occupancy=c.gauge(
            "lodestar_sched_lane_occupancy_permille",
            "Per-chip EWMA busy-ns per wall-ns (0-1000)",
            ["device"],
        ),
        lane_launches=c.counter(
            "lodestar_sched_lane_launches_total",
            "Device launches per mesh lane (mode: single or sharded collective)",
            ["device", "mode"],
        ),
        lane_wedge_trips=c.counter(
            "lodestar_sched_lane_wedge_trips_total",
            "Per-chip wedge-breaker trips (lane degraded out of the mesh)",
            ["device"],
        ),
        mesh_lanes=c.gauge(
            "lodestar_sched_mesh_lanes_available",
            "Mesh lanes currently serving (non-wedged)",
        ),
    )
    return BeaconMetrics(
        creator=c,
        bls_pool=bls,
        bls_prep=bls_prep,
        bls_pipeline=bls_pipeline,
        device_launch=device_launch,
        ssz_htr=ssz_htr,
        kzg=kzg,
        state_transition=st,
        gossip=gossip,
        fork_choice=fc,
        network=network,
        sync=sync,
        db=db,
        regen=regen,
        op_pool=op_pool,
        api=api,
        reqresp=reqresp,
        peer=peer,
        gossip_detail=gossip_detail,
        sync_detail=sync_detail,
        db_detail=db_detail,
        chain=chain,
        process=process,
        trace=trace,
        slo=slo,
        sched=sched,
        resilience=resilience,
        audit=audit,
        head_slot=c.gauge("beacon_head_slot", "Current head slot"),
        finalized_epoch=c.gauge("beacon_finalized_epoch", "Finalized epoch"),
        justified_epoch=c.gauge("beacon_current_justified_epoch", "Justified epoch"),
        clock_slot=c.gauge("beacon_clock_slot", "Current wall-clock slot"),
        peers=c.gauge("libp2p_peers", "Connected peers"),
        validator_monitor=ValidatorMonitor(c),
    )


class MetricsServer:
    """Minimal /metrics scrape endpoint (reference `server/http.ts:14`)."""

    def __init__(self, metrics: BeaconMetrics, port: int = 8008, host: str = "127.0.0.1"):
        self.metrics = metrics
        self.port = port
        self.host = host
        self._httpd = None
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        import http.server

        metrics = self.metrics

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                path = self.path.split("?", 1)[0].rstrip("/")
                if path == "/metrics":
                    body = metrics.scrape()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/healthz":
                    # liveness probe (k8s-style): the scrape server being
                    # able to answer at all is the signal
                    body = b'{"status":"ok"}'
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *a):
                pass

        self._httpd = http.server.ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
