"""CLI: beacon / validator / dev commands (reference `packages/cli/src`,
`cli.ts:19` yargs tree; `dev` = in-process node + all validators, the
`getDevBeaconNode` workflow).

Usage:
  python -m lodestar_tpu_torch dev --validators 16 --slots 8 [--preset minimal] [--device cpu]
  python -m lodestar_tpu_torch beacon --db ./chain-db [--rest-port 9596] [--device cpu]
  python -m lodestar_tpu_torch validator --beacon-url http://127.0.0.1:9596 --interop-keys 16
  python -m lodestar_tpu_torch lightclient --server http://127.0.0.1:9596

The port of `lodestar_tpu.cli`, with its imports rewritten and three
departures (ROADMAP Queue 3):

* `dev` and `beacon` take `--device {cuda,cpu}` (default cuda), passed to
  `BeaconNodeOptions(device=)`: the way to ask for the CPU, where the JAX
  CLI reads `JAX_PLATFORMS`. Without CUDA, the default raises.
* `bench` stays in the parser, but the port has no benchmark of its own
  yet: it says so on stderr and exits 2.
* The parser's prog and description name the port. Every dest, default
  and choice is the JAX parser's.
"""

from __future__ import annotations

import argparse
import asyncio
import sys

__all__ = ["main"]

#: what `bench` says: the repo's bench.py drives the JAX package, and the
#: port's own benchmark is not written yet
BENCH_MISSING = "error: the port's benchmark is not in the tree yet; `bench` has nothing to run"


def _add_tracing_args(sp) -> None:
    """Per-slot pipeline tracing flags (lodestar_tpu_torch.tracing), shared by
    the node-running commands."""
    sp.add_argument(
        "--tracing", action="store_true",
        help="enable per-slot pipeline span tracing (gossip→BLS→STF→fork choice)",
    )
    sp.add_argument(
        "--tracing-slow-slot-ms", type=float, default=2000.0,
        help="dump any slot trace slower than this as a structured log line",
    )
    sp.add_argument(
        "--tracing-export-dir", default=None,
        help="write slow-slot traces as Chrome trace_event JSON into this directory",
    )
    sp.add_argument(
        "--tracing-export-max-files", type=int, default=256,
        help="keep at most this many exported trace files (oldest pruned; 0 = unlimited)",
    )
    sp.add_argument(
        "--tracing-export-max-age-sec", type=float, default=None,
        help="prune exported trace files older than this many seconds",
    )
    sp.add_argument(
        # literal copy of telemetry.TELEMETRY_MODES (argparse-import
        # doctrine: BeaconNodeOptions re-validates against the canonical
        # tuple post-parse, so a drifted copy fails loudly there)
        "--launch-telemetry", choices=["auto", "on", "off"], default="auto",
        help="record per-dispatch device launch telemetry (wall time, "
        "program, size class, first-call compile detection) at the "
        "counted dispatch seams: auto = once the node's metric sink is "
        "installed, on = always (ledger even without metrics), off = "
        "disabled. Surfaced as lodestar_device_launch_* metrics, "
        "GET /eth/v0/debug/launches, and slow-slot dumps.",
    )


def _add_device_arg(sp) -> None:
    """--device, shared by the node-running commands (the port's only
    flag that the JAX CLI lacks). A literal copy of node.NODE_DEVICES:
    BeaconNodeOptions re-validates it."""
    sp.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="verify signatures and hash the state on this device: cuda = "
        "the BLS verifier pool and the state root on the GPU (raises "
        "without CUDA), cpu = the host oracle and the plain PyTorch path",
    )


def _add_slo_args(sp) -> None:
    """Slot-deadline SLO flags (lodestar_tpu_torch.slo), shared by the
    node-running commands."""
    sp.add_argument(
        "--slo-disable", action="store_true",
        help="disable slot-deadline SLO accounting (per-class remaining-"
        "slack histograms, deadline-miss counters, good/total SLI pairs, "
        "the GET /eth/v0/debug/slo wait-budget profile, and the slack "
        "attributes on bls_verify/block_import spans and slow-slot dumps)",
    )
    sp.add_argument(
        "--slo-slack-floor-ms", type=float, default=0.0,
        help="treat a verdict landing with less than this much remaining "
        "slot-deadline slack as a deadline miss (0 = miss only when the "
        "deadline is actually blown; raise to alert before the cliff)",
    )


def _add_scheduler_args(sp) -> None:
    """Device work scheduler + offload flags (lodestar_tpu_torch.scheduler),
    shared by the node-running commands."""
    sp.add_argument(
        "--bls-offload", action="append", default=[], metavar="HOST:PORT",
        help="route BLS verification to this offload server (repeatable; "
        "multiple endpoints load-balance by occupancy and admission state)",
    )
    sp.add_argument(
        "--sched-disable", action="store_true",
        help="disable the priority-aware device work scheduler (FIFO launches; "
        "debug/comparison only)",
    )
    sp.add_argument(
        "--bls-device-prep", choices=["auto", "on", "off"], default="auto",
        help="run batch-verify input prep (G1/G2 decompression, subgroup "
        "checks, hash-to-G2) on the device: auto = only on a CUDA "
        "device, on = always, off = host prep (native C++ / python "
        "oracle). A device-prep error raises.",
    )
    sp.add_argument(
        "--bls-pipeline", choices=["auto", "on", "off"], default="auto",
        help="double-buffer the BLS prep→verify pipeline: stage input prep "
        "of batch k+1 while batch k verifies (auto = only when the mesh "
        "has a sibling lane to prep on, on = overlap even on one chip, "
        "off = prep inline with the launch). Verdicts, priority "
        "placement, and the fail-closed degradation chain are unchanged.",
    )
    sp.add_argument(
        # literal copy of models.batch_verify.SINGLE_LAUNCH_MODES
        # (argparse-import doctrine: BeaconNodeOptions re-validates
        # against the canonical tuple post-parse)
        "--bls-single-launch", choices=["auto", "on", "off"], default="auto",
        help="verify each BLS batch as ONE resident device program "
        "(decompression, subgroup checks, hash-to-G2, RLC aggregation, "
        "Miller loop, final exponentiation in a single counted "
        "dispatch, a CUDA graph replay): auto = on a CUDA device "
        "(unless --bls-device-prep is pinned off), on = always, off = "
        "the split prep-then-verify schedule. A single-launch error "
        "raises.",
    )
    sp.add_argument(
        "--htr-device", choices=["auto", "on", "off"], default="auto",
        help="flush state hashTreeRoot dirty subtrees through the device "
        "SHA-256 levels (one graph replay per tree level): auto = only "
        "on a CUDA --device, on = always, off = CPU incremental "
        "hashing. A device error raises.",
    )
    sp.add_argument(
        "--bls-mesh", choices=["auto", "on", "off"], default="auto",
        help="serve the local BLS verifier pool on the full device mesh: "
        "per-chip launch lanes (latency work to the least-occupied chip, "
        "bulk sharded data-parallel across idle chips, per-chip wedge "
        "breakers). auto = only when more than one CUDA device is "
        "visible; off = the single-device pool.",
    )
    sp.add_argument(
        "--offload-tenant", default=None, metavar="NAME",
        help="tenant identity stamped onto offload verify frames (multi-"
        "tenant serving hosts apply per-tenant quotas and stride-fair "
        "scheduling to it; omitted = the server's default tenant)",
    )
    from lodestar_tpu_torch.offload.resilience import (
        DEFAULT_FAILURE_THRESHOLD,
        DEFAULT_HEDGE_DELAY_MS,
        DEFAULT_MAX_RESET_TIMEOUT_S,
        DEFAULT_RESET_TIMEOUT_S,
    )

    sp.add_argument(
        "--offload-hedge-delay-ms", type=float, default=None, metavar="MS",
        help="fire a concurrent hedge RPC to a second offload endpoint when "
        "the primary has not answered within this many milliseconds (first "
        "verdict wins, the loser is discarded; needs >= 2 endpoints; "
        f"0 or omitted = sequential split-budget retry; {DEFAULT_HEDGE_DELAY_MS:g} "
        "is the chaos-harness-tuned default — see TUNING.md)",
    )
    sp.add_argument(
        "--offload-breaker-threshold", type=int, default=DEFAULT_FAILURE_THRESHOLD,
        help="consecutive verify failures before an offload endpoint's circuit "
        "breaker opens (the hot path then skips it without dialing)",
    )
    sp.add_argument(
        "--offload-breaker-reset-sec", type=float, default=DEFAULT_RESET_TIMEOUT_S,
        help="base delay before an open breaker admits a half-open trial (doubles "
        f"per consecutive open, capped at {DEFAULT_MAX_RESET_TIMEOUT_S:g}s, jittered)",
    )
    sp.add_argument(
        "--offload-fallback", choices=["none", "cpu", "device"], default="cpu",
        help="degradation chain when offload fails: cpu = re-verify on the CPU "
        "oracle, device = local device pool (then the CPU oracle with --device cpu; "
        "on cuda the pool fails closed), none = fail closed with "
        "no fallback (blocks reject while the offload host is down)",
    )
    from lodestar_tpu_torch.offload.audit import DEFAULT_AUDIT_BUDGET, DEFAULT_AUDIT_RATE
    from lodestar_tpu_torch.offload.resilience import DEFAULT_QUARANTINE_COOLOFF_S

    sp.add_argument(
        "--offload-audit-rate", type=float, default=DEFAULT_AUDIT_RATE,
        help="base probability an offload verdict is re-verified against an "
        "independent verifier (gossip classes at full rate, bulk classes "
        "scaled down; 0 disables Byzantine auditing)",
    )
    sp.add_argument(
        "--offload-audit-budget", type=float, default=DEFAULT_AUDIT_BUDGET,
        help="fraction of one CPU core the audit worker may consume (duty-cycle "
        "cap; excess samples are dropped, never queued against the hot path)",
    )
    sp.add_argument(
        "--offload-audit-via", choices=["cpu", "helper"], default="cpu",
        help="independent verifier for audits: cpu = the in-process oracle, "
        "helper = a second offload endpoint with CPU arbitration on "
        "disagreement (needs >= 2 endpoints, else falls back to cpu)",
    )
    sp.add_argument(
        "--offload-audit-seed", type=int, default=None,
        help="seed for the audit sampler — testing/replay ONLY (a helper that "
        "can predict the sample stream can lie on unsampled verdicts; the "
        "default draws an unpredictable seed and logs it)",
    )
    sp.add_argument(
        "--offload-quarantine-sec", type=float, default=DEFAULT_QUARANTINE_COOLOFF_S,
        help="cool-off before a quarantined (caught-lying) endpoint gets one "
        "half-open trial; 0 = quarantined until --offload-unquarantine",
    )
    sp.add_argument(
        "--offload-unquarantine", action="append", default=[], metavar="HOST:PORT",
        help="admin action: lift a persisted Byzantine quarantine for this "
        "endpoint at startup (repeatable)",
    )


def _build_parser(with_subparsers: bool = False):
    ap = argparse.ArgumentParser(
        prog="lodestar-tpu-torch", description="beacon chain framework on PyTorch and CUDA"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    subparsers: list = []
    _add = sub.add_parser

    def add_parser(*a, **kw):
        sp = _add(*a, **kw)
        subparsers.append(sp)
        return sp

    sub.add_parser = add_parser

    dev = sub.add_parser("dev", help="single-process dev chain: node + validators")
    dev.add_argument("--validators", type=int, default=16)
    dev.add_argument("--slots", type=int, default=8, help="slots to advance before exiting")
    dev.add_argument("--preset", default="minimal", choices=["minimal", "mainnet"])
    dev.add_argument("--rest-port", type=int, default=0)
    dev.add_argument("--slot-time", type=float, default=0.0, help="seconds per slot (0 = as fast as possible)")
    dev.add_argument("--p2p-port", type=int, default=0, help="serve P2P (TCP/noise/gossipsub) on this port")
    dev.add_argument("--genesis-time", type=int, default=0, help="interop genesis_time (share with peers)")
    dev.add_argument("--linger", type=float, default=0.0, help="keep serving P2P this many seconds after the last slot")
    dev.add_argument("--altair-epoch", type=int, default=None, help="enable the altair fork at this epoch (default: never)")
    _add_device_arg(dev)
    _add_tracing_args(dev)
    _add_scheduler_args(dev)
    _add_slo_args(dev)

    beacon = sub.add_parser("beacon", help="run a beacon node")
    beacon.add_argument("--db", default=None, help="data directory (default: in-memory)")
    beacon.add_argument("--rest-port", type=int, default=9596)
    beacon.add_argument("--metrics-port", type=int, default=0)
    beacon.add_argument("--preset", default="mainnet", choices=["minimal", "mainnet"])
    beacon.add_argument("--genesis-validators", type=int, default=64)
    beacon.add_argument("--p2p-port", type=int, default=0, help="serve P2P (TCP/noise/gossipsub) on this port")
    beacon.add_argument("--bootnode", action="append", default=[], help="host:port of a peer to dial (repeatable)")
    beacon.add_argument("--dev-genesis", action="store_true", help="dev-chain genesis: phase0-only forks + interop validators (peer with `dev --p2p-port`)")
    beacon.add_argument("--genesis-time", type=int, default=0, help="interop genesis_time (share with peers)")
    beacon.add_argument("--sync-target", type=int, default=0, help="exit 0 once head reaches this slot (testing)")
    beacon.add_argument("--slot-time", type=int, default=0, help="dev-genesis slot seconds (match the dev node)")
    beacon.add_argument("--altair-epoch", type=int, default=None, help="dev-genesis: altair fork epoch (match the dev node)")
    beacon.add_argument(
        "--checkpoint-sync-url",
        default=None,
        help="trusted beacon API to anchor from (finalized state) instead of a dev genesis",
    )
    _add_device_arg(beacon)
    _add_tracing_args(beacon)
    _add_scheduler_args(beacon)
    _add_slo_args(beacon)

    val = sub.add_parser("validator", help="run a REST-mode validator client")
    val.add_argument("--beacon-url", default="http://127.0.0.1:9596")
    val.add_argument("--keystores", default=None, help="directory of EIP-2335 keystore JSON files")
    val.add_argument("--password", default="", help="keystore password (all files)")
    val.add_argument("--interop-keys", type=int, default=0, help="use N deterministic interop keys instead of keystores")
    val.add_argument("--preset", default="mainnet", choices=["minimal", "mainnet"])
    val.add_argument("--slots", type=int, default=0, help="stop after N slots (0 = run forever)")
    val.add_argument("--keymanager-port", type=int, default=0, help="serve the keymanager API on this port")
    val.add_argument("--data-dir", default=None, help="persist slashing protection here (STRONGLY recommended)")

    lc = sub.add_parser("lightclient", help="run the driving light client against a beacon API")
    lc.add_argument("--server", default="http://127.0.0.1:9596", help="beacon API base URL")
    lc.add_argument("--checkpoint-root", default=None, help="trusted block root (hex; default: the server's finalized root)")
    lc.add_argument("--preset", default="minimal", choices=["minimal", "mainnet"])
    lc.add_argument("--target-slot", type=int, default=0, help="exit 0 once the light head reaches this slot (0 = follow forever)")
    lc.add_argument("--poll-sec", type=float, default=2.0)

    sub.add_parser("bench", help="run the device benchmark (not in the port yet)")
    if with_subparsers:
        return ap, subparsers
    return ap


def _apply_rc_config(ap, sub_actions, argv):
    """--rc-config <yaml> / --rc-config=<yaml>: file values become
    argument defaults, CLI flags still win (reference `cli.ts:5`
    rcConfigOption). Keys use the flag spelling (dashes or underscores);
    keys matching no known argument are rejected loudly."""
    path = None
    rest = []
    it = iter(argv)
    for a in it:
        if a == "--rc-config":
            path = next(it, None)
            if path is None:
                raise SystemExit("--rc-config requires a file path")
        elif a.startswith("--rc-config="):
            path = a.split("=", 1)[1]
        else:
            rest.append(a)
    if path is None:
        return argv
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if not isinstance(raw, dict):
        raise SystemExit(f"--rc-config {path}: expected a mapping")
    defaults = {str(k).replace("-", "_"): v for k, v in raw.items()}
    known = {a.dest for sp in sub_actions for a in sp._actions}
    unknown = sorted(set(defaults) - known)
    if unknown:
        raise SystemExit(f"--rc-config {path}: unknown keys {unknown}")
    ap.set_defaults(**defaults)
    for sp in sub_actions:
        sp.set_defaults(**defaults)
    return rest


async def _run_lightclient(args) -> int:
    import time as _time

    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.api.client import BeaconApiClient
    from lodestar_tpu_torch.light_client.client import Lightclient

    params.set_active_preset(args.preset)
    client = BeaconApiClient(args.server)
    genesis = client.get_genesis()["data"]
    gvr = bytes.fromhex(genesis["genesis_validators_root"][2:])
    fork = client.get_state_fork("head")["data"]
    fork_version = bytes.fromhex(fork["current_version"][2:])
    cp = args.checkpoint_root or "finalized"
    if cp in ("head", "finalized", "justified", "genesis"):
        root_hex = client.get_block_root(cp)["data"]["root"]
    else:
        root_hex = cp
    trusted = bytes.fromhex(root_hex[2:] if root_hex.startswith("0x") else root_hex)

    lc = Lightclient(
        transport=client, genesis_validators_root=gvr, fork_version=fork_version
    )
    lc.on_head(lambda h: print(f"light head: slot {int(h.beacon.slot)}", flush=True))
    lc.bootstrap(trusted)
    print(f"bootstrapped from {root_hex[:18]}…, finalized slot {lc.finalized_slot}", flush=True)
    genesis_time = int(genesis["genesis_time"])
    spec = client.get_spec()["data"]
    seconds_per_slot = int(spec.get("SECONDS_PER_SLOT", 12))
    while True:
        # lint: allow(monotonic-durations) — slot math is anchored at the protocol's wall-clock genesis_time; monotonic has no epoch
        current_slot = max(0, int(_time.time()) - genesis_time) // max(1, seconds_per_slot)
        lc.sync_to_head(current_slot=current_slot)
        lc.poll_head()
        print(
            f"finalized {lc.finalized_slot} head {lc.head_slot} status {lc.status}",
            flush=True,
        )
        if args.target_slot and lc.head_slot >= args.target_slot:
            print(f"target slot {args.target_slot} reached", flush=True)
            return 0
        await asyncio.sleep(args.poll_sec)


def dev_chain_config(altair_epoch: int | None = None):
    """The `dev` command's chain config: minimal, every fork after phase0
    far away unless `altair_epoch` brings Altair in."""
    from lodestar_tpu_torch.config import minimal_chain_config

    far = 2**64 - 1
    return minimal_chain_config().replace(
        ALTAIR_FORK_EPOCH=far if altair_epoch is None else altair_epoch,
        BELLATRIX_FORK_EPOCH=far, CAPELLA_FORK_EPOCH=far, DENEB_FORK_EPOCH=far,
    )


async def _run_dev(args) -> int:
    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.config import create_beacon_config
    from lodestar_tpu_torch.db import MemoryDbController
    from lodestar_tpu_torch.node import BeaconNode, BeaconNodeOptions
    from lodestar_tpu_torch.state_transition.genesis import (
        create_interop_genesis_state,
        interop_secret_keys,
    )
    from lodestar_tpu_torch.validator import SlashingProtection, Validator, ValidatorStore

    params.set_active_preset(args.preset)
    p = params.active_preset()
    cc = dev_chain_config(args.altair_epoch)
    p2p = args.p2p_port != 0
    if p2p:
        # peers compute the wall-clock slot from genesis_time: pin slot
        # seconds to the dev pace and align slot starts to real time
        cc = cc.replace(SECONDS_PER_SLOT=max(1, int(args.slot_time or 1)))
    sks = interop_secret_keys(args.validators)
    genesis = create_interop_genesis_state(
        args.validators,
        genesis_time=args.genesis_time,
        p=p,
        genesis_fork_version=cc.GENESIS_FORK_VERSION,
    )

    # manual clock: the dev loop drives slots itself from genesis
    now = [0.0]
    node = await BeaconNode.init(
        anchor_state=genesis,
        chain_config=cc,
        opts=BeaconNodeOptions(
            rest_enabled=args.rest_port != 0,
            rest_port=args.rest_port,
            device=args.device,
            manual_clock=True,
            p2p_enabled=p2p,
            p2p_port=args.p2p_port,
            tracing_enabled=args.tracing,
            tracing_slow_slot_ms=args.tracing_slow_slot_ms,
            tracing_export_dir=args.tracing_export_dir,
            tracing_export_max_files=args.tracing_export_max_files,
            tracing_export_max_age_s=args.tracing_export_max_age_sec,
            offload_endpoints=args.bls_offload,
            offload_breaker_threshold=args.offload_breaker_threshold,
            offload_breaker_reset_s=args.offload_breaker_reset_sec,
            offload_hedge_delay_ms=args.offload_hedge_delay_ms,
            offload_fallback=args.offload_fallback,
            offload_audit_rate=args.offload_audit_rate,
            offload_audit_budget=args.offload_audit_budget,
            offload_audit_via=args.offload_audit_via,
            offload_audit_seed=args.offload_audit_seed,
            offload_quarantine_cooloff_s=args.offload_quarantine_sec,
            offload_unquarantine=args.offload_unquarantine,
            scheduler_enabled=not args.sched_disable,
            bls_device_prep=args.bls_device_prep,
            bls_pipeline=args.bls_pipeline,
            bls_single_launch=args.bls_single_launch,
            htr_device=args.htr_device,
            bls_mesh=args.bls_mesh,
            offload_tenant=args.offload_tenant,
            launch_telemetry=args.launch_telemetry,
            slo_enabled=not args.slo_disable,
            slo_slack_floor_ms=args.slo_slack_floor_ms,
        ),
        p=p,
        time_fn=lambda: now[0],
    )
    if p2p:
        node.start_gossip_drain()
    cfg = create_beacon_config(cc, bytes(genesis.genesis_validators_root))
    store = ValidatorStore(cfg, SlashingProtection(MemoryDbController()), sks, p)
    validator = Validator(chain=node.chain, store=store, p=p)

    import time as _time

    for slot in range(1, args.slots + 1):
        if p2p and args.genesis_time:
            # wall-clock slot alignment so peers' clocks agree
            start = args.genesis_time + slot * cc.SECONDS_PER_SLOT
            # lint: allow(monotonic-durations) — aligning to a shared wall-clock genesis_time so peers' slot clocks agree
            delay = start - _time.time()
            if delay > 0:
                await asyncio.sleep(delay)
        node.chain.fork_choice.on_tick(slot)
        out = await validator.run_slot_duties(slot)
        if out["proposed"] is not None and node.network is not None:
            try:
                await node.network.publish_block(out["proposed"])
            except Exception as e:
                print(f"gossip publish failed: {e}", file=sys.stderr)
        head = node.chain.get_head_state()
        proposed = "block" if out["proposed"] is not None else "-    "
        print(
            f"slot {slot:3d}: {proposed} atts={len(out['attestations']):3d} "
            f"justified={head.current_justified_checkpoint.epoch} "
            f"finalized={head.finalized_checkpoint.epoch}",
            flush=True,
        )
        if args.slot_time and not (p2p and args.genesis_time):
            await asyncio.sleep(args.slot_time)
    head = node.chain.get_head_state()
    ok = head.slot == args.slots
    print(
        f"dev chain done: head slot {head.slot}, finalized epoch {head.finalized_checkpoint.epoch}",
        flush=True,
    )
    if args.linger:
        await asyncio.sleep(args.linger)
    await node.close()
    return 0 if ok else 1


async def _run_beacon(args) -> int:
    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.node import BeaconNode, BeaconNodeOptions
    from lodestar_tpu_torch.state_transition.genesis import create_interop_genesis_state

    from lodestar_tpu_torch.config import mainnet_chain_config, minimal_chain_config

    params.set_active_preset(args.preset)
    p = params.active_preset()
    chain_cfg = minimal_chain_config() if args.preset == "minimal" else mainnet_chain_config()
    if args.dev_genesis:
        far = 2**64 - 1
        chain_cfg = chain_cfg.replace(
            ALTAIR_FORK_EPOCH=far if args.altair_epoch is None else args.altair_epoch,
            BELLATRIX_FORK_EPOCH=far,
            CAPELLA_FORK_EPOCH=far,
            DENEB_FORK_EPOCH=far,
        )
        if args.p2p_port or args.bootnode:
            chain_cfg = chain_cfg.replace(SECONDS_PER_SLOT=max(1, int(args.slot_time or 1)))
    anchor = None
    db = None
    if args.db:
        from lodestar_tpu_torch.db import FileDbController
        from lodestar_tpu_torch.node.checkpoint_sync import load_anchor_state_from_db

        db = FileDbController(args.db + "/wal.log")
        try:
            anchor = load_anchor_state_from_db(db, p, chain_cfg)
            if anchor is None:
                # non-empty datadir with hot blocks but no archive yet:
                # refuse to interleave a fresh chain into the same wal
                from lodestar_tpu_torch.db import Bucket, Repository
                from lodestar_tpu_torch.ssz import uint64

                hot = Repository(db, Bucket.allForks_block, uint64).keys(limit=1)
                if hot:
                    print(
                        f"error: data directory {args.db} holds blocks but no archived "
                        "state (node stopped before first finalization); delete the "
                        "datadir or finish syncing with the original flags",
                        file=sys.stderr,
                    )
                    return 1
        except Exception as e:
            # a NON-EMPTY datadir that cannot be decoded must abort, not
            # silently start a fresh chain into the same wal (wrong
            # --preset / corruption would interleave two chains)
            print(
                f"error: data directory {args.db} exists but its archived state "
                f"cannot be decoded under preset {args.preset!r}: {e}",
                file=sys.stderr,
            )
            return 1
    if anchor is not None:
        if args.checkpoint_sync_url:
            print(
                "warning: --checkpoint-sync-url ignored — resuming from the data "
                "directory's archived state (delete the datadir to re-anchor)",
                file=sys.stderr,
            )
    elif args.checkpoint_sync_url:
        import time as _time

        from lodestar_tpu_torch.api.client import BeaconApiClient
        from lodestar_tpu_torch.node.checkpoint_sync import fetch_checkpoint_state

        client = BeaconApiClient(args.checkpoint_sync_url)
        genesis_time = int(client.get_genesis()["data"]["genesis_time"])
        current_slot = (
            # lint: allow(monotonic-durations) — slot math is anchored at the protocol's wall-clock genesis_time
            max(0, int(_time.time()) - genesis_time) // chain_cfg.SECONDS_PER_SLOT
        )
        anchor = fetch_checkpoint_state(client, p=p, current_slot=current_slot)
    else:
        anchor = create_interop_genesis_state(
            args.genesis_validators,
            genesis_time=args.genesis_time,
            p=p,
            genesis_fork_version=chain_cfg.GENESIS_FORK_VERSION,
        )
    bootnodes = []
    for b in args.bootnode:
        bhost, sep, bport = b.rpartition(":")
        if not sep or not bport.isdigit():
            print(f"error: --bootnode must be host:port, got {b!r}", file=sys.stderr)
            return 2
        bootnodes.append((bhost or "127.0.0.1", int(bport)))
    node = await BeaconNode.init(
        anchor_state=anchor,
        chain_config=chain_cfg,
        opts=BeaconNodeOptions(
            db_path=(args.db + "/wal.log") if args.db else None,
            rest_port=args.rest_port,
            device=args.device,
            metrics_enabled=args.metrics_port != 0,
            metrics_port=args.metrics_port,
            p2p_enabled=args.p2p_port != 0 or bool(bootnodes),
            p2p_port=args.p2p_port,
            bootnodes=bootnodes,
            tracing_enabled=args.tracing,
            tracing_slow_slot_ms=args.tracing_slow_slot_ms,
            tracing_export_dir=args.tracing_export_dir,
            tracing_export_max_files=args.tracing_export_max_files,
            tracing_export_max_age_s=args.tracing_export_max_age_sec,
            offload_endpoints=args.bls_offload,
            offload_breaker_threshold=args.offload_breaker_threshold,
            offload_breaker_reset_s=args.offload_breaker_reset_sec,
            offload_hedge_delay_ms=args.offload_hedge_delay_ms,
            offload_fallback=args.offload_fallback,
            offload_audit_rate=args.offload_audit_rate,
            offload_audit_budget=args.offload_audit_budget,
            offload_audit_via=args.offload_audit_via,
            offload_audit_seed=args.offload_audit_seed,
            offload_quarantine_cooloff_s=args.offload_quarantine_sec,
            offload_unquarantine=args.offload_unquarantine,
            scheduler_enabled=not args.sched_disable,
            bls_device_prep=args.bls_device_prep,
            bls_pipeline=args.bls_pipeline,
            bls_single_launch=args.bls_single_launch,
            htr_device=args.htr_device,
            bls_mesh=args.bls_mesh,
            offload_tenant=args.offload_tenant,
            launch_telemetry=args.launch_telemetry,
            slo_enabled=not args.slo_disable,
            slo_slack_floor_ms=args.slo_slack_floor_ms,
        ),
        p=p,
        db=db,
    )
    print(f"beacon node running; REST on :{node.rest_server.port}  (ctrl-c to stop)", flush=True)
    try:
        if node.network is not None and bootnodes:
            rc = await _sync_and_follow(node, args)
            if rc is not None:
                await node.close()
                return rc
        while True:
            await asyncio.sleep(3600)
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    await node.close()
    return 0


async def _sync_and_follow(node, args) -> int | None:
    """Range-sync to the best peer's head, then follow via gossip.
    Returns an exit code when --sync-target is set, else None."""
    from lodestar_tpu_torch.sync.range_sync import RangeSync

    net = node.network
    # wait for a peer: generous window — the remote may be inside a
    # first-use CUDA graph capture with its event loop pinned, and the
    # bootnode redial loop lands a connection once it resurfaces
    for _ in range(450):
        if net.host.peers():
            break
        await asyncio.sleep(0.2)
    peers = net.host.peers()
    if not peers:
        print("no peers to sync from", file=sys.stderr, flush=True)
        return 1 if args.sync_target else None
    # a transient peer failure here must not take the node down — the
    # follow loop below retries the gap sync on stall
    try:
        remote = await net.status(peers[0])
        local_head = int(
            node.chain.fork_choice.proto_array.get_block(node.chain.fork_choice.head).slot
        )
        remote_head = int(remote.head_slot)
        print(f"peer head {remote_head}, local head {local_head}", flush=True)
        if remote_head > local_head:
            rs = RangeSync(chain=node.chain, network=net, peers=peers)
            result = await rs.sync(local_head + 1, remote_head)
            print(
                f"range sync done: processed {result.processed_blocks} blocks", flush=True
            )
    except Exception as e:
        print(f"initial sync failed (will retry via follow loop): {e!r}", file=sys.stderr, flush=True)
    # follow via gossip until target (or forever); if gossip stalls (e.g.
    # blocks missed while range sync ran), re-range-sync the gap
    stall = 0
    last = -1
    while True:
        head = node.chain.fork_choice.proto_array.get_block(node.chain.fork_choice.head)
        head_slot = int(head.slot)
        print(f"head slot {head_slot}", flush=True)
        if args.sync_target and head_slot >= args.sync_target:
            print(f"sync target {args.sync_target} reached", flush=True)
            return 0
        stall = stall + 1 if head_slot == last else 0
        last = head_slot
        if stall >= 3 and net.host.peers():
            try:
                remote = await net.status(net.host.peers()[0])
                if int(remote.head_slot) > head_slot:
                    rs = RangeSync(chain=node.chain, network=net, peers=net.host.peers())
                    await rs.sync(head_slot + 1, int(remote.head_slot))
            except Exception as e:
                print(f"gap re-sync failed: {e!r}", file=sys.stderr, flush=True)
            stall = 0
        await asyncio.sleep(1.0)


async def _run_validator(args) -> int:
    """REST-mode validator process (reference `validator` command:
    keystores -> ValidatorStore -> duty loop against a beacon URL)."""
    import json as _json
    import os as _os
    import time as _time

    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.api.client import BeaconApiClient
    from lodestar_tpu_torch.config import create_beacon_config, mainnet_chain_config, minimal_chain_config
    from lodestar_tpu_torch.crypto.bls.api import SecretKey
    from lodestar_tpu_torch.db import MemoryDbController
    from lodestar_tpu_torch.validator import SlashingProtection, ValidatorStore
    from lodestar_tpu_torch.validator.keystore import decrypt_keystore
    from lodestar_tpu_torch.validator.rest_client import RestValidator

    params.set_active_preset(args.preset)
    p = params.active_preset()
    chain_cfg = minimal_chain_config() if args.preset == "minimal" else mainnet_chain_config()

    sks = []
    if args.interop_keys:
        from lodestar_tpu_torch.state_transition.genesis import interop_secret_keys

        sks = interop_secret_keys(args.interop_keys)
    elif args.keystores:
        for fname in sorted(_os.listdir(args.keystores)):
            if not fname.endswith(".json"):
                continue
            with open(_os.path.join(args.keystores, fname)) as f:
                ks = _json.load(f)
            sks.append(SecretKey.from_bytes(decrypt_keystore(ks, args.password)))
    if not sks:
        print("error: no keys (use --keystores or --interop-keys)", file=sys.stderr)
        return 1

    client = BeaconApiClient(args.beacon_url)
    genesis = client.get_genesis()["data"]
    # adopt the NODE's fork schedule/timing: signing domains must match the
    # chain we attach to, not the local preset defaults (reference
    # validator asserts config compatibility via /eth/v1/config/spec)
    try:
        spec = client.get_spec()["data"]
        node_preset = spec.get("PRESET_BASE", args.preset)
        if node_preset not in (args.preset, "custom"):
            print(
                f"error: node runs preset {node_preset!r} but --preset is "
                f"{args.preset!r}; epoch math would disagree — restart with "
                f"--preset {node_preset}",
                file=sys.stderr,
            )
            return 1
        overrides = {}
        for name in type(chain_cfg).__dataclass_fields__:
            if name not in spec:
                continue
            value = spec[name]
            current = getattr(chain_cfg, name)
            if isinstance(current, bytes):
                overrides[name] = bytes.fromhex(value[2:] if value.startswith("0x") else value)
            elif isinstance(current, int):
                overrides[name] = int(value)
            else:
                overrides[name] = value
        chain_cfg = chain_cfg.replace(**overrides)
    except Exception as e:
        print(f"warning: could not adopt node spec, using local config: {e}", file=sys.stderr)
    cfg = create_beacon_config(chain_cfg, bytes.fromhex(genesis["genesis_validators_root"][2:]))
    if args.data_dir:
        import os as _os2

        from lodestar_tpu_torch.db import FileDbController

        _os2.makedirs(args.data_dir, exist_ok=True)
        slashing_db = FileDbController(args.data_dir + "/slashing_protection.log")
    else:
        print(
            "warning: no --data-dir — slashing protection is IN MEMORY and "
            "lost on restart",
            file=sys.stderr,
        )
        slashing_db = MemoryDbController()
    store = ValidatorStore(cfg, SlashingProtection(slashing_db), sks, p)
    rv = RestValidator(client=client, store=store, p=p)

    km_server = None
    if args.keymanager_port:
        from lodestar_tpu_torch.validator.keymanager import KeymanagerApi, create_keymanager_server

        km = KeymanagerApi(store, genesis_validators_root=bytes.fromhex(genesis["genesis_validators_root"][2:]))
        km_server = create_keymanager_server(
            km, port=args.keymanager_port, token_dir=args.data_dir
        )
        km_server.start()
        where = (
            f"{args.data_dir}/api-token.txt" if args.data_dir else "(no --data-dir; shown once below)"
        )
        print(f"keymanager API on :{km_server.port}, bearer token in {where}")
        if not args.data_dir:
            print(f"keymanager token: {km_server.auth_token}")

    genesis_time = int(genesis["genesis_time"])
    seconds = int(chain_cfg.SECONDS_PER_SLOT)
    print(f"validator client up: {len(sks)} keys against {args.beacon_url}")
    ran = 0
    try:
        while args.slots == 0 or ran < args.slots:
            now = _time.time()
            if now < genesis_time + seconds:
                # pre-genesis / slot 0: wait for the slot-1 window rather
                # than running duties early and skipping them later
                await asyncio.sleep(min(2.0, genesis_time + seconds - now + 0.1))
                continue
            slot = (int(now) - genesis_time) // seconds
            try:
                out = rv.run_slot_duties(slot)
                if out["proposed"] is not None or out["attestations"]:
                    print(
                        f"slot {slot}: proposed={'yes' if out['proposed'] else 'no'} "
                        f"atts={len(out['attestations'])}"
                    )
            except Exception as e:
                print(f"slot {slot}: duty error: {e}", file=sys.stderr)
            ran += 1
            next_slot_at = genesis_time + (slot + 1) * seconds
            # lint: allow(monotonic-durations) — sleeping until a wall-clock slot boundary derived from genesis_time
            await asyncio.sleep(max(0.2, next_slot_at - _time.time()))
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        if km_server is not None:
            km_server.stop()
    return 0


def main(argv: list[str] | None = None) -> int:
    ap, sub_actions = _build_parser(with_subparsers=True)
    import sys as _sys

    argv = list(_sys.argv[1:] if argv is None else argv)
    argv = _apply_rc_config(ap, sub_actions, argv)
    args = ap.parse_args(argv)
    if args.cmd == "dev":
        return asyncio.run(_run_dev(args))
    if args.cmd == "beacon":
        return asyncio.run(_run_beacon(args))
    if args.cmd == "lightclient":
        return asyncio.run(_run_lightclient(args))
    if args.cmd == "validator":
        return asyncio.run(_run_validator(args))
    if args.cmd == "bench":
        print(BENCH_MISSING, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
