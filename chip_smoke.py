#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`lodestar_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. probe    torch version, CUDA device, `nvidia-smi` name and power limit.
2. build    compile the Fp kernels (ops/csrc/fp_kernels.cu) from source with
            nvcc and, beside it, the native host libraries with g++
            (native/sha256_batch.cpp, native/bls_host.cpp, into
            native/_build/): fails if either does not build or load or the
            BLS one fails its self-test; prints the SHA-256 backend and
            each build's s.
3. kernels  each of the five kernels against its plain PyTorch version on
            the card, bit for bit (tolerance 0), at the tile edges of the
            kernels and the main path's row counts (N_KERNEL_CHECK), on
            random relaxed signed limbs made with numpy from a fixed seed:
            +-LIMB_LOOSE rows, exact-zero rows, and for redc signed sums of
            three accumulators. Then each kernel's DEVICE time at the row
            counts of N_TIMED: 50 launches captured in one CUDA graph, the
            replays timed with CUDA events (so the wrappers' host work is
            not in it), each time beside its bound.
4. main     the port's main path through its entry points, compressed bytes
            in and verdict out, with device input prep (ops/prep.py) on the
            card, through the split schedule (single launch switched off
            for this phase): 128 synthetic sets (bench.py's seed 17) verify True, two
            swapped signatures verify False, and a batch with one pubkey
            off the curve and one signature off the G2 subgroup verifies
            False through prep's own ok bits. Then 16 copies of the 128
            sets' bytes and messages (bench.py's merge) go through
            `build_device_inputs(..., size=2048)` on device prep (1 warm-up,
            TIMED_RUNS timed runs); the 128 unique sets' prepped arrays must equal
            the pure-Python oracle's prep on canonical values (the oracle
            runs once, on 128 sets, outside every timed window); and the
            device-prepped 2048 sets go through `device_batch_verify` with
            fresh blinding (1 warm-up, TIMED_RUNS timed), all True. Prints the
            prep time per 2048 sets, the oracle's per 128, and
            bytes-to-verdict sigs/s beside verify-only sigs/s. Launch
            counts are reset just before and read just after; every kernel
            must have launched. Then the host road (`prep="off"`): the 2048
            merged sets through `prepare_sets` on the native C++ library
            (TIMED_RUNS timed; s and sets/s), its limbs equal to
            device prep's on canonical values and to the oracle's limb for
            limb on the 128 unique sets; one split-schedule verify of the
            native inputs (True, every kernel launched), the swapped batch
            False and the invalid-point batch rejected by the native prep.
5. profile  where the time of one merged 2048-set verify and of one
            2048-set prep goes: each kernel's launches per verify and per
            prep by row count, and its kernel ms per verify and per prep
            (launches x graph-replay time at each of those row counts); one
            more verify split at its three stage boundaries and one more
            prep at its stages (host bytes, then field, subgroup, hash
            finish; wall time, kernel launches and kernel ms per stage).
            The split schedule is not profiled (PERF.md has its busy time
            and profiler ms per kernel): the kernels line's
            `profiler_ms_per_2048_*` are null.
6. single   the single-launch path, the default on the card: compressed
            bytes in, one counted dispatch per batch, one CUDA-graph
            replay per size class (`graphs.py`). Kernel launch counts and
            graph replays are reset just before it and read just after;
            every kernel must have been launched by a replay. 128 sets
            valid (True), swapped (False), invalid points (False, and the
            replay's batch_valid False), valid again, all on one captured
            graph; then the 2048 merged sets (1 warm-up with the capture,
            TIMED_RUNS timed): capture and instantiate s, the graph's node count
            (`cuGraphGetNodes`), its pool's reserved memory, bytes-to-
            verdict s and sigs/s beside the split schedule's of phase 4,
            the host byte stage alone, copy in + replay + verdict read, the
            replay's device time by CUDA events (the gaps between its kernel
            nodes included) and its share of copy in + replay + read (the
            card's idle share is not measured here), Fp launches per replay
            (counted at capture); the
            replay's (verdict, batch_valid) equals the eager body's and the
            split schedule's verdict on the same inputs and bits. Then
            `device_batch_verify_many` on the merged batch as 16 jobs of
            128 (every job True; one tampered job False), eagerly, at row
            counts phase 3 checked.
7. serve    serving through the port's verifier pool: `warm_single_launch`
            captures every size class a package of the pool can reach
            (`POOL_SIZE_CLASSES`, 8 through 1024; 128 is already captured
            by phase 6), each class printed with its capture and
            instantiate s, node count, pool MiB, Fp launches per replay and
            one copy in + replay + verdict read; a warmed graph
            must launch the kernels only at row counts phase 3 checked
            (`POOL_ROWS`). Then `BlsDeviceVerifierPool(mesh_mode="auto")`
            (one lane on one GPU) serves, with kernel launch counts and
            replays reset just before and read just after, and no capture
            allowed: 16 batchable jobs of 128 at API priority (4 replays of
            class 512), the same at range-sync priority (16 of class 128),
            SERVE_GOSSIP_JOBS (128) one-set gossip-attestation jobs at once (the buffer and
            16-job chunks: replays of class 16, and 8 for a short last
            chunk), 4 jobs of 128 with two swapped signatures in the second
            (one class-512 replay False, then 4 per-job class-128 replays:
            [True, False, True, True]), a wrong-length set and a set whose
            pubkey is not bytes (False, no replay); the lane's breaker must
            show no failure. Each run prints its wall s, sigs/s, launches
            and replays by class; the API run again through a pipelined
            pool (`pipeline="on"`) prints its `pipeline_stats()`. Every
            kernel must be launched by a replay while the pool serves, and
            none eagerly. `create_metrics()`'s families are attached to the
            first pool (`sched_metrics=`, `pipeline_metrics=`), prep
            (`configure_device_prep(metrics=)`), the launch telemetry and the
            SLO accountant before it serves; its scrape through a
            `MetricsServer` on 127.0.0.1 (bytes, ms) must equal the pool's
            jobs started, the lane's launches, `prep_counts()`, the replays
            by class (one `_single_launch_verify` dispatch each) and the
            jobs' verdicts by class.
7b. offload the offload host (`offload/server.py`) as its entry point builds it:
            `build_server(OFFLOAD_ARGV)` (the CUDA mesh, one lane on one GPU,
            every pool class captured; one service slot, tenants a=1 and
            b=3). Counts, replays and captures are reset after it; its
            Status frame must say ACCEPT, one chip not wedged, tenant
            capable. Verify frames go in through `local_transports`'s
            `LocalStub` (the phase needs no grpc, which a GPU host may lack;
            whether grpc imports is printed for the record) from four threads, as gRPC's workers
            call `_verify`, and every reply is decoded against its request
            (digest-checked): 16 frames of the merged batch's 128 sets, 8
            with tenant a and 8 with b, at API priority (16 class-128
            replays, True), 16 one-set gossip-attestation frames (16 class-8
            replays, True), a frame of 128 with two swapped signatures
            (False), a frame one byte short and a frame whose trailer names
            an unknown priority class (error frames, no replay), and one
            traced frame whose trailing metadata carries the server's
            `offload_decode` and `offload_device_verify` spans, grafted
            under a local span. Each run prints wall s, frames/s, sigs/s,
            replays by class and the tenancy's served count per tenant; the
            API run beside phase 7's pool figure. Then
            `DegradingBlsVerifier([device pool, CPU oracle])`: 16 jobs of
            128 True and the tampered job False, each served by the device
            layer with zero fallbacks and skips. No capture, no eager
            launch, every kernel launched by a replay, the lane breakers
            clean. The host is built with `--metrics-port` on a free port:
            its lodestar_offload_tenant_* scrape must equal the sets served
            per tenant, the tenancy's sheds, the weights and no slot held.
            Lines start `offload:`.
7c. client  the port's offload client (`offload/client.py`) over two hosts on
            the card: "h100-a" is 7b's host, "h100-b" a second
            `BlsOffloadServer` over the same lanes with the same tenancy
            flags, both in-process through `local_transports` with a
            `FaultInjector` in front; counts, replays and captures reset
            first. (a) the 16 API jobs of 128 (tenant a, gathered on one
            loop; the API budget raised to 30 s, see CLIENT_API_BUDGET_S):
            all True, 16 class-128 replays, the jobs' split between the
            hosts, sigs/s beside 7b's and phase 7's. (b) 16 one-set
            gossip-block jobs at the default class budgets, sequential
            retry, then with the concurrent hedge at
            DEFAULT_HEDGE_DELAY_MS: verdicts, sheds, failovers, hedges,
            replays and the replays past the verdicts. (c) h100-b cut
            under a burst of one-set gossip-attestation jobs: every
            verdict True through failover to h100-a, h100-b's breaker
            open after DEFAULT_FAILURE_THRESHOLD failures and not dialed,
            then healed: a probe answers and its half-open trial re-closes
            it; endpoint_states() at each step. (d) a LIE_VERDICT window on
            h100-b (h100-a cut meanwhile), an OffloadAuditor on the CPU
            oracle: the lie served, caught within detection_horizon
            samples, h100-b quarantined, later jobs on h100-a only, then
            lifted by unquarantine_endpoint. (e) DegradingBlsVerifier
            [client, device pool, CPU oracle]: both hosts cut, the pool
            serves (counted); healed, the client serves. No capture, no
            eager launch, every kernel replayed. The clients' `metrics=` and
            the auditor's feed one `create_metrics()`'s `ResilienceMetrics`
            and `AuditMetrics`: the scrape's routed, failover, hedge,
            hedge-win and shed totals equal the runs' counts, and its audit
            counters the auditor's. Lines start `offload-client:`.
7d. sharded the sharded verify (`verify_signature_sets_sharded`) over
            every visible GPU, or cuda:0 twice on one GPU. First, outside
            the counted run: the single launch's verdict on a tampered copy
            of the road's batch, and `warm_sharded` of the pool's class.
            Then counts and replays reset: (a) the road's batch (the first
            BATCH of the merged sets, so one shard class serves the whole
            phase) True and the tampered copy False, as the single launch
            says, each in n_shards + 1 dispatches, TIMED_RUNS timed, sigs/s; (e)
            the pool over two lanes with the real collective:
            SHARD_POOL_JOBS (2) range-sync jobs of 128 True in as many
            sharded launches with 0 fallbacks, one
            job with a bad signature False through the per-job retry, no
            capture, no eager launch; replays read. (b) the graph road's
            partials limb-equal to the eager road's on the same bits; (c)
            every Fp launch of the shard and finish graphs at a row count
            phase 3 checked; (d) each graph's capture and instantiate s,
            nodes, pool MiB and replay ms (CUDA events); the steps' wall s.
            Lines start `sharded:`.
8. htr     the state hashTreeRoot (`state_transition/htr.py` over
            `ssz/device_htr.py` and `ops/sha256.py`), on the card by default
            (mode "auto"): each merkle level of at least 2048 pairs is one
            replay of a CUDA graph captured per pow-2 pair class
            (`graphs.GraphCache`), smaller levels are hashed on the host
            (the native batch hasher, `native/sha256_batch.cpp`).
            (a) `merkle_root` of 2^20 random chunks (bench.py's seed 0), one
            graph for the tree: 1 warm-up with the capture, 5 timed, the
            root equal to hashlib's; pair-hashes/s; the host hasher's
            backend and its pair-hashes/s on the tree and on a 2,047-pair
            level (the largest host level) beside hashlib's, the native
            root equal to hashlib's. (b) the collector on a
            2^18-chunk stack with 4096 dirty chunks a flush, 5 flushes, each
            on the device with at most 18 launches; chunks/s. (c) a mainnet
            Capella BeaconState with 2^20 validators: a cold root,
            HTR_ROUNDS epoch-boundary round(s), as many slot-shaped rounds
            and a profiled epoch round through `state_hash_tree_root`, each root equal to a second
            tracker's on the same state hashed on the host only (no launch,
            no replay); each round prints host prepare s, flush s, launches,
            replays by pair class and captures (none after the cold root).
            (d) each level graph's capture and instantiate s, nodes, pool MiB
            and replay device time beside its bound; the profiled round's
            device busy ms and idle share. Lines start `htr:`.
9. kzg      KZG blob commitments and proof checks (`crypto/kzg.py`) at a
            mainnet block, on the card by default: counts and replays
            reset just before and read just after; every kernel must have
            launched, and every launch (graph or eager) must be at a row
            count phase 3 checked (KZG_ROWS). (b) the trusted setup's load
            s and the upload s of its limbs. (c) a random mainnet blob
            (numpy seed KZG_SEED): 1 warm-up with the MSM graph's capture
            (class 4,096), KZG_TIMED timed commitments, equal to the host
            oracle's bytes (`oracle=True`, once, untimed) and a constant
            blob's equal to [c]G1; capture and instantiate s, nodes, pool
            MiB, the replay's device ms beside its bound, commitments/s,
            Fp launches per replay. (d) opening checks through the
            pairing-check graph (class 2): `verify_kzg_proof` True for a
            linear blob's opening and False for y + 1,
            `verify_blob_kzg_proof` True and False, each verdict equal to
            the oracle's `pairings_are_one` on the same pairs; the replay's
            device ms, nodes, capture s and one profiled check's idle
            share. (e) a block of MAX_BLOBS_PER_BLOCK blobs: the aggregate proof (5
            MSM replays), its checks (right order, swapped commitments,
            swapped blobs, empty sidecars), `validate_blobs_sidecar`
            passing and raising KzgError on a wrong slot and an infinity
            proof, the check's wall s split into host s and replay s; no
            capture after (c) and (d). Lines start `kzg:`.
10. block   a mainnet-preset Capella block imported on the card in the
            shape of the JAX package's chain.py block import, through the
            port's public functions: an interop phase0 genesis of
            BLOCK_VALIDATORS validators (keys derived on worker processes),
            altair, bellatrix and capella at epoch 1, and a block at
            BLOCK_SLOT with its randao reveal, 2 x 32 attestations (every
            committee of slots 1-32, every member attesting), an empty sync
            aggregate and its state root from a host-only run (every hash
            the host hasher's). The import, counts and replays set to 0 just before
            and read just after: `process_slots` to the block's slot (its
            state roots through the HTR level graphs), the block's 66
            signature sets, then the sets through `BlsDeviceVerifierPool` on
            cuda:0 (API priority, not batchable: one class-128 replay, every
            kernel launched by it, none eagerly) while an executor thread
            runs `process_block(..., verify_signatures=False)` and roots the
            post-state on the card. Verdict True, the root equal to the
            block's, the sets equal field for field to sets derived from
            the secret keys (`reference_sets`, no pubkey decoded); a block
            with two attestations' signatures swapped verifies False;
            a block with one byte of its state root changed is reported as
            a root mismatch. Prints the
            set-up s, process_slots s (host prepare + flush, HTR replays by
            pair class), set-building s and its pubkey-aggregation share,
            the verify's wall s, replay class and Fp launches per replay,
            process_block s and state-root s, the import's wall s. No graph
            may be captured in the phase. Lines start `block:`.
10b. chain  phase 10's genesis, config, keys and slot-33 block through the
            port's `BeaconChain` (fork choice, a `MemoryDbController`, the
            verifier pool on cuda:0), counts and replays set to 0 just
            before each step and read just after: (a) `process_block` of the
            slot-33 block (API priority) with phase 10's signature sets
            (its set-building is not repeated): its root returned, the head,
            the db's bytes the block's, one class-128 replay and no eager
            launch, its wall s split by the trace's spans (verify, STF +
            root, and the chain's own sanity, regen, persist and fork
            choice); (b) at slot
            34, one SignedAggregateAndProof of each slot-33 committee (every
            member attesting, the aggregator found by its selection proof)
            and one single attestation, each validated
            (`validate_gossip_aggregate_and_proof`,
            `validate_gossip_attestation`) and its sets verified through the
            pool as one gossip-attestation job (True), imported into the
            pools and fork choice; each aggregate again is IGNOREd; (c)
            `produce_block` at slot 34 packs both aggregates; the block
            signed with another validator's key is rejected with
            INVALID_SIGNATURES (head and db unchanged), the valid block
            imports in one class-8 replay and becomes the head, and fork
            choice holds the slot-33 attesters' votes for block 33; (d) the
            slot-34 state dropped from the state cache and regenerated from
            the db, its root on the card block 34's. Every replay at a pool
            class phase 7 warmed, no graph captured. Lines start `chain:`.
10c. sync   phase 10's genesis, config and keys through the port's network
            side, counts and replays set to 0 just before each step and read
            just after: (a) 32 Capella blocks at slots 35-66 (no
            attestations, slots 1-34 empty) built on the host, imported by a
            serving `BeaconChain` (mock verifier) and served by its
            `ReqRespBeaconNode` over TCP on 127.0.0.1 (in-memory streams
            where a loopback socket is refused); (b) `RangeSync(35, 66)`
            into a fresh chain on `BlsDeviceVerifierPool(mesh_mode="auto")`
            over blocks-by-range v2: 32 imports, one class-8 replay each,
            the head the server's; (b') a device error in the pool's lanes
            pauses the round (no attempt spent, no downscore); (c)
            `BackfillSync` of the window [34, 66) from the synced head: 31
            blocks linked down to the genesis block, their proposer
            signatures as one BACKFILL job (one class-32 replay), persisted;
            with a byte of one signature changed, rejected with nothing
            persisted; (d) a produced slot-67 block, the slot-66 aggregates
            and an attestation pushed by topic into `NetworkProcessor` and
            drained with `execute_work` (validation s, pool s, replay class
            and verdict per object; processed 4, errors 0, the head at 67).
            No graph captured. Lines start `sync:`.
10d. p2p    two `Libp2pBeaconNetwork` services on 127.0.0.1 over phase 10c's
            chains (`p2p_run`), counts and replays set to 0 just before each
            step and read just after. A serves 10c's serving chain (mock
            verifier) after importing 10c's slot-67 block; B serves 10c's
            synced chain on a fresh `BlsDeviceVerifierPool(mesh_mode="auto")`.
            (a) B knows only A's ENR: its discovery loop finds A through
            discv5 over UDP (WHOAREYOU, handshake, FINDNODE) and dials it
            (TCP, multistream, noise XX, mplex); the status handshake runs
            both ways; no replay. (b) A imports 4 blocks (slots 68-71, built
            on the host) with its mock; `RangeSync` on B downloads them from
            A over blocks-by-range v2 on an mplex stream inside the noise
            channel: 4 imports, one class-8 replay each, B's head A's. (c) A
            publishes the slot-72 block on gossipsub; B's validator decodes
            it, its node object pushes it into `NetworkProcessor` and the
            drain loop imports it (one class-8 replay, head at 72); then an
            aggregate of slot 71 on `beacon_aggregate_and_proof` (True, one
            class-8 replay). (d) the slot-73 block with one byte of its
            proposer signature changed: rejected on the pool's False verdict
            (one class-8 replay), B's head stays at 72. (e) both stop: B's
            goodbye answered, no task left; the noise frames, bytes and mplex
            streams each side sent. No graph captured, no eager launch, no
            in-memory stand-in: a refused loopback socket fails the phase.
            Lines start `p2p:`.
10e. lightclient  a light client on phase 10d's synced chain (`lc_run`),
            counts and replays set to 0 just before each step and read just
            after, on a fresh `BlsDeviceVerifierPool(mesh_mode="auto")` and
            with a `LightClientServer` attached: (a) blocks 73-76 built on
            the host with full sync aggregates (all 512 bits; one signature
            by the sum mod r of the members' keys, checked once on the host
            oracle's `eth_fast_aggregate_verify`), each imported through
            `BeaconChain.process_block` as 3 sets (proposer, randao, the
            512-pubkey sync-committee set) in one class-8 replay, split into
            set-building s, pool s and the server's `on_imported_block` s;
            (b) block 77, its aggregate signed over another root, rejected
            INVALID_SIGNATURES after one class-8 replay, head and the
            server's updates unchanged; (c) a `Lightclient` (fork version:
            Capella's) over req/resp on 127.0.0.1 (`LightClientWire`):
            bootstrap from block 73, `sync_to_head` (period 0's update),
            `poll_head` (the optimistic update: its header at slot 75, the
            finalized header still 73's), an update with one signature byte
            changed refused; bootstrap s, each validation's s, bytes on the
            wire; no replay. No graph captured. Lines start `lightclient:`.
10f. rest   a validator client over the port's Beacon REST API on phase
            10e's chain (`rest_run`): an event loop on a thread attached as
            `chain.loop`, a fresh `BlsDeviceVerifierPool(mesh_mode="auto")`
            made on it, `BeaconRestApiServer(BeaconApiImpl(chain), port=0)`
            on 127.0.0.1, and a `RestValidator` over a `BeaconApiClient`
            whose store (`SlashingProtection` on a `MemoryDbController`)
            holds the interop keys of the proposers of slots 77-78, the
            first REST_ATTESTERS members of each slot's committee 0 and one
            sync-committee member (the first found an aggregator at slot
            77). Each request is a counted step (counts and replays set to 0
            just before, read just after; wall s, pool jobs, replays by
            class). (a) `refresh_indices` over the validators route; (b) two
            slots of `run_slot_duties`: produce, sign and publish the block
            (GOSSIP_BLOCK priority, one replay; the second packs what the
            aggregated pool holds and the first slot's contribution), the
            attestations (one API job and one class-8 replay each), the
            sync-committee messages and the contribution; the new head's
            state root on the card equal to the block's; (c) an
            attestation with signature byte REST_TAMPERED_BYTE changed and
            a block signed with another validator's key: HTTP 400 after one
            replay each, head and db unchanged; (d) an SSE stream on head
            and block, opened before (b), saw both slots; (e) the server
            stopped, no stream and no server thread left, the pool and the
            loop closed. Every signature the validator made is then checked
            once on the host oracle. Every replay at a class phase 7 warmed,
            no graph captured, no eager launch. Lines start `rest:`.
10g. node  the port's node and CLI (`node_run`), at the minimal preset.
            (a) `lodestar_tpu_torch.cli.main(["dev", "--validators", "16",
            "--slots", "32", "--preset", "minimal", "--rest-port", P,
            "--linger", L])` in-process on a thread of its own, with the
            default `--device cuda`: its `BeaconNode`'s verifier must be the
            CUDA `BlsDeviceVerifierPool`; each of its 32 blocks imports
            through `BeaconChain.process_block` in one class-8 replay (the
            graph phase 7 captured); the chain finalizes epoch 2 at slot 32,
            main returns 0. Its slot lines are printed as `node: (a) ...`;
            per-import s, replays by class, Fp launches per kernel beside
            32 x a class-8 replay's, a class-8 replay's device ms by CUDA
            events and its kernels' busy ms under the profiler (one replay
            after the phase), and the card's idle share, estimated: the
            run's replays x that busy ms, over the run's wall s.
            (b) while (a) lingers: `fetch_checkpoint_state` over a
            `BeaconApiClient` on (a)'s REST server (the finalized state, its
            root the finalized block's state root), blocks 17-32 with
            `get_block_v2`, and `BeaconNode.init` on the card anchored on
            the state (db in a temp dir, metrics and REST servers on free
            ports, a manual clock at slot 32): the 16 blocks in 16 class-8
            replays, its head and finalized and justified checkpoints beside
            (a)'s; one /metrics scrape (head slot, finalized epoch, pool
            jobs, the single launch's dispatches by class) equal to the
            phase's own counts; one `notifier.on_slot(32)` line. (c) both
            nodes closed: no server thread, listening socket or new thread
            left; the preset and the process-global prep, HTR, telemetry and
            SLO settings the nodes reconfigured restored. Counts and replays
            set to 0 just before (a) and (b) and read just after; no graph
            captured, no eager launch, no block rejected. Lines start
            `node:`.
11. check   a Miller loop + final exponentiation of two pairs on the card
            equals the CPU path (the plain versions) limb for limb, and
            equals e(P, Q) from the host pairing check on canonical values.
12. report  one JSON line of kernels, the `nvidia-smi` line, and the last
            line {"ok": true, "device": {...}}.

With `--compare-parent DIR` (a checkout of an earlier commit, for example
unpacked with `git archive` into a directory that .gitignore lists),
phase 2 also builds DIR's kernel source, beside this one's, and a step
between phases 11 and 12 checks each of its kernels against the plain
version and times it beside this source's, in turns (parent, this, this,
parent), at the row counts of N_TIMED and of one merged verify, each
with its ms per verify.

The pure-Python oracle prep (`prep="off"`, tens of ms per set) is the
reference for device prep; it runs once, outside every timed window, and is
printed on its own line.
"""

import argparse
import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import time

# Row counts the main path launches the Fp kernels at (a 2048-set verify:
# 1 in the Fermat chains, 12/36 in the final exponentiation, 2048 in the
# Fermat chain of the blinded public keys, 4096-6147 in the curve and tower
# steps, 24588-73764 in the Miller loop; a 2048-set prep: PREP_ROWS, 20480
# and 30720 in its Fp2 square-root chain), the edges of the kernels' paths
# (one row, one 16- or 32-row tile), tiles, 128-row blocks and share counts
# (eight a row up to 16 rows per SM: 2112 on an H100 SXM), the two sides of
# redc's switch to its column-range body (past five 32-row tiles per SM:
# 21120), and 110646, the row count the first kernel table was measured at.
# Phase 4 fails if a prep launches a kernel at a row count not checked here,
# and phase 6 if `device_batch_verify_many` of 16 jobs of 128 sets does
# (MANY_ROWS: its scalar muls on 2048 rows, its Miller loop on 16 x 129
# pairs, its folds and 16 final exponentiations).
PREP_ROWS = (2048, 4096, 6144, 8192, 12288, 20480, 30720, 81920, 122880)
MANY_ROWS = (16, 32, 48, 64, 96, 128, 144, 192, 256, 288, 384, 512, 576, 768, 864, 1024, 1536,
             1728, 2048, 3072, 3456, 4096, 4128, 6144, 6192, 6912, 12288, 13824, 24576, 24768,
             27648, 37152, 49536, 55296, 74304, 110592)
# POOL_ROWS: every row count the single-launch graphs of the verifier pool's
# size classes (8 through 1024) launch a kernel at, counted on the CPU by
# `rows_on_meta` (the body on meta tensors with stub products); phase 7 fails
# if a warmed graph launches one not checked here.
POOL_ROWS = (1, 2, 3, 4, 6, 8, 9, 12, 16, 18, 24, 27, 32, 34, 36, 48, 51, 54, 64, 66, 80, 96,
             99, 108, 120, 128, 130, 160, 162, 192, 195, 204, 216, 240, 256, 258, 306, 320,
             324, 384, 387, 396, 408, 432, 480, 512, 514, 594, 612, 640, 768, 771, 780, 792,
             864, 960, 1024, 1026, 1170, 1188, 1280, 1536, 1539, 1548, 1560, 1728, 1920, 2048,
             2050, 2322, 2340, 2560, 3072, 3075, 3084, 3096, 3456, 3840, 4096, 4626, 4644,
             5120, 6144, 6156, 6168, 6912, 7680, 9234, 9252, 10240, 12288, 12300, 12312, 13824,
             15360, 18450, 18468, 20480, 24600, 27648, 30720, 36900, 40960, 55296, 61440)
# KZG_ROWS: every row count the KZG graphs launch a kernel at (the MSM's at
# class 4,096: the double-and-add on 4,096 rows and the tree fold's 2,048 down
# to 1; the pairing check's at class 2), counted on the CPU by
# `kzg_rows_on_meta`; phase 9 fails if a graph or an eager launch of the KZG
# path uses one not checked here.
KZG_ROWS = (1, 2, 4, 6, 8, 9, 12, 16, 18, 24, 32, 36, 48, 54, 64, 72, 128, 256, 512, 1024, 2048,
            4096)
# SHARD_ROWS: every row count the sharded verify's graphs launch a kernel at
# with two shards (phase 7d): the shard body (prep legs and partials) at shard
# classes 1,024 (2,048 sets) and 64 (the pool's 128-set jobs) and the finish at
# two shards, counted on the CPU by `shard_rows_on_meta`; phase 7d fails if a
# shard or finish graph launches one that no phase checked.
SHARD_ROWS = (1, 2, 3, 4, 6, 8, 9, 12, 16, 18, 24, 32, 36, 48, 54, 64, 96, 108, 128, 192, 216,
              256, 384, 432, 512, 640, 768, 864, 960, 1024, 1152, 1536, 1728, 2048, 2304, 2560,
              3072, 3456, 3840, 4096, 6144, 6912, 10240, 12288, 13824, 15360, 18432, 24576,
              27648, 36864, 40960, 61440)
N_TIMED = (1, 12, 36, 2048, 4096, 6147, 20480, 21120, 21121, 24588, 30720, 73764, 110646,
           122880)
N_KERNEL_CHECK = tuple(sorted({*N_TIMED, *PREP_ROWS, *MANY_ROWS, *POOL_ROWS, *KZG_ROWS,
                               *SHARD_ROWS, 2, 15, 16,
                               17, 31, 32, 33, 63, 64, 65, 511, 512, 513, 2049, 2112, 2113,
                               4098}))
N_COMPARE = 110646
BATCH = 128  # sets per gossip job
MERGE_JOBS = 16  # jobs merged into one RLC batch
TIMED_RUNS = 1  # timed runs after the warm-up in phases 4, 6 and 7d
SERVE_CLASS_REPLAYS = 1  # phase 7's timed replays of each warmed class
SERVE_GOSSIP_JOBS = 128  # phase 7's one-set gossip jobs

# H100 SXM peaks for the bound (NVIDIA's data sheet and the Hopper
# architecture white paper): 3.35 TB/s of HBM; int32 multiply-adds at
# 132 SMs x 64 int32 lanes x 1.98 GHz (half the 67 TFLOP/s float32 rate,
# which counts 128 lanes and a multiply-add as two operations).
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 132 * 64 * 1.98e9

REPLACES = {
    "mul_acc": "lodestar_tpu/ops/fp_pallas.py:173",
    "sq_acc": "lodestar_tpu/ops/fp_pallas.py:182",
    "mont_sq": "lodestar_tpu/ops/fp_pallas.py:187",
    "redc": "lodestar_tpu/ops/fp_pallas.py:193",
    "mont_mul": "lodestar_tpu/ops/fp_pallas.py:199",
}
SOURCE = "lodestar_tpu_torch/ops/csrc/fp_kernels.cu"


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean time of fn() over `iters` back-to-back host calls (CUDA events
    around the loop): device time only where the device, not the host's
    issue rate, is the limit (the plain versions, milliseconds a call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=50, replays=5):
    """Device time of one fn() call: `iters` calls captured in one CUDA
    graph, `replays` replays timed with CUDA events, divided out. The
    wrapper's host work (checks, allocation, the ctypes call) runs once at
    capture and not in the timed window; what remains per call is the
    kernel and the graph's launch of it. Inputs stay in the 50 MB L2 across
    the calls where they fit, as they do for the main path's producer and
    consumer kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def rows_on_meta(size):
    """{kernel: {rows: launches}} of the single-launch body at one size
    class, counted on the CPU with no card (`count_on_meta`)."""
    from lodestar_tpu_torch.models import batch_verify as bv

    return count_on_meta(bv._single_launch_verify, bv._warm_inputs(size))


def shard_rows_on_meta(shard_class, n_shards):
    """{kernel: {rows: launches}} of one shard body at `shard_class` rows and
    of the finish at `n_shards` shards, counted on the CPU with no card
    (`count_on_meta`)."""
    import numpy as np

    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import fp

    shard = count_on_meta(bv._single_launch_shard, bv._warm_inputs(shard_class))
    finish = count_on_meta(bv._shard_finish_body, (
        np.zeros((n_shards, 2, 3, 2, fp.LIMBS), np.int32),
        *(np.zeros((n_shards, 2, fp.LIMBS), np.int32) for _ in range(3)),
        np.zeros((2, fp.LIMBS), np.int32), np.zeros((2, fp.LIMBS), np.int32)))
    return {k: {n: shard[k].get(n, 0) + finish[k].get(n, 0)
                for n in sorted({*shard[k], *finish[k]})} for k in shard}


def count_on_meta(body, arrays):
    """{kernel: {rows: launches}} of `body` on `arrays`, counted on the CPU
    with no card: the body runs on meta tensors (shapes only) with the
    kernel wrappers' launch replaced by a stub that books the row count
    and returns an empty meta result."""
    import numpy as np
    import torch

    from lodestar_tpu_torch.ops import fp_cuda

    rows = {k: {} for k in fp_cuda.KERNELS}

    def stub(name, *args, lib=None):
        lead = args[0].shape[:-1]
        n = int(np.prod(lead))
        rows[name][n] = rows[name].get(n, 0) + 1
        return torch.empty((*lead, fp_cuda._SHAPES[name][2]), dtype=torch.int32, device="meta")

    real, fp_cuda.launch = fp_cuda.launch, stub
    try:
        body(*(torch.as_tensor(np.ascontiguousarray(a)).to("meta") for a in arrays))
    finally:
        fp_cuda.launch = real
    return rows


def bound(name, n):
    """(least ms for n rows on the card, "bytes" or "operations")."""
    macs, nbytes = work_per_row(name)
    t_ops = n * macs / INT32_MAD_PER_S * 1e3
    t_bytes = n * nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


# --- phase 3 -----------------------------------------------------------------


def kernel_inputs(name, n, rng, dev):
    """Random relaxed signed limbs (and for redc, signed sums of three
    accumulators) on the card, with extreme and exact-zero rows."""
    import numpy as np
    import torch

    from lodestar_tpu_torch.ops import fp, fp_cuda

    def rows(k):
        a = rng.integers(-66, fp.LIMB_LOOSE + 1, size=(k, fp.LIMBS)).astype(np.int32)
        a[:, -1] = rng.integers(-1, 2, size=k)
        a[0::7] = fp.LIMB_LOOSE
        a[3::7] = -fp.LIMB_LOOSE
        a[5::11] = 0
        return torch.from_numpy(a).to(dev)

    if name == "redc":
        a, b, c = rows(n), rows(n), rows(n)
        t = fp.plain_mul_acc(a, b) + fp.plain_mul_acc(b, c) - fp.plain_sq_acc(c)
        t[2::9] = 0
        return (t,)
    if name in ("sq_acc", "mont_sq"):
        return (rows(n),)
    return rows(n), rows(n)


def work_per_row(name):
    """(int32 multiply-adds, bytes read + written) per row: each input read
    once and each output written once; products skip zero constant limbs
    and a square counts each cross product once."""
    from lodestar_tpu_torch.ops import fp

    L = fp.LIMBS
    conv, sq = L * L, L * (L + 1) // 2
    m_step = sum(L - j for j, c in enumerate(fp.PPRIME_LIMBS) if c)
    mp_step = L * sum(1 for c in fp.P_LIMBS if c)
    redc = m_step + mp_step
    return {
        "mul_acc": (conv, 4 * (L + L + 2 * L)),
        "sq_acc": (sq, 4 * (L + 2 * L)),
        "redc": (redc, 4 * (2 * L + L)),
        "mont_mul": (conv + redc, 4 * (L + L + L)),
        "mont_sq": (sq + redc, 4 * (L + L)),
    }[name]


def check_kernels(dev, rows=N_KERNEL_CHECK):
    """Phase 3: each kernel against its plain version, bit for bit, at
    `rows`, and its device time at the rows of N_TIMED among them. Phase 7d
    passes the row counts of shard classes outside N_KERNEL_CHECK (a host
    whose GPU count gives other shard classes than SHARD_ROWS' two); the
    report is then empty, since N_COMPARE is not among them."""
    import numpy as np
    import torch

    from lodestar_tpu_torch.ops import fp, fp_cuda

    rng = np.random.default_rng(20261017)
    report = {}
    for name in fp_cuda.KERNELS:
        kernel = getattr(fp_cuda, name)
        plain = getattr(fp, f"plain_{name}")
        max_err = 0
        at_rows = {}
        for n in rows:
            args = kernel_inputs(name, n, rng, dev)
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
            max_err = max(max_err, err)
            if got.shape != want.shape or not torch.equal(got, want):
                fail(f"{name} differs from its plain version at N={n} (max |err| {err})")
            if n in N_TIMED:
                ms = graph_ms(lambda: kernel(*args))
                b_ms, by = bound(name, n)
                at_rows[n] = {"ms": ms, "bound_ms": b_ms, "bound_by": by}
                say(f"kernel {name} N={n}: {ms * 1e3:.2f} us device (graph replay), "
                    f"bound {b_ms * 1e3:.2f} us by {by}, {ms / b_ms:.2f}x the bound")
            if n == N_COMPARE:
                plain_ms = cuda_ms(lambda: plain(*args), iters=5, warmup=1)
        if N_COMPARE not in rows:
            say(f"kernel {name}: bit-exact at N={list(rows)}")
            continue
        b_ms, by = bound(name, N_COMPARE)
        report[name] = {
            "max_abs_err": max_err,
            "ms": at_rows[N_COMPARE]["ms"],
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": by,
            "n": N_COMPARE,
            "at_rows": at_rows,
        }
        say(f"kernel {name}: bit-exact at N={list(rows)}; at N={N_COMPARE}: "
            f"{report[name]['ms']:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {by})")
    if N_COMPARE not in rows:
        return report
    paths = {}
    for n in N_KERNEL_CHECK:
        paths.setdefault(sq_acc_path(n), []).append(n)
    say(f"kernel sq_acc: bit-exact on each path at N = {json.dumps(paths)}")
    for n in N_TIMED:
        sq, mul = report["sq_acc"]["at_rows"][n], report["mul_acc"]["at_rows"][n]
        say(f"kernel sq_acc N={n}: {sq['ms'] * 1e3:.2f} us against mul_acc's "
            f"{mul['ms'] * 1e3:.2f} us in this call (bound {sq['bound_ms'] * 1e3:.2f} us)")
    return report


def sq_acc_path(n):
    """The path `lodestar_fp_sq_acc` takes for n rows (fp_kernels.cu): one
    row; one tile of 16 rows at eight shares a row; the tile loop at eight
    shares up to 16 rows per SM, else at four."""
    import torch

    if n == 1:
        return "one row"
    if n <= 16 * torch.cuda.get_device_properties(0).multi_processor_count:
        return "one tile, 8 shares" if n <= 16 else "tile loop, 8 shares"
    return "tile loop, 4 shares"


# --- phase 4 -----------------------------------------------------------------


def rows_since(before):
    """{kernel: {rows: launches}} of the launches since the snapshot `before`
    of fp_cuda.ROWS."""
    from lodestar_tpu_torch.ops import fp_cuda

    return {k: {n: c - before[k].get(n, 0) for n, c in sorted(fp_cuda.ROWS[k].items())
                if c > before[k].get(n, 0)}
            for k in fp_cuda.KERNELS}


def rows_snapshot():
    from lodestar_tpu_torch.ops import fp_cuda

    return {k: dict(v) for k, v in fp_cuda.ROWS.items()}


def invalid_batch(sets):
    """The first 8 sets with pubkey 2 replaced by a well-formed encoding of
    an x off the curve, and signature 5 by a point on the twist but off the
    G2 subgroup: both pass the host's structural checks, so only prep's
    device ok bits can reject the batch. Points from a fixed seed."""
    import dataclasses

    import numpy as np

    from lodestar_tpu_torch.crypto.bls import curve as C
    from lodestar_tpu_torch.crypto.bls import fields as F
    from lodestar_tpu_torch.crypto.bls import serdes

    rng = np.random.default_rng(4)

    def rand_fp():
        while True:
            v = int.from_bytes(rng.bytes(48), "big")
            if v < F.P:
                return v

    while True:
        x = rand_fp()
        if F.fp_sqrt((x * x * x + 4) % F.P) is None:
            break
    pk = bytearray(x.to_bytes(48, "big"))
    pk[0] |= 0x80
    while True:
        x2 = (rand_fp(), rand_fp())
        y2 = F.fp2_sqrt(C.g2_rhs(x2))
        if y2 is not None and not C.g2_in_subgroup((x2, y2)):
            break
    bad = list(sets[:8])
    bad[2] = dataclasses.replace(bad[2], pubkey=bytes(pk))
    bad[5] = dataclasses.replace(bad[5], signature=serdes.g2_to_bytes((x2, y2)))
    return bad


def main_path(dev, smi):
    import dataclasses

    import numpy as np
    import torch

    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import fp, fp_cuda

    t0 = time.perf_counter()
    sets = bv.make_synthetic_sets(BATCH, seed=17)
    say(f"host: made {BATCH} synthetic signature sets in {time.perf_counter() - t0:.1f} s")
    tampered = list(sets)
    tampered[0] = dataclasses.replace(sets[0], signature=sets[1].signature)
    tampered[1] = dataclasses.replace(sets[1], signature=sets[0].signature)
    bad = invalid_batch(sets)
    bad_full = list(sets)  # the same two invalid points in a batch of BATCH sets
    bad_full[2], bad_full[5] = bad[2], bad[5]
    merged = BATCH * MERGE_JOBS
    merged_sets = sets * MERGE_JOBS  # bench.py's merge: 16 copies of the job's bytes

    if not bv.single_launch_active(device=dev):
        fail("single launch is not the default on the card")
    bv.configure_single_launch("off")  # this phase drives the split schedule
    fp_cuda.reset_launches()  # the main path's run starts here
    if not bv.device_prep_active(device=dev):
        fail("device prep is not the default on the card")
    t0 = time.perf_counter()
    if bv.verify_signature_sets_device(sets) is not True:
        fail(f"the valid {BATCH}-set batch did not verify")
    say(f"main: {BATCH}-set batch verifies True ({time.perf_counter() - t0:.2f} s, device prep "
        "included)")
    t0 = time.perf_counter()
    if bv.verify_signature_sets_device(tampered) is not False:
        fail("the batch with two swapped signatures verified")
    say(f"main: swapped-signature batch verifies False ({time.perf_counter() - t0:.2f} s)")
    parsed = bv._parse_host_arrays(bad, 8)
    if parsed is None or not (parsed[2].all() and parsed[5].all()):
        fail("the invalid-point batch should pass the host's structural checks")
    t0 = time.perf_counter()
    if bv.build_device_inputs(bad) is not None or bv.verify_signature_sets_device(bad):
        fail("the batch with a pubkey off the curve and a signature off G2 was not rejected")
    say(f"main: off-curve pubkey + off-subgroup signature batch rejected by prep's device ok "
        f"bits, verifies False ({time.perf_counter() - t0:.2f} s)")

    # the merged 2048 sets, compressed bytes in: device prep
    if bv.build_device_inputs(merged_sets, size=merged) is None:
        fail("warm-up device prep rejected the merged sets")
    prep_times, per_prep_rows, inputs = [], None, None
    for i in range(TIMED_RUNS):
        before = rows_snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inputs = bv.build_device_inputs(merged_sets, size=merged)
        torch.cuda.synchronize()
        prep_times.append(time.perf_counter() - t0)
        if inputs is None:
            fail(f"timed device prep {i} rejected the merged sets")
        if per_prep_rows is None:
            per_prep_rows = rows_since(before)
    prep_mean = sum(prep_times) / len(prep_times)
    say(f"main: device prep of {merged} sets x{TIMED_RUNS}: "
        f"{', '.join(f'{t:.3f}' for t in prep_times)} s on {smi}")
    unchecked = sorted({n for rows in per_prep_rows.values() for n in rows} - set(N_KERNEL_CHECK))
    if unchecked:
        fail(f"prep launched kernels at row counts phase 3 did not check: {unchecked}")
    pk_m, h_m, sig_m, _, mask_m = inputs

    # the 128 unique sets' device-prepped arrays against the oracle's prep
    t0 = time.perf_counter()
    oracle = bv.prepare_sets_oracle(bv._set_bytes(sets))
    oracle_s = time.perf_counter() - t0
    if oracle is None:
        fail("the oracle prep rejected the synthetic sets")
    for name, dev_pt, host_pt in zip(("pk", "h", "sig"), (pk_m, h_m, sig_m), oracle):
        for c, (d, h) in enumerate(zip(dev_pt, host_pt)):
            got = fp.from_mont(d[:BATCH])
            want = fp.from_mont(torch.as_tensor(h, device=dev))
            if not torch.equal(got, want):
                fail(f"device prep's {name}[{c}] differs from the oracle's on canonical values")
            if not all(torch.equal(d[:BATCH], d[k * BATCH:(k + 1) * BATCH])
                       for k in range(1, MERGE_JOBS)):
                fail(f"device prep's {name}[{c}] differs between copies of the same sets")
    say(f"main: device-prepped pk/h/sig of the {BATCH} unique sets == the oracle's prep on "
        f"canonical values; oracle prep {oracle_s:.2f} s per {BATCH} sets (outside the timed "
        "windows)")

    def fresh_bits():
        bits, _ = bv._blinding_and_mask(merged, merged)
        return torch.as_tensor(bits, device=dev)

    if not bool(bv.device_batch_verify(pk_m, h_m, sig_m, fresh_bits(), mask_m)):
        fail("warm-up merged batch did not verify")
    times, per_verify_rows = [], None
    for i in range(TIMED_RUNS):
        bits = fresh_bits()
        before = rows_snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = bool(bv.device_batch_verify(pk_m, h_m, sig_m, bits, mask_m))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not ok:
            fail(f"timed merged batch {i} did not verify")
        if per_verify_rows is None:
            per_verify_rows = rows_since(before)
    launches = dict(fp_cuda.LAUNCHES)  # the main path's run ends here
    per_verify = {k: sum(rows.values()) for k, rows in per_verify_rows.items()}
    per_prep = {k: sum(rows.values()) for k, rows in per_prep_rows.items()}
    mean = sum(times) / len(times)
    say(f"main: {merged}-set merged batch x{TIMED_RUNS}: "
        f"{', '.join(f'{t:.3f}' for t in times)} s; {merged / mean:.1f} sigs/s on {smi}")
    say(f"main: bytes to verdict {merged / (prep_mean + mean):.1f} sigs/s (device prep "
        f"{prep_mean:.3f} s + verify {mean:.3f} s per {merged} sets) against verify-only "
        f"{merged / mean:.1f} sigs/s; oracle prep {oracle_s:.2f} s per {BATCH} sets")
    say(f"main: launches over the main path {launches}")
    say(f"main: launches per {merged}-set verify {per_verify}")
    say(f"main: launches per {merged}-set prep {per_prep}")
    missing = [k for k in fp_cuda.KERNELS if launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    missing = [k for k in fp_cuda.KERNELS if per_prep[k] <= 0]
    if missing:
        fail(f"kernels never launched by the {merged}-set prep: {missing}")
    native = native_prep(dev, smi, merged_sets, (pk_m, h_m, sig_m), oracle, tampered, bad)
    return {
        "launches": launches,
        "per_verify_rows": per_verify_rows,
        "per_prep_rows": per_prep_rows,
        "sigs_per_s": merged / mean,
        "bytes_to_verdict_sigs_per_s": merged / (prep_mean + mean),
        "prep_s": prep_mean,
        "oracle_s_per_128": oracle_s,
        "merged_inputs": (pk_m, h_m, sig_m, mask_m, fresh_bits),
        "merged_sets": merged_sets,
        "batches": {"valid": sets, "swapped": tampered, "invalid": bad_full},
        "native": native,
    }


def native_prep(dev, smi, merged_sets, device_prepped, oracle, tampered, bad):
    """The host road (`prep="off"`): the merged sets prepared by the native
    C++ library through `prepare_sets` (TIMED_RUNS timed; the library was
    built and loaded in phase 2, so no warm-up), its pk/h/sig limbs equal
    to device prep's on canonical values for all the rows and to the
    oracle's limb for limb on the BATCH unique sets; one split-schedule
    verify of the native inputs, copied to the card as
    `build_device_inputs(prep="off")` copies them (True, every kernel
    launched), the swapped batch through the host road (False) and the
    invalid-point batch rejected by the native prep itself."""
    import torch

    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.native import bls as native_bls
    from lodestar_tpu_torch.ops import fp, fp_cuda

    if not native_bls.available():
        fail("the native BLS library is unavailable")
    merged = len(merged_sets)
    times, prepared = [], None
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        prepared = bv.prepare_sets(merged_sets)
        times.append(time.perf_counter() - t0)
        if prepared is None:
            fail("the native prep rejected the merged sets")
    prep_s = sum(times) / len(times)
    for name, dev_pt, host_pt, ref_pt in zip(("pk", "h", "sig"), device_prepped, prepared, oracle):
        for c, (d, h, ref) in enumerate(zip(dev_pt, host_pt, ref_pt)):
            if not (h[:BATCH] == ref).all():
                fail(f"native prep's {name}[{c}] differs from the oracle's limb for limb")
            if not torch.equal(fp.from_mont(torch.as_tensor(h, device=dev)), fp.from_mont(d)):
                fail(f"native prep's {name}[{c}] differs from device prep's on canonical values")
    say(f"main: native prep (host road, prep=\"off\") of {merged} sets x{TIMED_RUNS}: "
        f"{', '.join(f'{t:.3f}' for t in times)} s, {merged / prep_s:.1f} sets/s; pk/h/sig == "
        f"device prep's on canonical values, == the oracle's limb for limb on {BATCH} sets")
    if bv.prepare_sets(bad) is not None:
        fail("the native prep accepted the off-curve pubkey and off-subgroup signature")
    before = dict(fp_cuda.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bits, mask = bv._blinding_and_mask(merged, merged)
    inputs = bv.inputs_from_numpy(*prepared, bits, mask, dev)
    if not bool(bv.device_batch_verify(*inputs)):
        fail("the split-schedule verify of the natively prepared sets is not True")
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    launched = {k: fp_cuda.LAUNCHES[k] - before[k] for k in fp_cuda.KERNELS}
    missing = [k for k in fp_cuda.KERNELS if launched[k] <= 0]
    if missing:
        fail(f"the verify of natively prepared sets never launched {missing}")
    if bv.verify_signature_sets_device(tampered, device=dev, prep="off") is not False:
        fail("the swapped batch verified through the host road")
    say(f"main: natively prepared {merged} sets verify True in {verify_s:.3f} s (copy + split "
        f"verify), launches {launched}; the swapped batch False, the invalid-point batch "
        f"rejected by the native prep; on {smi}")
    return {"prep_s": prep_s, "sets_per_s": merged / prep_s, "times_s": times,
            "copy_and_verify_s": verify_s,
            "bytes_to_verdict_sigs_per_s": merged / (prep_s + verify_s), "launches": launched}


# --- phase 5 -----------------------------------------------------------------


def verify_by_stage(pk, h, sig, bits, mask):
    """`device_batch_verify` split at its stage boundaries: the verdict and
    {stage: (wall s, kernel launches)}, host clock after a synchronize."""
    import torch

    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import fp_cuda
    from lodestar_tpu_torch.ops import pairing as prg

    stages = {}

    def timed(name, fn, *args):
        before = sum(fp_cuda.LAUNCHES.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0, sum(fp_cuda.LAUNCHES.values()) - before)
        return res

    rpk_aff, s_aff, s_inf = timed("blind+aggregate", bv._blind_and_aggregate_body,
                                  pk[0], pk[1], sig[0], sig[1], bits, mask)
    p_x, p_y, q_x, q_y, pair_mask = bv._assemble_pairs(rpk_aff, s_aff, s_inf, h[0], h[1], mask)
    fs = timed("miller_loop", prg.miller_loop, (p_x, p_y), (q_x, q_y))
    ok = timed("fold+final_exp", bv._fold_verdict_body, fs, pair_mask)
    return bool(ok), stages


class TraceEvent:
    """One event of a profiler trace: its name, whether it ran on the card,
    and its start and end in microseconds from the trace's start."""

    __slots__ = ("name", "cuda", "start", "end")


def trace_events(prof):
    """The events of a finished `torch.profiler.profile`, read straight from
    Kineto's results. Building the profiler's own event tree
    (`prof.events()`) took ~100 s for the ~1.2 M events of a 2048-set split
    verify on the H100 machine's host (a probe of phase 5, PR 8)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    results = prof.profiler.kineto_results
    origin = results.trace_start_ns()
    events = []
    for k in results.events():
        e = TraceEvent()
        e.name, e.cuda = k.name(), k.device_type() == cuda
        e.start = (k.start_ns() - origin) / 1e3
        e.end = e.start + k.duration_ns() / 1e3
        events.append(e)
    return events


def device_events(events):
    """The trace's device work: its CUDA events."""
    return [e for e in events if e.cuda]


def busy_ms(events, lo=float("-inf"), hi=float("inf")):
    """Union of the device work intervals of a profiler trace, clipped to
    the window [lo, hi] (profiler microseconds), in ms."""
    spans = sorted((max(e.start, lo), min(e.end, hi)) for e in device_events(events)
                   if e.end > lo and e.start < hi)
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3  # profiler times are in microseconds


def graph_times(runs, dev):
    """{name: {rows: ms}}: graph-replay device time of each kernel at every
    row count the runs ({name: {rows: launches}} each) launch it at."""
    import numpy as np

    from lodestar_tpu_torch.ops import fp_cuda

    rng = np.random.default_rng(7)
    out = {}
    for name in fp_cuda.KERNELS:
        kernel = getattr(fp_cuda, name)
        out[name] = {}
        for n in sorted({n for run in runs for n in run.get(name, {})}):
            args = kernel_inputs(name, n, rng, dev)
            out[name][n] = graph_ms(lambda: kernel(*args), iters=20, replays=3)
    return out


def kernel_ms(per_rows, times):
    """{name: ms}: launches x graph-replay device time, summed over the row
    counts of one run ({name: {rows: launches}})."""
    return {name: sum(c * times[name][n] for n, c in by_rows.items())
            for name, by_rows in per_rows.items()}


def prep_by_stage(merged_sets, dev):
    """One device prep of the merged sets split at its stages: the host byte
    stage (with the copy to the card), then the three device stages of
    `prepare_arrays_fused`. Returns the all-valid verdict and {stage: (wall
    s, {kernel: {rows: launches}})}, host clock after a synchronize."""
    import torch

    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import prep as dp

    stages = {}

    def timed(name, fn, *args):
        before = rows_snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0, rows_since(before))
        return res

    def host_bytes():
        parsed = bv._parse_host_arrays(merged_sets, len(merged_sets))
        pk, pk_sign, _, sig, sig_sign, _, lo, hi = (torch.as_tensor(a, device=dev) for a in parsed)
        return pk, pk_sign, sig, sig_sign, lo, hi

    args = timed("host bytes", host_bytes)
    pk_x, pk_y, pk_curve, sig_x, sig_y, sig_curve, q0, q1 = timed(
        "field", dp._prep_field_stage, *args)
    pk_ok, sig_ok = timed("subgroup", dp._prep_subgroup_stage,
                          pk_x, pk_y, pk_curve, sig_x, sig_y, sig_curve)
    timed("hash finish", dp.hash_finish, q0, q1)
    return bool(pk_ok.all() and sig_ok.all()), stages


def profiled(run):
    """run() under `torch.profiler`: (its result, wall ms with the profiler
    on, the trace's events)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return res, wall_ms, trace_events(prof)


def profile_main(main, smi):
    """Phase 5: one merged verify and one 2048-set prep, each by stage.
    Returns ({kernel: ms}, {kernel: None}: the profiler's ms, not measured)
    per verify and per prep."""
    from lodestar_tpu_torch.models import batch_verify as bv

    pk, h, sig, mask, fresh_bits = main["merged_inputs"]
    merged = mask.numel()
    runs = {"verify": main["per_verify_rows"], "prep": main["per_prep_rows"]}
    times = graph_times(runs.values(), mask.device)
    out = {}
    for label, per_rows in runs.items():
        for name, by_rows in per_rows.items():
            say(f"profile: {name} launches per {merged}-set {label} by row count "
                f"{{rows: launches}}: {json.dumps(by_rows)}")
        out[label] = kernel_ms(per_rows, times)

    ok, stages = verify_by_stage(pk, h, sig, fresh_bits(), mask)
    if not ok:
        fail("the stage-split merged batch did not verify")
    wall = sum(t for t, _ in stages.values())
    say(f"profile: stage-split {merged}-set verify {wall:.3f} s on {smi}")
    for name, (t, n) in stages.items():
        say(f"profile: verify stage {name}: {t:.3f} s ({100 * t / wall:.1f}%), {n} kernel launches")
    ok, stages = prep_by_stage(main["merged_sets"], mask.device)
    if not ok:
        fail("the stage-split prep rejected the merged sets")
    wall = sum(t for t, _ in stages.values())
    say(f"profile: stage-split {merged}-set prep {wall:.3f} s on {smi}")
    for name, (t, by_kernel) in stages.items():
        n = sum(c for rows in by_kernel.values() for c in rows.values())
        say(f"profile: prep stage {name}: {t:.3f} s ({100 * t / wall:.1f}%), {n} kernel launches, "
            f"{sum(kernel_ms(by_kernel, times).values()):.2f} kernel ms (graph replay x "
            f"launches) {json.dumps({k: v for k, v in by_kernel.items() if v})}")
    # the split schedule is not profiled: a profiled verify and prep cost
    # ~1 min of the script's time limit on a slow host (PERF.md has their
    # busy ms and profiler ms per kernel)
    return out, {label: dict.fromkeys(per_rows) for label, per_rows in runs.items()}


def single_launch(dev, smi, main):
    """Phase 6: the single-launch path, the default on the card: compressed
    bytes in, one counted dispatch, one CUDA-graph replay per batch.
    Returns its figures and counts."""
    import torch

    from lodestar_tpu_torch import graphs
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import fp_cuda
    from lodestar_tpu_torch.ops import prep as dp

    bv.configure_single_launch("auto")
    if not bv.single_launch_active(device=dev):
        fail("single launch is not the default on the card")
    cache = bv._SINGLE_LAUNCH_GRAPHS
    merged_sets = main["merged_sets"]
    merged = len(merged_sets)

    def verify(label, batch, want):
        """One entry-point batch on the card: its verdict, one dispatch."""
        base = dp.prep_launches_total()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = bv.verify_signature_sets_device(batch)
        t = time.perf_counter() - t0
        if got is not want:
            fail(f"single launch: the {label} batch verified {got}, not {want}")
        if dp.prep_launches_total() - base != dp.SINGLE_LAUNCH_BUDGET:
            fail(f"single launch: the {label} batch made {dp.prep_launches_total() - base} "
                 f"dispatches, not {dp.SINGLE_LAUNCH_BUDGET}")
        return t

    fp_cuda.reset_launches()
    graphs.reset_replayed()  # the single-launch path's run starts here
    order = (("valid", True), ("swapped", False), ("invalid", False), ("valid", True))
    for i, (label, want) in enumerate(order):
        t = verify(label, main["batches"][label], want)
        say(f"single: {BATCH}-set {label} batch verifies {want} in one dispatch ({t:.2f} s"
            f"{', warm-up and capture included' if i == 0 else ''})")
    g_small = cache.graphs.get((dev.index, BATCH))
    if g_small is None or g_small.replays != len(order):
        fail(f"single launch: the {BATCH}-set batches did not replay one captured graph")
    si = bv.prepare_single_launch_inputs(main["batches"]["invalid"])
    verdict, batch_valid = cache(dev, *si.arrays, si.bits, si.mask)
    if bool(verdict) or bool(batch_valid):
        fail("single launch: the invalid-point batch's batch_valid is not False")
    say(f"single: the invalid-point batch's replay gives batch_valid False (prep's ok bits "
        f"folded on the device); {BATCH}-set graph: {g_small.nodes} nodes, capture "
        f"{g_small.capture_s:.2f} s, instantiate {g_small.instantiate_s:.2f} s")

    t0 = time.perf_counter()
    if bv.verify_sets_single_launch(merged_sets) is not True:
        fail(f"single launch: the {merged}-set merged batch did not verify (warm-up)")
    first_s = time.perf_counter() - t0
    g = cache.graphs[(dev.index, merged)]
    say(f"single: {merged}-set graph: first batch {first_s:.2f} s (eager warm-up, capture "
        f"{g.capture_s:.2f} s, instantiate {g.instantiate_s:.2f} s, one replay); {g.nodes} "
        f"nodes; pool {g.pool_bytes / 2**20:.1f} MiB reserved; Fp launches per replay "
        f"{g.launches} on {smi}")
    times = []
    for i in range(TIMED_RUNS):
        base = dp.prep_launches_total()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = bv.verify_sets_single_launch(merged_sets)  # fresh bits each time
        times.append(time.perf_counter() - t0)
        if ok is not True or dp.prep_launches_total() - base != dp.SINGLE_LAUNCH_BUDGET:
            fail(f"single launch: timed merged batch {i} gave {ok} in "
                 f"{dp.prep_launches_total() - base} dispatches")
    replayed = dict(graphs.REPLAYED)  # the single-launch path's run ends here
    missing = [k for k in fp_cuda.KERNELS if replayed[k] <= 0]
    if missing:
        fail(f"kernels never launched by a single-launch replay: {missing}")
    if g.replays != 1 + TIMED_RUNS:
        fail(f"single launch: {g.replays} replays of the {merged}-set graph, not {1 + TIMED_RUNS}")
    mean = sum(times) / len(times)
    split_s = main["prep_s"] + merged / main["sigs_per_s"]
    say(f"single: {merged}-set merged batch x{TIMED_RUNS}, bytes to verdict: "
        f"{', '.join(f'{t:.3f}' for t in times)} s; {merged / mean:.1f} sigs/s against the split "
        f"schedule's {split_s:.3f} s, {merged / split_s:.1f} sigs/s in this call, on {smi}")
    say(f"single: Fp launches replayed over the path {replayed}")

    # the parts of one batch: the host byte stage, then copy in + replay + read
    host, replay = [], []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        si = bv.prepare_single_launch_inputs(merged_sets)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verdict, batch_valid = cache(dev, *si.arrays, si.bits, si.mask)
        replay.append(time.perf_counter() - t0)
        if not (bool(verdict) and bool(batch_valid)):
            fail("single launch: a replay of the merged batch did not verify")
    host_s, replay_s = sum(host) / len(host), sum(replay) / len(replay)
    say(f"single: host byte stage x{TIMED_RUNS}: {', '.join(f'{t:.3f}' for t in host)} s; "
        f"copy in + replay + verdict read x{TIMED_RUNS}: {', '.join(f'{t:.3f}' for t in replay)} "
        f"s on {smi}")
    device_ms = replay_ms(cache.graphs[(dev.index, merged)])
    share = device_ms / (replay_s * 1e3)
    say(f"single: the replay's device time {device_ms:.1f} ms (CUDA events around the graph's "
        f"replay, its static inputs as the last call left them, the gaps between its kernel "
        f"nodes included), {100 * share:.1f}% of the copy in + replay + verdict read "
        f"{replay_s * 1e3:.1f} ms on {smi}; the card's idle share: not measured")

    # replay == the eager body == the split schedule, on the same inputs and bits
    si = bv.prepare_single_launch_inputs(merged_sets)
    replayed_out = tuple(bool(t) for t in cache(dev, *si.arrays, si.bits, si.mask))
    eager = tuple(bool(t) for t in bv._single_launch_verify(
        *(torch.as_tensor(a, device=dev) for a in (*si.arrays, si.bits, si.mask))))
    inputs = bv.build_device_inputs(merged_sets, size=merged, coeff_bits=si.bits, prep="on")
    split = inputs is not None and bool(bv.device_batch_verify(*inputs))
    if not replayed_out == eager == (True, True) or split is not True:
        fail(f"single launch: replay {replayed_out}, eager body {eager} and split schedule "
             f"{split} disagree on the merged batch")
    say(f"single: {merged}-set replay == eager body == split schedule on the same inputs and "
        "bits: (verdict, batch_valid) = (True, True)")
    return {
        "graph": g,
        "replayed": replayed,
        "bytes_to_verdict_s": mean,
        "sigs_per_s": merged / mean,
        "host_s": host_s,
        "replay_s": replay_s,
        "replay_device_ms": device_ms,
        "replay_share": share,
    }


def verify_many(dev, smi, main):
    """`device_batch_verify_many` on the merged batch as 16 jobs of 128 sets
    (bench.py's shape), eagerly: every job True, then one job tampered.
    Fails on a kernel row count phase 3 did not check."""
    import numpy as np
    import torch

    from lodestar_tpu_torch.models import batch_verify as bv

    pk, h, sig, mask, _ = main["merged_inputs"]

    def jobs(pt):
        return tuple(c.reshape(MERGE_JOBS, BATCH, *c.shape[1:]) for c in pt)

    def bits():
        return torch.as_tensor(np.stack([bv._blinding_and_mask(BATCH, BATCH)[0]
                                         for _ in range(MERGE_JOBS)]), device=dev)

    job_mask = mask.reshape(MERGE_JOBS, BATCH)
    before = rows_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = bv.device_batch_verify_many(jobs(pk), jobs(h), jobs(sig), bits(), job_mask).tolist()
    t = time.perf_counter() - t0
    rows = rows_since(before)
    if got != [True] * MERGE_JOBS:
        fail(f"device_batch_verify_many: valid jobs gave {got}")
    bad = tuple(c.clone() for c in jobs(sig))
    for c in bad:
        c[-1, [0, 1]] = c[-1, [1, 0]]  # the last job: two swapped signatures
    got = bv.device_batch_verify_many(jobs(pk), jobs(h), bad, bits(), job_mask).tolist()
    if got != [True] * (MERGE_JOBS - 1) + [False]:
        fail(f"device_batch_verify_many: with the last job tampered gave {got}")
    unchecked = sorted({n for r in rows.values() for n in r} - set(N_KERNEL_CHECK))
    if unchecked:
        fail(f"device_batch_verify_many launched kernels at row counts phase 3 did not check: "
             f"{unchecked}")
    say(f"many: {MERGE_JOBS} jobs x {BATCH} sets in one call, eagerly: {t:.3f} s, every job "
        f"True; the last job tampered: only it False; {sum(sum(r.values()) for r in rows.values())} "
        f"Fp launches, every row count checked in phase 3, on {smi}")
    return t


# --- phase 7 -----------------------------------------------------------------


def scrape_metrics(target, port=0):
    """GET /metrics from a `metrics.MetricsServer` over `target` (anything
    with `scrape()`) on 127.0.0.1, or from the server already listening on
    `port` when `target` is None. Returns ({(name, labels): value} of every
    sample but the `_created` ones, the body's bytes, the GET's ms)."""
    import urllib.request

    from prometheus_client.parser import text_string_to_metric_families

    from lodestar_tpu_torch.metrics import MetricsServer

    server = None
    if target is not None:
        server = MetricsServer(target, port=0, host="127.0.0.1")
        server.start()
        port = server.port
    try:
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
            body = resp.read()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        if server is not None:
            server.stop()
    out = {}
    for fam in text_string_to_metric_families(body.decode()):
        for smp in fam.samples:
            if not smp.name.endswith("_created"):
                out[(smp.name, tuple(sorted(smp.labels.items())))] = smp.value
    return out, len(body), ms


def sample_sum(samples, name, **labels):
    """Sum of the samples named `name` whose labels include `labels`."""
    return sum(v for (n, lab), v in samples.items()
               if n == name and all(dict(lab).get(k) == str(x) for k, x in labels.items()))


def serve(dev, smi, main):
    """Phase 7: serving through the port's verifier pool. Every size class a
    package of the pool can reach (`POOL_SIZE_CLASSES`) is captured by
    `warm_single_launch` first; then a pool built as a node builds it
    (`mesh_mode="auto"`: one lane on one GPU) serves API, range-sync and
    gossip traffic, a tampered job and two malformed sets, with no capture
    while it serves; `create_metrics()`'s families are attached to that
    pool, its scheduler, prep, the launch telemetry and the SLO accountant
    before it serves, and scraped after (`check_serve_scrape`). Returns its
    figures and counts."""
    import asyncio
    import dataclasses

    import torch

    from lodestar_tpu_torch import graphs, slo, telemetry
    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool, VerifySignatureOpts
    from lodestar_tpu_torch.chain.bls.pool import POOL_SIZE_CLASSES
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import fp_cuda
    from lodestar_tpu_torch.scheduler import PriorityClass

    cache = bv._SINGLE_LAUNCH_GRAPHS
    merged_sets = main["merged_sets"]
    t0 = time.perf_counter()
    warmed = bv.warm_single_launch(POOL_SIZE_CLASSES, device=dev)
    warm_s = time.perf_counter() - t0
    say(f"serve: warm_single_launch captured classes {sorted(warmed)} in {warm_s:.1f} s "
        f"(classes already captured: "
        f"{sorted(set(POOL_SIZE_CLASSES) - set(warmed))}) on {smi}")
    per_class = {}
    for size in POOL_SIZE_CLASSES:
        g = cache.graphs.get((dev.index, size))
        if g is None:
            fail(f"serve: class {size} has no graph after the warm-up")
        unchecked = sorted({n for r in g.rows.values() for n in r} - set(N_KERNEL_CHECK))
        if unchecked:
            fail(f"serve: the class-{size} graph launches kernels at row counts phase 3 did "
                 f"not check: {unchecked}")
        si = bv.prepare_single_launch_inputs(merged_sets[:size])
        times = []
        for _ in range(SERVE_CLASS_REPLAYS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            verdict, batch_valid = cache(dev, *si.arrays, si.bits, si.mask)
            times.append(time.perf_counter() - t0)
            if not (bool(verdict) and bool(batch_valid)):
                fail(f"serve: a class-{size} replay of {size} valid sets did not verify")
        per_class[size] = {**{k: v for k, v in g.info().items() if k != "rows"},
                           "replay_s": sum(times) / len(times), "launches": g.launches,
                           "warmed_here": size in warmed}
        say(f"serve: class {size}: capture {g.capture_s:.2f} s, instantiate "
            f"{g.instantiate_s:.2f} s, {g.nodes} nodes, pool {g.pool_bytes / 2**20:.1f} MiB, Fp "
            f"launches per replay {sum(g.launches.values())} {g.launches}; copy in + replay + "
            f"verdict read x{SERVE_CLASS_REPLAYS}: {', '.join(f'{t:.3f}' for t in times)} s (mean "
            f"{per_class[size]['replay_s']:.3f} s, {size / per_class[size]['replay_s']:.1f} "
            f"sigs/s) on {smi}")

    sets = main["batches"]["valid"]
    jobs16 = [merged_sets[i * BATCH:(i + 1) * BATCH] for i in range(MERGE_JOBS)]
    tampered = [sets, main["batches"]["swapped"], sets, sets]
    wrong_length = [dataclasses.replace(sets[0], signature=sets[0].signature[:95])]
    unreadable = [dataclasses.replace(sets[0], pubkey=None)]

    def replays():
        return {size: g.replays for (idx, size), g in cache.graphs.items() if idx == dev.index}

    async def traffic(pool, jobs, priority, batchable=True):
        opts = VerifySignatureOpts(batchable=batchable, priority=priority)
        return list(await asyncio.gather(*(pool.verify_signature_sets(j, opts) for j in jobs)))

    runs = {}
    verdicts = {}  # priority label -> the jobs' verdicts, for the scrape's SLO counts

    async def serve_all():
        pool = BlsDeviceVerifierPool(mesh_mode="auto", sched_metrics=metrics.sched,
                                     pipeline_metrics=metrics.bls_pipeline)
        if len(pool.mesh) != torch.cuda.device_count():
            fail(f"serve: the auto mesh has {len(pool.mesh)} lanes on "
                 f"{torch.cuda.device_count()} devices")
        lane = pool.mesh.lanes[0]
        plan = (
            ("api_16x128", jobs16, PriorityClass.API, True, [True] * MERGE_JOBS, {512: 4}),
            ("rangesync_16x128", jobs16, PriorityClass.RANGE_SYNC, True, [True] * MERGE_JOBS,
             {128: MERGE_JOBS}),
            (f"gossip_{SERVE_GOSSIP_JOBS}x1", [[s] for s in merged_sets[:SERVE_GOSSIP_JOBS]],
             PriorityClass.GOSSIP_ATTESTATION, True, [True] * SERVE_GOSSIP_JOBS, None),
            ("tampered", tampered, PriorityClass.API, True, [True, False, True, True],
             {512: 1, 128: 4}),
            ("wrong_length", [wrong_length], PriorityClass.API, False, [False], {}),
            ("unreadable", [unreadable], PriorityClass.API, False, [False], {}),
        )
        for name, jobs, priority, batchable, want, want_replays in plan:
            before, launches = replays(), lane.launches
            n_sets = sum(len(j) for j in jobs)
            t0 = time.perf_counter()
            got = await traffic(pool, jobs, priority, batchable)
            wall = time.perf_counter() - t0
            after = replays()
            by_class = {k: after[k] - before.get(k, 0) for k in sorted(after)
                        if after[k] != before.get(k, 0)}
            run = {"wall_s": wall, "sets": n_sets, "sigs_per_s": n_sets / wall,
                   "launches": lane.launches - launches, "replays_by_class": by_class}
            runs[name] = run
            say(f"serve: {name}: {len(jobs)} jobs, {n_sets} sets in {wall:.3f} s "
                f"({run['sigs_per_s']:.1f} sigs/s), {run['launches']} launches, replays by "
                f"class {by_class} on {smi}")
            verdicts.setdefault(priority.label, []).extend(got)
            if got != want:
                fail(f"serve: {name} gave {got}, not {want}")
            if want_replays is not None and by_class != want_replays:
                fail(f"serve: {name} replayed {by_class}, not {want_replays}")
            if want_replays is None and (set(by_class) - {8, 16} or
                                         sum(by_class.values()) != run["launches"]):
                fail(f"serve: {name} replayed {by_class} in {run['launches']} launches")
        if lane.breaker.state().name != "CLOSED" or lane.breaker._failures:
            fail(f"serve: the lane's breaker shows a failure ({lane.breaker.state().name})")
        runs["pool_counts"] = dict(pool.metrics)
        runs["lane"] = {"label": lane.label, "launches": lane.launches}
        scraped.update(check_serve_scrape(smi, metrics, runs, verdicts, served_replays(),
                                          pool))
        await pool.close()

        # the api run again through the pipelined pool: the same verdicts
        pool = BlsDeviceVerifierPool(mesh_mode="auto", pipeline="on")
        t0 = time.perf_counter()
        got = await traffic(pool, jobs16, PriorityClass.API)
        wall = time.perf_counter() - t0
        stats = pool.pipeline_stats()
        await pool.close()
        if got != [True] * MERGE_JOBS or not stats["pipeline_enabled"]:
            fail(f"serve: the pipelined api run gave {got} ({stats})")
        runs["api_16x128_pipelined"] = {"wall_s": wall, "sigs_per_s": BATCH * MERGE_JOBS / wall,
                                        "pipeline_stats": stats}
        say(f"serve: api_16x128 pipelined: {wall:.3f} s ({BATCH * MERGE_JOBS / wall:.1f} "
            f"sigs/s), pipeline_stats {stats} on {smi}")

    from lodestar_tpu_torch.metrics import create_metrics

    metrics = create_metrics()
    bv.configure_device_prep(metrics=metrics.bls_prep)
    telemetry.reset_launch_telemetry()
    telemetry.configure_launch_telemetry(metrics=metrics.device_launch)
    # the slack floor far below any slack: sli_good then counts the True verdicts
    slo.configure_slo(genesis_time=time.time(), slack_floor_ms=-1e12, metrics=metrics.slo)
    bv.reset_prep_counts()
    scraped = {}
    captures = cache.captures
    before_serving = replays()

    def served_replays():
        now = replays()
        return {k: now[k] - before_serving.get(k, 0) for k in now
                if now[k] != before_serving.get(k, 0)}

    fp_cuda.reset_launches()
    graphs.reset_replayed()  # the serving path's run starts here
    try:
        asyncio.run(serve_all())
    finally:  # the families stay with this phase
        bv._prep_metrics = None
        bv.dp.configure_launch_counter(None)
        telemetry.reset_launch_telemetry()
        slo.reset_slo()
    replayed = dict(graphs.REPLAYED)  # the serving path's run ends here
    if cache.captures != captures:
        fail(f"serve: {cache.captures - captures} graphs were captured while the pool served")
    missing = [k for k in fp_cuda.KERNELS if replayed[k] <= 0]
    if missing:
        fail(f"serve: kernels never launched by a replay while the pool served: {missing}")
    if any(fp_cuda.LAUNCHES.values()):
        fail(f"serve: eager kernel launches while the pool served: {dict(fp_cuda.LAUNCHES)}")
    say(f"serve: no capture while serving; Fp launches replayed {replayed}")
    return {"warm_s": warm_s, "per_class": per_class, "runs": runs, "replayed": replayed,
            "scrape": scraped}


def check_serve_scrape(smi, metrics, runs, verdicts, replays_by_class, pool):
    """Phase 7's scrape, through a `MetricsServer` on 127.0.0.1, held
    against the pool's own counts, the prep counters and the replays the
    phase counted: jobs dequeued (by class) = the pool's jobs started; lane
    launches = the lane's; prep sets and rejects = `prep_counts()`; the
    single-launch dispatches by size class = the graph replays by class, one
    prep-seam launch each; SLO verdicts and True verdicts by class = the
    jobs'. Returns the scrape's bytes and ms and the compared figures."""
    from lodestar_tpu_torch.models import batch_verify as bv

    s, n_bytes, ms = scrape_metrics(metrics)
    counts = bv.prep_counts()
    pool_counts = runs["pool_counts"]
    lane = runs["lane"]
    dequeued = sample_sum(s, "lodestar_sched_jobs_dequeued_total")
    by_program = {}
    for (name, labels), v in s.items():
        if name == "lodestar_device_launch_seconds_count" and v:
            lab = dict(labels)
            by_program.setdefault(lab["program"], {})[int(lab["size_class"])] = int(v)
    single = by_program.get("_single_launch_verify", {})
    got = {
        "jobs_dequeued": dequeued,
        "lane_launches": sample_sum(s, "lodestar_sched_lane_launches_total", device=lane["label"],
                                    mode="single"),
        "prep_sets": {layer: sample_sum(s, "lodestar_bls_prep_sets_total", layer=layer)
                      for layer in bv.PREP_LAYERS},
        "prep_rejected": sample_sum(s, "lodestar_bls_prep_rejected_total"),
        "prep_launches": sample_sum(s, "lodestar_bls_prep_launches_total"),
        "launches_by_program": by_program,
        "slo_verdicts": {c: sample_sum(s, "lodestar_slo_sli_total", **{"class": c})
                         for c in verdicts},
        "slo_true": {c: sample_sum(s, "lodestar_slo_sli_good_total", **{"class": c})
                     for c in verdicts},
        "fallbacks": sample_sum(s, "lodestar_bls_prep_fallbacks_total")
        + sample_sum(s, "lodestar_bls_prep_single_launch_fallbacks_total"),
        "mesh_lanes": sample_sum(s, "lodestar_sched_mesh_lanes_available"),
    }
    want = {
        "jobs_dequeued": pool_counts["jobs_started"],
        "lane_launches": lane["launches"],
        "prep_sets": {layer: counts["sets"][layer] for layer in bv.PREP_LAYERS},
        "prep_rejected": counts["rejected"],
        "prep_launches": sum(replays_by_class.values()),
        "launches_by_program": {"_single_launch_verify": replays_by_class,
                                "bls_lane_verify": by_program.get("bls_lane_verify", {})},
        "slo_verdicts": {c: len(v) for c, v in verdicts.items()},
        "slo_true": {c: v.count(True) for c, v in verdicts.items()},
        "fallbacks": 0,
        "mesh_lanes": len(pool.mesh.available()),
    }
    lane_by_class = sum(by_program.get("bls_lane_verify", {}).values())
    say(f"serve: scrape of create_metrics() through a MetricsServer on 127.0.0.1: {n_bytes} "
        f"bytes in {ms:.2f} ms; jobs dequeued {dequeued} (the pool's jobs started "
        f"{pool_counts['jobs_started']}, sets started {pool_counts['sig_sets_started']}), lane "
        f"launches {got['lane_launches']}, prep sets {got['prep_sets']}, single-launch dispatches "
        f"by class {single} (replays {replays_by_class}), SLO verdicts {got['slo_verdicts']}, "
        f"True {got['slo_true']} on {smi}")
    if got != want or lane_by_class != lane["launches"] or not dequeued:
        fail(f"serve: the scrape {got} disagrees with the phase's counts {want} "
             f"(bls_lane_verify launches {lane_by_class})")
    return {"bytes": n_bytes, "ms": ms, "compared": got}


# --- phase 7b ----------------------------------------------------------------
# The offload host (`offload/server.py`) built as its entry point builds it,
# on the CUDA mesh, driven in-process through `local_transports` (no grpc
# needed, which a GPU host may lack) from four threads, as gRPC's worker threads call
# `_verify`: one service slot, two tenants weighted 1:3.
OFFLOAD_ARGV = ("--bls-mesh", "auto", "--workers", "4", "--tenant-slots", "1",
                "--tenant-weight", "a=1", "--tenant-weight", "b=3")


class _Counter:
    """A labelled counter (or gauge) that `DegradingBlsVerifier`,
    `BlsOffloadClient` and `OffloadAuditor` write to: counted here, and
    passed on to `real` (a family of `lodestar_tpu_torch.metrics`) when one
    is given, so a scrape can be held against the phase's own counts."""

    def __init__(self, real=None):
        self.counts = {}
        self.real = real

    def labels(self, *key):
        counts, real = self.counts, self.real

        class _One:
            def inc(self, by=1):
                counts[key] = counts.get(key, 0) + by
                if real is not None:
                    real.labels(*key).inc(by)

            def set(self, value):
                counts[key] = value
                if real is not None:
                    real.labels(*key).set(value)

        return _One()

    def inc(self, by=1):  # an unlabelled family (the auditor's cpu_seconds)
        self.counts[()] = self.counts.get((), 0) + by
        if self.real is not None:
            self.real.inc(by)

    def set(self, value):  # an unlabelled gauge (the auditor's queue_depth)
        self.counts[()] = value
        if self.real is not None:
            self.real.set(value)

    def total(self):
        return sum(self.counts.values())


class _Gauge:
    def __init__(self):
        self.value = None

    def set(self, value):
        self.value = value


class FallbackMetrics:
    """The `metrics.fallback_*` of `DegradingBlsVerifier`, counted here."""

    def __init__(self):
        self.fallback_active = _Gauge()
        self.fallback_verifications = _Counter()
        self.fallback_skipped = _Counter()


def offload(dev, smi, main, served):
    """Phase 7b: the offload host. (a) `build_server(OFFLOAD_ARGV)`, then
    counts, replays and captures reset and the Status frame read; (b) verify
    frames in and digest-checked verdict frames out through `LocalStub`
    from four threads: 16 frames of 128 at API priority (tenants a and b),
    16 one-set gossip frames, a tampered frame, a length mismatch and an
    unknown priority class (error frames), and one traced frame whose
    trailing metadata carries the server's spans; (c) each run's wall s,
    frames/s, sigs/s, replays by class and tenancy served counts; (d)
    `DegradingBlsVerifier` over the device pool and the CPU oracle, served
    by the device layer every time. Fails on a capture, an eager launch, a
    kernel no replay launched or a lane breaker that saw a failure."""
    import asyncio

    import torch

    from lodestar_tpu_torch import graphs, tracing
    from lodestar_tpu_torch.chain.bls import (
        BlsDeviceVerifierPool,
        BlsSingleThreadVerifier,
        DegradingBlsVerifier,
        VerifySignatureOpts,
    )
    from lodestar_tpu_torch.chain.bls.pool import POOL_SIZE_CLASSES
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.offload import (
        SETS_TRAILER_MAGIC,
        SETS_TRAILER_VERSION,
        OffloadError,
        OffloadShed,
        decode_sets_ex,
        decode_status,
        decode_verdict,
        encode_sets,
    )
    from lodestar_tpu_torch.offload import server as osrv
    from lodestar_tpu_torch.ops import fp_cuda
    from lodestar_tpu_torch.scheduler import AdmissionState, PriorityClass

    t_phase = time.perf_counter()
    try:
        import grpc  # noqa: F401

        have_grpc = True
    except ImportError:
        have_grpc = False
    say(f"offload: grpc {'imports' if have_grpc else 'does not import'} on this machine "
        f"(recorded only: the phase serves in-process through LocalStub)")

    # (a) the host as its entry point builds it, its tenant families scraped
    # over HTTP on a free port (`--metrics-port`)
    metrics_port = free_port()
    argv = [*OFFLOAD_ARGV, "--metrics-port", str(metrics_port)]
    t0 = time.perf_counter()
    server = osrv.build_server(argv)
    build_s = time.perf_counter() - t0
    mesh = server.mesh
    if server.metrics_server is None or server.metrics_server.port != metrics_port:
        fail(f"offload: --metrics-port {metrics_port} started no scrape server")
    say(f"offload: (a) build_server({' '.join(argv)}) in {build_s:.1f} s: "
        f"{len(mesh)} lane(s) on {[str(lane.device) for lane in mesh.lanes]}, classes "
        f"{list(POOL_SIZE_CLASSES)} captured (all of them by phase 7 already in this process)")
    cache = bv._SINGLE_LAUNCH_GRAPHS
    unwarmed = [c for c in POOL_SIZE_CLASSES if (dev.index, c) not in cache.graphs]
    if len(mesh) != torch.cuda.device_count() or unwarmed:
        fail(f"offload: the host's mesh has {len(mesh)} lanes, classes without a graph: "
             f"{unwarmed}")
    captures = cache.captures
    fp_cuda.reset_launches()
    graphs.reset_replayed()  # the serving path's run starts here
    status = decode_status(server._status(b"", osrv._LocalContext()))
    say(f"offload: (a) Status: admission {status.admission.label}, chips "
        f"{[(c.occupancy_permille, c.wedged) for c in status.chips]}, tenant_capable "
        f"{status.tenant_capable}, queue depth {status.queue_depth}")
    if (status.admission is not AdmissionState.ACCEPT or len(status.chips) != len(mesh)
            or any(c.wedged for c in status.chips) or not status.tenant_capable):
        fail(f"offload: the Status frame is {status}")

    # (b) frames in, digest-checked verdicts out, from four threads
    stub = osrv.local_transports({"h100": server})("h100", "verify", None)
    merged_sets = main["merged_sets"]
    sets = main["batches"]["valid"]
    api = [encode_sets(merged_sets[i * BATCH:(i + 1) * BATCH], tenant="ab"[i % 2],
                       priority=PriorityClass.API) for i in range(MERGE_JOBS)]
    gossip = [encode_sets([s], tenant="ab"[i % 2], priority=PriorityClass.GOSSIP_ATTESTATION)
              for i, s in enumerate(merged_sets[:MERGE_JOBS])]
    tampered = encode_sets(main["batches"]["swapped"], tenant="a", priority=PriorityClass.API)
    mismatch = encode_sets(sets[:2])[:-1]  # one byte short of its two sets
    unknown_class = (encode_sets(sets[:1]) + bytes([SETS_TRAILER_MAGIC, SETS_TRAILER_VERSION, 99])
                     + (1).to_bytes(2, "little") + b"a")

    def replays():
        return {size: g.replays for (idx, size), g in cache.graphs.items() if idx == dev.index}

    def verdict(frame, reply):
        try:
            return decode_verdict(reply, request=frame)
        except OffloadShed as e:
            return f"shed: {e}"
        except OffloadError as e:
            return f"error: {e}"

    def one(frame):
        return verdict(frame, stub(frame))  # no deadline: see PERF.md §7

    runs = {}
    served_sets = {}  # tenant -> sets of the frames that got a verdict

    def count_served(frame, got):
        if isinstance(got, bool):
            sets_, trailer = decode_sets_ex(frame)
            tenant = trailer.tenant if trailer is not None else ""
            served_sets[tenant] = served_sets.get(tenant, 0) + len(sets_)

    def run(name, frames, want, want_replays):
        before, served_before = replays(), dict(server.tenancy.served)
        n_sets = sum(int.from_bytes(f[:4], "little") for f in frames)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            got = list(pool.map(one, frames))
        wall = time.perf_counter() - t0
        after = replays()
        by_class = {k: after[k] - before.get(k, 0) for k in sorted(after)
                    if after[k] != before.get(k, 0)}
        tenants = {t: n - served_before.get(t, 0) for t, n in sorted(server.tenancy.served.items())
                   if n != served_before.get(t, 0)}
        runs[name] = {"frames": len(frames), "sets": n_sets, "wall_s": wall,
                      "frames_per_s": len(frames) / wall, "sigs_per_s": n_sets / wall,
                      "replays_by_class": by_class, "served_by_tenant": tenants}
        say(f"offload: {name}: {len(frames)} frames, {n_sets} sets in {wall:.3f} s "
            f"({len(frames) / wall:.2f} frames/s, {n_sets / wall:.1f} sigs/s), replays by class "
            f"{by_class}, served by tenant {tenants}, verdicts {sorted(set(map(str, got)))} "
            f"on {smi}")
        for frame, g in zip(frames, got):
            count_served(frame, g)
        if [g if isinstance(g, bool) else g.split(":")[0] for g in got] != want:
            fail(f"offload: {name} gave {got}, not {want}")
        if by_class != want_replays:
            fail(f"offload: {name} replayed {by_class}, not {want_replays}")

    run("api_16x128", api, [True] * MERGE_JOBS, {BATCH: MERGE_JOBS})
    run("gossip_16x1", gossip, [True] * MERGE_JOBS, {8: MERGE_JOBS})
    run("tampered_1x128", [tampered], [False], {BATCH: 1})
    run("length_mismatch", [mismatch], ["error"], {})
    run("unknown_class", [unknown_class], ["error"], {})
    api_run = runs["api_16x128"]
    say(f"offload: api_16x128 {api_run['sigs_per_s']:.1f} sigs/s through the host beside phase "
        f"7's pool api_16x128 {served['runs']['api_16x128']['sigs_per_s']:.1f} sigs/s (4 "
        f"class-512 replays there, 16 class-128 here); a class-128 frame costs "
        f"{api_run['wall_s'] / MERGE_JOBS:.3f} s of wall a replay, against the server's "
        f"slot_wait_margin_s {server.slot_wait_margin_s} on {smi}")

    # a traced frame: the server's spans come home in trailing metadata
    tracing.reset()
    tracing.configure(enabled=True, slow_slot_ms=60_000.0)
    try:
        before = replays()
        with tracing.root("offload_smoke") as root:
            t0 = time.monotonic_ns()
            reply, call = stub.with_call(gossip[0], metadata=(
                (tracing.TRACE_CONTEXT_KEY, tracing.context_header()),))
            payload = dict(call.trailing_metadata()).get(tracing.TRACE_SPANS_KEY)
            grafted = tracing.graft_remote_spans(root, payload, t0)
        spans = {s.name: s for s in root.trace.spans}
    finally:
        tracing.reset()
    got = verdict(gossip[0], reply)
    count_served(gossip[0], got)
    names = [item["name"] for item in json.loads(payload)] if payload else []
    after = replays()
    by_class = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    span_ms = {n: round(spans[n].duration_ms, 1) for n in names if n in spans}
    say(f"offload: traced frame: verdict {got}, trailing spans {names}, {grafted} grafted "
        f"(ms {span_ms}), replays by class {by_class}")
    if (got is not True or {"offload_decode", "offload_device_verify"} - set(names)
            or grafted != 2 or by_class != {8: 1}):
        fail(f"offload: the traced frame gave {got} with spans {names} ({grafted} grafted)")
    lane = mesh.lanes[0]
    if lane.breaker.state().name != "CLOSED" or lane.breaker._failures:
        fail(f"offload: the lane's breaker shows a failure ({lane.breaker.state().name})")
    tenant_scrape = check_tenant_scrape(smi, server, metrics_port, served_sets)

    # (d) the degradation chain, served by its device layer
    metrics = FallbackMetrics()

    async def degrade():
        pool = BlsDeviceVerifierPool(mesh_mode="auto")
        deg = DegradingBlsVerifier([("device", pool), ("cpu", BlsSingleThreadVerifier())],
                                   metrics=metrics)
        opts = VerifySignatureOpts(batchable=True, priority=PriorityClass.API)

        async def job(sets_):
            return await deg.verify_signature_sets(sets_, opts), deg.serving_layer()

        before = replays()
        t0 = time.perf_counter()
        got = await asyncio.gather(*(job(merged_sets[i * BATCH:(i + 1) * BATCH])
                                     for i in range(MERGE_JOBS)))
        wall = time.perf_counter() - t0
        mid = replays()
        bad = await job(main["batches"]["swapped"])
        after = replays()
        breaker = pool.mesh.lanes[0].breaker
        clean = breaker.state().name == "CLOSED" and not breaker._failures
        await deg.close()
        return (got, bad, wall, clean,
                {k: mid[k] - before.get(k, 0) for k in mid if mid[k] != before.get(k, 0)},
                {k: after[k] - mid.get(k, 0) for k in after if after[k] != mid.get(k, 0)})

    got, bad, wall, clean, by_class, bad_by_class = asyncio.run(degrade())
    fallbacks = sum(metrics.fallback_verifications.counts.values())
    skips = sum(metrics.fallback_skipped.counts.values())
    degrading = {"wall_s": wall, "sigs_per_s": BATCH * MERGE_JOBS / wall,
                 "replays_by_class": by_class, "tampered_replays_by_class": bad_by_class,
                 "fallbacks": fallbacks, "skips": skips,
                 "fallback_active": metrics.fallback_active.value}
    say(f"offload: (d) DegradingBlsVerifier [device, cpu]: 16 jobs of 128 in {wall:.3f} s "
        f"({degrading['sigs_per_s']:.1f} sigs/s), replays by class {by_class}; tampered job "
        f"{bad[0]} (replays {bad_by_class}); layers {sorted({layer for _, layer in got})} and "
        f"{bad[1]}; fallbacks {fallbacks}, skips {skips}, fallback_active "
        f"{metrics.fallback_active.value} on {smi}")
    if (got != [(True, "device")] * MERGE_JOBS or bad != (False, "device") or fallbacks or skips
            or metrics.fallback_active.value != 0 or not clean):
        fail(f"offload: the degrading verifier gave {got} and {bad} (fallbacks {fallbacks}, "
             f"skips {skips}, breaker clean {clean})")

    replayed = dict(graphs.REPLAYED)  # the serving path's run ends here
    if cache.captures != captures:
        fail(f"offload: {cache.captures - captures} graphs were captured while the host served")
    missing = [k for k in fp_cuda.KERNELS if replayed[k] <= 0]
    if missing:
        fail(f"offload: kernels never launched by a replay while the host served: {missing}")
    if any(fp_cuda.LAUNCHES.values()):
        fail(f"offload: eager kernel launches while the host served: {dict(fp_cuda.LAUNCHES)}")
    say(f"offload: no capture while serving; Fp launches replayed {replayed}")
    # the host keeps serving: phase 7c's client routes to it (and stops it)
    return {"grpc": have_grpc, "build_s": build_s, "runs": runs, "degrading": degrading,
            "tenant_scrape": tenant_scrape, "replayed": replayed,
            "phase_s": time.perf_counter() - t_phase, "server": server}


def check_tenant_scrape(smi, server, port, served_sets):
    """Phase 7b's scrape of the host's `--metrics-port`: the
    lodestar_offload_tenant_* families per tenant against the tenancy's own
    counts: sets served = the sets of the frames that got a verdict, sheds
    (by reason, summed) = `tenancy.shed`, the stride weights the flags', no
    slot still granted. Returns the scrape's bytes and ms and the figures."""
    s, n_bytes, ms = scrape_metrics(None, port=port)
    tenants = sorted(set(server.tenancy.served) | set(server.tenancy.shed) | set(served_sets))
    got = {t: {"served_sets": sample_sum(s, "lodestar_offload_tenant_served_sets_total", tenant=t),
               "shed": sample_sum(s, "lodestar_offload_tenant_shed_total", tenant=t),
               "inflight": sample_sum(s, "lodestar_offload_tenant_inflight", tenant=t)}
           for t in tenants}
    want = {t: {"served_sets": served_sets.get(t, 0), "shed": server.tenancy.shed.get(t, 0),
                "inflight": 0} for t in tenants}
    weights = {t: sample_sum(s, "lodestar_offload_tenant_quota_weight", tenant=t) for t in "ab"}
    say(f"offload: scrape of --metrics-port {port}: {n_bytes} bytes in {ms:.2f} ms; per tenant "
        f"{got}; tenancy grants {dict(server.tenancy.served)}, sheds "
        f"{dict(server.tenancy.shed)}; weights {weights} on {smi}")
    if got != want or weights != {"a": 1, "b": 3} or not served_sets:
        fail(f"offload: the tenant scrape {got} (weights {weights}) disagrees with the "
             f"tenancy's counts {want}")
    return {"bytes": n_bytes, "ms": ms, "per_tenant": got}


# --- phase 7c ----------------------------------------------------------------
# The port's offload client (`offload/client.py`) over two endpoints on the one
# card: "h100-a" is phase 7b's host, "h100-b" a second `BlsOffloadServer` over
# the same mesh's lanes with the same tenancy flags (one service slot each).
# Both are served in-process through `local_transports`, a `FaultInjector` in
# front. The two hosts share one lane, so every replay of a class runs one at a
# time on the card, whichever host serves it.
CLIENT_TARGETS = ("h100-a", "h100-b")
CLIENT_PROBE_S = 0.5  # the clients' Status probe interval (the default is 2.0 s)
CLIENT_EXECUTOR_THREADS = 32  # the loop's default executor: every job of a burst in flight
# (a) alone: 16 class-128 replays one at a time take ~11 s on the card, past
# the API class's 10 s budget, so (a) measures throughput at a 30 s budget
# (the client's flat timeout); (b) measures the class budgets themselves
CLIENT_API_BUDGET_S = 30.0
# (c) alone: a burst of 2 x DEFAULT_FAILURE_THRESHOLD one-set jobs all lands
# on h100-a once h100-b is cut (~6.3 s of class-8 replays), past the 4 s
# gossip-attestation budget; (c) gives the class one slot (12 s)
CLIENT_FAULT_BUDGET_S = 12.0
CLIENT_FAULT_BURSTS = 3  # bursts tried until h100-b's breaker opens
CLIENT_AUDIT_RATE = 0.5  # (d): detection_horizon(0.5) = 7 samples
CLIENT_AUDIT_SEED = 0


class ClientMetrics:
    """The `metrics=` of `BlsOffloadClient` (routed, failovers, hedges,
    hedge_wins, shed, breaker_state, breaker_transitions) or of
    `OffloadAuditor` (sampled, verified, dropped, byzantine, trust_score,
    quarantined, queue_depth, cpu_seconds), counted here and passed on to
    `real`, the `ResilienceMetrics` or `AuditMetrics` of the phase's
    `create_metrics()`."""

    def __init__(self, real=None):
        self._real = real

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        family = _Counter(None if self._real is None else getattr(self._real, name))
        setattr(self, name, family)
        return family

    def counts(self):
        return {name: getattr(self, name).total()
                for name in ("routed", "failovers", "hedges", "hedge_wins", "shed")}


def offload_client(dev, smi, main, served, offloaded):
    """Phase 7c: the port's offload client over phase 7b's host ("h100-a") and a
    second host on the same lanes ("h100-b"). (a) 16 API jobs of 128 sets; (b)
    16 one-set gossip-block jobs at the default class budgets, sequential, then
    with the concurrent hedge at DEFAULT_HEDGE_DELAY_MS; (c) a partition of
    h100-b under a burst of one-set gossip-attestation jobs: failover to
    h100-a, h100-b's breaker open after DEFAULT_FAILURE_THRESHOLD failures,
    re-closed by its half-open trial after heal and a probe success; (d) a
    LIE_VERDICT window on h100-b caught by an OffloadAuditor on the CPU oracle,
    the liar quarantined, later jobs on h100-a only, then lifted; (e)
    DegradingBlsVerifier [client, device pool, CPU oracle]: both hosts cut (the
    pool serves), then healed (the client serves). Counts, replays and
    captures reset at the start; fails on a wrong verdict (other than the
    injected lie, which must be caught), a capture, an eager launch, or a
    kernel no replay launched. The clients' and the auditor's `metrics=` pass
    their counts on to the `ResilienceMetrics` and `AuditMetrics` of one
    `create_metrics()`, scraped at the end (`check_client_scrape`)."""
    import asyncio
    from collections import Counter

    from lodestar_tpu_torch import graphs
    from lodestar_tpu_torch.metrics import create_metrics
    from lodestar_tpu_torch.chain.bls import (
        BlsDeviceVerifierPool,
        BlsSingleThreadVerifier,
        DegradingBlsVerifier,
        VerifySignatureOpts,
    )
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.offload import OffloadError
    from lodestar_tpu_torch.offload import server as osrv
    from lodestar_tpu_torch.offload.audit import (
        AuditSampler,
        OffloadAuditor,
        cpu_oracle_reference,
        detection_horizon,
    )
    from lodestar_tpu_torch.offload.client import BlsOffloadClient
    from lodestar_tpu_torch.offload.resilience import (
        CLASS_DEADLINE_S,
        DEFAULT_FAILURE_THRESHOLD,
        DEFAULT_HEDGE_DELAY_MS,
    )
    from lodestar_tpu_torch.ops import fp_cuda
    from lodestar_tpu_torch.scheduler import PriorityClass
    from lodestar_tpu_torch.testing import FaultInjector, FaultKind, FaultRule

    t_phase = time.perf_counter()
    host_a = offloaded["server"]
    mesh, ten = host_a.mesh, host_a.tenancy
    host_b = osrv.BlsOffloadServer(
        host_a.backend, max_workers=host_a._max_workers, tenant_weights=dict(ten._weights),
        tenant_default_weight=ten._default_weight, tenant_slots=ten._slots,
        tenant_shed_depth=ten.shed_depth, tenant_reject_depth=ten.reject_depth,
        chip_status_fn=mesh.chip_table)
    servers = dict(zip(CLIENT_TARGETS, (host_a, host_b)))
    A, B = CLIENT_TARGETS
    say(f"offload-client: two hosts on {len(mesh)} lane(s): {A} = phase 7b's "
        f"build_server({' '.join(OFFLOAD_ARGV)}), {B} = BlsOffloadServer(the same backend, "
        f"{ten._slots} slot, weights {ten._weights}); probe {CLIENT_PROBE_S} s, "
        f"{CLIENT_EXECUTOR_THREADS} executor threads; class budgets "
        f"{ {c.label: v for c, v in CLASS_DEADLINE_S.items()} } s, hedge delay "
        f"{DEFAULT_HEDGE_DELAY_MS} ms, breaker threshold {DEFAULT_FAILURE_THRESHOLD}")
    cache = bv._SINGLE_LAUNCH_GRAPHS
    captures = cache.captures
    fp_cuda.reset_launches()
    graphs.reset_replayed()  # the client's run starts here

    merged_sets = main["merged_sets"]
    valid, swapped = main["batches"]["valid"], main["batches"]["swapped"]
    api_jobs = [merged_sets[i * BATCH:(i + 1) * BATCH] for i in range(MERGE_JOBS)]
    gossip_jobs = [[s] for s in valid[:MERGE_JOBS]]
    invalid_jobs = [[swapped[i % 2]] for i in range(2 * MERGE_JOBS)]  # a swapped signature

    def replays():
        return {size: g.replays for (idx, size), g in cache.graphs.items() if idx == dev.index}

    def since(before):
        after = replays()
        return {k: after[k] - before.get(k, 0) for k in sorted(after)
                if after[k] != before.get(k, 0)}

    def make_client(inj, **kw):
        kw.setdefault("probe_interval_s", CLIENT_PROBE_S)
        kw.setdefault("tenant", "a")
        return BlsOffloadClient(list(CLIENT_TARGETS), transport_wrapper=osrv.local_transports(
            servers, wrap=inj.wrap_transport), **kw)

    def states(client):
        return {s["target"]: {k: s[k] for k in ("healthy", "breaker", "quarantined", "trust",
                                                 "outstanding", "admission",
                                                 "occupancy_permille")}
                for s in client.endpoint_states()}

    async def outcome(client, sets_, priority):
        try:
            return await client.verify_signature_sets(sets_, VerifySignatureOpts(priority=priority))
        except OffloadError as e:  # fail closed: a shed or an error, never a verdict
            return type(e).__name__

    async def idle(client, timeout_s=30.0):
        deadline = time.monotonic() + timeout_s
        while any(s["outstanding"] for s in client.endpoint_states()):
            if time.monotonic() > deadline:
                fail(f"offload-client: work still in flight after {timeout_s} s: "
                     f"{states(client)}")
            await asyncio.sleep(0.01)

    async def settle(client, inj, targets=CLIENT_TARGETS, timeout_s=20.0):
        """Nothing in flight, then two more Status probes of each target, all
        healthy: the card is idle across the probes, so its occupancy only
        decays between them. Returns the seconds waited."""
        t0 = time.perf_counter()
        await idle(client)
        marks = {t: inj.calls_to(t, "status") for t in targets}
        deadline = time.monotonic() + timeout_s
        while not (all(inj.calls_to(t, "status") >= marks[t] + 2 for t in targets)
                   and all(states(client)[t]["healthy"] for t in targets)):
            if time.monotonic() > deadline:
                fail(f"offload-client: endpoints not healthy after {timeout_s} s: "
                     f"{states(client)}")
            await asyncio.sleep(0.02)
        return time.perf_counter() - t0

    out = {}
    phase_metrics = create_metrics()
    client_metrics = []  # every client's ClientMetrics, in run order

    def new_metrics():
        m = ClientMetrics(phase_metrics.resilience)
        client_metrics.append(m)
        return m

    audit_metrics = ClientMetrics(phase_metrics.audit)
    audited = {}

    async def run_api():
        inj, m = FaultInjector(seed=0), new_metrics()
        client = make_client(inj, metrics=m, class_deadlines={
            **CLASS_DEADLINE_S, PriorityClass.API: CLIENT_API_BUDGET_S})
        await settle(client, inj)
        before = replays()
        served_before = {t: srv.tenancy.served.get("a", 0) for t, srv in servers.items()}
        t0 = time.perf_counter()
        got = await asyncio.gather(*(outcome(client, j, PriorityClass.API) for j in api_jobs))
        wall = time.perf_counter() - t0
        by_class = since(before)
        split = {t: inj.calls_to(t, "verify") for t in CLIENT_TARGETS}
        tenant_a = {t: srv.tenancy.served.get("a", 0) - served_before[t]
                    for t, srv in servers.items()}
        await client.close()
        n_sets = BATCH * MERGE_JOBS
        run = {"wall_s": wall, "sigs_per_s": n_sets / wall, "replays_by_class": by_class,
               "split": split, "served_tenant_a": tenant_a, "counts": m.counts()}
        say(f"offload-client: (a) api 16x128 (tenant a, API budget {CLIENT_API_BUDGET_S} s): "
            f"{n_sets} sets in {wall:.3f} s ({run['sigs_per_s']:.1f} sigs/s), replays by class "
            f"{by_class}, jobs by endpoint {split}, tenant a served {tenant_a}, verdicts "
            f"{dict(Counter(map(str, got)))}; beside phase 7b's host "
            f"{offloaded['runs']['api_16x128']['sigs_per_s']:.1f} and phase 7's pool "
            f"{served['runs']['api_16x128']['sigs_per_s']:.1f} sigs/s on {smi}")
        if got != [True] * MERGE_JOBS or by_class != {BATCH: MERGE_JOBS}:
            fail(f"offload-client: (a) gave {got}, replays {by_class}")
        if sum(tenant_a.values()) != MERGE_JOBS:
            fail(f"offload-client: (a) the tenant trailer was not accounted: {tenant_a}")
        out["api"] = run

    async def run_gossip(label, **kw):
        inj, m = FaultInjector(seed=0), new_metrics()
        client = make_client(inj, metrics=m, **kw)
        await settle(client, inj)
        before = replays()
        sheds_before = {t: srv.tenancy.shed.get("a", 0) for t, srv in servers.items()}
        t0 = time.perf_counter()
        got = await asyncio.gather(*(outcome(client, j, PriorityClass.GOSSIP_BLOCK)
                                     for j in gossip_jobs))
        wall = time.perf_counter() - t0
        await idle(client)  # a hedge's loser runs on: in-process calls are not cut
        settled = time.perf_counter() - t0
        by_class = since(before)
        n_replays = sum(by_class.values())
        verdicts = dict(Counter(map(str, got)))
        served_sheds = {t: srv.tenancy.shed.get("a", 0) - sheds_before[t]
                        for t, srv in servers.items()}
        run = {"wall_s": wall, "settled_s": settled, "verdicts": verdicts,
               "replays_by_class": by_class, "replays": n_replays,
               "replays_past_verdicts": n_replays - got.count(True), "counts": m.counts(),
               "server_sheds": served_sheds,
               "split": {t: inj.calls_to(t, "verify") for t in CLIENT_TARGETS}}
        await client.close()
        say(f"offload-client: (b) {label}: {len(gossip_jobs)} one-set gossip-block jobs in "
            f"{wall:.3f} s (all replays done {settled:.3f} s), verdicts {verdicts}, "
            f"client {run['counts']}, server sheds {served_sheds}, calls by endpoint "
            f"{run['split']}, replays {by_class} ({run['replays_past_verdicts']} past the "
            f"{got.count(True)} verdicts) on {smi}")
        if False in got or set(by_class) - {8}:
            fail(f"offload-client: (b) {label} gave {got}, replays {by_class}")
        out[label] = run

    async def run_fault():
        inj, m = FaultInjector(seed=0), new_metrics()
        client = make_client(inj, metrics=m, class_deadlines={
            **CLASS_DEADLINE_S, PriorityClass.GOSSIP_ATTESTATION: CLIENT_FAULT_BUDGET_S})
        steps, verdicts = [], []

        def step(name):
            st = states(client)
            steps.append({"step": name, "states": st})
            say(f"offload-client: (c) {name}: endpoint_states {st}")

        async def burst(jobs):
            got = await asyncio.gather(*(outcome(client, j, PriorityClass.GOSSIP_ATTESTATION)
                                         for j in jobs))
            verdicts.extend(got)
            if got != [True] * len(jobs):
                fail(f"offload-client: (c) a verdict went wrong: {got}")

        before = replays()
        t0 = time.perf_counter()
        await settle(client, inj)
        step("start")
        await burst(gossip_jobs[:2])
        n = 2 * DEFAULT_FAILURE_THRESHOLD
        for attempt in range(CLIENT_FAULT_BURSTS):
            await settle(client, inj)  # an idle probe pair: h100-b ranks no lower than h100-a
            step(f"before partition {attempt}")
            b0 = inj.calls_to(B, "verify")
            inj.partition(B)
            await burst(gossip_jobs[:n])
            failed_b = inj.calls_to(B, "verify") - b0
            step(f"{B} partitioned, burst of {n}: {failed_b} calls failed on {B}")
            if states(client)[B]["breaker"] == "open":
                break
            inj.heal(B)
        else:
            fail(f"offload-client: (c) {B}'s breaker never opened")
        b0 = inj.calls_to(B, "verify")
        await burst(gossip_jobs[:2])
        step("breaker open: 2 more jobs")
        if inj.calls_to(B, "verify") != b0:
            fail(f"offload-client: (c) {B} was dialed with its breaker open")
        inj.heal(B)
        t_heal = time.perf_counter()
        await settle(client, inj, targets=(B,))
        heal_s = time.perf_counter() - t_heal
        step(f"healed; a probe answered after {heal_s:.2f} s")
        b0 = inj.calls_to(B, "verify")
        await burst(gossip_jobs[:1])
        step("one job: the half-open trial")
        if inj.calls_to(B, "verify") != b0 + 1 or states(client)[B]["breaker"] != "closed":
            fail(f"offload-client: (c) the trial did not re-close {B}: {states(client)}")
        opened = m.breaker_transitions.counts.get((B, "open"), 0)
        run = {"wall_s": time.perf_counter() - t0, "verdicts": dict(Counter(map(str, verdicts))),
               "counts": m.counts(), "breaker_opened": opened, "heal_to_probe_s": heal_s,
               "replays_by_class": since(before), "partitioned_calls": inj.injected[
                   FaultKind.PARTITION], "steps": steps}
        await client.close()
        say(f"offload-client: (c) fault: {len(verdicts)} jobs, verdicts {run['verdicts']}, "
            f"client {run['counts']}, {B} opened {opened}x, {run['partitioned_calls']} calls "
            f"(verify and Status) refused by the partition, replays {run['replays_by_class']}, "
            f"{run['wall_s']:.3f} s on {smi}")
        out["fault"] = run

    async def run_audit():
        loop = asyncio.get_running_loop()
        inj, m = FaultInjector(seed=0), new_metrics()
        aud = OffloadAuditor(sampler=AuditSampler(CLIENT_AUDIT_RATE, seed=CLIENT_AUDIT_SEED),
                             reference=cpu_oracle_reference, budget=1.0,
                             quarantine_cooloff_s=None, metrics=audit_metrics)
        client = make_client(inj, metrics=m, auditor=aud)
        horizon = detection_horizon(CLIENT_AUDIT_RATE)
        before = replays()
        t0 = time.perf_counter()
        await settle(client, inj)
        # the lie window: h100-b's next `horizon` verify calls answer the flipped
        # verdict, re-signed; h100-a is cut meanwhile, so every job reaches the liar
        b0 = inj.calls_to(B, "verify")
        inj.rules.append(FaultRule(FaultKind.LIE_VERDICT, first_call=b0,
                                   last_call=b0 + horizon - 1, targets=frozenset({B}),
                                   methods=frozenset({"verify"})))
        inj.partition(A)
        lied, caught_at = [], None
        for i in range(horizon):
            lied.append(await outcome(client, invalid_jobs[i], PriorityClass.GOSSIP_BLOCK))
            if not await loop.run_in_executor(None, aud.drain, 60.0):
                fail("offload-client: (d) the audit did not drain in 60 s")
            if states(client)[B]["quarantined"]:
                caught_at = i + 1
                break
        lies_served = inj.injected[FaultKind.LIE_VERDICT]
        say(f"offload-client: (d) {B} served the lied verdicts {lied} for invalid sets "
            f"({lies_served} lies); audit sampled {aud.sampled}, audited {aud.audited}; caught "
            f"at sample {caught_at} of the horizon {horizon}; events "
            f"{[{k: e[k] for k in ('endpoint', 'claimed_verdict', 'recheck_verdict')} for e in aud.byzantine_events]}")
        if caught_at is None or lied != [True] * caught_at or len(aud.byzantine_events) != 1:
            fail(f"offload-client: (d) the lie was not caught: {lied}, {states(client)}")
        inj.heal(A)
        await settle(client, inj, targets=(A,))
        b0 = inj.calls_to(B, "verify")
        after = [await outcome(client, j, PriorityClass.GOSSIP_BLOCK) for j in invalid_jobs[:2]]
        if not await loop.run_in_executor(None, aud.drain, 60.0):
            fail("offload-client: (d) the audit did not drain in 60 s")
        quarantined = states(client)
        if after != [False, False] or inj.calls_to(B, "verify") != b0:
            fail(f"offload-client: (d) after the quarantine: {after}, {quarantined}")
        lifted = client.unquarantine_endpoint(B)
        if not lifted or states(client)[B]["quarantined"]:
            fail(f"offload-client: (d) unquarantine_endpoint did not lift {B}")
        run = {"wall_s": time.perf_counter() - t0, "lied": lied, "caught_at": caught_at,
               "horizon": horizon, "sampled": aud.sampled, "audited": aud.audited,
               "trust": {t: aud.trust_value(t) for t in CLIENT_TARGETS},
               "after_quarantine": after, "states_quarantined": quarantined,
               "states_lifted": states(client), "replays_by_class": since(before)}
        say(f"offload-client: (d) quarantined: {quarantined}; 2 later jobs {after} all on {A}; "
            f"unquarantine_endpoint({B}) -> {lifted}: {states(client)[B]}; trust "
            f"{run['trust']}; replays {run['replays_by_class']}; {run['wall_s']:.3f} s on {smi}")
        await client.close()
        audited.update(sampled=aud.sampled, audited=aud.audited,
                       byzantine=len(aud.byzantine_events))
        out["audit"] = run

    async def run_degrade():
        inj, m, fm = FaultInjector(seed=0), new_metrics(), FallbackMetrics()
        client = make_client(inj, metrics=m)
        pool = BlsDeviceVerifierPool(mesh_mode="auto")
        deg = DegradingBlsVerifier([("offload", client), ("device", pool),
                                    ("cpu", BlsSingleThreadVerifier())], metrics=fm)
        opts = VerifySignatureOpts(priority=PriorityClass.GOSSIP_ATTESTATION)
        before = replays()
        t0 = time.perf_counter()
        await settle(client, inj)
        served_by = []
        inj.partition("*")
        for job in gossip_jobs[:2]:
            served_by.append((await deg.verify_signature_sets(job, opts), deg.serving_layer()))
        cut = {"fallbacks": {k[0]: v for k, v in fm.fallback_verifications.counts.items()},
               "skips": {k[0]: v for k, v in fm.fallback_skipped.counts.items()},
               "down": client.is_down()}
        inj.heal("*")
        await settle(client, inj)
        served_by.append((await deg.verify_signature_sets(gossip_jobs[2], opts),
                          deg.serving_layer()))
        await deg.close()
        run = {"wall_s": time.perf_counter() - t0, "served_by": served_by, "cut": cut,
               "fallback_active": fm.fallback_active.value, "replays_by_class": since(before)}
        say(f"offload-client: (e) DegradingBlsVerifier [offload, device, cpu]: both hosts cut: "
            f"{served_by[:2]} (fallbacks {cut['fallbacks']}, skips {cut['skips']}, client "
            f"down {cut['down']}); healed: {served_by[2]}; fallback_active "
            f"{fm.fallback_active.value}; replays {run['replays_by_class']}; "
            f"{run['wall_s']:.3f} s on {smi}")
        if (served_by != [(True, "device"), (True, "device"), (True, "offload")]
                or cut["fallbacks"] != {"device": 2} or fm.fallback_active.value != 0):
            fail(f"offload-client: (e) the degrading verifier gave {served_by} ({cut})")
        out["degrade"] = run

    async def drive():
        asyncio.get_running_loop().set_default_executor(concurrent.futures.ThreadPoolExecutor(
            CLIENT_EXECUTOR_THREADS, thread_name_prefix="offload-client"))
        await run_api()
        await run_gossip("gossip_sequential")
        await run_gossip("gossip_hedged", hedge_delay_ms=DEFAULT_HEDGE_DELAY_MS)
        await run_fault()
        await run_audit()
        await run_degrade()

    asyncio.run(drive())
    for srv in servers.values():
        srv.stop()
    host_a.metrics_server.stop()
    out["scrape"] = check_client_scrape(smi, phase_metrics, client_metrics, audit_metrics,
                                        audited)
    replayed = dict(graphs.REPLAYED)  # the client's run ends here
    if cache.captures != captures:
        fail(f"offload-client: {cache.captures - captures} graphs were captured")
    missing = [k for k in fp_cuda.KERNELS if replayed[k] <= 0]
    if missing:
        fail(f"offload-client: kernels never launched by a replay: {missing}")
    if any(fp_cuda.LAUNCHES.values()):
        fail(f"offload-client: eager kernel launches: {dict(fp_cuda.LAUNCHES)}")
    if any(lane.breaker.state().name != "CLOSED" or lane.breaker._failures for lane in mesh.lanes):
        fail("offload-client: a lane's breaker shows a failure")
    out["replayed"] = replayed
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"offload-client: no capture, no eager launch; Fp launches replayed {replayed}; phase "
        f"{out['phase_s']:.1f} s on {smi}")
    return out


def check_client_scrape(smi, metrics, client_metrics, audit_metrics, audited):
    """Phase 7c's scrape of the clients' `ResilienceMetrics` and the
    auditor's `AuditMetrics` through a `MetricsServer` on 127.0.0.1: each
    counter's total equals the sum of the counts the runs printed, and the
    audit counters equal the auditor's own (sampled, audited, Byzantine
    events). Returns the scrape's bytes and ms and the figures."""
    s, n_bytes, ms = scrape_metrics(metrics)
    names = {"routed": "lodestar_resilience_routed_total",
             "failovers": "lodestar_resilience_failover_total",
             "hedges": "lodestar_resilience_hedge_total",
             "hedge_wins": "lodestar_resilience_hedge_win_total",
             "shed": "lodestar_resilience_shed_total"}
    printed = {k: sum(m.counts()[k] for m in client_metrics) for k in names}
    got = {k: sample_sum(s, name) for k, name in names.items()}
    audit_got = {"sampled": sample_sum(s, "lodestar_offload_audit_sampled_total"),
                 "audited": sample_sum(s, "lodestar_offload_audit_verified_total"),
                 "byzantine": sample_sum(s, "lodestar_offload_audit_byzantine_total")}
    audit_counted = {"sampled": audit_metrics.sampled.total(),
                     "audited": audit_metrics.verified.total(),
                     "byzantine": audit_metrics.byzantine.total()}
    say(f"offload-client: scrape of the clients' and the auditor's families through a "
        f"MetricsServer on 127.0.0.1: {n_bytes} bytes in {ms:.2f} ms; resilience {got} (the "
        f"runs' counts summed {printed}); audit {audit_got} (the auditor's {audited}) on {smi}")
    if got != printed or audit_got != audited or audit_counted != audited or not got["routed"]:
        fail(f"offload-client: the scrape {got}, {audit_got} disagrees with the phase's counts "
             f"{printed}, {audited}")
    return {"bytes": n_bytes, "ms": ms, "resilience": got, "audit": audit_got}


# --- phase 7d ----------------------------------------------------------------
# The sharded verify (`verify_signature_sets_sharded`): one batch split into
# equal row slices over several devices, each shard one replay of a graph per
# (device, shard class), the finish one replay on the first device. The shard
# devices are every visible GPU when there are more than one, else cuda:0
# twice: two shards on one GPU replay one after the other, so on one GPU the
# phase shows the road is right and what it costs, not a speed-up.
SHARD_POOL_JOBS = 2  # (e) range-sync jobs of BATCH sets, each sharded over two lanes


def replay_ms(g, reps=3):
    """Mean device time of `reps` replays of a captured graph on its stream
    (its static inputs as the last call left them), by CUDA events."""
    import torch

    times = []
    with torch.cuda.stream(g.stream):
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return sum(times) / len(times)


def profiled_replay(g):
    """One replay of a captured graph under `torch.profiler` (its static
    inputs as the last call left them): the union of its kernels' device
    spans in ms, None when the trace holds no device events, and the
    trace's device event count."""
    import torch

    def run():
        with torch.cuda.stream(g.stream):
            g.graph.replay()

    _, _, events = profiled(run)
    return busy_ms(events) or None, len(device_events(events))


def sharded(dev, smi, main, single):
    """Phase 7d: the sharded verify on the card, then the pool's sharded bulk
    road over two lanes with the real collective. Returns its figures and
    counts."""
    import asyncio
    import dataclasses

    import torch

    from lodestar_tpu_torch import graphs
    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool, VerifySignatureOpts
    from lodestar_tpu_torch.chain.bls.mesh import MeshLane, VerifierMesh
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import fp_cuda
    from lodestar_tpu_torch.ops import prep as dp
    from lodestar_tpu_torch.scheduler import PriorityClass

    t_phase = time.perf_counter()
    n_gpu = torch.cuda.device_count()
    devs = [torch.device("cuda", i) for i in range(n_gpu)] if n_gpu > 1 else [dev, dev]
    n_shards = len(devs)
    merged_sets = main["merged_sets"]
    # one shard class in the phase: the road's batch is one pool job's BATCH
    # sets, so (a)-(d) and the pool's jobs in (e) replay the same shard graph
    road_sets = merged_sets[:BATCH]
    merged = len(road_sets)
    size = bv._sharded_size(merged, n_shards)
    k = size // n_shards
    say(f"sharded: {n_shards} shards on {[str(d) for d in devs]} "
        f"({'one per GPU' if n_gpu > 1 else 'two on the one GPU, replayed one after the other'}"
        f"); {merged} sets padded to {size}, shard class {k}")
    tampered = list(road_sets)
    tampered[5] = dataclasses.replace(road_sets[5], signature=road_sets[6].signature)
    tampered[6] = dataclasses.replace(road_sets[6], signature=road_sets[5].signature)
    shard_cache, finish_cache = bv._SHARD_GRAPHS, bv._SHARD_FINISH_GRAPHS
    out = {"devices": [str(d) for d in devs], "gpus": n_gpu, "shard_class": k}
    steps = {}  # wall s of each step of the phase

    def verify(sets):
        base = dp.prep_launches_total()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = bv.verify_signature_sets_sharded(sets, devs)
        wall = time.perf_counter() - t0
        if dp.prep_launches_total() - base != n_shards + 1:
            fail(f"sharded: a verify made {dp.prep_launches_total() - base} dispatches, not "
                 f"{n_shards + 1}")
        return ok, wall

    # the single launch's verdict on the tampered copy, and the capture of
    # the pool's shard class for (e) (`warm_sharded`, as a serving process
    # with a collective would): both before the sharded road's run, whose
    # replay counts hold only sharded verifies and the pool's sharded road
    t0 = time.perf_counter()
    single_bad = bv.verify_sets_single_launch(tampered, device=devs[0])
    steps["single_tampered"] = time.perf_counter() - t0
    if n_gpu > 1:
        lanes = [MeshLane(i, bv.make_lane_verify_fn(i),
                          verify_prepared_fn=bv.make_lane_verify_prepared_fn(i),
                          device=torch.device("cuda", i)) for i in range(2)]
        collective = bv.make_mesh_sharded_fn()
    else:
        lanes = [MeshLane(i, bv.make_lane_verify_fn(0, dev),
                          verify_prepared_fn=bv.make_lane_verify_prepared_fn(0, dev),
                          device=dev) for i in range(2)]
        collective = bv.make_mesh_sharded_fn(devices=[dev, dev])
    pool_devs = [lane.device for lane in lanes]
    t0 = time.perf_counter()
    warmed = bv.warm_sharded(pool_devs, [BATCH])
    pool_warm_s = steps["pool_warm"] = time.perf_counter() - t0
    say(f"sharded: warm_sharded({[str(d) for d in pool_devs]}, [{BATCH}]) captured "
        f"{sorted(warmed)} in {pool_warm_s:.2f} s")

    # (a) verdicts, against the single launch's on the same sets
    t0 = time.perf_counter()
    fp_cuda.reset_launches()
    graphs.reset_replayed()  # the sharded road's run starts here
    ok, first_s = verify(road_sets)
    if ok is not True:
        fail(f"sharded: the {merged} sets verified {ok} (phase 6's single launch: True)")
    ok_bad, _ = verify(tampered)
    if ok_bad is not False or single_bad is not False:
        fail(f"sharded: the tampered copy verified {ok_bad} sharded, {single_bad} single launch")
    walls = []
    for i in range(TIMED_RUNS):
        ok, wall = verify(road_sets)  # fresh blinding each time
        if ok is not True:
            fail(f"sharded: timed run {i} verified {ok}")
        walls.append(wall)
    mean = sum(walls) / len(walls)
    steps["a"] = time.perf_counter() - t0
    out.update({"first_s": first_s, "walls_s": walls, "sigs_per_s": merged / mean})
    say(f"sharded: (a) {merged} sets True (first call {first_s:.2f} s), the "
        f"tampered copy False, as the single launch says; x{TIMED_RUNS} bytes to verdict "
        f"{', '.join(f'{w:.3f}' for w in walls)} s, {merged / mean:.1f} sigs/s on {n_gpu} "
        f"GPU(s) (phase 6's single launch of {BATCH * MERGE_JOBS} sets "
        f"{single['sigs_per_s']:.1f}) on {smi}")

    # (e) the pool's sharded road over two lanes, the real collective
    t0 = time.perf_counter()
    mesh = VerifierMesh(lanes, sharded_fn=collective)
    jobs = [merged_sets[i * BATCH:(i + 1) * BATCH] for i in range(SHARD_POOL_JOBS)]
    bad_job = list(jobs[0])
    bad_job[3] = dataclasses.replace(jobs[0][3], signature=jobs[0][4].signature)
    captures = shard_cache.captures + finish_cache.captures
    eager_before = dict(fp_cuda.LAUNCHES)

    async def serve():
        pool = BlsDeviceVerifierPool(mesh=mesh, scheduler_enabled=True)
        opts = VerifySignatureOpts(priority=PriorityClass.RANGE_SYNC)
        t0 = time.perf_counter()
        got = list(await asyncio.gather(*(pool.verify_signature_sets(j, opts) for j in jobs)))
        wall = time.perf_counter() - t0
        counts = dict(pool.metrics)
        bad = await pool.verify_signature_sets(bad_job, opts)
        after_bad = dict(pool.metrics)
        await pool.close()
        return got, wall, counts, bad, after_bad

    got, pool_wall, counts, bad, after_bad = asyncio.run(serve())
    replayed = dict(graphs.REPLAYED)  # the sharded road's run ends here
    steps["e"] = time.perf_counter() - t0
    if got != [True] * SHARD_POOL_JOBS:
        fail(f"sharded: (e) the pool gave {got}")
    if counts["sharded_launches"] != SHARD_POOL_JOBS or counts["sharded_fallbacks"] != 0:
        fail(f"sharded: (e) {counts['sharded_launches']} sharded launches and "
             f"{counts['sharded_fallbacks']} fallbacks, not {SHARD_POOL_JOBS} and 0")
    if bad is not False or after_bad["batch_retries"] - counts["batch_retries"] != 1 \
            or after_bad["sharded_fallbacks"] != 0:
        fail(f"sharded: (e) the job with a bad signature gave {bad} "
             f"({after_bad['batch_retries'] - counts['batch_retries']} retries, "
             f"{after_bad['sharded_fallbacks']} fallbacks)")
    if mesh.sharded_breaker._failures or any(lane.breaker._failures for lane in lanes):
        fail("sharded: (e) a breaker shows a failure")
    if shard_cache.captures + finish_cache.captures != captures:
        fail("sharded: (e) a graph was captured while the pool served")
    if dict(fp_cuda.LAUNCHES) != eager_before:
        fail("sharded: (e) eager kernel launches while the pool served")
    missing = [name for name in fp_cuda.KERNELS if replayed[name] <= 0]
    if missing:
        fail(f"sharded: kernels never launched by a replay on the sharded road: {missing}")
    out["pool"] = {"jobs": SHARD_POOL_JOBS, "sets": SHARD_POOL_JOBS * BATCH, "wall_s": pool_wall,
                   "sigs_per_s": SHARD_POOL_JOBS * BATCH / pool_wall, "warm_s": pool_warm_s,
                   "metrics": after_bad}
    say(f"sharded: (e) pool over 2 lanes ({[str(d) for d in pool_devs]}), the real collective: "
        f"{SHARD_POOL_JOBS} range-sync jobs of {BATCH} all True in {pool_wall:.3f} s "
        f"({SHARD_POOL_JOBS * BATCH / pool_wall:.1f} sigs/s), {counts['sharded_launches']} "
        f"sharded launches (shard class {BATCH // 2}), {counts['sharded_fallbacks']} fallbacks; "
        f"one bad signature: False through the per-job retry on one lane; no capture, no eager "
        f"launch while serving (class captured beforehand by warm_sharded in {pool_warm_s:.2f} "
        f"s) on {smi}")
    say(f"sharded: Fp launches replayed over the road {replayed}")
    out["replayed"] = replayed

    # (b) the graph road's partials against the eager road's, the same bits
    t0 = time.perf_counter()
    si = bv.prepare_single_launch_inputs(road_sets, size=size)
    parts = bv._shard_replays(si, devs)
    inputs = bv.build_device_inputs(road_sets, size=size, device=devs[0], coeff_bits=si.bits,
                                    prep="on")
    eager = bv._eager_shard_partials(devs, *inputs)
    h = inputs[1]
    for i, (g_part, e_part) in enumerate(zip(parts, eager)):
        for j, (a, b) in enumerate(zip(g_part[:4], e_part)):
            if not torch.equal(a, b.cpu()):
                fail(f"sharded: (b) shard {i}'s partial {j} differs between the graph road and "
                     f"the eager road")
    if not (torch.equal(parts[0][4], h[0][0].cpu()) and torch.equal(parts[0][5], h[1][0].cpu())):
        fail("sharded: (b) the finish's placeholder point differs between the roads")
    eager_ok = bool(bv._shard_finish(*bv._gather_partials(eager, (h[0][0], h[1][0]), devs[0])))
    graph_ok = bool(bv._finish_launch(parts, devs[0]))
    if not (eager_ok and graph_ok and all(bool(p[6]) for p in parts)):
        fail(f"sharded: (b) finish verdicts graph {graph_ok}, eager {eager_ok}")
    say(f"sharded: (b) {n_shards} shards' partials (Fp12 product, Jacobian G2 sum) limb-equal "
        f"between the graph road and device_batch_verify_sharded's eager road on the same "
        f"bits; both finishes True")

    steps["b"] = time.perf_counter() - t0

    # (c) every Fp launch of the shard and finish graphs at a checked row count
    t0 = time.perf_counter()
    shard_graphs = {key: g for key, g in shard_cache.graphs.items()}
    finish_graphs = {key: g for key, g in finish_cache.graphs.items()}
    rows = {n for g in (*shard_graphs.values(), *finish_graphs.values())
            for by in g.rows.values() for n in by}
    stray = sorted(rows - set(N_KERNEL_CHECK))
    if stray:
        if n_shards == 2:
            fail(f"sharded: (c) graphs launched kernels at row counts phase 3 did not check: "
                 f"{stray}")
        check_kernels(dev, stray)
        say(f"sharded: (c) {n_shards} shards launch at row counts outside SHARD_ROWS: {stray}; "
            f"each kernel checked bit for bit there")
    say(f"sharded: (c) every Fp launch of the shard and finish graphs at a row count checked "
        f"({len(rows)} row counts)")

    # (d) the graphs and their replay times
    out["graphs"] = {}
    for label, cache in (("shard", shard_graphs), ("finish", finish_graphs)):
        for (idx, n), g in sorted(cache.items()):
            ms = replay_ms(g)
            info = {**{key: v for key, v in g.info().items() if key != "rows"},
                    "replay_ms": ms, "launches": g.launches}
            out["graphs"][f"{label}_{idx}_{n}"] = info
            say(f"sharded: (d) {label} graph cuda:{idx} class {n}: capture {g.capture_s:.2f} s, "
                f"instantiate {g.instantiate_s:.2f} s, {g.nodes} nodes, pool "
                f"{g.pool_bytes / 2**20:.1f} MiB, replay {ms:.1f} ms (CUDA events), Fp "
                f"launches per replay {sum(g.launches.values())} on {smi}")
    steps["c_d"] = time.perf_counter() - t0
    out["steps_s"] = steps
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"sharded: phase {out['phase_s']:.1f} s; steps (s) "
        f"{json.dumps({key: round(v, 1) for key, v in steps.items()})}")
    return out


# --- phase 8 -----------------------------------------------------------------
# The state hashTreeRoot at BASELINE config 4's size. The HTR path has no
# hand kernel (the JAX package's `ops/sha256.py` is plain XLA): each level
# is one CUDA-graph replay of plain PyTorch word ops per pow-2 pair class.

HTR_TREE_DEPTH = 20  # (a) merkle_root_device on 2^20 chunks
HTR_TREE_TIMED = 1
HTR_STACK_DEPTH = 18  # (b) the collector: a 2^18-chunk stack ...
HTR_DIRTY = 4096  # ... and 4096 dirty chunks per flush
HTR_FLUSHES = 1
HTR_VALIDATORS = 1 << 20  # (c) a mainnet Capella BeaconState
HTR_ROUNDS = 1  # epoch-boundary rounds, and as many slot-shaped rounds
# The least int32 operations one pair hash needs (a 64-byte message, two
# compressions), with a rotation as one funnel shift: a round is Sigma1
# (3 rotations, 2 xors), Ch (3), T1 (4 adds), Sigma0 (5), Maj (4) and the
# two new words (3 adds), 24; a scheduled word is sigma0 and sigma1 (5
# each) and 3 adds, 13; the data block schedules 48 words, the padding
# block's schedule is a constant; each compression ends with 8 adds.
SHA_OPS_PER_PAIR = 2 * (64 * 24 + 8) + 48 * 13


def htr_bound(pairs):
    """(least ms for `pairs` pair hashes on the card, "bytes" or
    "operations"): 64 bytes read and 32 written per pair."""
    t_ops = pairs * SHA_OPS_PER_PAIR / INT32_MAD_PER_S * 1e3
    t_bytes = pairs * 96 / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def host_root(chunks, native=False):
    """Root of a complete tree of (N, 32) chunks on the host: with hashlib,
    or with the host hasher `ssz.hash` routes to (`native=True`)."""
    from lodestar_tpu_torch.ssz.hash import hash_nodes_cpu, hash_nodes_hashlib

    hasher = hash_nodes_cpu if native else hash_nodes_hashlib
    level = chunks
    while level.shape[0] > 1:
        level = hasher(level)
    return level[0].tobytes()


def host_hasher_rates(chunks, expect, host_s, smi):
    """The host hasher (`ssz.hash.hash_nodes_cpu`, native when built) on the
    2^20-chunk tree and on one 2,047-pair level, the largest a state root
    hashes on the host, beside hashlib's rate in the same run; the native
    root must equal hashlib's."""
    from lodestar_tpu_torch import native
    from lodestar_tpu_torch.ssz.hash import hash_nodes_cpu, hash_nodes_hashlib

    backend = native.sha256_backend()
    if backend == "unavailable":
        fail("htr: the native host hasher is unavailable")
    n = chunks.shape[0]
    t0 = time.perf_counter()
    root = host_root(chunks, native=True)
    tree_s = time.perf_counter() - t0
    if root != expect:
        fail("htr: the native host hasher's tree root differs from hashlib's")
    level = chunks[:2 * 2047]
    reps = {"native": 200, "hashlib": 5}
    level_s = {}
    for name, fn in (("native", hash_nodes_cpu), ("hashlib", hash_nodes_hashlib)):
        t0 = time.perf_counter()
        for _ in range(reps[name]):
            out = fn(level)
        level_s[name] = (time.perf_counter() - t0) / reps[name]
        if out.tobytes() != hash_nodes_hashlib(level).tobytes():
            fail(f"htr: the {name} host level differs from hashlib's")
    rates = {"backend": backend, "tree_s": tree_s, "tree_pair_hashes_per_s": (n - 1) / tree_s,
             "hashlib_tree_pair_hashes_per_s": (n - 1) / host_s,
             "level_pairs": 2047,
             "level_pair_hashes_per_s": {k: 2047 / v for k, v in level_s.items()}}
    say(f"htr: (a) host hasher backend {backend}: tree {tree_s:.3f} s, {(n - 1) / tree_s:.4g} "
        f"pair-hashes/s beside hashlib's {(n - 1) / host_s:.4g}/s (root == hashlib's); a "
        f"2,047-pair host level {2047 / level_s['native']:.4g}/s beside hashlib's "
        f"{2047 / level_s['hashlib']:.4g}/s; on {smi}")
    return rates


@contextlib.contextmanager
def host_only_htr():
    """Every hash on the host (the host hasher `ssz.hash` routes to), through
    the incremental state-root tracker (mode "on" on the CPU, every level
    under the device floors); fails if anything launched on a device
    meanwhile."""
    from lodestar_tpu_torch.ssz import device_htr as dh
    from lodestar_tpu_torch.ssz import hash as ssz_hash

    prev_mode = dh.configure_device_htr(mode="on")
    prev_dev, prev_flush = dh._htr_device, dh.DEVICE_MIN_FLUSH_PAIRS
    prev_min = ssz_hash.DEVICE_MIN_PAIRS
    dh.configure_device_htr(device="cpu")
    ssz_hash.DEVICE_MIN_PAIRS = dh.DEVICE_MIN_FLUSH_PAIRS = 1 << 62
    launches = dh.launch_count()
    try:
        yield
    finally:
        ssz_hash.DEVICE_MIN_PAIRS, dh.DEVICE_MIN_FLUSH_PAIRS = prev_min, prev_flush
        dh.configure_device_htr(mode=prev_mode, device=prev_dev)
    if dh.launch_count() != launches:
        fail("the host-only state roots launched on a device")


def htr_replays(dev):
    """{pair class: replays} of the level graphs on `dev`."""
    from lodestar_tpu_torch.ssz import device_htr as dh

    return {size // 2: g.replays for (idx, size), g in sorted(dh.HTR_GRAPHS.graphs.items())
            if idx == dev.index}


def replays_since(before, dev):
    now = htr_replays(dev)
    return {c: now[c] - before.get(c, 0) for c in now if now[c] != before.get(c, 0)}


def graph_info(g):
    """A graph's capture and instantiate s, nodes and pool bytes (an HTR
    graph launches no Fp kernel, so its rows are left out)."""
    return {k: v for k, v in g.info().items() if k != "rows"}


def replay_device_ms(g, reps=3):
    """Device time of one replay of a captured graph (CUDA events)."""
    import torch

    with torch.cuda.stream(g.stream):
        g.graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            g.graph.replay()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def htr_tree(dev, smi):
    """(a) `merkle_root_device` on 2^20 random chunks (bench.py's seed 0) as
    one launch through `device_htr.merkle_root`: 1 warm-up with the capture,
    then HTR_TREE_TIMED timed; the root equals hashlib's."""
    import numpy as np
    import torch

    from lodestar_tpu_torch.ssz import device_htr as dh

    n = 1 << HTR_TREE_DEPTH
    words = np.random.default_rng(0).integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    chunks = np.frombuffer(words.astype(">u4").tobytes(), dtype=np.uint8).reshape(n, 32).copy()
    t0 = time.perf_counter()
    expect = host_root(chunks)
    host_s = time.perf_counter() - t0
    base = dh.launch_count()
    t0 = time.perf_counter()
    first = dh.merkle_root(chunks)
    first_s = time.perf_counter() - t0
    g = dh.ROOT_GRAPHS.graphs[(dev.index, n)]
    times = []
    for i in range(HTR_TREE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        root = dh.merkle_root(chunks)
        times.append(time.perf_counter() - t0)
        if root != expect:
            fail(f"htr: tree root of timed run {i} differs from hashlib's")
    if first != expect:
        fail("htr: the 2^20-chunk tree root differs from hashlib's")
    if dh.launch_count() - base != 1 + HTR_TREE_TIMED or g.replays != 1 + HTR_TREE_TIMED:
        fail(f"htr: the tree made {dh.launch_count() - base} launches and {g.replays} replays, "
             f"not {1 + HTR_TREE_TIMED} of each")
    mean = sum(times) / len(times)
    dev_ms = replay_device_ms(g)
    bound_ms, bound_by = htr_bound(n - 1)
    out = {"chunks": n, "first_s": first_s, "times_s": times, "pair_hashes_per_s": (n - 1) / mean,
           "replay_device_ms": dev_ms, "device_pair_hashes_per_s": (n - 1) / dev_ms * 1e3,
           "bound_ms": bound_ms, "bound_by": bound_by, "hashlib_s": host_s, **graph_info(g),
           "host_hasher": host_hasher_rates(chunks, expect, host_s, smi)}
    say(f"htr: (a) tree of {n} chunks == hashlib root; first call {first_s:.2f} s (eager "
        f"warm-up, capture {g.capture_s:.2f} s, instantiate {g.instantiate_s:.2f} s, one "
        f"replay); {g.nodes} nodes; pool {g.pool_bytes / 2**20:.1f} MiB")
    say(f"htr: (a) x{HTR_TREE_TIMED} bytes in to root out: {', '.join(f'{t:.4f}' for t in times)} "
        f"s, {(n - 1) / mean:.4g} pair-hashes/s; replay alone {dev_ms:.2f} ms device, "
        f"{out['device_pair_hashes_per_s']:.4g} pair-hashes/s; bound {bound_ms:.3f} ms "
        f"({bound_by}); hashlib on one host core {host_s:.2f} s, {(n - 1) / host_s:.4g}/s; "
        f"on {smi}")
    return out


def htr_collector(dev, smi):
    """(b) the collector at the state_htr_rate shape: a 2^18-chunk stack, 4096
    dirty chunks a flush, HTR_FLUSHES flushes, each on the device with at
    most one launch per level; the stack's root equals hashlib's."""
    import numpy as np

    from lodestar_tpu_torch.ssz import device_htr as dh

    n = 1 << HTR_STACK_DEPTH
    rng = np.random.default_rng(51)
    levels = [np.zeros((n >> k, 32), dtype=np.uint8) for k in range(HTR_STACK_DEPTH + 1)]
    levels[0][:] = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    captures = dh.HTR_GRAPHS.captures
    cold = dh.DirtyCollector()
    cold.add_stack_job(levels, range(n))
    t0 = time.perf_counter()
    cold_stats = cold.flush()
    cold_s = time.perf_counter() - t0
    if levels[-1][0].tobytes() != host_root(levels[0]):
        fail("htr: the collector's cold stack root differs from hashlib's")
    say(f"htr: (b) cold flush of {n} chunks: {cold_s:.2f} s, {cold_stats['launches']} launches, "
        f"{dh.HTR_GRAPHS.captures - captures} graphs captured")
    captures = dh.HTR_GRAPHS.captures
    times, launches = [], []
    before = htr_replays(dev)
    for it in range(HTR_FLUSHES):
        dirty = rng.choice(n, size=HTR_DIRTY, replace=False)
        levels[0][dirty] ^= np.uint8(1 + it)
        coll = dh.DirtyCollector()
        coll.add_stack_job(levels, dirty)
        t0 = time.perf_counter()
        stats = coll.flush()
        times.append(time.perf_counter() - t0)
        launches.append(stats["launches"])
        if stats["backend"] != "device" or not 0 < stats["launches"] <= HTR_STACK_DEPTH:
            fail(f"htr: collector flush {it}: {stats}")
    if levels[-1][0].tobytes() != host_root(levels[0]):
        fail("htr: the collector's stack root differs from hashlib's after the flushes")
    if dh.HTR_GRAPHS.captures != captures:
        fail("htr: the collector's timed flushes captured a graph")
    mean = sum(times) / len(times)
    replays = replays_since(before, dev)
    say(f"htr: (b) {HTR_FLUSHES} flushes of {HTR_DIRTY} dirty chunks: "
        f"{', '.join(f'{t:.4f}' for t in times)} s, {HTR_DIRTY / mean:.4g} chunks/s; launches "
        f"{launches}, replays by pair class {replays}; root == hashlib's; on {smi}")
    return {"chunks": n, "dirty": HTR_DIRTY, "times_s": times, "chunks_per_s": HTR_DIRTY / mean,
            "launches": launches, "replays_by_class": replays, "cold_s": cold_s}


def htr_state(dev, smi):
    """(c) a mainnet Capella BeaconState of HTR_VALIDATORS validators, filled
    as `epoch_htr_replay` fills it: a cold root, HTR_ROUNDS epoch-boundary
    rounds, HTR_ROUNDS slot-shaped rounds and one profiled epoch round,
    each root through `state_hash_tree_root` equal to a second tracker's on
    the same state that hashes on the host only (no launch)."""
    import numpy as np
    import torch

    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.ssz import device_htr as dh
    from lodestar_tpu_torch.state_transition import StateRootTracker, state_hash_tree_root
    from lodestar_tpu_torch.types import ssz_types

    p = params.MAINNET
    t = ssz_types(p)
    n = HTR_VALIDATORS
    t0 = time.perf_counter()
    state = t.capella.BeaconState.default()
    vs = []
    for i in range(n):
        v = t.Validator.default()
        v.pubkey = (i.to_bytes(8, "little") * 6)[:48]
        v.effective_balance = 32_000_000_000
        v.exit_epoch = 2**64 - 1
        v.withdrawable_epoch = 2**64 - 1
        vs.append(v)
    state.validators = vs
    state.balances = [32_000_000_000] * n
    state.previous_epoch_participation = [1] * n
    state.current_epoch_participation = [3] * n
    state.inactivity_scores = [0] * n
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(52)

    def epoch_mutation(round_):
        state.slot = int(state.slot) + p.SLOTS_PER_EPOCH
        state.balances = [int(x) for x in rng.integers(31_000_000_000, 33_000_000_000, size=n)]
        state.previous_epoch_participation = state.current_epoch_participation
        state.current_epoch_participation = [0] * n
        state.randao_mixes[round_ % len(state.randao_mixes)] = bytes(
            rng.integers(0, 256, size=32, dtype=np.uint8))
        state.slashings[round_ % len(state.slashings)] = int(rng.integers(0, 2**40))
        for i in rng.integers(0, n, size=8):
            state.validators[int(i)].effective_balance = int(rng.integers(0, 2**40))

    def slot_mutation(round_):
        state.slot = int(state.slot) + 1
        for i in rng.integers(0, n, size=4):
            state.balances[int(i)] = int(rng.integers(31_000_000_000, 33_000_000_000))
        k = int(state.slot) % p.SLOTS_PER_HISTORICAL_ROOT
        state.state_roots[k] = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
        state.block_roots[k] = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
        state.validators[int(rng.integers(0, n))].effective_balance = int(rng.integers(0, 2**40))

    flushes = []  # every collector flush's stats, in order
    real_flush = dh.DirtyCollector.flush

    def logged_flush(self):
        stats = real_flush(self)
        flushes.append(stats)
        return stats

    ref = StateRootTracker(state.type)
    rounds = []

    def root_round(label, mutate=None, run=None):
        if mutate is not None:
            mutate()
        del flushes[:]
        launches, replays, captures = dh.launch_count(), htr_replays(dev), dh.HTR_GRAPHS.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run is None:
            root = state_hash_tree_root(state)
            extra = {}
        else:
            root, extra = run()
        wall = time.perf_counter() - t0
        (stats,) = flushes
        launched = dh.launch_count() - launches
        rec = {"round": label, "wall_s": wall, "flush_s": stats["seconds"],
               "prepare_s": wall - stats["seconds"], "levels": stats["levels"],
               "dirty_chunks": stats["dirty_chunks"], "flush_launches": stats["launches"],
               "prepare_launches": launched - stats["launches"],
               "replays_by_class": replays_since(replays, dev),
               "captures": dh.HTR_GRAPHS.captures - captures, **extra}
        with host_only_htr():
            t0 = time.perf_counter()
            want, _ = ref.root(state)
            rec["reference_s"] = time.perf_counter() - t0
        if root != want:
            fail(f"htr: the {label} root differs from the host-only tracker's")
        if stats["backend"] != "device" or stats["launches"] > stats["levels"]:
            fail(f"htr: the {label} flush: {stats}")
        # the validators' element re-rooting launches once per level of its
        # container tree at most: 3 field levels and the pubkey's
        if rec["prepare_launches"] > 4:
            fail(f"htr: the {label} round's prepare made {rec['prepare_launches']} launches")
        if sum(rec["replays_by_class"].values()) != launched:
            fail(f"htr: the {label} round made {launched} launches but replays "
                 f"{rec['replays_by_class']}")
        say(f"htr: (c) {label}: root == host tracker's; wall {wall:.3f} s = host prepare "
            f"{rec['prepare_s']:.3f} s + flush {stats['seconds']:.3f} s; {stats['levels']} "
            f"levels, {stats['dirty_chunks']} dirty chunks; launches {stats['launches']} in the "
            f"flush, {rec['prepare_launches']} in prepare; replays by pair class "
            f"{rec['replays_by_class']}; captures {rec['captures']}; host-only reference "
            f"{rec['reference_s']:.3f} s")
        rounds.append(rec)
        return rec

    dh.DirtyCollector.flush = logged_flush
    try:
        say(f"htr: (c) mainnet Capella BeaconState with {n} validators built in {setup_s:.1f} s")
        cold = root_round("cold")
        for r in range(HTR_ROUNDS):
            rec = root_round(f"epoch {r + 1}", lambda r=r: epoch_mutation(r + 1))
            if rec["flush_launches"] == 0:
                fail(f"htr: epoch round {r + 1} made no device launch")
        for r in range(HTR_ROUNDS):
            root_round(f"slot {r + 1}", lambda r=r: slot_mutation(r + 1))

        def run_profiled():
            root, prof_wall_ms, events = profiled(lambda: state_hash_tree_root(state))
            return root, {"prof_wall_ms": prof_wall_ms, "busy_ms": busy_ms(events),
                          "device_events": len(device_events(events))}

        prof = root_round("epoch profiled", lambda: epoch_mutation(HTR_ROUNDS + 1), run_profiled)
    finally:
        dh.DirtyCollector.flush = real_flush
    later = [r for r in rounds if r["round"] != "cold"]
    if any(r["captures"] for r in later):
        fail(f"htr: graphs were captured after the cold root: {[r['captures'] for r in later]}")
    epoch_wall = [r["wall_s"] for r in rounds if r["round"].startswith("epoch ")
                  and r is not prof]
    mean_ms = 1e3 * sum(epoch_wall) / len(epoch_wall)
    if prof["busy_ms"] == 0:
        say("htr: (d) profiled epoch round: device busy time not measured (no device events)")
    else:
        say(f"htr: (d) profiled epoch round: device busy {prof['busy_ms']:.1f} ms over "
            f"{prof['device_events']} device events; idle {100 * (1 - prof['busy_ms'] / mean_ms):.1f}% "
            f"of an unprofiled epoch round's {mean_ms:.1f} ms ({100 * (1 - prof['busy_ms'] / prof['prof_wall_ms']):.1f}% "
            f"of the profiled {prof['prof_wall_ms']:.1f} ms) on {smi}")
    prof["idle"] = 1 - prof["busy_ms"] / mean_ms if prof["busy_ms"] else None
    return {"validators": n, "setup_s": setup_s, "rounds": rounds,
            "cold_captures": cold["captures"]}


def htr_graphs(dev, smi):
    """(d) every level graph captured: capture and instantiate s, nodes,
    pool MiB, one replay's device time beside its bound."""
    from lodestar_tpu_torch.ssz import device_htr as dh

    out = {}
    for (idx, size), g in sorted(dh.HTR_GRAPHS.graphs.items()):
        if idx != dev.index:
            continue
        pairs = size // 2
        ms = replay_device_ms(g)
        bound_ms, bound_by = htr_bound(pairs)
        out[pairs] = {**graph_info(g), "replay_device_ms": ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "replays": g.replays}
        say(f"htr: (d) pair class {pairs}: capture {g.capture_s:.2f} s, instantiate "
            f"{g.instantiate_s:.2f} s, {g.nodes} nodes, pool {g.pool_bytes / 2**20:.1f} MiB, "
            f"replay {ms:.3f} ms device (bound {bound_ms:.4f} ms, {bound_by}), "
            f"{g.replays} replays")
    pools = sum(c["pool_bytes"] for c in out.values()) + sum(
        g.pool_bytes for (idx, _), g in dh.ROOT_GRAPHS.graphs.items() if idx == dev.index)
    say(f"htr: (d) {len(out)} level graphs and {len(dh.ROOT_GRAPHS.graphs)} tree graph: pools "
        f"{pools / 2**20:.1f} MiB in all; card memory reserved "
        f"{__import__('torch').cuda.memory_reserved(dev) / 2**30:.2f} GiB on {smi}")
    return {"classes": out, "pools_bytes": pools}


def htr(dev, smi):
    """Phase 8: the state hashTreeRoot on the card. Launch counts and
    replays are read around every part; returns their figures."""
    from lodestar_tpu_torch.ssz import device_htr as dh

    if not dh.device_htr_active():
        fail("htr: device hashing is not the default on the card")
    dh.configure_device_htr(device=dev)
    t0 = time.perf_counter()
    out = {"tree": htr_tree(dev, smi), "collector": htr_collector(dev, smi),
           "state": htr_state(dev, smi), "graphs": htr_graphs(dev, smi)}
    out["phase_s"] = time.perf_counter() - t0
    say(f"htr: phase {out['phase_s']:.1f} s")
    return out


# --- phase 9 -----------------------------------------------------------------
# KZG blob commitments and proof checks (`crypto/kzg.py`) at a mainnet block:
# MAX_BLOBS_PER_BLOCK = 4 blobs of FIELD_ELEMENTS_PER_BLOB = 4,096 elements.
# The commitment's 4,096-point G1 MSM and every pairing-product check are one
# CUDA-graph replay each (classes 4,096 and 2), on the five Fp kernels.

KZG_TIMED = 1  # timed commitments after the warm-up
KZG_SEED = 4844


def kzg_rows_on_meta():
    """{"msm": ..., "check": ...}: the row counts of the two KZG graph bodies
    at their classes (4,096 setup points and 255 bits; 2 pairs), counted on
    the CPU by `count_on_meta` (~75 s)."""
    import numpy as np

    from lodestar_tpu_torch.crypto import kzg as K
    from lodestar_tpu_torch.ops import fp, msm

    n = K.FIELD_ELEMENTS_PER_BLOB_MAINNET
    limbs = np.zeros((n, fp.LIMBS), np.int32)
    bits = np.zeros((n, K.SCALAR_BITS), np.int32)
    g1, g2 = np.zeros((2, fp.LIMBS), np.int32), np.zeros((2, 2, fp.LIMBS), np.int32)
    return {"msm": count_on_meta(msm.msm_g1_body, (limbs, limbs, bits)),
            "check": count_on_meta(K._pairing_graph_body, (g1, g1, g2, g2, np.ones(2, bool)))}


def random_blob(rng):
    """A mainnet blob: 4,096 little-endian field elements below r."""
    from lodestar_tpu_torch.crypto import kzg as K

    return b"".join((int.from_bytes(rng.bytes(32), "little") % K.R).to_bytes(32, "little")
                    for _ in range(K.FIELD_ELEMENTS_PER_BLOB_MAINNET))


def replay_bound(g):
    """(least ms of one replay of graph `g` on the card, "bytes" or
    "operations"): the int32 multiply-adds of its Fp launches
    ({kernel: {rows: launches}}, counted at capture) over the card's rate,
    or its inputs read once and outputs written once over HBM's."""
    macs = sum(c * n * work_per_row(k)[0] for k, by in g.rows.items() for n, c in by.items())
    nbytes = sum(t.numel() * t.element_size() for t in (*g.inputs, *g.outputs))
    t_ops, t_bytes = macs / INT32_MAD_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def dispatch_seconds(programs, since):
    """Wall seconds of the counted dispatches of `programs` recorded by the
    launch telemetry after sequence number `since`."""
    from lodestar_tpu_torch import telemetry

    with telemetry._lock:
        return sum(e["seconds"] for e in telemetry._ledger
                   if e["seq"] > since and e["program"] in programs)


def _oracle_commitment(blob):
    """The host oracle's KZG commitment of `blob` and its wall s (a worker of
    phase 9, which runs it beside the card's commitments)."""
    from lodestar_tpu_torch.crypto import kzg as K

    t0 = time.perf_counter()
    commitment = K.blob_to_kzg_commitment(blob, oracle=True)
    return commitment, time.perf_counter() - t0


def kzg(dev, smi):
    """Phase 9: KZG at a mainnet block of MAX_BLOBS_PER_BLOCK blobs. Launch counts and
    replays are reset just before the path and read just after; every
    kernel must have been launched. Lines start `kzg:`."""
    import multiprocessing

    import numpy as np
    import torch

    from lodestar_tpu_torch import graphs, params, telemetry
    from lodestar_tpu_torch.crypto import kzg as K
    from lodestar_tpu_torch.crypto.bls import curve as C
    from lodestar_tpu_torch.crypto.bls.pairing import pairings_are_one
    from lodestar_tpu_torch.crypto.bls.serdes import g1_to_bytes
    from lodestar_tpu_torch.ops import fp_cuda

    t_phase = time.perf_counter()
    n = params.MAINNET.FIELD_ELEMENTS_PER_BLOB
    n_blobs = params.MAINNET.MAX_BLOBS_PER_BLOCK
    rng = np.random.default_rng(KZG_SEED)
    out = {}
    fp_cuda.reset_launches()
    graphs.reset_replayed()  # the KZG path's run starts here

    # (b) the setup, and its limbs onto the card once
    t0 = time.perf_counter()
    g1, _ = K.load_trusted_setup()
    out["setup_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    K._points_on(tuple(g1), dev, n)
    torch.cuda.synchronize()
    out["setup_upload_s"] = time.perf_counter() - t0
    say(f"kzg: (b) trusted setup ({len(g1)} G1 points) loaded in {out['setup_load_s']:.2f} s; "
        f"its Montgomery limbs on the card in {out['setup_upload_s']:.3f} s")

    # (c) one commitment: 1 warm-up with the capture, KZG_TIMED timed; the
    # host oracle's commitment of the same blob runs meanwhile on a worker
    # process
    blob = random_blob(rng)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as oracle_pool:
        oracle = oracle_pool.submit(_oracle_commitment, blob)
        t0 = time.perf_counter()
        first = K.blob_to_kzg_commitment(blob)
        out["first_commitment_s"] = time.perf_counter() - t0
        g = K._MSM_GRAPHS.graphs[(dev.index, n)]
        times = []
        for i in range(KZG_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if K.blob_to_kzg_commitment(blob) != first:
                fail(f"kzg: timed commitment {i} differs from the first")
            times.append(time.perf_counter() - t0)
        expect, out["oracle_commitment_s"] = oracle.result()
    if first != expect:
        fail("kzg: the card's blob commitment differs from the host oracle's")
    c = 0x1234567
    if K.blob_to_kzg_commitment(c.to_bytes(32, "little") * n) != g1_to_bytes(C.g1_mul(C.G1_GEN, c)):
        fail("kzg: a constant blob's commitment is not [c]G1")
    msm_ms = replay_device_ms(g)
    msm_bound, msm_by = replay_bound(g)
    mean = sum(times) / len(times)
    out["commitment"] = {"times_s": times, "commitments_per_s": 1 / mean,
                         "replay_device_ms": msm_ms, "bound_ms": msm_bound, "bound_by": msm_by,
                         "fp_launches_per_replay": g.launches,
                         **graph_info(g)}
    say(f"kzg: (c) blob commitment == host oracle's ({out['oracle_commitment_s']:.1f} s on the "
        f"host, once, on a worker process); constant blob == [c]G1; first call {out['first_commitment_s']:.1f} s "
        f"(eager warm-up, capture {g.capture_s:.2f} s, instantiate {g.instantiate_s:.2f} s); "
        f"{g.nodes} nodes; pool {g.pool_bytes / 2**20:.1f} MiB")
    say(f"kzg: (c) x{KZG_TIMED} bytes to commitment (host inverse NTT included): "
        f"{', '.join(f'{t:.3f}' for t in times)} s, {1 / mean:.3f} commitments/s; replay "
        f"{msm_ms:.2f} ms device, bound {msm_bound:.3f} ms ({msm_by}); Fp launches per replay "
        f"{g.launches} on {smi}")

    # (d) the opening checks through the pairing-check graph at class 2
    a, b, z = (int.from_bytes(rng.bytes(31), "little") for _ in range(3))
    line = K.blob_to_kzg_commitment(blob_of_poly([a, b]))
    if line != g1_to_bytes(C.g1_add(C.g1_mul(g1[0], a), C.g1_mul(g1[1], b))):
        fail("kzg: the linear blob's commitment is not [a]G1 + [b][tau]G1")
    proof = g1_to_bytes(C.g1_mul(C.G1_GEN, b))
    y = (a + b * z) % K.R
    const = c.to_bytes(32, "little") * n
    right, wrong = g1_to_bytes(C.g1_mul(C.G1_GEN, c)), g1_to_bytes(C.g1_mul(C.G1_GEN, c + 1))
    zc = K._compute_challenge(const, right)
    yc = K._evaluate_blob_at(K._blob_to_scalars(const), zc)
    zw = K._compute_challenge(const, wrong)
    checks = []
    for label, run, opening, want in (
            ("verify_kzg_proof valid", lambda: K.verify_kzg_proof(line, z, y, proof),
             (line, z, y, proof), True),
            ("verify_kzg_proof y + 1", lambda: K.verify_kzg_proof(line, z, y + 1, proof),
             (line, z, y + 1, proof), False),
            ("verify_blob_kzg_proof valid",
             lambda: K.verify_blob_kzg_proof(const, right, K.G1_INFINITY_BYTES),
             (right, zc, yc, K.G1_INFINITY_BYTES), True),
            ("verify_blob_kzg_proof wrong commitment",
             lambda: K.verify_blob_kzg_proof(const, wrong, K.G1_INFINITY_BYTES),
             (wrong, zw, K._evaluate_blob_at(K._blob_to_scalars(const), zw),
              K.G1_INFINITY_BYTES), False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run()
        wall = time.perf_counter() - t0
        oracle = pairings_are_one(K._opening_pairs(*opening))
        if got is not want or oracle is not want:
            fail(f"kzg: (d) {label}: card {got}, oracle {oracle}, expected {want}")
        checks.append({"check": label, "verdict": got, "wall_s": wall})
    pg = K._PAIRING_GRAPHS.graphs[(dev.index, 2)]
    check_ms = replay_device_ms(pg)
    check_bound, check_by = replay_bound(pg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    K.verify_kzg_proof(line, z, y, proof)
    check_wall_ms = (time.perf_counter() - t0) * 1e3
    ok, prof_wall_ms, events = profiled(lambda: K.verify_kzg_proof(line, z, y, proof))
    busy = busy_ms(events)
    if not ok:
        fail("kzg: (d) the profiled opening check failed")
    out["check"] = {"checks": checks, "replay_device_ms": check_ms, "bound_ms": check_bound,
                    "bound_by": check_by, "wall_ms": check_wall_ms,
                    "busy_ms": busy, "idle": 1 - busy / check_wall_ms if busy else None,
                    "fp_launches_per_replay": pg.launches, **graph_info(pg)}
    walls_s = ", ".join(f"{k['wall_s']:.3f}" for k in checks)
    say(f"kzg: (d) opening checks {[(k['check'], k['verdict']) for k in checks]} == the "
        f"oracle's pairings_are_one on the same pairs; walls {walls_s} s")
    idle = (f"device busy {busy:.2f} ms, idle {100 * (1 - busy / check_wall_ms):.1f}% of the "
            f"unprofiled {check_wall_ms:.1f} ms" if busy else
            "device busy time not measured (no device events)")
    say(f"kzg: (d) pairing-check graph (class 2): capture {pg.capture_s:.2f} s, instantiate "
        f"{pg.instantiate_s:.2f} s, {pg.nodes} nodes, pool {pg.pool_bytes / 2**20:.1f} MiB; "
        f"replay {check_ms:.2f} ms device, bound {check_bound:.4f} ms ({check_by}); Fp launches "
        f"per replay {pg.launches}; one profiled check: {idle} on {smi}")

    # (e) one block: 4 blobs, an aggregate proof and its checks; no capture
    captures = K._MSM_GRAPHS.captures + K._PAIRING_GRAPHS.captures
    replays = g.replays
    blobs = [random_blob(rng) for _ in range(n_blobs)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = K.compute_aggregate_kzg_proof(blobs)
    out["aggregate_proof_s"] = time.perf_counter() - t0
    if g.replays - replays != n_blobs + 1:
        fail(f"kzg: (e) the aggregate proof made {g.replays - replays} MSM replays, "
             f"not {n_blobs + 1}")
    commitments = [K.blob_to_kzg_commitment(bl) for bl in blobs]
    prev_mode = telemetry._mode
    telemetry._mode = "on"  # the dispatch seam times each replay
    try:
        walls = []
        for _ in range(3):
            since = telemetry._seq
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = K.verify_aggregate_kzg_proof(blobs, commitments, proof)
            wall = time.perf_counter() - t0
            if not ok:
                fail("kzg: (e) the block's aggregate proof did not verify")
            dev_s = dispatch_seconds({K._PAIRING_GRAPHS.__name__}, since)
            walls.append({"wall_s": wall, "replay_s": dev_s, "host_s": wall - dev_s})
    finally:
        telemetry._mode = prev_mode
    sw = list(commitments)
    sw[0], sw[1] = sw[1], sw[0]
    swb = list(blobs)
    swb[0], swb[1] = swb[1], swb[0]
    verdicts = {
        "right order": K.verify_aggregate_kzg_proof(blobs, commitments, proof),
        "commitments swapped": K.verify_aggregate_kzg_proof(blobs, sw, proof),
        "blobs swapped": K.verify_aggregate_kzg_proof(swb, commitments, proof),
        "empty, infinity proof": K.verify_aggregate_kzg_proof([], [], K.G1_INFINITY_BYTES),
        "empty, other proof": K.verify_aggregate_kzg_proof([], [], proof),
    }
    if verdicts != {"right order": True, "commitments swapped": False, "blobs swapped": False,
                    "empty, infinity proof": True, "empty, other proof": False}:
        fail(f"kzg: (e) aggregate verdicts {verdicts}")

    class Sidecar:
        beacon_block_slot = 7
        beacon_block_root = b"\x11" * 32

        def __init__(self, proof_):
            self.blobs = blobs
            self.kzg_aggregated_proof = proof_

    K.validate_blobs_sidecar(7, b"\x11" * 32, commitments, Sidecar(proof))
    for label, args in (("slot", (8, b"\x11" * 32, commitments, Sidecar(proof))),
                        ("proof", (7, b"\x11" * 32, commitments, Sidecar(K.G1_INFINITY_BYTES)))):
        try:
            K.validate_blobs_sidecar(*args)
        except K.KzgError as e:
            if label not in str(e):
                fail(f"kzg: (e) validate_blobs_sidecar with a wrong {label} raised {e!r}")
        else:
            fail(f"kzg: (e) validate_blobs_sidecar accepted a wrong {label}")
    if K._MSM_GRAPHS.captures + K._PAIRING_GRAPHS.captures != captures:
        fail("kzg: (e) a graph was captured after (c) and (d)")
    out["block"] = {"blobs": n_blobs, "aggregate_proof_s": out["aggregate_proof_s"],
                    "verify": walls, "verdicts": verdicts}
    say(f"kzg: (e) block of {n_blobs} blobs: compute_aggregate_kzg_proof "
        f"{out['aggregate_proof_s']:.2f} s ({n_blobs + 1} MSM replays); "
        f"verify_aggregate_kzg_proof " + ", ".join(
            f"{w['wall_s']:.3f} s (host {w['host_s']:.3f} + replay {w['replay_s']:.3f})"
            for w in walls) + f"; verdicts {verdicts}; validate_blobs_sidecar passes and raises "
        f"KzgError on a wrong slot and an infinity proof; no capture on {smi}")

    # (a) the row counts every launch of the path used, all checked by phase 3
    launches = dict(fp_cuda.LAUNCHES)
    replayed = dict(graphs.REPLAYED)  # the KZG path's run ends here
    eager_rows = {k: dict(v) for k, v in fp_cuda.ROWS.items()}
    for label, rows in (("the MSM graph", g.rows), ("the pairing-check graph", pg.rows),
                        ("an eager launch", eager_rows)):
        stray = sorted({r for by in rows.values() for r in by} - set(N_KERNEL_CHECK))
        if stray:
            fail(f"kzg: {label} launched a kernel at row counts phase 3 did not check: {stray}")
    missing = [k for k in fp_cuda.KERNELS if launches[k] + replayed[k] == 0]
    if missing:
        fail(f"kzg: kernels never launched on the KZG path: {missing}")
    say(f"kzg: (a) every launch at a row count phase 3 checked (KZG_ROWS); launches on the "
        f"path: eager {launches}, by replays {replayed}")
    out["launches"] = {k: launches[k] + replayed[k] for k in fp_cuda.KERNELS}
    out["msm_rows"], out["check_rows"] = g.rows, pg.rows
    times = graph_times([g.rows, pg.rows], dev)
    out["ms_per_commitment"] = kernel_ms(g.rows, times)
    out["ms_per_check"] = kernel_ms(pg.rows, times)
    for name in fp_cuda.KERNELS:
        say(f"kzg: fp kernel {name}: {g.launches[name]} launches per commitment replay, "
            f"{out['ms_per_commitment'][name]:.2f} ms (graph replay x launches); "
            f"{pg.launches[name]} per check replay, {out['ms_per_check'][name]:.3f} ms")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"kzg: phase {out['phase_s']:.1f} s")
    return out


def blob_of_poly(coeffs):
    """The mainnet blob (bit-reversed evaluation form) of sum_k coeffs[k] x^k."""
    from lodestar_tpu_torch.crypto import kzg as K

    out = bytearray()
    for w in K.compute_roots_of_unity(K.FIELD_ELEMENTS_PER_BLOB_MAINNET):
        v = 0
        for c in reversed(coeffs):
            v = (v * w + c) % K.R
        out += v.to_bytes(32, "little")
    return bytes(out)


# --- phase 10 ----------------------------------------------------------------
# Block import at a mainnet-preset Capella block, in the shape of the JAX
# package's `chain/chain.py:418-485` (the port's `chain.py` is not written
# yet, so the phase composes the package's public functions itself): dial
# the pre-state to the block's slot, collect the block's signature sets,
# then verify them through the verifier pool on the card while an executor
# thread runs the signature-free block transition and roots the post-state.
# The widths are mainnet's (TARGET_COMMITTEE_SIZE 128, SLOTS_PER_EPOCH 32,
# SYNC_COMMITTEE_SIZE 512); only the validator count is cut, because interop
# keys are derived and committee pubkeys decoded on the host (~4.8 ms and
# ~3.3 ms each). At 8,192 validators a slot has 2 committees of 128.
BLOCK_VALIDATORS = 8192
BLOCK_SLOT = 33  # epoch 1's second slot: the upgrades of epoch 1 have run


def _pubkeys_of(scalars):
    """The pubkeys of secret-key scalars (a worker of `pubkeys_on_workers`;
    it imports the host oracle alone, not torch)."""
    from lodestar_tpu_torch.crypto.bls.api import SecretKey

    return [SecretKey(k).to_pubkey() for k in scalars]


def pubkeys_on_workers(sks, workers):
    """The pubkeys of `sks`, derived on `workers` spawned processes (each one
    scalar multiplication on the host oracle)."""
    import multiprocessing

    step = -(-len(sks) // workers)
    chunks = [[sk.scalar for sk in sks[lo:lo + step]] for lo in range(0, len(sks), step)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(chunks), mp_context=ctx) as pool:
        return [pk for chunk in pool.map(_pubkeys_of, chunks) for pk in chunk]


def block_chain_config():
    """Mainnet's chain config with altair, bellatrix and capella all at
    epoch 1 (deneb not scheduled): the block at BLOCK_SLOT is a pre-merge
    Capella block."""
    from lodestar_tpu_torch.config import mainnet_chain_config

    return mainnet_chain_config().replace(ALTAIR_FORK_EPOCH=1, BELLATRIX_FORK_EPOCH=1,
                                          CAPELLA_FORK_EPOCH=1)


def build_block(genesis, sks, p, cfg, slot, attest_from=1):
    """A signed Capella block at `slot` on top of `genesis` (not mutated),
    made with every hash on the host: `unsigned_block`'s body, its state
    root from a host-only run of the block, signed by its proposer. Returns
    (signed block, the dialed host state, its EpochContext)."""
    from lodestar_tpu_torch.state_transition import (
        EpochContext,
        process_block,
        process_slots,
        state_hash_tree_root,
    )

    with host_only_htr():
        work = genesis.copy()
        ctx = process_slots(work, slot, p, cfg)
        block = unsigned_block(work, ctx, sks, p, slot, attest_from)
        post = work.copy()
        process_block(post, block, EpochContext(post, p), verify_signatures=False, cfg=cfg)
        block.state_root = state_hash_tree_root(post)
        signed = sign_block(block, sks[block.proposer_index], work, p)
    return signed, work, ctx


def unsigned_block(work, ctx, sks, p, slot, attest_from, sync=None):
    """The Capella block at `slot` on `work` (dialed to `slot`), its state
    root left zero: its proposer, parent, a randao reveal, the eth1 data, one
    attestation of every committee of slots attest_from..slot-1 (every
    member attesting; its signature is one signature by the sum of the
    committee's secret keys mod r, equal in bytes to the aggregate of the
    members' signatures) and an empty sync aggregate (no participant, the
    G2 infinity signature), or with `sync` "full" or a 32-byte root the
    full one of `full_sync_aggregate`. Slots before `attest_from` get no
    attestation."""
    from lodestar_tpu_torch import params, ssz
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.crypto.bls.fields import R
    from lodestar_tpu_torch.state_transition.util import (
        compute_signing_root,
        get_block_root,
        get_block_root_at_slot,
        get_current_epoch,
        get_domain,
    )
    from lodestar_tpu_torch.types import ssz_types

    t = ssz_types(p)
    epoch = get_current_epoch(work)
    proposer = ctx.get_beacon_proposer(slot)
    block = t.capella.BeaconBlock.default()
    block.slot = slot
    block.proposer_index = proposer
    block.parent_root = t.BeaconBlockHeader.hash_tree_root(work.latest_block_header)
    block.body.randao_reveal = bls.sign(sks[proposer], compute_signing_root(
        ssz.uint64, epoch, get_domain(work, params.DOMAIN_RANDAO)))
    block.body.eth1_data = work.eth1_data
    atts = []
    for s in range(attest_from, slot):
        target = s // p.SLOTS_PER_EPOCH
        for ci in range(ctx.get_committee_count_per_slot(target)):
            committee = ctx.get_beacon_committee(s, ci)
            att = t.Attestation.default()
            att.aggregation_bits = [True] * len(committee)
            att.data.slot = s
            att.data.index = ci
            att.data.beacon_block_root = get_block_root_at_slot(work, s, p)
            att.data.source = (work.current_justified_checkpoint if target == epoch
                               else work.previous_justified_checkpoint)
            cp = t.Checkpoint.default()
            cp.epoch = target
            cp.root = get_block_root(work, target, p)
            att.data.target = cp
            root = compute_signing_root(t.AttestationData, att.data, get_domain(
                work, params.DOMAIN_BEACON_ATTESTER, target))
            summed = bls.SecretKey(sum(sks[int(i)].scalar for i in committee) % R)
            att.signature = bls.sign(summed, root)
            atts.append(att)
    block.body.attestations = atts
    if sync is None:
        block.body.sync_aggregate.sync_committee_bits = [False] * p.SYNC_COMMITTEE_SIZE
        block.body.sync_aggregate.sync_committee_signature = bls.G2_INFINITY
    else:
        block.body.sync_aggregate = full_sync_aggregate(
            work, ctx, sks, p, root=None if sync == "full" else sync)
    return block


def full_sync_aggregate(work, ctx, sks, p, root=None):
    """The sync aggregate of `work`'s whole current sync committee (every
    bit set) over the previous slot's block root under DOMAIN_SYNC_COMMITTEE
    at that slot's epoch, or over `root` (a forgery that still decodes): one
    signature by the sum mod r of the members' secret keys, each counted as
    often as it sits in the committee, equal in bytes to the aggregate of
    the members' signatures."""
    import hashlib

    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.crypto.bls.fields import R
    from lodestar_tpu_torch.state_transition.util import get_block_root_at_slot, get_domain
    from lodestar_tpu_torch.types import ssz_types

    previous = max(int(work.slot), 1) - 1
    if root is None:
        root = get_block_root_at_slot(work, previous, p)
    domain = get_domain(work, params.DOMAIN_SYNC_COMMITTEE, previous // p.SLOTS_PER_EPOCH)
    index = ctx.pubkey_to_index(work)
    members = [index[bytes(pk)] for pk in work.current_sync_committee.pubkeys]
    summed = bls.SecretKey(sum(sks[i].scalar for i in members) % R)
    agg = ssz_types(p).SyncAggregate.default()
    agg.sync_committee_bits = [True] * p.SYNC_COMMITTEE_SIZE
    agg.sync_committee_signature = bls.sign(summed, hashlib.sha256(root + domain).digest())
    return agg


def build_segment(anchor, sks, p, cfg, slots, sync=None):
    """Consecutive signed blocks at `slots` on `anchor` (not mutated), each as
    `build_block` makes it with no attestation, chained on the previous
    block's post-state: one state dialed, built on and rooted in place, every
    hash on the host through its warm tracker. `sync` maps a slot to the
    `unsigned_block` sync argument of its block ("full", or a forged root;
    none: empty aggregates). Returns the signed blocks."""
    from lodestar_tpu_torch.state_transition import (
        EpochContext,
        process_block,
        process_slots,
        state_hash_tree_root,
    )

    out = []
    with host_only_htr():
        state = anchor.copy()
        for slot in slots:
            ctx = process_slots(state, slot, p, cfg)
            block = unsigned_block(state, ctx, sks, p, slot, attest_from=slot,
                                   sync=(sync or {}).get(slot))
            process_block(state, block, EpochContext(state, p), verify_signatures=False, cfg=cfg)
            block.state_root = state_hash_tree_root(state)
            # the block leaves the state's slot and fork, so its proposer domain, as they were
            out.append(sign_block(block, sks[block.proposer_index], state, p))
    return out


def reference_sets(state, signed, ctx, sks, p):
    """The block's signature sets derived from the secret keys, no pubkey
    decoded: the proposer's and the randao reveal's (a registry pubkey each,
    as `get_block_signature_sets` gives them), then per attestation the
    public key of the sum of its attesters' secret keys mod r (equal in
    bytes to the aggregate of their pubkeys), the signing root of its data
    and its signature."""
    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.crypto.bls.fields import R
    from lodestar_tpu_torch.state_transition import signature_sets as ss
    from lodestar_tpu_torch.state_transition.util import compute_signing_root, get_domain
    from lodestar_tpu_torch.types import ssz_types

    t = ssz_types(p)
    body = signed.message.body
    sets = [ss.block_proposer_signature_set(state, signed, ctx),
            ss.randao_signature_set(state, body, ctx)]
    for att in body.attestations:
        attesting = ctx.get_attesting_indices(att.data, att.aggregation_bits)
        summed = bls.SecretKey(sum(sks[int(i)].scalar for i in attesting) % R)
        sets.append(bls.SignatureSet(summed.to_pubkey(), compute_signing_root(
            t.AttestationData, att.data,
            get_domain(state, params.DOMAIN_BEACON_ATTESTER, int(att.data.target.epoch))),
            bytes(att.signature)))
    return sets


def sign_block(block, sk, state, p):
    """The block (of `state`'s fork) signed by `sk` under the proposer domain
    of `state`'s epoch."""
    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.state_transition.block import fork_of
    from lodestar_tpu_torch.state_transition.util import compute_signing_root, get_domain
    from lodestar_tpu_torch.types import ssz_types

    ns = getattr(ssz_types(p), fork_of(state))
    signed = ns.SignedBeaconBlock.default()
    signed.message = block
    signed.signature = bls.sign(sk, compute_signing_root(
        ns.BeaconBlock, block, get_domain(state, params.DOMAIN_BEACON_PROPOSER)))
    return signed


@contextlib.contextmanager
def timed_calls(obj, name, totals):
    """Add the wall s of every call of obj.name to totals[name]."""
    real = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0

    setattr(obj, name, wrapper)
    try:
        yield
    finally:
        setattr(obj, name, real)


@contextlib.contextmanager
def wrapped(obj, name, make):
    """obj.name replaced by make(obj.name) inside the block (an instance's
    method through an attribute of the instance, taken away after)."""
    own = name in vars(obj)
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    try:
        yield
    finally:
        if own:
            setattr(obj, name, real)
        else:
            delattr(obj, name)


async def verify_and_transition(pool, executor, work, ctx, signed, sets, cfg):
    """The parallel half of the import: the sets through the pool (API
    priority, not batchable: the class of a block that is not timely) while
    an executor thread runs the signature-free block transition on `work`
    and roots it. Returns the verdict, the root, the error the import
    reports (None, or "state root mismatch") and the legs' wall s."""
    import asyncio

    from lodestar_tpu_torch.chain.bls import VerifySignatureOpts
    from lodestar_tpu_torch.scheduler import PriorityClass
    from lodestar_tpu_torch.state_transition import process_block, state_hash_tree_root

    block = signed.message
    out = {}

    def stf():
        t0 = time.perf_counter()
        process_block(work, block, ctx, verify_signatures=False, cfg=cfg)
        t1 = time.perf_counter()
        root = state_hash_tree_root(work)
        out["process_block_s"], out["state_root_s"] = t1 - t0, time.perf_counter() - t1
        return root

    async def sigs():
        t0 = time.perf_counter()
        ok = await pool.verify_signature_sets(
            sets, VerifySignatureOpts(batchable=False, priority=PriorityClass.API))
        out["verify_s"] = time.perf_counter() - t0
        return ok

    stf_task = asyncio.get_running_loop().run_in_executor(executor, stf)
    verdict, root = await asyncio.gather(sigs(), stf_task)
    out.update(verdict=verdict, root=root,
               error=None if root == bytes(block.state_root) else "state root mismatch")
    return out


async def import_block(pool, executor, pre, signed, p, cfg, sets=None):
    """Block import in the shape of the JAX package's chain.py: copy the
    pre-state and dial it to the block's slot, collect the block's signature
    sets (unless given), then `verify_and_transition`. Returns its figures,
    the sets and the post-state."""
    from lodestar_tpu_torch.ssz import device_htr as dh
    from lodestar_tpu_torch.state_transition import process_slots
    from lodestar_tpu_torch.state_transition import signature_sets as ss

    flushes = []
    real_flush = dh.DirtyCollector.flush

    def logged_flush(self):
        stats = real_flush(self)
        flushes.append(stats)
        return stats

    t_start = time.perf_counter()
    work = pre.copy()
    dh.DirtyCollector.flush = logged_flush
    try:
        ctx = process_slots(work, signed.message.slot, p, cfg)
    finally:
        dh.DirtyCollector.flush = real_flush
    t_slots = time.perf_counter()
    totals = {}
    if sets is None:
        with timed_calls(ss, "aggregate_pubkeys", totals):
            sets = ss.get_block_signature_sets(work, signed, ctx)
    t_sets = time.perf_counter()
    out = await verify_and_transition(pool, executor, work, ctx, signed, sets, cfg)
    out.update(
        wall_s=time.perf_counter() - t_start, process_slots_s=t_slots - t_start,
        slots_flush_s=sum(f["seconds"] for f in flushes),
        slots_launches=sum(f["launches"] for f in flushes), sets_s=t_sets - t_slots,
        aggregate_pubkeys_s=totals.get("aggregate_pubkeys", 0.0), n_sets=len(sets),
        parallel_s=time.perf_counter() - t_sets)
    out["slots_prepare_s"] = out["process_slots_s"] - out["slots_flush_s"]
    return out, sets, work


def set_fields(sets):
    """Each signature set as its (pubkey, message, signature) bytes."""
    return [(bytes(s.pubkey), bytes(s.message), bytes(s.signature)) for s in sets]


def on_pool(device, fn):
    """asyncio.run(fn(pool, executor)) with a fresh verifier pool on `device`
    (one lane) and one executor thread for the block transition; both are
    closed after."""
    import asyncio

    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool

    async def main():
        pool = BlsDeviceVerifierPool(device=device)
        executor = concurrent.futures.ThreadPoolExecutor(1)
        try:
            return await fn(pool, executor)
        finally:
            await pool.close()
            executor.shutdown(wait=True)

    return asyncio.run(main())


def block_import(dev, smi, p=None, n=BLOCK_VALIDATORS, slot=BLOCK_SLOT, attest_from=1):
    """Phase 10: a mainnet-preset Capella block imported on the card. The
    set-up (keys, genesis, the block and its sets derived from the secret
    keys) comes first; then, with the Fp launch counts and graph replays set to 0 just before
    and read just after, the import: verdict True through one class-128
    replay, the card's post-state root equal to the block's, the sets equal
    to those field for field. Then a block with two attestations'
    signatures swapped (False), a block with one byte of its state root
    changed (reported as a root mismatch), and the valid block once more
    under the profiler for the card's busy time. No graph may be captured.
    Lines start `block:`. The preset (mainnet unless given), validator
    count, slot and first attested slot are the chip run's by default."""
    from lodestar_tpu_torch import graphs, params
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import fp_cuda
    from lodestar_tpu_torch.ssz import device_htr as dh
    from lodestar_tpu_torch.state_transition import signature_sets as ss
    from lodestar_tpu_torch.state_transition.genesis import (
        create_interop_genesis_state,
        interop_pubkeys,
        interop_secret_keys,
    )

    p, cfg = p or params.MAINNET, block_chain_config()
    workers = min(8, os.cpu_count() or 1)
    out = {"validators": n, "slot": slot}
    t0 = time.perf_counter()
    sks = interop_secret_keys(n)
    pubkeys = pubkeys_on_workers(sks, workers)
    out["keygen_s"] = time.perf_counter() - t0
    if pubkeys[:2] != interop_pubkeys(2):
        fail("block: the workers' interop pubkeys differ from the package's")
    t0 = time.perf_counter()
    with host_only_htr():
        genesis = create_interop_genesis_state(n, p=p, pubkeys=pubkeys,
                                               genesis_fork_version=cfg.GENESIS_FORK_VERSION)
    out["genesis_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    signed, host_work, host_ctx = build_block(genesis, sks, p, cfg, slot, attest_from)
    out["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_sets = reference_sets(host_work, signed, host_ctx, sks, p)
    out["host_sets_s"] = time.perf_counter() - t0
    n_atts = len(signed.message.body.attestations)
    say(f"block: set-up on the host: {n} interop keys in {out['keygen_s']:.1f} s (pubkeys on "
        f"{workers} processes), phase0 genesis in {out['genesis_s']:.1f} s, the slot-{slot} "
        f"Capella block ({n_atts} attestations, empty sync aggregate, state root host-only) in "
        f"{out['build_s']:.1f} s, its {len(host_sets)} signature sets from the secret keys in "
        f"{out['host_sets_s']:.1f} s")
    if len(host_sets) != 2 + n_atts:
        fail(f"block: {len(host_sets)} sets for a block of {n_atts} attestations")

    # the swapped block: two attestations' signatures swapped, signed by its
    # proposer; its sets are the valid block's but for the proposer's (the
    # block's root changed) and the two swapped signatures, as
    # get_block_signature_sets gives them (without decoding the pubkeys again)
    swapped = signed.message.copy()
    a, b = swapped.body.attestations[0], swapped.body.attestations[1]
    a.signature, b.signature = bytes(b.signature), bytes(a.signature)
    swapped = sign_block(swapped, sks[int(swapped.proposer_index)], host_work, p)
    # the changed-root block: one byte of its state root changed, signed
    changed = signed.message.copy()
    changed.state_root = bytes([bytes(changed.state_root)[0] ^ 1]) + bytes(changed.state_root)[1:]
    changed = sign_block(changed, sks[int(changed.proposer_index)], host_work, p)

    cache = bv._SINGLE_LAUNCH_GRAPHS
    captures = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)

    def replays():
        return {size: g.replays for (idx, size), g in cache.graphs.items() if idx == dev.index}

    async def counted(pool, executor):
        before, htr_before = replays(), htr_replays(dev)
        fp_cuda.reset_launches()
        graphs.reset_replayed()  # the block import's run starts here
        res, sets, post = await import_block(pool, executor, genesis, signed, p, cfg)
        replayed = dict(graphs.REPLAYED)  # the block import's run ends here
        after = replays()
        res["replays_by_class"] = {k: after[k] - before.get(k, 0) for k in sorted(after)
                                   if after[k] != before.get(k, 0)}
        res["htr_replays_by_class"] = replays_since(htr_before, dev)
        res["fp_replayed"], res["fp_eager"] = replayed, dict(fp_cuda.LAUNCHES)
        return res, sets, post

    res, sets, post = on_pool(dev, counted)
    out["import"] = {k: v for k, v in res.items() if k != "root"}
    if res["verdict"] is not True:
        fail(f"block: the block's {len(sets)} signature sets verified {res['verdict']}")
    if res["error"] is not None:
        fail(f"block: the card's post-state root differs from the block's ({res['error']})")
    if set_fields(sets) != set_fields(host_sets):
        fail("block: the card run's signature sets differ from the secret keys' sets")
    (cls,) = res["replays_by_class"] or (None,)
    if res["replays_by_class"] != {cls: 1} or cls != bv.pad_pow2(len(sets)):
        fail(f"block: the verify replayed {res['replays_by_class']}, not one class "
             f"{bv.pad_pow2(len(sets))} replay")
    missing = [k for k in fp_cuda.KERNELS if res["fp_replayed"][k] <= 0]
    if missing:
        fail(f"block: kernels never launched by the import's replay: {missing}")
    if any(res["fp_eager"].values()):
        fail(f"block: eager kernel launches in the import: {res['fp_eager']}")
    if res["slots_launches"] <= 0:
        fail("block: process_slots' state roots never launched on the card")
    launches = dict(cache.graphs[(dev.index, cls)].launches) if cls else {}
    out["replay_class"], out["fp_launches_per_replay"] = cls, launches
    say(f"block: import of the slot-{slot} block on {dev}: verdict True, post-state root "
        f"== the block's, {len(sets)} sets == the secret keys' field for field; wall "
        f"{res['wall_s']:.2f} s on {smi}")
    say(f"block: process_slots 0->{slot}: {res['process_slots_s']:.2f} s = host prepare "
        f"{res['slots_prepare_s']:.2f} s + flush {res['slots_flush_s']:.2f} s; "
        f"{res['slots_launches']} HTR launches, replays by pair class "
        f"{res['htr_replays_by_class']} (process_slots and the post-state root) on {smi}")
    say(f"block: set-building {res['sets_s']:.2f} s, of it pubkey aggregation "
        f"{res['aggregate_pubkeys_s']:.2f} s "
        f"({100 * res['aggregate_pubkeys_s'] / res['sets_s']:.1f}%, "
        f"{n_atts} x {len(signed.message.body.attestations[0].aggregation_bits)} pubkeys)")
    say(f"block: verify {res['verify_s']:.3f} s wall through the pool (one class-{cls} replay, "
        f"Fp launches per replay {sum(launches.values())} {launches}) beside process_block "
        f"{res['process_block_s']:.3f} s + state root {res['state_root_s']:.3f} s on the executor "
        f"thread; the parallel half {res['parallel_s']:.3f} s on {smi}")

    async def variants(pool, executor):
        """The swapped block's sets through the pool; the changed-root block's
        verify and transition on a copy of the dialed host state (its root a
        fresh tracker's, on the card)."""
        from lodestar_tpu_torch.chain.bls import VerifySignatureOpts
        from lodestar_tpu_torch.scheduler import PriorityClass

        fields = set_fields(sets)
        sw = list(sets)
        sw[0] = ss.block_proposer_signature_set(host_work, swapped, host_ctx)
        sw[2] = bls.SignatureSet(fields[2][0], fields[2][1], fields[3][2])
        sw[3] = bls.SignatureSet(fields[3][0], fields[3][1], fields[2][2])
        t0 = time.perf_counter()
        res_s = {"verdict": await pool.verify_signature_sets(
            sw, VerifySignatureOpts(batchable=False, priority=PriorityClass.API))}
        res_s["verify_s"] = time.perf_counter() - t0
        ch = [ss.block_proposer_signature_set(host_work, changed, host_ctx)] + list(sets[1:])
        res_c = await verify_and_transition(pool, executor, host_work.copy(), host_ctx, changed,
                                            ch, cfg)
        return res_s, res_c

    res_s, res_c = on_pool(dev, variants)
    out["swapped"] = res_s
    out["changed_root"] = {k: v for k, v in res_c.items() if k != "root"}
    if res_s["verdict"] is not False:
        fail("block: the block with two attestations' signatures swapped verified")
    if res_c["verdict"] is not True or res_c["error"] != "state root mismatch":
        fail(f"block: the changed-root block gave verdict {res_c['verdict']}, error "
             f"{res_c['error']!r}")
    say(f"block: two attestations' signatures swapped: verdict False ({res_s['verify_s']:.3f} s); "
        f"one byte of the state root changed: verdict True, reported as a state root mismatch")

    now = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)
    if now != captures:
        fail(f"block: graphs were captured in the phase (BLS, HTR level, HTR root: "
             f"{captures} -> {now})")
    # phase 10b's set-up, which the JSON summary leaves out
    out["setup"] = {"p": p, "cfg": cfg, "sks": sks, "genesis": genesis, "signed": signed,
                    "sets": sets}
    return out


def bls_replays(dev):
    """{size class: replays} of the single-launch graphs on `dev`."""
    from lodestar_tpu_torch.models import batch_verify as bv

    return {size: g.replays for (idx, size), g in bv._SINGLE_LAUNCH_GRAPHS.graphs.items()
            if idx == dev.index}


class CountedStep:
    """One step's window: the Fp launch counts and graph replays set to 0 on
    entry, read on exit into steps[name] (wall s, BLS replays by class, HTR
    replays by pair class, Fp launches replayed and eager); the replayed
    launches are added to `totals` and the classes to `classes`."""

    def __init__(self, dev, steps, totals, classes, name):
        self.dev, self.steps, self.totals, self.classes, self.name = (
            dev, steps, totals, classes, name)

    def __enter__(self):
        from lodestar_tpu_torch import graphs
        from lodestar_tpu_torch.ops import fp_cuda

        self.before, self.htr_before = bls_replays(self.dev), htr_replays(self.dev)
        fp_cuda.reset_launches()
        graphs.reset_replayed()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from lodestar_tpu_torch import graphs
        from lodestar_tpu_torch.ops import fp_cuda

        wall = time.perf_counter() - self.t0
        fp_replayed, fp_eager = dict(graphs.REPLAYED), dict(fp_cuda.LAUNCHES)
        after = bls_replays(self.dev)
        by_class = {k: after[k] - self.before.get(k, 0) for k in sorted(after)
                    if after[k] != self.before.get(k, 0)}
        self.rec = self.steps[self.name] = {
            "wall_s": wall, "replays_by_class": by_class,
            "htr_replays_by_class": replays_since(self.htr_before, self.dev),
            "fp_replayed": fp_replayed, "fp_eager": fp_eager}
        for k in fp_cuda.KERNELS:
            self.totals[k] += fp_replayed[k]
        self.classes.update(by_class)
        return False


# --- phase 10b ---------------------------------------------------------------
# The same block through the port's beacon chain, as the JAX package's node
# imports it: `BeaconChain.process_block` (sanity, regen, the sets through the
# pool beside the transition and root on an executor thread, the db, fork
# choice), gossip aggregates validated and verified as the JAX network
# processor does, and a block produced from the pools and imported.


def signed_aggregate(chain, sks, slot, index):
    """A SignedAggregateAndProof of committee `index` at `slot` on the chain's
    head: every member attesting (data from `make_attestation_data`), the
    aggregate signed with the sum of the members' keys mod r (equal in bytes
    to the aggregate of their signatures), by the first member whose
    selection proof `is_aggregator` accepts."""
    from lodestar_tpu_torch import params, ssz
    from lodestar_tpu_torch.chain.produce_block import make_attestation_data
    from lodestar_tpu_torch.chain.validation import is_aggregator
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.crypto.bls.fields import R
    from lodestar_tpu_torch.state_transition import EpochContext
    from lodestar_tpu_torch.state_transition.util import compute_signing_root, get_domain

    t, p = chain.types, chain.p
    state = chain.get_head_state()
    committee = [int(i) for i in EpochContext(state, p).get_beacon_committee(slot, index)]
    data = make_attestation_data(chain, slot, index)
    epoch = int(data.target.epoch)
    att = t.Attestation.default()
    att.data = data
    att.aggregation_bits = [True] * len(committee)
    summed = bls.SecretKey(sum(sks[i].scalar for i in committee) % R)
    att.signature = bls.sign(summed, compute_signing_root(
        t.AttestationData, data, get_domain(state, params.DOMAIN_BEACON_ATTESTER, epoch)))
    sel_root = compute_signing_root(ssz.uint64, slot,
                                    get_domain(state, params.DOMAIN_SELECTION_PROOF, epoch))
    for vi in committee:
        proof = bls.sign(sks[vi], sel_root)
        if is_aggregator(len(committee), proof):
            break
    else:
        fail(f"chain: no aggregator in committee {index} of slot {slot}")
    agg = t.AggregateAndProof.default()
    agg.aggregator_index = vi
    agg.aggregate = att
    agg.selection_proof = proof
    signed = t.SignedAggregateAndProof.default()
    signed.message = agg
    signed.signature = bls.sign(sks[vi], compute_signing_root(
        t.AggregateAndProof, agg, get_domain(state, params.DOMAIN_AGGREGATE_AND_PROOF, epoch)))
    return signed


def single_attestation(chain, sks, slot, index, member=0):
    """An unaggregated attestation of committee `index` at `slot` on the
    chain's head, by its `member`-th member."""
    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.chain.produce_block import make_attestation_data
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.state_transition import EpochContext
    from lodestar_tpu_torch.state_transition.util import compute_signing_root, get_domain

    t, p = chain.types, chain.p
    state = chain.get_head_state()
    committee = EpochContext(state, p).get_beacon_committee(slot, index)
    att = t.Attestation.default()
    att.data = make_attestation_data(chain, slot, index)
    att.aggregation_bits = [i == member for i in range(len(committee))]
    att.signature = bls.sign(sks[int(committee[member])], compute_signing_root(
        t.AttestationData, att.data,
        get_domain(state, params.DOMAIN_BEACON_ATTESTER, int(att.data.target.epoch))))
    return att


def span_ms(trace, *names):
    """Total ms of the trace's spans with these names."""
    return sum(s.duration_ms for s in trace.spans if s.name in names)


def import_split(trace, slots_s):
    """A `process_block` trace split by its spans (s): set-building, verify,
    STF + root (the executor thread's), and the chain's own share: sanity
    (the root's start to the regen span's), regen less `process_slots`,
    persist and fork choice (its attestation votes and head)."""
    root = trace.root
    regen = [s for s in trace.spans if s.name == "pre_state_regen"]
    sanity_ms = (regen[0].start_ns - root.start_ns) / 1e6 if regen else root.duration_ms
    out = {
        "wall_s": root.duration_ms / 1e3,
        "sets_s": span_ms(trace, "signature_sets") / 1e3,
        "verify_s": span_ms(trace, "bls_verify") / 1e3,
        "stf_s": span_ms(trace, "state_transition") / 1e3,
        "root_s": span_ms(trace, "hash_tree_root") / 1e3,
        "process_slots_s": slots_s,
        "sanity_s": sanity_ms / 1e3,
        "regen_s": span_ms(trace, "pre_state_regen") / 1e3 - slots_s,
        "persist_s": span_ms(trace, "persist_block") / 1e3,
        "fork_choice_s": span_ms(trace, "fork_choice") / 1e3,
    }
    out["chain_own_s"] = sum(out[k] for k in ("sanity_s", "regen_s", "persist_s",
                                              "fork_choice_s"))
    return out


def chain_phase(dev, smi, blocked):
    """Phase 10b: phase 10's set-up through the port's `BeaconChain`. Each
    step sets the Fp launch counts and graph replays to 0 just before and
    reads them just after; the kernels' `chain_replayed` sums the steps.
    Lines start `chain:`."""
    from lodestar_tpu_torch import params, ssz, tracing
    from lodestar_tpu_torch.chain import chain as chain_mod
    from lodestar_tpu_torch.chain.bls import VerifySignatureOpts
    from lodestar_tpu_torch.chain.bls.pool import POOL_SIZE_CLASSES
    from lodestar_tpu_torch.chain.chain import BeaconChain, BlockError, BlockErrorCode
    from lodestar_tpu_torch.chain.produce_block import produce_block
    from lodestar_tpu_torch.chain.validation import (
        GossipAction,
        GossipValidationError,
        validate_gossip_aggregate_and_proof,
        validate_gossip_attestation,
    )
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.db import MemoryDbController
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import fp_cuda
    from lodestar_tpu_torch.scheduler import PriorityClass
    from lodestar_tpu_torch.ssz import device_htr as dh
    from lodestar_tpu_torch.state_transition import EpochContext, state_hash_tree_root
    from lodestar_tpu_torch.state_transition.util import compute_signing_root, get_domain
    from lodestar_tpu_torch.types import ssz_types

    setup = blocked["setup"]
    p, cfg, sks, genesis, signed = (setup[k] for k in ("p", "cfg", "sks", "genesis", "signed"))
    t = ssz_types(p)
    slot = int(signed.message.slot)
    nxt = slot + 1
    root_a = t.capella.BeaconBlock.hash_tree_root(signed.message)
    cache = bv._SINGLE_LAUNCH_GRAPHS
    captures = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)
    out = {"steps": {}}
    replayed_total = dict.fromkeys(fp_cuda.KERNELS, 0)
    classes_seen = set()

    def replays():
        return bls_replays(dev)

    def Step(name):
        return CountedStep(dev, out["steps"], replayed_total, classes_seen, name)

    def one_replay(step, cls, what):
        rec = out["steps"][step]
        if rec["replays_by_class"] != {cls: 1}:
            fail(f"chain: {what} replayed {rec['replays_by_class']}, not one class-{cls} replay")
        missing = [k for k in fp_cuda.KERNELS if rec["fp_replayed"][k] <= 0]
        if missing:
            fail(f"chain: kernels never launched by {what}: {missing}")
        if any(rec["fp_eager"].values()):
            fail(f"chain: eager kernel launches in {what}: {rec['fp_eager']}")

    def last_trace(name):
        trace = tracing.get_tracer().ring[-1]
        if trace.name != name:
            fail(f"chain: the last trace is {trace.name!r}, not {name!r}")
        return trace

    slots_s = {}
    tracing.reset()
    tracing.configure(enabled=True, slow_slot_ms=1e9)
    t0 = time.perf_counter()
    chain = BeaconChain(anchor_state=genesis, bls_verifier=None, db=MemoryDbController(), p=p,
                        cfg=cfg, current_slot=slot)
    out["chain_setup_s"] = time.perf_counter() - t0

    async def steps(pool, executor):
        chain.bls = pool
        # (a) the slot-33 block. Its sets are phase 10's (built there through
        # get_block_signature_sets, ~25 s of pubkey aggregation on the host,
        # and checked against the secret keys' sets), so (a) times the
        # chain's import around them
        def known_sets(real):
            def run(state, block, ctx, **kw):
                return list(setup["sets"]) if block is signed else real(state, block, ctx, **kw)
            return run

        with wrapped(chain_mod, "get_block_signature_sets", known_sets), \
                timed_calls(chain_mod, "process_slots", slots_s), Step("a"):
            got = await chain.process_block(signed)
        split_a = import_split(last_trace("process_block"), slots_s.get("process_slots", 0.0))
        out["steps"]["a"]["split"] = split_a
        if got != root_a or chain.head_root != root_a:
            fail("chain: (a) the imported block's root is not the returned root and the head")
        stored = chain.get_block_by_root(root_a)
        if stored.type.serialize(stored) != signed.type.serialize(signed):
            fail("chain: (a) the db's block differs from the imported block's bytes")
        one_replay("a", bv.pad_pow2(blocked["import"]["n_sets"]), "(a)'s import")

        # (b) gossip for slot 33 on the new head
        chain.on_slot(nxt)
        committees = EpochContext(chain.get_head_state(), p).get_committee_count_per_slot(
            slot // p.SLOTS_PER_EPOCH)
        t_b = time.perf_counter()
        objects = [("aggregate", ci, signed_aggregate(chain, sks, slot, ci))
                   for ci in range(committees)]
        objects.append(("attestation", 0, single_attestation(chain, sks, slot, 0)))
        out["gossip_build_s"] = time.perf_counter() - t_b
        gossip = []
        with Step("b"):
            for kind, ci, obj in objects:
                t1 = time.perf_counter()
                if kind == "aggregate":
                    res = validate_gossip_aggregate_and_proof(chain, obj)
                else:
                    res = validate_gossip_attestation(chain, obj)
                t2 = time.perf_counter()
                before = replays()
                ok = await pool.verify_signature_sets(
                    res.signature_sets, VerifySignatureOpts(priority=PriorityClass.GOSSIP_ATTESTATION))
                t3 = time.perf_counter()
                after = replays()
                if ok is not True:
                    fail(f"chain: (b) the {kind} of committee {ci} verified {ok}")
                # as the JAX network processor imports a verified attestation
                res.register_seen()
                att = obj.message.aggregate if kind == "aggregate" else obj
                att_root = t.AttestationData.hash_tree_root(att.data)
                pool_of = (chain.aggregated_attestation_pool if kind == "aggregate"
                           else chain.attestation_pool)
                pool_of.add(att, att_root)
                chain.fork_choice.on_attestation(
                    res.attesting_indices, "0x" + bytes(att.data.beacon_block_root).hex(),
                    att.data.target.epoch, att.data.slot)
                gossip.append({
                    "kind": kind, "committee": ci, "sets": len(res.signature_sets),
                    "attesters": len(res.attesting_indices), "validate_s": t2 - t1,
                    "pool_s": t3 - t2,
                    "replay_classes": {k: after[k] - before.get(k, 0) for k in after
                                       if after[k] != before.get(k, 0)}})
        out["gossip"] = gossip
        for g in gossip:
            if g["replay_classes"] != {bv.pad_pow2(g["sets"]): 1}:
                fail(f"chain: (b) the {g['kind']} of committee {g['committee']} replayed "
                     f"{g['replay_classes']}, not one class-{bv.pad_pow2(g['sets'])} replay")
        if any(out["steps"]["b"]["fp_eager"].values()):
            fail(f"chain: (b) eager kernel launches: {out['steps']['b']['fp_eager']}")
        for kind, ci, obj in objects:
            if kind != "aggregate":
                continue
            try:
                validate_gossip_aggregate_and_proof(chain, obj)
            except GossipValidationError as e:
                if e.action is not GossipAction.IGNORE or "already seen aggregator" not in str(e):
                    fail(f"chain: (b) the repeated aggregate raised {e}")
            else:
                fail(f"chain: (b) the aggregate of committee {ci} validated twice")

        # (c) produce slot 34, import it signed with the wrong key, then the right one
        state_a = chain.get_state_by_block_root(root_a)
        proposer = EpochContext(state_a, p).get_beacon_proposer(nxt)
        reveal = bls.sign(sks[proposer], compute_signing_root(
            ssz.uint64, nxt // p.SLOTS_PER_EPOCH, get_domain(state_a, params.DOMAIN_RANDAO)))
        with Step("c_produce"):
            block = produce_block(chain, slot=nxt, randao_reveal=reveal)
        prod = last_trace("block_production")
        out["produce"] = {k: span_ms(prod, name) / 1e3 for k, name in (
            ("state_advance_s", "produce_state_advance"),
            ("packing_s", "produce_op_pool_packing"), ("stf_s", "produce_stf"),
            ("root_s", "produce_hash_tree_root"))}
        out["produce"]["wall_s"] = out["steps"]["c_produce"]["wall_s"]
        packed = sorted(a.type.serialize(a) for a in block.body.attestations)
        want = sorted(o.message.aggregate.type.serialize(o.message.aggregate)
                      for kind, _, o in objects if kind == "aggregate")
        if packed != want:
            fail(f"chain: (c) the produced block packs {len(packed)} attestations, not the "
                 f"{len(want)} aggregates")
        out["packed"] = len(packed)
        good = sign_block(block, sks[proposer], state_a, p)
        wrong = sign_block(block, sks[(proposer + 1) % len(sks)], state_a, p)
        root_c = t.capella.BeaconBlock.hash_tree_root(block)
        with Step("c_wrong_key"):
            try:
                await chain.process_block(wrong)
            except BlockError as e:
                if e.code != BlockErrorCode.INVALID_SIGNATURES:
                    fail(f"chain: (c) the wrong-key block was rejected with {e.code}, not "
                         "INVALID_SIGNATURES")
            else:
                fail("chain: (c) the block signed with the wrong key imported")
        if (chain.head_root != root_a or chain.blocks_db.get_binary(root_c) is not None
                or chain.fork_choice.proto_array.has_block("0x" + root_c.hex())):
            fail("chain: (c) the rejected block moved the head or reached the db or fork choice")
        slots_s.clear()
        with timed_calls(chain_mod, "process_slots", slots_s), Step("c_import"):
            got = await chain.process_block(good)
        split_c = import_split(last_trace("process_block"), slots_s.get("process_slots", 0.0))
        out["steps"]["c_import"]["split"] = split_c
        n_sets = [s.attrs.get("sets") for s in last_trace("process_block").spans
                  if s.name == "bls_verify"]
        if got != root_c or chain.head_root != root_c:
            fail("chain: (c) the produced block did not become the head")
        if n_sets != [2 + len(want)]:
            fail(f"chain: (c) the produced block's import verified {n_sets} sets, not "
                 f"{2 + len(want)}")
        one_replay("c_import", bv.pad_pow2(2 + len(want)), "(c)'s import")
        votes = chain.fork_choice.votes
        ctx_a = EpochContext(state_a, p)
        attesters = sorted({int(i) for ci in range(committees)
                            for i in ctx_a.get_beacon_committee(slot, ci)})
        hex_a = "0x" + root_a.hex()
        if any(votes.root_of(int(votes.current[i])) != hex_a for i in attesters):
            fail(f"chain: (c) fork choice does not hold the {len(attesters)} attesters' votes "
                 "for the slot-33 block")
        out["votes_for_block_a"] = len(attesters)

        # (d) regen of the slot-34 state from the db
        chain.state_cache._by_root.pop(root_c, None)
        with Step("d"):
            st = chain.get_state_by_block_root(root_c)
            t_r = time.perf_counter()
            got_root = state_hash_tree_root(st)
            out["regen_root_s"] = time.perf_counter() - t_r
        if got_root != bytes(block.state_root):
            fail("chain: (d) the regenerated slot-34 state's root differs from the block's")
        if out["steps"]["d"]["replays_by_class"]:
            fail(f"chain: (d) regen replayed BLS graphs {out['steps']['d']['replays_by_class']}")

    on_pool(dev, steps)
    tracing.reset()

    unwarmed = sorted(classes_seen - set(POOL_SIZE_CLASSES))
    if unwarmed:
        fail(f"chain: replays at classes phase 7 did not warm: {unwarmed}")
    now = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)
    if now != captures:
        fail(f"chain: graphs were captured in the phase (BLS, HTR level, HTR root: "
             f"{captures} -> {now})")
    out["replayed"] = replayed_total

    st, gossip = out["steps"], out["gossip"]
    split_a, split_c = st["a"]["split"], st["c_import"]["split"]
    cls_a, cls_c = (next(iter(st[k]["replays_by_class"]), None) for k in ("a", "c_import"))
    say(f"chain: (a) BeaconChain.process_block of the slot-{slot} block with phase 10's sets: "
        f"{split_a['wall_s']:.2f} s (phase 10's composed import {blocked['import']['wall_s']:.2f} "
        f"s, {blocked['import']['sets_s']:.2f} s of it set-building); one class-{cls_a} replay; "
        f"head == its root, the db's bytes == the block's; chain set-up "
        f"{out['chain_setup_s']:.2f} s on {smi}")
    say(f"chain: (a) split: process_slots {split_a['process_slots_s']:.2f} s, set-building "
        f"{split_a['sets_s']:.2f} s, verify {split_a['verify_s']:.3f} s beside STF "
        f"{split_a['stf_s']:.3f} s + root {split_a['root_s']:.3f} s; the chain's own "
        f"{split_a['chain_own_s']:.3f} s = sanity {split_a['sanity_s']:.3f} + regen "
        f"{split_a['regen_s']:.3f} + persist {split_a['persist_s']:.3f} + fork choice "
        f"{split_a['fork_choice_s']:.3f} on {smi}")
    for g in gossip:
        say(f"chain: (b) {g['kind']} of committee {g['committee']}: {g['attesters']} attesters, "
            f"{g['sets']} sets, validation {g['validate_s']:.3f} s, pool {g['pool_s']:.3f} s "
            f"(replays by class {g['replay_classes']}), True on {smi}")
    say(f"chain: (b) {st['b']['wall_s']:.2f} s for {len(gossip)} objects (built in "
        f"{out['gossip_build_s']:.2f} s) on {smi}; each aggregate again IGNOREd (already seen "
        "aggregator)")
    pr = out["produce"]
    say(f"chain: (c) produce_block at slot {nxt}: {pr['wall_s']:.2f} s = state advance "
        f"{pr['state_advance_s']:.2f} + packing {pr['packing_s']:.3f} + STF {pr['stf_s']:.3f} + "
        f"root {pr['root_s']:.3f} s; {out['packed']} aggregates packed on {smi}")
    say(f"chain: (c) signed with another key: INVALID_SIGNATURES in "
        f"{st['c_wrong_key']['wall_s']:.2f} s (replays {st['c_wrong_key']['replays_by_class']}), "
        f"head and db unchanged; the valid block: {split_c['wall_s']:.2f} s, one class-"
        f"{cls_c} replay, head == its root, "
        f"{out['votes_for_block_a']} votes for block {slot} on {smi}")
    say(f"chain: (d) regen from the db: {st['d']['wall_s']:.2f} s (the root on the card "
        f"{out['regen_root_s']:.2f} s), == block {nxt}'s state root on {smi}")
    return out


# --- phase 10c ---------------------------------------------------------------
# Sync on the card, as the JAX package's node syncs: a serving chain on phase
# 10's genesis serves a segment of blocks through the port's req/resp
# handlers; a fresh chain range-syncs it over the wire through the verifier
# pool, a third chain backfills its window as one BACKFILL job, and gossip
# drains through the network processor into the pool. The chains anchor at
# genesis: on a later anchor fork choice holds the head at the anchor until
# a justification past it lands (the store's justified epoch is the anchor's
# plus one, as in the JAX package), which blocks without attestations never
# bring.

SYNC_SLOTS = 32  # blocks at slots 35-66 (slots 1-34 empty), across the epoch boundary at 64
SYNC_BACKFILL_SLOTS = 32  # BASELINE config 5's window, one BACKFILL job
SYNC_TAMPERED = 10  # the backfill window's block whose proposer signature gets a byte changed
BLOCKS_BY_RANGE = "/eth2/beacon_chain/req/beacon_blocks_by_range/2/ssz_snappy"
STATUS = "/eth2/beacon_chain/req/status/1/ssz_snappy"


class _MemoryWriter:
    """The writing half of an in-memory stream: what it writes, the paired
    `asyncio.StreamReader` reads."""

    def __init__(self, reader):
        self._reader, self._eof = reader, False

    def write(self, data):
        self._reader.feed_data(data)

    async def drain(self):
        return None

    def write_eof(self):
        if not self._eof:
            self._eof = True
            self._reader.feed_eof()

    def close(self):
        self.write_eof()


async def open_wire(node, peer="syncer"):
    """(dial, transport, close) for req/resp streams that `node` serves with
    `handle_stream`: TCP on 127.0.0.1, or, where the host refuses a loopback
    socket, an in-memory `asyncio.StreamReader` pair per stream."""
    import asyncio

    try:
        server = await asyncio.start_server(
            lambda r, w: node.handle_stream(r, w, peer), "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        _, probe = await asyncio.open_connection("127.0.0.1", port)
        probe.close()
    except OSError as e:
        say(f"sync: a loopback socket was refused ({e!r}): in-memory streams")
    else:
        async def dial():
            return await asyncio.open_connection("127.0.0.1", port)

        return dial, "tcp 127.0.0.1", server.close

    tasks = set()

    async def dial():
        to_server, to_client = asyncio.StreamReader(), asyncio.StreamReader()
        task = asyncio.ensure_future(node.handle_stream(to_server, _MemoryWriter(to_client), peer))
        tasks.add(task)
        task.add_done_callback(tasks.discard)
        return to_client, _MemoryWriter(to_server)

    return dial, "in-memory streams", lambda: None


class WireNet:
    """The network of range sync and backfill: blocks by range v2 (a fork
    digest before each block) through a req/resp client; each download's
    (start, count, blocks, wall s) is kept."""

    def __init__(self, client, dial, types):
        self.client, self.dial, self.t = client, dial, types
        self.downloads = []

    async def blocks_by_range(self, peer, start, count):
        req = self.t.BeaconBlocksByRangeRequest.default()
        req.start_slot, req.count, req.step = start, count, 1
        t0 = time.perf_counter()
        out = await self.client.send_request(self.dial, BLOCKS_BY_RANGE, req)
        self.downloads.append((start, count, len(out), time.perf_counter() - t0))
        return out


def sync_phase(dev, smi, blocked, count=SYNC_SLOTS):
    """Phase 10c: range sync, backfill and gossip on phase 10's genesis,
    config and keys; the segment starts two slots after phase 10's block.
    Each step sets the Fp launch counts and graph replays to 0 just before
    and reads them just after; the kernels' `sync_replayed` sums the steps.
    Replay classes are checked on the card only (graphs exist there only).
    Lines start `sync:`."""
    import asyncio
    import statistics

    from lodestar_tpu_torch import params, ssz
    from lodestar_tpu_torch.chain import validation
    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool, BlsVerifierMock
    from lodestar_tpu_torch.chain.bls.pool import POOL_SIZE_CLASSES
    from lodestar_tpu_torch.chain.chain import BeaconChain
    from lodestar_tpu_torch.chain.produce_block import produce_block
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.db import MemoryDbController
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.network.processor import NetworkProcessor
    from lodestar_tpu_torch.network.reqresp_node import ReqRespBeaconNode
    from lodestar_tpu_torch.ops import fp_cuda
    from lodestar_tpu_torch.scheduler import PriorityClass
    from lodestar_tpu_torch.ssz import device_htr as dh
    from lodestar_tpu_torch.state_transition import EpochContext
    from lodestar_tpu_torch.state_transition.util import compute_signing_root, get_domain
    from lodestar_tpu_torch.sync import BackfillSync, BatchStatus, RangeSync
    from lodestar_tpu_torch.sync.backfill import BackfillError
    from lodestar_tpu_torch.types import ssz_types

    setup = blocked["setup"]
    p, cfg, sks, anchor_state = setup["p"], setup["cfg"], setup["sks"], setup["genesis"]
    t = ssz_types(p)
    start = int(setup["signed"].message.slot) + 2
    slots = range(start, start + count)
    first, last, nxt = slots[0], slots[-1], slots[-1] + 1
    root_anchor = bytes(setup["signed"].message.parent_root)  # the genesis block's root
    cache = bv._SINGLE_LAUNCH_GRAPHS
    captures = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)
    on_card = dev.type == "cuda"
    out = {"steps": {}, "slots": [first, last], "blocks": count}
    replayed_total = dict.fromkeys(fp_cuda.KERNELS, 0)
    classes_seen = set()

    def Step(name):
        return CountedStep(dev, out["steps"], replayed_total, classes_seen, name)

    def new_chain(state, verifier, slot):
        return BeaconChain(anchor_state=state.copy(), bls_verifier=verifier,
                           db=MemoryDbController(), p=p, cfg=cfg, current_slot=slot)

    def make_pool():
        return (BlsDeviceVerifierPool(mesh_mode="auto") if on_card
                else BlsDeviceVerifierPool(device=dev))

    def check_replays(step, want, what):
        rec = out["steps"][step]
        if not on_card:
            return
        if rec["replays_by_class"] != want:
            fail(f"sync: {what} replayed {rec['replays_by_class']}, not {want}")
        missing = [k for k in fp_cuda.KERNELS if rec["fp_replayed"][k] <= 0]
        if want and missing:
            fail(f"sync: kernels never launched by {what}: {missing}")
        if any(rec["fp_eager"].values()):
            fail(f"sync: eager kernel launches in {what}: {rec['fp_eager']}")

    # (a) set-up: the segment on the host, imported by the serving chain
    t0 = time.perf_counter()
    blocks = build_segment(anchor_state, sks, p, cfg, slots)
    out["build_s"] = time.perf_counter() - t0
    roots = [b.message.type.hash_tree_root(b.message) for b in blocks]
    if bytes(blocks[0].message.parent_root) != root_anchor:
        fail("sync: (a) the segment's first block is not a child of the genesis block")
    prof = {}

    async def run():
        serving = prof["serving"] = new_chain(anchor_state, BlsVerifierMock(True), last)
        t0 = time.perf_counter()
        for b in blocks:
            await serving.process_block(b)
        out["serving_import_s"] = time.perf_counter() - t0
        if serving.head_root != roots[-1]:
            fail("sync: (a) the serving chain's head is not the segment's last block")
        prof["anchor"] = serving.get_state_by_block_root(roots[-2])
        dial, out["transport"], close = await open_wire(ReqRespBeaconNode(serving))
        pool = make_pool()
        try:
            await range_sync(serving, dial, pool)
            await backfill(dial, pool)
            await gossip(pool)
            await outage(dial)
        finally:
            close()
            await pool.close()

    async def range_sync(serving, dial, pool):
        """(b) RangeSync over the wire into a fresh chain on the card's pool."""
        fresh = out["fresh"] = new_chain(anchor_state, pool, last)
        client = out["client"] = ReqRespBeaconNode(fresh)
        status = (await client.send_request(dial, STATUS, client.local_status()))[0]
        if int(status.head_slot) != last or bytes(status.head_root) != roots[-1]:
            fail(f"sync: (b) the server's status gives head {int(status.head_slot)}, not {last}")
        net = WireNet(client, dial, t)
        imports, downscored = [], []

        def timed(real):
            async def run(*args, **kwargs):
                t1 = time.perf_counter()
                try:
                    return await real(*args, **kwargs)
                finally:
                    imports.append(time.perf_counter() - t1)
            return run

        with wrapped(fresh, "process_block", timed), Step("b"):
            res = await RangeSync(chain=fresh, network=net, peers=["server"],
                                  on_peer_downscore=lambda peer, why: downscored.append(why)
                                  ).sync(first, last)
        rec = out["steps"]["b"]
        download_s = sum(d[3] for d in net.downloads)
        out["range"] = {
            "completed": res.completed, "processed": res.processed_blocks,
            "wall_s": rec["wall_s"], "download_s": download_s,
            "processing_s": rec["wall_s"] - download_s, "downloads": net.downloads,
            "import_s": {"min": min(imports), "median": statistics.median(imports),
                         "max": max(imports)} if imports else None,
            "head_root": fresh.head_root.hex()}
        if not res.completed or res.processed_blocks != count or downscored:
            fail(f"sync: (b) range sync gave completed {res.completed}, "
                 f"{res.processed_blocks} blocks, downscores {downscored}")
        if fresh.head_root != serving.head_root:
            fail("sync: (b) the synced head differs from the server's")
        check_replays("b", {8: count}, "(b)'s range sync")

    async def backfill(dial, pool):
        """(c) BackfillSync of one window from the synced head as one BACKFILL
        job; then the window with one proposer signature changed."""
        fresh, client = out["fresh"], out["client"]
        head_state = fresh.get_head_state()
        window = min(SYNC_BACKFILL_SLOTS, count)
        verifies = []

        def timed(real):
            async def run(sets, opts=None):
                t1 = time.perf_counter()
                ok = await real(sets, opts)
                verifies.append({"sets": len(sets), "s": time.perf_counter() - t1, "verdict": ok,
                                 "priority": getattr(getattr(opts, "priority", None), "name",
                                                     None)})
                return ok
            return run

        third = new_chain(head_state, None, last)
        net = WireNet(client, dial, t)
        with wrapped(pool, "verify_signature_sets", timed), Step("c"):
            persisted = await BackfillSync(
                chain=third, network=net, bls_verifier=pool, peers=["server"],
                anchor_state=head_state, batch_slots=window,
            ).backfill(blocks[-1], terminal_root=root_anchor)
        stored = dict(third.blocks_db.db.entries_stream())
        want = {bytes(b.type.serialize(b)) for b in blocks[:-1][-(window - 1):]}
        out["backfill"] = {"window": [last - window, last], "persisted": persisted,
                           "wall_s": out["steps"]["c"]["wall_s"],
                           "download_s": sum(d[3] for d in net.downloads),
                           "verifies": list(verifies)}
        if persisted != window - 1 or set(stored.values()) != want:
            fail(f"sync: (c) backfill persisted {persisted} blocks, not the window's "
                 f"{window - 1} as served")
        if len(verifies) != 1 or verifies[0]["sets"] != window - 1 or not verifies[0]["verdict"]:
            fail(f"sync: (c) backfill verified {verifies}, not one job of {window - 1} sets")
        check_replays("c", {bv.pad_pow2(window - 1): 1}, "(c)'s backfill job")

        class Tampered(WireNet):
            async def blocks_by_range(self, peer, start, count):
                got = [b.copy() for b in await super().blocks_by_range(peer, start, count)]
                k = min(SYNC_TAMPERED, len(got) - 1)
                sig = bytearray(bytes(got[k].signature))
                sig[40] ^= 1
                got[k].signature = bytes(sig)
                return got

        fourth = new_chain(head_state, None, last)
        verifies.clear()
        with wrapped(pool, "verify_signature_sets", timed), Step("c_tampered"):
            try:
                await BackfillSync(
                    chain=fourth, network=Tampered(client, dial, t), bls_verifier=pool,
                    peers=["server"], anchor_state=head_state, batch_slots=window,
                ).backfill(blocks[-1], terminal_root=root_anchor)
            except BackfillError as e:
                error = str(e)
            else:
                error = None
        out["backfill"]["tampered"] = {"error": error, "verifies": list(verifies),
                                       "persisted": len(list(fourth.blocks_db.db.entries_stream())),
                                       "wall_s": out["steps"]["c_tampered"]["wall_s"]}
        if error != "segment proposer-signature batch invalid":
            fail(f"sync: (c) the tampered window gave {error!r}")
        if out["backfill"]["tampered"]["persisted"]:
            fail("sync: (c) the tampered window persisted blocks")

    async def gossip(pool):
        """(d) a produced block, the aggregates and an attestation of the
        synced head's slot, pushed by topic into NetworkProcessor and
        drained with execute_work."""
        fresh = out["fresh"]
        t_b = time.perf_counter()
        fresh.on_slot(nxt)
        state = fresh.get_head_state()
        ctx = EpochContext(state, p)
        objects = [("beacon_aggregate_and_proof", f"aggregate {ci}",
                    signed_aggregate(fresh, sks, last, ci))
                   for ci in range(ctx.get_committee_count_per_slot(last // p.SLOTS_PER_EPOCH))]
        objects.append(("beacon_attestation", "attestation 0",
                        single_attestation(fresh, sks, last, 0)))
        proposer = ctx.get_beacon_proposer(nxt)
        reveal = bls.sign(sks[proposer], compute_signing_root(
            ssz.uint64, nxt // p.SLOTS_PER_EPOCH, get_domain(state, params.DOMAIN_RANDAO)))
        block = sign_block(produce_block(fresh, slot=nxt, randao_reveal=reveal), sks[proposer],
                           state, p)
        objects.insert(0, ("beacon_block", f"block {nxt}", block))
        out["gossip_build_s"] = time.perf_counter() - t_b
        cur, records = {}, []

        def timed_validation(real):
            def run(*args, **kwargs):
                t1 = time.perf_counter()
                try:
                    return real(*args, **kwargs)
                finally:
                    cur["rec"]["validate_s"] += time.perf_counter() - t1
            return run

        def timed_pool(real):
            async def run(sets, opts=None):
                before = bls_replays(dev)
                t1 = time.perf_counter()
                ok = await real(sets, opts)
                rec, after = cur["rec"], bls_replays(dev)
                rec["pool_s"] += time.perf_counter() - t1
                rec["sets"] += len(sets)
                rec["pool_verdict"] = ok
                for k in after:
                    if after[k] != before.get(k, 0):
                        rec["replay_classes"][k] = (rec["replay_classes"].get(k, 0) + after[k]
                                                    - before.get(k, 0))
                return ok
            return run

        def timed_handler(topic, real):
            async def run(message, peer):
                rec = cur["rec"] = {"topic": topic, "validate_s": 0.0, "pool_s": 0.0, "sets": 0,
                                    "replay_classes": {}, "verdict": "error"}
                records.append(rec)
                t1 = time.perf_counter()
                try:
                    await real(message, peer)
                    rec["verdict"] = "accepted"
                finally:
                    rec["wall_s"] = time.perf_counter() - t1
            return run

        names = ("validate_gossip_block", "validate_gossip_aggregate_and_proof",
                 "validate_gossip_attestation")
        with contextlib.ExitStack() as stack:
            for name in names:
                stack.enter_context(wrapped(validation, name, timed_validation))
            proc = NetworkProcessor(fresh)
        proc.handlers = {k: timed_handler(k, h) for k, h in proc.handlers.items()}
        for topic, _, obj in objects:
            if not proc.push(topic, obj, peer="server"):
                fail(f"sync: (d) the {topic} queue refused an object")
        # the handlers hold the timed validation functions they were built with
        with wrapped(fresh.bls, "verify_signature_sets", timed_pool), Step("d"):
            drained = await proc.execute_work()
        prof["block"] = block
        out["gossip"] = {"drained": drained, "processed": proc.processed, "errors": proc.errors,
                         "pending": proc.pending, "objects": records,
                         "head_slot": int(fresh.get_head_state().slot)}
        if drained != len(objects) or proc.processed != len(objects) or proc.errors:
            fail(f"sync: (d) the processor drained {drained} of {len(objects)} objects, "
                 f"processed {proc.processed}, errors {proc.errors}")
        if fresh.head_root != block.message.type.hash_tree_root(block.message):
            fail(f"sync: (d) the head did not move to the slot-{nxt} block")
        for rec in records:
            if on_card and rec["replay_classes"] != {bv.pad_pow2(rec["sets"]): 1}:
                fail(f"sync: (d) the {rec['topic']} object replayed {rec['replay_classes']}, "
                     f"not one class-{bv.pad_pow2(rec['sets'])} replay")
        if on_card and any(out["steps"]["d"]["fp_eager"].values()):
            fail(f"sync: (d) eager kernel launches: {out['steps']['d']['fp_eager']}")

    async def outage(dial):
        """(b') a device error in the pool's lanes during range sync (of the
        segment's last block, on a chain anchored at the server's state of
        the slot before): the round pauses with the batch unspent and no
        peer downscored."""
        broken_pool, calls, downscored = make_pool(), [], []

        def broken(*args, **kwargs):
            calls.append(1)
            raise RuntimeError("injected device error")

        for lane in broken_pool.mesh.lanes:
            lane.verify_fn = broken
            if lane.verify_prepared_fn is not None:
                lane.verify_prepared_fn = broken
        chain = new_chain(prof["anchor"], broken_pool, last)
        try:
            with Step("b_outage"):
                res = await RangeSync(chain=chain, network=WireNet(out["client"], dial, t),
                                      peers=["server"],
                                      on_peer_downscore=lambda peer, why: downscored.append(why)
                                      ).sync(last, last)
        finally:
            await broken_pool.close()
        fb = res.failed_batch
        out["outage"] = {"completed": res.completed, "calls": len(calls),
                         "status": fb.status.name if fb else None,
                         "processing_attempts": fb.processing_attempts if fb else None,
                         "downscored": downscored}
        if (res.completed or fb is None or fb.status is not BatchStatus.AWAITING_PROCESSING
                or fb.processing_attempts or downscored or not calls
                or chain.head_root != roots[-2]):
            fail(f"sync: (b') a device error did not pause range sync as a verifier outage: "
                 f"{out['outage']}")
        check_replays("b_outage", {}, "(b')'s failed import")

    asyncio.run(run())

    unwarmed = sorted(classes_seen - set(POOL_SIZE_CLASSES))
    if unwarmed:
        fail(f"sync: replays at classes phase 7 did not warm: {unwarmed}")
    now = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)
    if now != captures:
        fail(f"sync: graphs were captured in the phase (BLS, HTR level, HTR root: "
             f"{captures} -> {now})")
    # phase 10d goes on from the serving chain, the synced chain and its block
    out["chains"] = {"serving": prof["serving"], "synced": out.pop("fresh"),
                     "block": prof["block"]}
    out.pop("client")
    out["replayed"] = replayed_total

    st, rng, bf, gs = out["steps"], out["range"], out["backfill"], out["gossip"]
    say(f"sync: (a) {count} Capella blocks at slots {first}-{last} on phase 10's genesis (no "
        f"attestations) built on the host in {out['build_s']:.1f} s, imported by the serving "
        f"chain (mock verifier) in "
        f"{out['serving_import_s']:.1f} s; transport {out['transport']}")
    say(f"sync: (b) RangeSync({first}, {last}) over the wire: {rng['processed']} imports in "
        f"{rng['wall_s']:.2f} s = download {rng['download_s']:.2f} s + processing "
        f"{rng['processing_s']:.2f} s; per import min/median/max {rng['import_s']['min']:.3f} / "
        f"{rng['import_s']['median']:.3f} / {rng['import_s']['max']:.3f} s; replays "
        f"{st['b']['replays_by_class']}, Fp launches {st['b']['fp_replayed']}; head "
        f"{rng['head_root'][:16]} == the server's on {smi}")
    say(f"sync: (b') a device error in the pool: range sync paused ({out['outage']['status']}, "
        f"{out['outage']['processing_attempts']} attempts spent, no peer downscored), "
        f"{out['outage']['calls']} failed lane calls, no replay")
    v = bf["verifies"][0]
    say(f"sync: (c) backfill of the window [{bf['window'][0]}, {bf['window'][1]}): "
        f"{bf['persisted']} blocks persisted in {bf['wall_s']:.2f} s = download "
        f"{bf['download_s']:.2f} s + one BACKFILL job of {v['sets']} sets {v['s']:.3f} s "
        f"(replays {st['c']['replays_by_class']}) on {smi}; a byte of one signature changed: "
        f"{bf['tampered']['error']!r}, {bf['tampered']['persisted']} persisted, replays "
        f"{st['c_tampered']['replays_by_class']}")
    for rec in gs["objects"]:
        say(f"sync: (d) {rec['topic']}: validation {rec['validate_s']:.3f} s, pool "
            f"{rec['pool_s']:.3f} s ({rec['sets']} sets, replays {rec['replay_classes']}), "
            f"{rec['verdict']}, wall {rec['wall_s']:.3f} s on {smi}")
    say(f"sync: (d) NetworkProcessor drained {gs['drained']} objects in {st['d']['wall_s']:.2f} s "
        f"(built in {out['gossip_build_s']:.2f} s): processed {gs['processed']}, errors "
        f"{gs['errors']}, head at slot {gs['head_slot']}")
    return out


# --- phase 10d ---------------------------------------------------------------
# Two `Libp2pBeaconNetwork` services on 127.0.0.1 over phase 10c's chains: B
# finds A through discv5 over UDP and dials it (TCP, multistream, noise XX,
# mplex), range-syncs from it over blocks-by-range v2 on an mplex stream, and
# imports what A publishes on gossipsub through its `NetworkProcessor`.

P2P_SYNC_BLOCKS = 4  # blocks range-synced over libp2p (slots 68-71 after phase 10c)
P2P_TAMPERED_BYTE = 40  # the byte of the slot-73 block's proposer signature changed


class P2pCheckFailed(RuntimeError):
    """A check of phase 10d's, 10e's or 10f's scenario failed."""


class GossipNode:
    """The part of the JAX package's `BeaconNode` (`lodestar_tpu/node`) that
    `Libp2pBeaconNetwork` calls: `on_gossip` pushes a decoded gossip object
    into the node's `NetworkProcessor`, and a drain loop runs its
    `execute_work`, as `BeaconNode.on_gossip` and `start_gossip_drain` do."""

    def __init__(self, processor):
        self.processor = processor
        self.arrivals = []  # perf_counter of each object pushed
        self._drain = None

    def on_gossip(self, topic, message, peer=""):
        self.arrivals.append(time.perf_counter())
        return self.processor.push(topic, message, peer)

    def start_drain(self, interval_s=0.05):
        import asyncio

        async def loop():
            while True:
                try:
                    n = await self.processor.execute_work()
                except Exception as e:  # noqa: BLE001 - keep draining, as the node does
                    say(f"p2p: gossip drain error {e!r}")
                    n = 0
                await asyncio.sleep(0 if n else interval_s)

        self._drain = asyncio.ensure_future(loop())

    async def stop(self):
        import asyncio

        if self._drain is not None:
            self._drain.cancel()
            try:
                await self._drain
            except asyncio.CancelledError:
                pass
            self._drain = None


def p2p_modules():
    """The port's modules that phase 10d drives, by the names `p2p_run`
    reads (a test passes the JAX package's under the same names)."""
    from types import SimpleNamespace

    from lodestar_tpu_torch.network import gossipsub, processor, service
    from lodestar_tpu_torch.network.transport import host, mplex, noise
    from lodestar_tpu_torch.sync import range_sync

    return SimpleNamespace(service=service, processor=processor, range_sync=range_sync,
                           gossipsub=gossipsub, host=host, mplex=mplex, noise=noise)


async def p2p_run(net, a_chain, b_chain, blocks, make_aggregate, step=None, wait_s=60.0):
    """Phase 10d's scenario through the modules of `net` (`p2p_modules`).

    A serves `a_chain` (head H) and B `b_chain` (head H, its verifier the one
    under test); `blocks` are consecutive signed blocks on H: the blocks to
    range-sync, then the block to gossip, then the block to tamper with.
    `make_aggregate(chain)` gives a SignedAggregateAndProof of the last synced
    slot on A's chain. `step(name)` is a context manager around each counted
    step. (a) A starts with discv5 on; B starts knowing only A's ENR, finds
    A over UDP and dials it; the status handshake runs both ways; (b) A
    imports the sync blocks (its mock) and B range-syncs them from A over
    libp2p; (c) A publishes the next block on gossipsub and B imports it
    through its processor, then A publishes the aggregate; (d) A publishes
    the last block with one byte of its proposer signature changed: B's
    processor rejects it and its head stays; (e) both stop, B says goodbye,
    B's verifier is closed and no task is left. Returns what each step saw;
    raises P2pCheckFailed."""
    import asyncio

    def check(ok, msg):
        if not ok:
            raise P2pCheckFailed(f"p2p: {msg}")

    def root_of(b):
        return b.message.type.hash_tree_root(b.message)

    step = step or (lambda name: contextlib.nullcontext())
    sync_blocks, gossip_block, to_tamper = blocks[:-2], blocks[-2], blocks[-1]
    first, last = int(sync_blocks[0].message.slot), int(sync_blocks[-1].message.slot)
    out = {}
    ids, wire = {}, {side: {"noise_frames": 0, "bytes": 0, "mplex_streams": 0}
                     for side in "AB"}

    def sender(conn):
        return "A" if conn.remote_peer == ids.get("B") else "B"

    def count_frames(real):
        cap = net.noise.NoiseConnection.MAX_PLAINTEXT

        async def write_msg(self, data):
            n = max(1, -(-len(data) // cap))
            rec = wire[sender(self)]
            rec["noise_frames"] += n
            rec["bytes"] += len(data) + n * 18  # 2-byte length + 16-byte tag a frame
            return await real(self, data)
        return write_msg

    def count_streams(real):
        def open_stream(self):
            wire[sender(self._conn)]["mplex_streams"] += 1
            return real(self)
        return open_stream

    def timed_into(log):
        def make(real):
            async def run(*args, **kwargs):
                t0 = time.perf_counter()
                got = await real(*args, **kwargs)
                log.append((t0, time.perf_counter(), got))
                return got
            return run
        return make

    verdicts = []

    def timed_pool(real):
        async def run(sets, opts=None):
            t0 = time.perf_counter()
            ok = await real(sets, opts)
            verdicts.append({"sets": len(sets), "s": time.perf_counter() - t0, "verdict": ok})
            return ok
        return run

    nodes = {side: GossipNode(net.processor.NetworkProcessor(c))
             for side, c in (("A", a_chain), ("B", b_chain))}
    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(net.noise.NoiseConnection, "write_msg", count_frames))
        stack.enter_context(wrapped(net.mplex.Mplex, "open_stream", count_streams))
        stack.enter_context(wrapped(b_chain.bls, "verify_signature_sets", timed_pool))
        # (a) the two services; B knows A only by its ENR
        t0 = time.perf_counter()
        A = net.service.Libp2pBeaconNetwork(node=nodes["A"], chain=a_chain, discv5_port=0,
                                            target_peers=1)
        ids["A"] = A.peer_id
        a_port = await A.start("127.0.0.1")
        B = net.service.Libp2pBeaconNetwork(node=nodes["B"], chain=b_chain, discv5_port=0,
                                            discv5_bootnodes=[A.discv5.enr], target_peers=1)
        ids["B"] = B.peer_id
        statuses, bootstraps, dials, requests = [], [], [], []
        stack.enter_context(wrapped(B, "status", timed_into(statuses)))
        for node in nodes.values():
            node.start_drain()
        kinds = ("beacon_block", "beacon_aggregate_and_proof")
        topics = {k: net.service.topic_string(k, A.current_fork_digest()) for k in kinds}
        with step("a"):
            t_b = time.perf_counter()
            await B.start("127.0.0.1")
            # B's discovery loop has not run yet: time its discv5 pass and its dial
            stack.enter_context(wrapped(B.discv5, "bootstrap", timed_into(bootstraps)))
            stack.enter_context(wrapped(B.host, "connect", timed_into(dials)))
            deadline = time.perf_counter() + wait_s
            while not (statuses and A.peer_id in B.host.peers() and B.peer_id in A.host.peers()
                       and all(t in A.gossip.peer_topics.get(B.peer_id, ()) for t in topics.values())
                       and all(t in B.gossip.peer_topics.get(A.peer_id, ()) for t in topics.values())):
                check(time.perf_counter() < deadline, f"B did not reach A in {wait_s} s: "
                      f"{len(bootstraps)} discv5 passes, {len(dials)} dials, "
                      f"{len(statuses)} statuses")
                await asyncio.sleep(0.005)
        for router in (A.gossip, B.gossip):
            await router.heartbeat()  # form the meshes now, not at the next 0.7 s tick
        status = statuses[0][2]
        check(status is not None and bytes(status.head_root) == a_chain.head_root,
              "the status B received does not give A's head")
        pc = B.host.connections[A.peer_id]
        out["a"] = {
            "start_a_s": t_b - t0, "discovery_s": bootstraps[0][1] - t_b if bootstraps else None,
            "discv5_table": len(B.discv5.table), "discovered_a": A.discv5.node_id in B.discv5.table,
            "connect_s": dials[0][1] - dials[0][0] if dials else None,
            "dialed": [d[2].peer_id == A.peer_id for d in dials],
            "status_s": statuses[0][1] - t_b, "ready_s": time.perf_counter() - t_b,
            "status": {"head_slot": int(status.head_slot), "head_root": bytes(
                status.head_root).hex(), "finalized_epoch": int(status.finalized_epoch),
                "fork_digest": bytes(status.fork_digest).hex()},
            "transport": (f"tcp {pc.addr[0]}:{a_port}, multistream {net.host.NOISE_PROTO} "
                          f"XX, {net.host.MPLEX_PROTO}, gossipsub {net.gossipsub.PROTOCOL_ID}, "
                          f"discv5 udp {A.discv5.port}"),
            "mesh_peers": {k: len(B.gossip.mesh.get(t, ())) for k, t in topics.items()}}
        check(out["a"]["dialed"][:1] == [True] and out["a"]["discovered_a"],
              f"B did not dial A from its discv5 table: {out['a']}")
        check(out["a"]["mesh_peers"] == dict.fromkeys(kinds, 1),
              f"B's meshes are {out['a']['mesh_peers']}, not A on each topic")

        # (b) A imports the sync blocks with its mock; B range-syncs them over libp2p
        for c in (a_chain, b_chain):
            c.on_slot(last)
        t0 = time.perf_counter()
        for b in sync_blocks:
            await a_chain.process_block(b)
        out["a_import_s"] = time.perf_counter() - t0
        check(a_chain.head_root == root_of(sync_blocks[-1]), "A's head is not its last block")
        downloads, imports, downscored = [], [], []
        with wrapped(B, "blocks_by_range", timed_into(downloads)), \
                wrapped(b_chain, "process_block", timed_into(imports)), step("b"):
            t0 = time.perf_counter()
            res = await net.range_sync.RangeSync(
                chain=b_chain, network=B, peers=[A.peer_id],
                on_peer_downscore=lambda peer, why: downscored.append(why)).sync(first, last)
            wall = time.perf_counter() - t0
        out["b"] = {"completed": res.completed, "processed": res.processed_blocks,
                    "wall_s": wall, "downloads": [(d[1] - d[0], len(d[2])) for d in downloads],
                    "download_s": sum(d[1] - d[0] for d in downloads),
                    "import_s": [i[1] - i[0] for i in imports],
                    "pool": verdicts[-len(imports):] if imports else [],
                    "head_root": b_chain.head_root.hex()}
        check(res.completed and res.processed_blocks == len(sync_blocks) and not downscored,
              f"range sync over libp2p gave {out['b']}, downscores {downscored}")
        check(b_chain.head_root == a_chain.head_root, "B's head after range sync is not A's")
        aggregate = make_aggregate(a_chain)

        # (c) a block, then an aggregate, published by A on gossipsub
        proc, handled = nodes["B"].processor, []

        def timed_handler(real):
            async def run(message, peer):
                t1 = time.perf_counter()
                try:
                    await real(message, peer)
                finally:
                    handled.append((t1, time.perf_counter()))
            return run

        proc.handlers = {k: timed_handler(h) for k, h in proc.handlers.items()}

        async def gossip(name, publish, slot=None):
            """Publish on A; wait for B's processor to finish the object."""
            if slot is not None:
                for c in (a_chain, b_chain):
                    c.on_slot(slot)
            processed, errors, n_verdicts = proc.processed, proc.errors, len(verdicts)
            with step(name):
                t0 = time.perf_counter()
                sent = await publish()
                while proc.processed + proc.errors == processed + errors:
                    check(time.perf_counter() - t0 < wait_s, f"{name}: no verdict in {wait_s} s")
                    await asyncio.sleep(0.002)
                wall = time.perf_counter() - t0
            got = verdicts[n_verdicts:]
            arrived, (h0, h1) = nodes["B"].arrivals[-1], handled[-1]
            rec = out[name] = {
                "sent_to": sent, "publish_to_verdict_s": wall,
                # A's publish to B's push into the processor (gossipsub, noise,
                # mplex, B's decode), the queue hop to the drain loop, then the
                # handler: validation and the import or the verify, the pool's
                # share of it apart
                "to_processor_s": arrived - t0, "queue_s": h0 - arrived,
                "handler_s": h1 - h0,
                "pool_s": sum(v["s"] for v in got), "sets": sum(v["sets"] for v in got),
                "pool_verdicts": [v["verdict"] for v in got],
                "outcome": "processed" if proc.processed > processed else "error",
                "head_slot": int(b_chain.get_head_state().slot)}
            return rec

        slot = int(gossip_block.message.slot)
        for c in (a_chain, b_chain):
            c.on_slot(slot)
        await a_chain.process_block(gossip_block)  # the proposer's node imports, then publishes
        rec = await gossip("c_block", lambda: A.publish_block(gossip_block))
        check(rec["pool_verdicts"] == [True] and rec["outcome"] == "processed"
              and b_chain.head_root == root_of(gossip_block), f"the gossip block: {rec}")
        rec = await gossip("c_aggregate", lambda: A.publish("beacon_aggregate_and_proof",
                                                          aggregate))
        check(rec["pool_verdicts"] == [True] and rec["outcome"] == "processed",
              f"the gossip aggregate: {rec}")

        # (d) the next block with one byte of its proposer signature changed
        tampered = to_tamper.copy()
        sig = bytearray(bytes(tampered.signature))
        sig[P2P_TAMPERED_BYTE] ^= 1
        tampered.signature = bytes(sig)
        rec = await gossip("d", lambda: A.publish_block(tampered),
                           slot=int(tampered.message.slot))
        check(rec["pool_verdicts"] == [False] and rec["outcome"] == "error"
              and b_chain.head_root == root_of(gossip_block),
              f"the tampered block: {rec}, B's head {b_chain.head_root.hex()[:16]}")

        # (e) both services stop, B first (its goodbye to A), then the drain
        # loops and B's verifier, in the JAX node's `close` order
        stack.enter_context(wrapped(B, "_request", timed_into(requests)))
        t0 = time.perf_counter()
        await B.stop()
        await A.stop()
        for node in nodes.values():
            await node.stop()
        await b_chain.bls.close()
        await asyncio.sleep(0.05)
        pending = [t for t in asyncio.all_tasks()
                   if t is not asyncio.current_task() and not t.done()]
        out["e"] = {"stop_s": time.perf_counter() - t0,
                    "goodbyes": [(r[1] - r[0], len(r[2] or ())) for r in requests],
                    "pending": [repr(t.get_coro())[:80] for t in pending], "wire": wire}
        check(len(requests) == 1 and not pending, f"stop: {out['e']}")
    out["heads"] = {"A": a_chain.head_root.hex(), "B": b_chain.head_root.hex()}
    out["verdicts"] = [v["verdict"] for v in verdicts]
    out["processor"] = {"processed": proc.processed, "errors": proc.errors}
    return out


def p2p_phase(dev, smi, blocked, synced):
    """Phase 10d: `p2p_run` on phase 10c's chains. A serves the chain that
    served 10c's range sync (mock verifier) after importing 10c's produced
    slot-67 block; B serves 10c's synced chain (head 67) on a fresh
    `BlsDeviceVerifierPool(mesh_mode="auto")`. The blocks of slots 68-73 are
    built on A's head on the host. Each counted step sets the Fp launch
    counts and graph replays to 0 just before and reads them just after; the
    kernels' `p2p_replayed` sums the steps. Lines start `p2p:`."""
    import asyncio

    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool
    from lodestar_tpu_torch.chain.bls.pool import POOL_SIZE_CLASSES
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import fp_cuda
    from lodestar_tpu_torch.ssz import device_htr as dh

    setup = blocked["setup"]
    p, cfg, sks = setup["p"], setup["cfg"], setup["sks"]
    chains = synced["chains"]
    a_chain, b_chain, produced = chains["serving"], chains["synced"], chains["block"]
    on_card = dev.type == "cuda"
    cache = bv._SINGLE_LAUNCH_GRAPHS
    captures = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)
    out = {"steps": {}}
    replayed_total = dict.fromkeys(fp_cuda.KERNELS, 0)
    classes_seen = set()

    def Step(name):
        return CountedStep(dev, out["steps"], replayed_total, classes_seen, name)

    async def run():
        slot = int(produced.message.slot)
        a_chain.on_slot(slot)
        t0 = time.perf_counter()
        await a_chain.process_block(produced)
        out["a_prelude_s"] = time.perf_counter() - t0
        if a_chain.head_root != b_chain.head_root:
            fail("p2p: A's head after the slot-67 block is not the synced chain's")
        t0 = time.perf_counter()
        slots = range(slot + 1, slot + 1 + P2P_SYNC_BLOCKS + 2)
        blocks = build_segment(a_chain.get_head_state(), sks, p, cfg, slots)
        out["build_s"] = time.perf_counter() - t0
        out["slots"] = [slots[0], slots[-1]]
        last = slots[P2P_SYNC_BLOCKS - 1]
        b_chain.bls = (BlsDeviceVerifierPool(mesh_mode="auto") if on_card
                       else BlsDeviceVerifierPool(device=dev))
        try:
            return await p2p_run(p2p_modules(), a_chain, b_chain, blocks,
                                 lambda chain: signed_aggregate(chain, sks, last, 0), step=Step)
        except P2pCheckFailed as e:
            fail(str(e))
        finally:
            await b_chain.bls.close()

    t0 = time.perf_counter()
    rec = asyncio.run(run())
    out["wall_s"] = time.perf_counter() - t0
    want = {"a": {}, "b": {8: P2P_SYNC_BLOCKS}, "c_block": {8: 1}, "c_aggregate": {8: 1},
            "d": {8: 1}}
    for name, classes in want.items() if on_card else ():
        got = out["steps"][name]
        if got["replays_by_class"] != classes:
            fail(f"p2p: step {name} replayed {got['replays_by_class']}, not {classes}")
        if any(got["fp_eager"].values()):
            fail(f"p2p: eager kernel launches in step {name}: {got['fp_eager']}")
        missing = [k for k in fp_cuda.KERNELS if classes and got["fp_replayed"][k] <= 0]
        if missing:
            fail(f"p2p: kernels never launched by step {name}: {missing}")
    unwarmed = sorted(classes_seen - set(POOL_SIZE_CLASSES))
    if unwarmed:
        fail(f"p2p: replays at classes phase 7 did not warm: {unwarmed}")
    now = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)
    if now != captures:
        fail(f"p2p: graphs were captured in the phase (BLS, HTR level, HTR root: "
             f"{captures} -> {now})")
    out.update(rec)
    out["replays"] = {name: s["replays_by_class"] for name, s in out["steps"].items()}
    out["replayed"] = replayed_total

    a, b, st = out["a"], out["b"], out["steps"]
    s = a["status"]
    say(f"p2p: (a) A on {a['transport']}; B knew only A's ENR: first discv5 pass "
        f"(PING/WHOAREYOU/handshake + FINDNODE over UDP) {a['discovery_s']:.3f} s after B's "
        f"start, table {a['discv5_table']}; dial (TCP + multistream + noise XX + mplex) "
        f"{a['connect_s']:.3f} s; status received {a['status_s']:.3f} s after B's start: head "
        f"slot {s['head_slot']} root {s['head_root'][:16]}, finalized epoch "
        f"{s['finalized_epoch']}, fork digest {s['fork_digest']}; B's mesh peers "
        f"{a['mesh_peers']}; step replays {st['a']['replays_by_class']}")
    say(f"p2p: (b) A imported 10c's block 67 in {out['a_prelude_s']:.2f} s; blocks "
        f"{out['slots'][0]}-{out['slots'][1]} built on the host in {out['build_s']:.2f} s; A "
        f"imported {P2P_SYNC_BLOCKS} (mock) in {out['a_import_s']:.2f} s; RangeSync over "
        f"libp2p: {b['processed']} imports in {b['wall_s']:.2f} s = download "
        f"{b['download_s']:.3f} s over {len(b['downloads'])} blocks-by-range v2 request(s) + "
        f"processing {b['wall_s'] - b['download_s']:.2f} s; per import "
        f"{', '.join(f'{x:.3f}' for x in b['import_s'])} s, of it the pool "
        f"{', '.join(f'{v["s"]:.3f}' for v in b['pool'])} s; replays "
        f"{st['b']['replays_by_class']}; B's head {b['head_root'][:16]} == A's on {smi}")
    for name, what in (("c_block", f"block {out['slots'][0] + P2P_SYNC_BLOCKS}"),
                       ("c_aggregate", "aggregate"), ("d", "tampered block")):
        g = out[name]
        say(f"p2p: ({name[0]}) {what}: sent to {g['sent_to']} peer(s), publish to verdict "
            f"{g['publish_to_verdict_s']:.3f} s = to B's processor {g['to_processor_s']:.4f} s "
            f"+ queue hop {g['queue_s']:.4f} s + handler {g['handler_s']:.3f} s (pool "
            f"{g['pool_s']:.3f} s, {g['sets']} sets, replays {st[name]['replays_by_class']}); "
            f"pool verdicts {g['pool_verdicts']}, {g['outcome']}, B's head at slot "
            f"{g['head_slot']} on {smi}")
    e = out["e"]
    say(f"p2p: (e) both stopped in {e['stop_s']:.3f} s, B's goodbye answered in "
        f"{e['goodbyes'][0][0]:.3f} s, no task left; sent over the noise channels: A "
        f"{e['wire']['A']}, B {e['wire']['B']}; B's processor {out['processor']}; phase "
        f"{out['wall_s']:.1f} s")
    return out


# --- phase 10e ---------------------------------------------------------------
# The light client on phase 10d's synced chain: blocks with full sync
# aggregates imported through `BeaconChain` (the 512-pubkey sync-committee set
# beside the proposer's and the randao reveal's, in one class-8 replay), the
# chain's `LightClientServer` producing updates from them, and a `Lightclient`
# following the head over req/resp on TCP.

LC_BLOCKS = 4  # consecutive Capella blocks with full sync aggregates on 10d's head
LC_FORGED_ROOT = b"\x5a" * 32  # the root the fifth block's sync aggregate is signed over
LC_TAMPERED_BYTE = 40  # the byte of the optimistic update's signature changed
LC_BOOTSTRAP = "/eth2/beacon_chain/req/light_client_bootstrap/1/ssz_snappy"
LC_UPDATES = "/eth2/beacon_chain/req/light_client_updates_by_range/1/ssz_snappy"
LC_FINALITY = "/eth2/beacon_chain/req/light_client_finality_update/1/ssz_snappy"
LC_OPTIMISTIC = "/eth2/beacon_chain/req/light_client_optimistic_update/1/ssz_snappy"


class CountingStream:
    """A req/resp stream half that adds the bytes it reads or writes to
    `counts[key]`."""

    def __init__(self, inner, counts, key):
        self._inner, self._counts, self._key = inner, counts, key

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _add(self, data):
        self._counts[self._key] = self._counts.get(self._key, 0) + len(data)
        return data

    def write(self, data):
        self._inner.write(self._add(data))

    async def read(self, n=-1):
        return self._add(await self._inner.read(n))

    async def readexactly(self, n):
        return self._add(await self._inner.readexactly(n))


class LightClientWire:
    """The `Lightclient`'s transport (the REST shape of its docstring) over
    req/resp: each of the four light-client requests goes to a
    `ReqRespBeaconNode` through `dial` on `loop` (the client runs on another
    thread), and comes back as `{"data": to_json(...)}`; a finality or
    optimistic request answered with an error raises, as a 404 does. Bytes
    read and written per request are counted in `wire`."""

    def __init__(self, loop, dial, types):
        from lodestar_tpu_torch.reqresp import ReqResp

        self.loop, self._dial, self.t = loop, dial, types
        self.client = ReqResp()
        self.wire = []  # (protocol, bytes written, bytes read, wall s)

    def _request(self, protocol, request):
        counts = {}

        async def dial():
            reader, writer = await self._dial()
            return CountingStream(reader, counts, "read"), CountingStream(writer, counts, "written")

        async def go():
            t0 = time.perf_counter()
            try:
                return await self.client.send_request(dial, protocol, request)
            finally:
                self.wire.append((protocol.split("/")[4], counts.get("written", 0),
                                  counts.get("read", 0), time.perf_counter() - t0))

        import asyncio

        return asyncio.run_coroutine_threadsafe(go(), self.loop).result(60)

    def get_lc_bootstrap(self, block_root_hex):
        from lodestar_tpu_torch.ssz.json import to_json

        (boot,) = self._request(LC_BOOTSTRAP, bytes.fromhex(block_root_hex[2:]))
        return {"data": to_json(self.t.LightClientBootstrap, boot)}

    def get_lc_updates(self, start_period, count):
        from lodestar_tpu_torch.ssz.json import to_json

        req = self.t.LightClientUpdatesByRange.default()
        req.start_period, req.count = start_period, count
        return {"data": [{"data": to_json(self.t.LightClientUpdate, u)}
                         for u in self._request(LC_UPDATES, req)]}

    def get_lc_finality_update(self):
        from lodestar_tpu_torch.ssz.json import to_json

        (u,) = self._request(LC_FINALITY, None)
        return {"version": "capella", "data": to_json(self.t.LightClientFinalityUpdate, u)}

    def get_lc_optimistic_update(self):
        from lodestar_tpu_torch.ssz.json import to_json

        (u,) = self._request(LC_OPTIMISTIC, None)
        return {"version": "capella", "data": to_json(self.t.LightClientOptimisticUpdate, u)}


async def lc_run(chain, blocks, forged, p, cfg, step=None):
    """Phase 10e's scenario on `chain` (its verifier set by the caller, its
    head the parent of `blocks[0]`): a `LightClientServer` attached, (a) each
    of `blocks` (full sync aggregates) imported through `process_block`,
    (b) `forged` (its aggregate signed over another root) rejected
    INVALID_SIGNATURES with the head and the server's updates unchanged,
    (c) a `Lightclient` over req/resp bootstrapping from blocks[0]'s root,
    `sync_to_head`, `poll_head`, and a forged update refused. `step(name)` is
    a context manager around each counted step (CountedStep), or None.
    Returns what each step gave; a check that fails raises P2pCheckFailed."""
    import asyncio
    import contextlib
    import hashlib

    from lodestar_tpu_torch import light_client as lc_mod
    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.chain import chain as chain_mod
    from lodestar_tpu_torch.chain.chain import BlockError, BlockErrorCode
    from lodestar_tpu_torch.chain.light_client_server import LightClientServer
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.light_client import LightClientError
    from lodestar_tpu_torch.light_client.client import Lightclient, RunStatusCode
    from lodestar_tpu_torch.network.reqresp_node import ReqRespBeaconNode
    from lodestar_tpu_torch.ssz.json import from_json
    from lodestar_tpu_torch.state_transition.util import get_domain
    from lodestar_tpu_torch.types import ssz_types

    def check(ok, msg):
        if not ok:
            raise P2pCheckFailed(f"lightclient: {msg}")

    step = step or (lambda name: contextlib.nullcontext())
    t = ssz_types(p)
    server = LightClientServer(chain)
    chain.light_client_server = server
    out = {"imports": []}

    def root_of(signed):
        return signed.message.type.hash_tree_root(signed.message)

    # the first aggregate on the host oracle, once: the 512 members' pubkeys
    # over the parent's root, as process_sync_aggregate checks it
    head_state = chain.get_head_state()
    first = blocks[0].message
    agg = first.body.sync_aggregate
    domain = get_domain(head_state, params.DOMAIN_SYNC_COMMITTEE,
                        (int(first.slot) - 1) // p.SLOTS_PER_EPOCH)
    t0 = time.perf_counter()
    oracle = bls.eth_fast_aggregate_verify(
        [bytes(k) for k in head_state.current_sync_committee.pubkeys],
        hashlib.sha256(bytes(first.parent_root) + domain).digest(),
        bytes(agg.sync_committee_signature))
    out["oracle_s"] = time.perf_counter() - t0
    check(oracle, "the host oracle refuses the first block's sync aggregate")
    check(all(agg.sync_committee_bits), "the first block's aggregate is not full")

    def timed_list(obj, name, into):
        def make(real):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return real(*args, **kwargs)
                finally:
                    into.append(time.perf_counter() - t0)
            return run
        return wrapped(obj, name, make)

    async def one_import(signed, name):
        sets_s, server_s, pool = [], [], []
        verify = chain.bls.verify_signature_sets

        async def timed_verify(sets, opts=None):
            t0 = time.perf_counter()
            try:
                return await verify(sets, opts)
            finally:
                pool.append({"s": time.perf_counter() - t0, "sets": len(sets),
                             "pubkeys": [len(s.pubkey) for s in sets]})

        chain.on_slot(int(signed.message.slot))
        rec = {"slot": int(signed.message.slot)}
        with timed_list(chain_mod, "get_block_signature_sets", sets_s), \
                timed_list(server, "on_imported_block", server_s), \
                wrapped(chain.bls, "verify_signature_sets", lambda real: timed_verify), \
                step(name):
            t0 = time.perf_counter()
            try:
                await chain.process_block(signed)
                rec["verdict"] = "imported"
            except BlockError as e:
                rec["verdict"] = e.code
            rec["import_s"] = time.perf_counter() - t0
        rec.update(sets_s=sum(sets_s), server_s=sum(server_s),
                   pool_s=sum(v["s"] for v in pool), sets=[v["sets"] for v in pool])
        return rec

    # (a) the blocks with full sync aggregates
    for i, signed in enumerate(blocks):
        rec = await one_import(signed, f"a{i + 1}")
        out["imports"].append(rec)
        check(rec["verdict"] == "imported", f"block {rec['slot']}: {rec['verdict']}")
        check(chain.head_root == root_of(signed), f"block {rec['slot']} is not the head")
        check(rec["sets"] == [3], f"block {rec['slot']} sent {rec['sets']} sets, not [3]")
    check(len(server.get_updates(0, 1)) == 1 and server.get_optimistic_update() is not None,
          "the server produced no update")
    best, optimistic = server.get_updates(0, 1)[0], server.get_optimistic_update()
    check(int(best.signature_slot) == int(first.slot),
          "period 0's best update is not the first block's (the oldest attested header)")

    # (b) the forged aggregate: a valid point over another root
    head = chain.head_root
    rec = await one_import(forged, "b")
    out["forged"] = rec
    check(rec["verdict"] == BlockErrorCode.INVALID_SIGNATURES,
          f"the forged aggregate gave {rec['verdict']}, not INVALID_SIGNATURES")
    check(chain.head_root == head, "the head moved on the forged block")
    check(server.get_optimistic_update() is optimistic and server.get_updates(0, 1)[0] is best,
          "the server produced an update from the forged block")

    # (c) a light client over req/resp
    node = ReqRespBeaconNode(chain)
    dial, transport, close = await open_wire(node, "lightclient")
    loop = asyncio.get_running_loop()
    wire = LightClientWire(loop, dial, t)
    gvr = bytes(head_state.genesis_validators_root)
    client = Lightclient(transport=wire, genesis_validators_root=gvr,
                         fork_version=bytes(cfg.CAPELLA_FORK_VERSION), p=p)
    validate_s = []
    c = {"transport": transport}
    try:
        with timed_list(lc_mod, "validate_light_client_update", validate_s), step("c"):
            t0 = time.perf_counter()
            await loop.run_in_executor(None, client.bootstrap, root_of(blocks[0]))
            c["bootstrap_s"] = time.perf_counter() - t0
            check(client.status == RunStatusCode.SYNCING, f"status {client.status} after bootstrap")
            t0 = time.perf_counter()
            c["applied"] = await loop.run_in_executor(None, client.sync_to_head)
            c["sync_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            await loop.run_in_executor(None, client.poll_head)
            c["poll_s"] = time.perf_counter() - t0
            c["validate_s"] = list(validate_s)
            # the optimistic update as the wire gave it, one byte of its signature changed
            data = (await loop.run_in_executor(None, wire.get_lc_optimistic_update))["data"]
            sig = bytearray.fromhex(data["sync_aggregate"]["sync_committee_signature"][2:])
            sig[LC_TAMPERED_BYTE] ^= 0x01
            data["sync_aggregate"]["sync_committee_signature"] = "0x" + sig.hex()
            bad = client._as_full_update(from_json(t.LightClientOptimisticUpdate, data), t)
            t0 = time.perf_counter()
            try:
                lc_mod.validate_light_client_update(client.store, bad, gvr,
                                                    bytes(cfg.CAPELLA_FORK_VERSION), p)
                c["forged_update"] = "accepted"
            except LightClientError as e:
                c["forged_update"] = f"LightClientError: {e}"
            c["forged_validate_s"] = time.perf_counter() - t0
    finally:
        close()
    c.update(head_slot=client.head_slot,
             finalized_slot=client.finalized_slot, status=client.status, wire=wire.wire,
             wire_bytes=sum(w + r for _, w, r, _ in wire.wire))
    out["c"] = c
    check(c["applied"] == 1, f"sync_to_head applied {c['applied']} updates, not 1")
    check(client.status == RunStatusCode.STARTED, f"status {client.status} after sync")
    last_parent = int(blocks[-1].message.slot) - 1
    check(client.head_slot == last_parent,
          f"the optimistic header is at slot {client.head_slot}, not {last_parent}")
    check(client.finalized_slot == int(blocks[0].message.slot),
          f"the finalized header moved to slot {client.finalized_slot}")
    check(c["forged_update"].startswith("LightClientError"), "the forged update was accepted")
    return out


def lightclient_phase(dev, smi, blocked, synced, count=LC_BLOCKS):
    """Phase 10e: `lc_run` on phase 10d's synced chain (B, head at slot 72)
    on a fresh `BlsDeviceVerifierPool(mesh_mode="auto")`: `count` blocks with
    full sync aggregates, then a fifth whose aggregate is signed over
    another root, built on the head on the host; then the light client over
    TCP. Each counted step sets the Fp launch counts and graph replays to 0
    just before and reads them just after; the kernels' `lc_replayed` sums
    the steps. Lines start `lightclient:`."""
    import asyncio

    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool
    from lodestar_tpu_torch.chain.bls.pool import POOL_SIZE_CLASSES
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import fp_cuda
    from lodestar_tpu_torch.ssz import device_htr as dh

    setup = blocked["setup"]
    p, cfg, sks = setup["p"], setup["cfg"], setup["sks"]
    chain = synced["chains"]["synced"]
    on_card = dev.type == "cuda"
    cache = bv._SINGLE_LAUNCH_GRAPHS
    captures = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)
    out = {"steps": {}}
    replayed_total = dict.fromkeys(fp_cuda.KERNELS, 0)
    classes_seen = set()

    def Step(name):
        return CountedStep(dev, out["steps"], replayed_total, classes_seen, name)

    head_slot = int(chain.get_head_state().slot)
    slots = range(head_slot + 1, head_slot + count + 2)
    t0 = time.perf_counter()
    sync = {s: "full" for s in slots[:-1]}
    sync[slots[-1]] = LC_FORGED_ROOT
    built = build_segment(chain.get_head_state(), sks, p, cfg, slots, sync=sync)
    out["build_s"] = time.perf_counter() - t0
    out["slots"] = [slots[0], slots[-1]]

    async def run():
        chain.bls = (BlsDeviceVerifierPool(mesh_mode="auto") if on_card
                     else BlsDeviceVerifierPool(device=dev))
        try:
            return await lc_run(chain, built[:-1], built[-1], p, cfg, step=Step)
        except P2pCheckFailed as e:
            fail(str(e))
        finally:
            await chain.bls.close()

    t0 = time.perf_counter()
    rec = asyncio.run(run())
    out["wall_s"] = time.perf_counter() - t0
    want = {**{f"a{i + 1}": {8: 1} for i in range(count)}, "b": {8: 1}, "c": {}}
    for name, classes in want.items() if on_card else ():
        got = out["steps"][name]
        if got["replays_by_class"] != classes:
            fail(f"lightclient: step {name} replayed {got['replays_by_class']}, not {classes}")
        if any(got["fp_eager"].values()):
            fail(f"lightclient: eager kernel launches in step {name}: {got['fp_eager']}")
        missing = [k for k in fp_cuda.KERNELS if classes and got["fp_replayed"][k] <= 0]
        if missing:
            fail(f"lightclient: kernels never launched by step {name}: {missing}")
    unwarmed = sorted(classes_seen - set(POOL_SIZE_CLASSES))
    if unwarmed:
        fail(f"lightclient: replays at classes phase 7 did not warm: {unwarmed}")
    now = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)
    if now != captures:
        fail(f"lightclient: graphs were captured in the phase (BLS, HTR level, HTR root: "
             f"{captures} -> {now})")
    out.update(rec)
    out["replays"] = {name: s["replays_by_class"] for name, s in out["steps"].items()}
    out["htr_replays"] = {name: s["htr_replays_by_class"] for name, s in out["steps"].items()}
    out["replayed"] = replayed_total

    st = out["steps"]
    say(f"lightclient: blocks {out['slots'][0]}-{out['slots'][1] - 1} with full sync aggregates "
        f"({p.SYNC_COMMITTEE_SIZE} bits) and the forged block {out['slots'][1]} built on the "
        f"host in {out['build_s']:.2f} s; the first aggregate on the host oracle "
        f"(eth_fast_aggregate_verify) {out['oracle_s']:.2f} s, True")
    for i, r in enumerate(out["imports"]):
        name = f"a{i + 1}"
        say(f"lightclient: (a) block {r['slot']}: import {r['import_s']:.3f} s = set-building "
            f"{r['sets_s']:.3f} s (the {p.SYNC_COMMITTEE_SIZE}-pubkey aggregation) + pool "
            f"{r['pool_s']:.3f} s ({r['sets'][0]} sets) + the server's on_imported_block "
            f"{r['server_s']:.3f} s + the rest; replays {st[name]['replays_by_class']}, HTR "
            f"{st[name]['htr_replays_by_class']}, Fp launches {st[name]['fp_replayed']} on {smi}")
    r = out["forged"]
    say(f"lightclient: (b) block {r['slot']} (aggregate over another root): {r['verdict']} in "
        f"{r['import_s']:.3f} s (sets {r['sets_s']:.3f} s, pool {r['pool_s']:.3f} s); replays "
        f"{st['b']['replays_by_class']}; head unchanged, no update from it")
    c = out["c"]
    say(f"lightclient: (c) Lightclient over req/resp on {c['transport']}: bootstrap "
        f"{c['bootstrap_s']:.3f} s, sync_to_head {c['sync_s']:.3f} s ({c['applied']} update), "
        f"poll_head {c['poll_s']:.3f} s; validate s per update "
        f"{', '.join(f'{x:.3f}' for x in c['validate_s'])} (host oracle); optimistic header at "
        f"slot {c['head_slot']}, finalized at {c['finalized_slot']}; the forged update "
        f"({c['forged_validate_s']:.3f} s): {c['forged_update']}; on the wire "
        f"{c['wire_bytes']} bytes over {len(c['wire'])} requests "
        f"({', '.join(f'{n} {w}+{rd} B' for n, w, rd, _ in c['wire'])}); replays "
        f"{st['c']['replays_by_class']}; phase {out['wall_s']:.1f} s")
    return out


# --- phase 10f ---------------------------------------------------------------
# A validator client over the port's Beacon REST API: `RestValidator` on a
# `BeaconApiClient`, the node's `BeaconRestApiServer` over phase 10e's chain,
# every block, attestation, sync-committee message and contribution verified
# by the chain's pool on the loop the chain runs on (`chain.loop`).

REST_SLOTS = 2  # slots of validator duties on the chain's head
REST_ATTESTERS = 4  # members of each slot's committee 0 in the validator's store
REST_SYNC_SCAN = 64  # sync-committee members tried for an aggregator at the first slot
REST_TAMPERED_BYTE = 40  # the forged attestation's signature byte changed
REST_TOPICS = ("head", "block")


def rest_keys(chain, sks, p, cfg, slots, attesters=REST_ATTESTERS, scan=REST_SYNC_SCAN):
    """The validator's keys for `slots` on the chain's head: each slot's
    proposer, the first `attesters` members of each slot's committee 0, and
    one member of the current sync committee: the first whose selection
    proof at slots[0] makes it its subnet's aggregator (tried over the first
    `scan` members), else the first. Returns (secret keys, roles)."""
    from lodestar_tpu_torch.chain.produce_block import dial_to_slot
    from lodestar_tpu_torch.chain.validation import is_sync_committee_aggregator
    from lodestar_tpu_torch.config import create_beacon_config
    from lodestar_tpu_torch.db import MemoryDbController
    from lodestar_tpu_torch.params import SYNC_COMMITTEE_SUBNET_COUNT
    from lodestar_tpu_torch.validator import SlashingProtection, ValidatorStore

    head = chain.get_head_state()
    roles = {"proposers": [], "attesters": {}}
    for slot in slots:
        work, ctx = dial_to_slot(head, slot, p, cfg)
        roles["proposers"].append(int(ctx.get_beacon_proposer(slot)))
        roles["attesters"][slot] = [int(v) for v in ctx.get_beacon_committee(slot, 0)[:attesters]]
    index_of = ctx.pubkey_to_index(work)
    members = [index_of[bytes(pk)] for pk in head.current_sync_committee.pubkeys]
    sub_size = p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
    probe = ValidatorStore(create_beacon_config(cfg, bytes(head.genesis_validators_root)),
                           SlashingProtection(MemoryDbController()), [], p)
    roles["sync"], roles["sync_selected"] = members[0], False
    for pos, vi in enumerate(members[:scan]):
        probe.add_secret_key(sks[vi])
        proof = probe.sign_sync_selection_proof(sks[vi].to_pubkey(), slots[0], pos // sub_size)
        if is_sync_committee_aggregator(proof, p):
            roles["sync"], roles["sync_selected"] = vi, True
            break
    wanted = sorted({*roles["proposers"], *[v for a in roles["attesters"].values() for v in a],
                     roles["sync"]})
    return [sks[i] for i in wanted], roles


class RequestCounter:
    """Makes every request of a `BeaconApiClient` one counted step (`step`:
    the Fp launch counts and graph replays set to 0 just before the request
    and read just after) and one record: the step's name, `slot` as set
    when the request was made, method, route, wall s, and the sets of each
    pool job appended to `jobs` during it."""

    def __init__(self, client, step, jobs):
        self.step, self.jobs = step, jobs
        self.records, self.slot = [], None
        real = client._req

        def counted(method, path, query=None, body=None):
            name = f"{len(self.records)}:{method} {path}"
            n_jobs = len(self.jobs)
            t0 = time.perf_counter()
            rec = {"step": name, "slot": self.slot, "method": method, "path": path}
            self.records.append(rec)
            with self.step(name):
                try:
                    return real(method, path, query, body)
                finally:
                    rec["wall_s"] = time.perf_counter() - t0
                    rec["jobs"] = [len(sets) for sets in self.jobs[n_jobs:]]

        client._req = counted


class SseConsumer:
    """GET /eth/v1/events on a thread, the frames kept as (event, data)."""

    def __init__(self, port, topics=REST_TOPICS):
        import http.client
        import threading

        self.frames, self.status = [], None
        self.ready, self.closed = threading.Event(), threading.Event()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)

        def run():
            try:
                conn.request("GET", "/eth/v1/events?topics=" + ",".join(topics))
                resp = conn.getresponse()
                self.status = resp.status
                self.ready.set()
                buf = b""
                while True:
                    chunk = resp.read1(4096)
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n\n" in buf:
                        frame, buf = buf.split(b"\n\n", 1)
                        lines = dict(ln.split(": ", 1) for ln in frame.decode().splitlines()
                                     if not ln.startswith(":"))
                        if "event" in lines:
                            self.frames.append((lines["event"], json.loads(lines["data"])))
            except OSError:
                pass
            finally:
                conn.close()
                self.ready.set()
                self.closed.set()

        self.thread = threading.Thread(target=run, name="sse-consumer", daemon=True)
        self.thread.start()
        if not self.ready.wait(30) or self.status != 200:
            raise P2pCheckFailed(f"rest: the SSE stream did not open ({self.status})")

    def slots(self, event):
        return sorted({int(d["slot"]) for e, d in self.frames if e == event})


def oracle_checks(store, roles_pk, outs, p, t):
    """Every signature the validator produced, once, on the host oracle:
    (kind, True/False) per signature."""
    import hashlib

    from lodestar_tpu_torch import params, ssz
    from lodestar_tpu_torch.config import compute_signing_root
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.state_transition.block import fork_of

    cfg = store.config
    checks = []

    def check(kind, pk, root, sig):
        checks.append((kind, bls.verify(pk, root, bytes(sig))))

    for out in outs:
        signed = out["proposed"]
        block = signed.message
        epoch = int(block.slot) // p.SLOTS_PER_EPOCH
        pk = roles_pk[int(block.proposer_index)]
        ns = getattr(t, fork_of(block))
        check("block", pk, compute_signing_root(
            ns.BeaconBlock, block, cfg.get_domain(params.DOMAIN_BEACON_PROPOSER, epoch)),
            signed.signature)
        check("randao", pk, compute_signing_root(
            ssz.uint64, epoch, cfg.get_domain(params.DOMAIN_RANDAO, epoch)),
            block.body.randao_reveal)
        for att, vi in out["attesters"]:
            check("attestation", roles_pk[vi], compute_signing_root(
                t.AttestationData, att.data,
                cfg.get_domain(params.DOMAIN_BEACON_ATTESTER, int(att.data.target.epoch))),
                att.signature)
        for msg in out["sync_messages"]:
            domain = cfg.get_domain(params.DOMAIN_SYNC_COMMITTEE,
                                    int(msg.slot) // p.SLOTS_PER_EPOCH)
            check("sync message", roles_pk[int(msg.validator_index)],
                  hashlib.sha256(bytes(msg.beacon_block_root) + domain).digest(), msg.signature)
        for signed_cp in out["sync_contributions"]:
            cp = signed_cp.message
            epoch = int(cp.contribution.slot) // p.SLOTS_PER_EPOCH
            pk = roles_pk[int(cp.aggregator_index)]
            check("contribution", pk, compute_signing_root(
                t.ContributionAndProof, cp,
                cfg.get_domain(params.DOMAIN_CONTRIBUTION_AND_PROOF, epoch)), signed_cp.signature)
            data = t.SyncAggregatorSelectionData.default()
            data.slot = int(cp.contribution.slot)
            data.subcommittee_index = int(cp.contribution.subcommittee_index)
            check("selection proof", pk, compute_signing_root(
                t.SyncAggregatorSelectionData, data,
                cfg.get_domain(params.DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, epoch)),
                cp.selection_proof)
    return checks


def server_threads():
    """The live threads of an HTTP server: its serve loop and its handlers."""
    import threading

    return sorted(th.name for th in threading.enumerate()
                  if "serve_forever" in th.name or "process_request_thread" in th.name)


def db_digest(chain):
    import hashlib

    h, n = hashlib.sha256(), 0
    for k, v in chain.blocks_db.db.entries_stream():
        h.update(k + v)
        n += 1
    return n, h.hexdigest()


def rest_run(chain, sks, p, cfg, slots, make_verifier, step=None):
    """Phase 10f's scenario on `chain` (its head the parent of slots[0]): an
    event loop on a thread attached as `chain.loop`, `make_verifier()` made
    on it as the chain's verifier, the port's `BeaconRestApiServer` on
    127.0.0.1 and a `RestValidator` over a `BeaconApiClient` with the keys
    of `rest_keys`. (a) `refresh_indices`, (b) `run_slot_duties` at each of
    `slots`, the SSE stream (d) open on head and block, (c) a forged
    attestation and a block signed with another key, both HTTP 400, (e) the
    server stopped. `step(name)` is a context manager around each request
    (CountedStep), or None. Returns what each step gave; a check that fails
    raises P2pCheckFailed."""
    import asyncio
    import threading

    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.api import BeaconApiClient, BeaconApiImpl, BeaconRestApiServer
    from lodestar_tpu_torch.api.client import ApiClientError
    from lodestar_tpu_torch.config import create_beacon_config
    from lodestar_tpu_torch.crypto.bls import api as bls
    from lodestar_tpu_torch.db import MemoryDbController
    from lodestar_tpu_torch.ssz.json import from_json, to_json
    from lodestar_tpu_torch.state_transition import state_hash_tree_root
    from lodestar_tpu_torch.state_transition.block import fork_of
    from lodestar_tpu_torch.state_transition.util import compute_signing_root, get_domain
    from lodestar_tpu_torch.types import ssz_types
    from lodestar_tpu_torch.validator import SlashingProtection, ValidatorStore
    from lodestar_tpu_torch.validator.rest_client import RestValidator

    def check(ok, msg):
        if not ok:
            raise P2pCheckFailed(f"rest: {msg}")

    step = step or (lambda name: contextlib.nullcontext())
    t = ssz_types(p)
    out = {"slots": list(slots)}
    t0 = time.perf_counter()
    keys, roles = rest_keys(chain, sks, p, cfg, slots)
    out["keys_s"] = time.perf_counter() - t0
    out["roles"] = roles
    roles_pk = {}
    head = chain.get_head_state()
    index_of = {bytes(v.pubkey): i for i, v in enumerate(head.validators)}
    for sk in keys:
        roles_pk[index_of[sk.to_pubkey()]] = sk.to_pubkey()

    loop = asyncio.new_event_loop()
    loop_thread = threading.Thread(target=loop.run_forever, name="rest-chain-loop", daemon=True)
    loop_thread.start()

    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result()

    async def attach():
        chain.bls = make_verifier()

    jobs = []
    server = None
    try:
        on_loop(attach())
        chain.loop = loop
        verify = chain.bls.verify_signature_sets

        async def counted_verify(sets, opts=None):
            jobs.append(sets)
            return await verify(sets, opts)

        chain.bls.verify_signature_sets = counted_verify
        server = BeaconRestApiServer(BeaconApiImpl(chain), port=0)
        server.start()
        client = BeaconApiClient(f"http://127.0.0.1:{server.port}")
        counter = RequestCounter(client, step, jobs)
        gvr = bytes(head.genesis_validators_root)
        store = ValidatorStore(create_beacon_config(cfg, gvr),
                               SlashingProtection(MemoryDbController()), keys, p)
        rv = RestValidator(client=client, store=store, p=p)
        sse = SseConsumer(server.port)

        # (a) index discovery over the validators route
        counter.slot = "a"
        rv.refresh_indices()
        rv._indices_epoch = slots[0] // p.SLOTS_PER_EPOCH  # (a) was this epoch's poll
        check(sorted(rv._index_to_pubkey) == sorted(roles_pk),
              f"refresh_indices mapped {sorted(rv._index_to_pubkey)}, not {sorted(roles_pk)}")

        # (b) the duties of each slot
        outs = []
        for slot in slots:
            chain.on_slot(slot)
            counter.slot = slot
            t0 = time.perf_counter()
            res = rv.run_slot_duties(slot)
            res["wall_s"] = time.perf_counter() - t0
            signed = res["proposed"]
            check(signed is not None, f"slot {slot}: no block proposed")
            block_root = signed.message.type.hash_tree_root(signed.message)
            check(chain.head_root == block_root, f"slot {slot}: the published block is not the head")
            with step(f"{slot}:root"):
                root = state_hash_tree_root(chain.get_head_state())
            check(root == bytes(signed.message.state_root),
                  f"slot {slot}: the head state's root is not the block's")
            ctx = dial_to_slot_ctx(chain, slot, p, cfg)[1]
            res["attesters"] = []
            for att in res["attestations"]:
                check(att.data.slot == slot and bytes(att.data.beacon_block_root) == block_root,
                      f"slot {slot}: an attestation is not on the new head")
                committee = ctx.get_beacon_committee(slot, int(att.data.index))
                res["attesters"].append(
                    (att, int(committee[list(att.aggregation_bits).index(True)])))
            pooled = len(chain.attestation_pool._by_slot.get(slot, {}))
            check(pooled >= 1 and len(res["attestations"]) >= len(roles["attesters"][slot]),
                  f"slot {slot}: {len(res['attestations'])} attestations, pool {pooled}")
            check(res["sync_messages"], f"slot {slot}: no sync-committee message")
            msg = res["sync_messages"][0]
            seats = [pos for pos, pk in enumerate(chain.get_head_state().current_sync_committee
                                                  .pubkeys) if bytes(pk) == roles_pk[roles["sync"]]]
            sub_size = p.SYNC_COMMITTEE_SIZE // params.SYNC_COMMITTEE_SUBNET_COUNT
            pooled_sync = [chain.sync_committee_message_pool.get_contribution(
                pos // sub_size, slot, block_root) for pos in seats]
            check(all(c is not None for c in pooled_sync) and int(msg.slot) == slot,
                  f"slot {slot}: the sync-committee message is not in the node's pool")
            res["seats"] = seats
            if slot == slots[0] and roles["sync_selected"]:
                check(res["sync_contributions"], f"slot {slot}: the selected aggregator's "
                      "contribution was not accepted")
            res["block_attestations"] = len(signed.message.body.attestations)
            res["block_sync_bits"] = (sum(1 for b in signed.message.body.sync_aggregate
                                          .sync_committee_bits if b)
                                      if fork_of(signed.message) != "phase0" else 0)
            outs.append(res)
        out["outs"] = outs

        # (c1) an attestation with one signature byte changed, by a member not yet seen
        slot = slots[-1]
        ctx = dial_to_slot_ctx(chain, slot, p, cfg)[1]
        index, pos, vi, size = next(
            (c, i, int(v), len(committee))
            for c in range(ctx.get_committee_count_per_slot(slot // p.SLOTS_PER_EPOCH))
            for committee in [ctx.get_beacon_committee(slot, c)]
            for i, v in enumerate(committee) if int(v) not in roles_pk)
        data = outs[-1]["attestations"][0].data.copy()
        data.index = index
        att = t.Attestation.default()
        bits = [False] * size
        bits[pos] = True
        att.aggregation_bits, att.data = bits, data
        domain = get_domain(chain.get_head_state(), params.DOMAIN_BEACON_ATTESTER,
                            int(data.target.epoch))
        sig = bytearray(bls.sign(sks[vi], compute_signing_root(t.AttestationData, data, domain)))
        sig[REST_TAMPERED_BYTE] ^= 0x01
        att.signature = bytes(sig)
        counter.slot = "c1"
        try:
            client.submit_pool_attestations([to_json(t.Attestation, att)])
            out["forged_attestation"] = "accepted"
        except ApiClientError as e:
            out["forged_attestation"] = str(e)
        check(out["forged_attestation"].startswith("400"),
              f"the forged attestation gave {out['forged_attestation']}")

        # (c2) a block signed with another validator's key
        forged_slot = slots[-1] + 1
        chain.on_slot(forged_slot)
        work_head, db_before = chain.head_root, db_digest(chain)
        _, ctx = dial_to_slot_ctx(chain, forged_slot, p, cfg)
        proposer = int(ctx.get_beacon_proposer(forged_slot))
        other = (proposer + 1) % len(head.validators)
        signer = ValidatorStore(store.config, SlashingProtection(MemoryDbController()),
                                [sks[proposer], sks[other]], p)
        epoch = forged_slot // p.SLOTS_PER_EPOCH
        counter.slot = "c2"
        produced = client.produce_block_v2(forged_slot,
                                           signer.sign_randao(sks[proposer].to_pubkey(), epoch))
        ns = getattr(t, produced["version"])
        block = from_json(ns.BeaconBlock, produced["data"])
        forged = signer.sign_block(sks[other].to_pubkey(), block)
        try:
            client.publish_block(to_json(ns.SignedBeaconBlock, forged))
            out["forged_block"] = "accepted"
        except ApiClientError as e:
            out["forged_block"] = str(e)
        check(out["forged_block"].startswith("400") and "INVALID_SIGNATURES" in out["forged_block"],
              f"the forged block gave {out['forged_block']}")
        check(chain.head_root == work_head, "the head moved on the forged block")
        check(db_digest(chain) == db_before, "the db changed on the forged block")
        out["db_entries"] = db_before[0]

        # (d) the SSE stream saw both slots' blocks and heads
        deadline = time.time() + 10
        while time.time() < deadline and not all(
                set(slots) <= set(sse.slots(e)) for e in REST_TOPICS):
            time.sleep(0.05)
        out["sse"] = {e: sse.slots(e) for e in REST_TOPICS}
        check(all(set(slots) <= set(out["sse"][e]) for e in REST_TOPICS),
              f"the SSE stream saw {out['sse']}")
        out["sse_frames"] = len(sse.frames)

        # (e) shutdown: no stream and no server thread left
        t0 = time.perf_counter()
        server.stop()
        server_stopped = server
        server = None
        sse.closed.wait(15)
        sse.thread.join(15)
        deadline = time.time() + 15
        while time.time() < deadline and server_threads():
            time.sleep(0.05)
        left = server_threads()
        out["stop_s"] = time.perf_counter() - t0
        check(not server_stopped._sse_streams, "an SSE stream is still registered")
        check(not sse.thread.is_alive(), "the SSE consumer never saw the stream end")
        check(not left, f"threads left after stop: {left}")
        out["records"] = counter.records
        t0 = time.perf_counter()
        out["oracle"] = oracle_checks(store, roles_pk, outs, p, t)
        out["oracle_s"] = time.perf_counter() - t0
        bad = [kind for kind, ok in out["oracle"] if not ok]
        check(not bad, f"the host oracle refuses the validator's signatures: {bad}")
    finally:
        if server is not None:
            server.stop()
        chain.loop = None
        try:
            on_loop(chain.bls.close())
            on_loop(loop.shutdown_default_executor())
        finally:
            loop.call_soon_threadsafe(loop.stop)
            loop_thread.join(15)
            loop.close()
    return out


def dial_to_slot_ctx(chain, slot, p, cfg):
    from lodestar_tpu_torch.chain.produce_block import dial_to_slot

    return dial_to_slot(chain.get_head_state(), slot, p, cfg)

def rest_phase(dev, smi, blocked, synced, count=REST_SLOTS):
    """Phase 10f: `rest_run` on phase 10e's chain (10d's synced chain, head
    at slot 76) on a fresh `BlsDeviceVerifierPool(mesh_mode="auto")`, for
    `count` slots past its head. Each request is a counted step; the kernels'
    `rest_replayed` sums them. Every pool job must be one replay at a class
    phase 7 warmed; no graph may be captured and no kernel launched eagerly.
    Lines start `rest:`."""
    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool
    from lodestar_tpu_torch.chain.bls.pool import POOL_SIZE_CLASSES
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import fp_cuda
    from lodestar_tpu_torch.ssz import device_htr as dh

    setup = blocked["setup"]
    p, cfg, sks = setup["p"], setup["cfg"], setup["sks"]
    chain = synced["chains"]["synced"]
    on_card = dev.type == "cuda"
    cache = bv._SINGLE_LAUNCH_GRAPHS
    captures = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)
    steps, replayed_total, classes_seen = {}, dict.fromkeys(fp_cuda.KERNELS, 0), set()

    def Step(name):
        return CountedStep(dev, steps, replayed_total, classes_seen, name)

    def make_verifier():
        return (BlsDeviceVerifierPool(mesh_mode="auto") if on_card
                else BlsDeviceVerifierPool(device=dev))

    head_slot = int(chain.get_head_state().slot)
    slots = range(head_slot + 1, head_slot + 1 + count)
    t0 = time.perf_counter()
    try:
        rec = rest_run(chain, sks, p, cfg, slots, make_verifier, step=Step)
    except P2pCheckFailed as e:
        fail(str(e))
    wall = time.perf_counter() - t0
    records = rec["records"]
    for r in records:
        st = steps[r["step"]]
        r["replays_by_class"] = st["replays_by_class"]
        if not on_card:
            continue
        if sum(st["replays_by_class"].values()) != len(r["jobs"]):
            fail(f"rest: {r['method']} {r['path']} ran {len(r['jobs'])} pool jobs in "
                 f"{st['replays_by_class']} replays, not one replay each")
        if any(st["fp_eager"].values()):
            fail(f"rest: eager kernel launches in {r['method']} {r['path']}: {st['fp_eager']}")
    for slot in slots:
        if on_card and steps[f"{slot}:root"]["replays_by_class"]:
            fail(f"rest: the state root of slot {slot} replayed a BLS graph")
    verifying = {("POST", "/eth/v1/beacon/blocks"), ("POST", "/eth/v1/beacon/pool/attestations"),
                 ("POST", "/eth/v1/beacon/pool/sync_committees")}
    for r in records:
        if isinstance(r["slot"], int) and (r["method"], r["path"]) in verifying and not r["jobs"]:
            fail(f"rest: slot {r['slot']} {r['method']} {r['path']} verified nothing")
    if on_card:
        missing = [k for k in fp_cuda.KERNELS if replayed_total[k] <= 0]
        if missing:
            fail(f"rest: kernels never launched in the phase: {missing}")
        unwarmed = sorted(classes_seen - set(POOL_SIZE_CLASSES))
        if unwarmed:
            fail(f"rest: replays at classes phase 7 did not warm: {unwarmed}")
    now = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)
    if now != captures:
        fail(f"rest: graphs were captured in the phase (BLS, HTR level, HTR root: "
             f"{captures} -> {now})")

    roles = rec["roles"]
    say(f"rest: validator keys for slots {slots[0]}-{slots[-1]} chosen in {rec['keys_s']:.2f} s: "
        f"proposers {roles['proposers']}, attesters {roles['attesters']}, sync-committee "
        f"member {roles['sync']} ({'aggregator' if roles['sync_selected'] else 'not selected'}"
        f" at slot {slots[0]})")
    for r in records:
        label = f"(b) slot {r['slot']}" if isinstance(r["slot"], int) else f"({r['slot']})"
        say(f"rest: {label} {r['method']} {r['path']}: {r['wall_s']:.3f} s, pool jobs {len(r['jobs'])} "
            f"(sets {r['jobs']}), replays {r['replays_by_class']}")
    slot_out = []
    for slot, res in zip(slots, rec["outs"]):
        slot_out.append({"slot": slot, "wall_s": res["wall_s"],
                         "attestations": len(res["attestations"]),
                         "sync_messages": len(res["sync_messages"]), "seats": res["seats"],
                         "contributions": len(res["sync_contributions"]),
                         "block_attestations": res["block_attestations"],
                         "block_sync_bits": res["block_sync_bits"],
                         "root_htr_replays": steps[f"{slot}:root"]["htr_replays_by_class"]})
        say(f"rest: (b) slot {slot}: run_slot_duties {res['wall_s']:.3f} s; block imported as "
            f"the head carrying {res['block_attestations']} attestations and "
            f"{res['block_sync_bits']} sync bits, its state root on the card the block's; "
            f"{len(res['attestations'])} attestations, {len(res['sync_messages'])} sync "
            f"message(s) over seats {res['seats']}, {len(res['sync_contributions'])} "
            f"contribution(s) accepted on {smi}")
    oracle = rec["oracle"]
    kinds = sorted({k for k, _ in oracle})
    say(f"rest: (b) the validator's {len(oracle)} signatures ("
        f"{', '.join(f'{sum(1 for x, _ in oracle if x == k)} {k}' for k in kinds)}) all True "
        f"on the host oracle in {rec['oracle_s']:.2f} s, outside the timed windows")
    say(f"rest: (c) the attestation with signature byte {REST_TAMPERED_BYTE} changed: "
        f"{rec['forged_attestation']}; the block signed with another key: "
        f"{rec['forged_block']}; head and db ({rec['db_entries']} entries) unchanged")
    say(f"rest: (d) SSE stream on {','.join(REST_TOPICS)}: {rec['sse_frames']} events, slots "
        f"{rec['sse']}; (e) the server stopped in {rec['stop_s']:.3f} s with no stream and no "
        f"server thread left; phase {wall:.1f} s")
    return {"slots": slot_out, "roles": roles, "keys_s": rec["keys_s"],
            "requests": [{k: r[k] for k in ("slot", "method", "path", "wall_s", "jobs",
                                            "replays_by_class")} for r in records],
            "forged_attestation": rec["forged_attestation"], "forged_block": rec["forged_block"],
            "sse": rec["sse"], "oracle_s": rec["oracle_s"], "signatures": len(oracle),
            "stop_s": rec["stop_s"], "wall_s": wall, "replayed": replayed_total}


# --- phase 10g ---------------------------------------------------------------
# The port's node and CLI: a dev chain through `cli.main` finalizing on the
# card's pool, and a node checkpoint-synced from it over REST.

NODE_VALIDATORS = 16  # the `dev` command's default
NODE_SLOTS = 32  # the shortest dev run that finalizes (epoch 2, at slot 32)
NODE_LINGER_S = 5.0  # (a)'s REST server stays up this long after its last slot


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def listening(port):
    """Whether something accepts TCP connections on 127.0.0.1:port."""
    import socket

    with socket.socket() as sock:
        sock.settimeout(1.0)
        return sock.connect_ex(("127.0.0.1", port)) == 0


class ThreadLines:
    """A stand-in for sys.stdout: what one thread prints is kept, line by
    line, and passed on with `prefix`; `seen` is set at the first line that
    starts with `until`. Other threads' output passes through untouched."""

    def __init__(self, real, thread_name, prefix, until):
        import threading

        self.real, self.thread_name, self.prefix, self.until = real, thread_name, prefix, until
        self.lines, self.partial = [], ""
        self.seen = threading.Event()

    def write(self, text):
        import threading

        if threading.current_thread().name != self.thread_name:
            return self.real.write(text)
        self.partial += text
        while "\n" in self.partial:
            line, self.partial = self.partial.split("\n", 1)
            self.lines.append(line)
            self.real.write(f"{self.prefix}{line}\n")
            if line.startswith(self.until):
                self.seen.set()
        return len(text)

    def flush(self):
        self.real.flush()


@contextlib.contextmanager
def node_settings_restored():
    """The process-global settings a `BeaconNode.init` reconfigures, saved
    on entry and put back on exit: the active preset, the prep and
    single-launch modes and the prep metrics, the HTR mode, metrics and
    device, the launch telemetry and the SLO accountant."""
    from lodestar_tpu_torch import params, slo, telemetry
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import prep
    from lodestar_tpu_torch.ssz import device_htr as dh

    fields = [(bv, "_prep_mode"), (bv, "_prep_metrics"), (bv, "_single_launch_mode"),
              (prep, "_launch_counter"), (dh, "_htr_mode"), (dh, "_htr_metrics"),
              (dh, "_htr_device"), (telemetry, "_mode"), (telemetry, "_metrics"),
              (telemetry, "_ledger"), (slo._ACCT, "model"), (slo._ACCT, "metrics"),
              (slo._ACCT, "slack_floor_s"), (slo._ACCT, "monotonic_ns")]
    saved = [getattr(obj, name) for obj, name in fields]
    preset = params.active_preset()
    try:
        yield
    finally:
        for (obj, name), value in zip(fields, saved):
            setattr(obj, name, value)
        params.set_active_preset(preset)


@contextlib.contextmanager
def timed_imports(times):
    """(chain, wall s, error or None) of every `BeaconChain.process_block`
    inside the block, appended to `times`."""
    from lodestar_tpu_torch.chain.chain import BeaconChain

    real = vars(BeaconChain)["process_block"]

    async def process_block(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            out = await real(self, *args, **kwargs)
        except BaseException as e:
            times.append((self, time.perf_counter() - t0, repr(e)))
            raise
        times.append((self, time.perf_counter() - t0, None))
        return out

    BeaconChain.process_block = process_block
    try:
        yield
    finally:
        BeaconChain.process_block = real


def verifier_kind(bls):
    """"pool:<device types>" for a `BlsDeviceVerifierPool`, else the class."""
    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool

    if isinstance(bls, BlsDeviceVerifierPool):
        return "pool:" + ",".join(sorted({lane.device.type for lane in bls.mesh.lanes}))
    return type(bls).__name__


def checkpoints(chain):
    """The chain's fork-choice head (slot, root hex) and its finalized and
    justified checkpoints (epoch, root hex)."""
    fc = chain.fork_choice
    head = fc.proto_array.get_block(fc.head)
    return {"head": [int(head.slot), head.block_root],
            "finalized": [int(fc.finalized.epoch), fc.finalized.root],
            "justified": [int(fc.justified.epoch), fc.justified.root]}


def fetch_anchor(url, p, slots=NODE_SLOTS):
    """(b)'s reads over REST from the dev node at `url`: the checkpoint state
    (`fetch_checkpoint_state` at `current_slot=slots`), the dev node's head
    and finality checkpoints, the finalized block's state root, and the
    blocks after the anchor up to `slots` (`get_block_v2`)."""
    from lodestar_tpu_torch.api.client import BeaconApiClient
    from lodestar_tpu_torch.node.checkpoint_sync import fetch_checkpoint_state
    from lodestar_tpu_torch.ssz.json import from_json
    from lodestar_tpu_torch.types import ssz_types

    client = BeaconApiClient(url)
    t0 = time.perf_counter()
    state = fetch_checkpoint_state(client, p=p, current_slot=slots)
    fetch_s = time.perf_counter() - t0
    fin = client.get_state_finality_checkpoints("head")["data"]
    header = client.get_block_header(fin["finalized"]["root"])["data"]["header"]["message"]
    head = client.get_block_header("head")["data"]["header"]["message"]
    t = ssz_types(p)
    blocks = []
    t0 = time.perf_counter()
    for slot in range(int(state.slot) + 1, slots + 1):
        res = client.get_block_v2(str(slot))
        blocks.append(from_json(getattr(t, res["version"]).SignedBeaconBlock, res["data"]))
    return {"state": state, "blocks": blocks, "fetch_state_s": fetch_s,
            "fetch_blocks_s": time.perf_counter() - t0,
            "finalized_state_root": header["state_root"],
            "dev": {"head": [int(head["slot"]), client.get_block_root("head")["data"]["root"]],
                    "finalized": [int(fin["finalized"]["epoch"]), fin["finalized"]["root"]],
                    "justified": [int(fin["current_justified"]["epoch"]),
                                  fin["current_justified"]["root"]]}}


async def anchored_node(fetched, device, p, slots=NODE_SLOTS, step=None, db_dir=None):
    """(b)'s node: `BeaconNode.init` on `device` anchored on the fetched
    state (the dev chain config, a db under `db_dir`, metrics and REST
    servers on ports the system picks, a manual clock at `slots`), the fetched blocks
    imported through its chain (inside `step("b")` when given), one scrape
    of its /metrics and one `notifier.on_slot(slots)` line; closed after.
    Runs on the calling loop (it becomes the chain's loop)."""
    import tempfile

    from lodestar_tpu_torch.cli import dev_chain_config
    from lodestar_tpu_torch.node import BeaconNode, BeaconNodeOptions

    cc = dev_chain_config()
    with tempfile.TemporaryDirectory(dir=db_dir) as tmp:
        opts = BeaconNodeOptions(
            device=device, db_path=os.path.join(tmp, "wal.log"), metrics_enabled=True,
            metrics_port=0, rest_port=0, manual_clock=True)
        node = await BeaconNode.init(anchor_state=fetched["state"], chain_config=cc, opts=opts,
                                     p=p, time_fn=lambda: slots * cc.SECONDS_PER_SLOT)
        try:
            out = {"verifier": verifier_kind(node.bls), "anchor": checkpoints(node.chain),
                   "ports": {"rest": node.rest_server.port,
                             "metrics": node.metrics_server.port}}
            t0 = time.perf_counter()
            with step("b") if step is not None else contextlib.nullcontext():
                for signed in fetched["blocks"]:
                    await node.chain.process_block(signed)
            out["import_s"] = time.perf_counter() - t0
            out.update(checkpoints(node.chain))
            out["pool"] = dict(getattr(node.bls, "metrics", {}))
            out["scrape"] = scrape_metrics(None, port=node.metrics_server.port)
            out["notifier"] = node.notifier.on_slot(slots)
        finally:
            await node.close()
    return out


def node_run(device="cuda", step=None, linger=NODE_LINGER_S, slots=NODE_SLOTS):
    """Phase 10g's scenario on `device` ("cuda", or "cpu" to run it here):
    (a) `cli.main(["dev", ...])` on a thread (its stdout kept by
    `ThreadLines`), (b) `fetch_anchor` while it lingers, then
    `anchored_node`, (c) both closed. `step(name)` is a context manager
    around (a) and (b) (CountedStep), or None. Restores the process-global
    settings the nodes change. Returns what each part gave."""
    import asyncio
    import threading

    from lodestar_tpu_torch import cli, params

    before = {th.name for th in threading.enumerate()}
    port = free_port()
    argv = ["dev", "--validators", str(NODE_VALIDATORS), "--slots", str(slots),
            "--preset", "minimal", "--rest-port", str(port), "--linger", str(linger)]
    if device != "cuda":
        argv += ["--device", device]
    result, times = {}, []

    def dev():
        try:
            result["rc"] = cli.main(argv)
        except BaseException as e:  # the phase reports it
            result["error"] = repr(e)

    out = {"argv": argv}
    with node_settings_restored(), timed_imports(times):
        thread = threading.Thread(target=dev, name="node-dev")
        lines = ThreadLines(sys.stdout, thread.name, "node: (a) ", "dev chain done")
        sys.stdout = lines
        try:
            t0 = time.perf_counter()
            with step("a") if step is not None else contextlib.nullcontext():
                thread.start()
                while not lines.seen.wait(0.2):
                    if not thread.is_alive():
                        raise P2pCheckFailed(f"node: the dev run ended early: {result}")
            out["dev_s"] = time.perf_counter() - t0
            out["dev_imports"] = [(dt, err) for chain, dt, err in times]
            out["dev_verifier"] = verifier_kind(times[0][0].bls) if times else None
            t0 = time.perf_counter()
            fetched = fetch_anchor(f"http://127.0.0.1:{port}", params.MINIMAL, slots)
            out["fetch_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["anchored"] = asyncio.run(anchored_node(fetched, device, params.MINIMAL,
                                                        slots, step))
            out["anchored_s"] = time.perf_counter() - t0
            out["anchored_imports"] = [(dt, err) for chain, dt, err in times[len(out["dev_imports"]):]]
            t0 = time.perf_counter()
            thread.join(linger + 60)
        finally:
            sys.stdout = lines.real
        out["close_s"] = time.perf_counter() - t0
    out["lines"] = lines.lines
    out["rc"] = result.get("rc")
    out["error"] = result.get("error")
    out.update({k: fetched[k] for k in ("fetch_state_s", "fetch_blocks_s", "finalized_state_root",
                                        "dev")})
    from lodestar_tpu_torch.state_transition import state_hash_tree_root

    out["anchor_state_root"] = "0x" + bytes(state_hash_tree_root(fetched["state"])).hex()
    out["anchor_slot"] = int(fetched["state"].slot)
    out["blocks"] = len(fetched["blocks"])
    deadline = time.time() + 15
    while time.time() < deadline and (server_threads() or thread.is_alive()):
        time.sleep(0.05)
    out["threads_left"] = sorted({th.name for th in threading.enumerate()} - before)
    out["listening"] = [p for p in (port, *out["anchored"]["ports"].values()) if listening(p)]
    return out


def node_phase(dev, smi):
    """Phase 10g: `node_run` on the card, each part a counted step. Fails on
    a verifier other than the CUDA pool, a rejected block, a replay other
    than one class-8 replay an import, a capture, an eager launch, a kernel
    no replay launched, a scrape that disagrees with the counts, a node
    that does not finalize as the CPU runs of both packages do, or anything
    left running. Lines start `node:`."""
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import fp_cuda
    from lodestar_tpu_torch.ssz import device_htr as dh

    on_card = dev.type == "cuda"
    cache = bv._SINGLE_LAUNCH_GRAPHS
    captures = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)
    steps, replayed_total, classes_seen = {}, dict.fromkeys(fp_cuda.KERNELS, 0), set()

    def Step(name):
        return CountedStep(dev, steps, replayed_total, classes_seen, name)

    t0 = time.perf_counter()
    try:
        rec = node_run("cuda" if on_card else "cpu", step=Step)
    except P2pCheckFailed as e:
        fail(str(e))
    wall = time.perf_counter() - t0
    b = rec["anchored"]
    n_a, n_b = NODE_SLOTS, NODE_SLOTS - rec["anchor_slot"]
    want_verifier = "pool:cuda" if on_card else "BlsSingleThreadVerifier"
    if rec["error"] is not None or rec["rc"] != 0:
        fail(f"node: the dev command returned {rec['rc']} ({rec['error']})")
    if rec["lines"][-1] != f"dev chain done: head slot {NODE_SLOTS}, finalized epoch 2":
        fail(f"node: the dev run ended with {rec['lines'][-1]!r}")
    if sum(1 for line in rec["lines"] if ": block atts=" in line) != n_a:
        fail(f"node: not every slot of the dev run proposed a block: {rec['lines']}")
    if rec["dev_verifier"] != want_verifier or b["verifier"] != want_verifier:
        fail(f"node: the verifiers are {rec['dev_verifier']} and {b['verifier']}, "
             f"not {want_verifier}")
    rejected = [err for _, err in rec["dev_imports"] + rec["anchored_imports"] if err]
    if rejected or len(rec["dev_imports"]) != n_a or len(rec["anchored_imports"]) != n_b:
        fail(f"node: imports {len(rec['dev_imports'])} + {len(rec['anchored_imports'])}, "
             f"rejected {rejected}")
    if rec["anchor_state_root"] != rec["finalized_state_root"]:
        fail(f"node: the checkpoint state's root {rec['anchor_state_root']} is not the "
             f"finalized block's state root {rec['finalized_state_root']}")
    dev_cp = rec["dev"]
    # the justified checkpoint may differ: a store anchored past genesis starts
    # at the anchor's epoch + 1 (as the JAX package's does; the CPU test holds
    # both packages' anchored nodes to the same three checkpoints)
    if b["head"] != dev_cp["head"] or b["finalized"] != dev_cp["finalized"]:
        fail(f"node: the anchored node's head {b['head']} and finalized {b['finalized']} "
             f"are not the dev node's {dev_cp}")
    if rec["threads_left"] or rec["listening"]:
        fail(f"node: left running: threads {rec['threads_left']}, ports {rec['listening']}")
    samples = b["scrape"][0]
    got = {"head_slot": sample_sum(samples, "beacon_head_slot"),
           "finalized_epoch": sample_sum(samples, "beacon_finalized_epoch"),
           "jobs_dequeued": sample_sum(samples, "lodestar_sched_jobs_dequeued_total")}
    want = {"head_slot": b["head"][0], "finalized_epoch": b["finalized"][0],
            "jobs_dequeued": b["pool"].get("jobs_started", 0)}
    if on_card:
        got["single_launch_by_class"] = {
            int(dict(lab)["size_class"]): int(v) for (name, lab), v in samples.items()
            if name == "lodestar_device_launch_seconds_count" and v
            and dict(lab)["program"] == "_single_launch_verify"}
        want["single_launch_by_class"] = steps["b"]["replays_by_class"]
        want["jobs_dequeued"] = n_b
    if got != want:
        fail(f"node: (b)'s scrape {got} disagrees with the phase's counts {want}")
    per_replay = {}
    if on_card:
        for name in ("a", "b"):
            st = steps[name]
            n = n_a if name == "a" else n_b
            if st["replays_by_class"] != {8: n}:
                fail(f"node: ({name}) replayed {st['replays_by_class']}, not {n} of class 8")
            if any(st["fp_eager"].values()):
                fail(f"node: ({name}) launched kernels eagerly: {st['fp_eager']}")
        missing = [k for k in fp_cuda.KERNELS if replayed_total[k] <= 0]
        if missing:
            fail(f"node: kernels never launched in the phase: {missing}")
        per_replay = cache.graphs[(dev.index, 8)].launches
    now = (cache.captures, dh.HTR_GRAPHS.captures, dh.ROOT_GRAPHS.captures)
    if now != captures:
        fail(f"node: graphs were captured in the phase (BLS, HTR level, HTR root: "
             f"{captures} -> {now})")
    replay_ms8 = replay_ms(cache.graphs[(dev.index, 8)]) if on_card else None
    busy_ms8, events8 = profiled_replay(cache.graphs[(dev.index, 8)]) if on_card else (None, 0)

    def spread(xs):
        xs = sorted(xs)
        return [xs[0], xs[len(xs) // 2], xs[-1]] if xs else None

    a_imports = spread([dt for dt, _ in rec["dev_imports"]])
    b_imports = spread([dt for dt, _ in rec["anchored_imports"]])
    # the card's idle share, estimated: the run's replays x one profiled
    # class-8 replay's kernel busy ms, over the run's wall s
    idle = {}
    for name in ("a", "b"):
        wall_s = rec["dev_s"] if name == "a" else b["import_s"]
        busy = (sum(steps[name]["replays_by_class"].values()) * busy_ms8 / 1e3
                if busy_ms8 else None)
        idle[name] = {"wall_s": wall_s, "busy_s": busy,
                      "idle_estimated": None if busy is None else 1 - busy / wall_s}

    def share(x):
        return "not measured" if x is None else f"{x:.3f}"
    a_fp = steps["a"]["fp_replayed"]
    say(f"node: (a) `python -m lodestar_tpu_torch {' '.join(rec['argv'])}` in-process: "
        f"verifier {rec['dev_verifier']}, {n_a} blocks in {rec['dev_s']:.2f} s, per import "
        f"(min / median / max) {a_imports} s, replays {steps['a']['replays_by_class']}, "
        f"exit {rec['rc']} on {smi}")
    say(f"node: (a) Fp launches {a_fp} (predicted {n_a} x a class-8 replay's "
        f"{ {k: n_a * v for k, v in per_replay.items()} }); a class-8 replay {replay_ms8} ms "
        f"device (CUDA events), its kernels busy {busy_ms8} ms over {events8} device events "
        f"(profiled); idle share estimated from {n_a} replays x that busy time over the "
        f"{idle['a']['wall_s']:.2f} s run: {share(idle['a']['idle_estimated'])}")
    say(f"node: (b) checkpoint state fetched over REST in {rec['fetch_state_s']:.3f} s: slot "
        f"{rec['anchor_slot']}, root {rec['anchor_state_root']} (the finalized block's state "
        f"root); {rec['blocks']} blocks in {rec['fetch_blocks_s']:.3f} s")
    say(f"node: (b) anchored node ({b['verifier']}) imported {rec['blocks']} blocks in "
        f"{b['import_s']:.2f} s, per import {b_imports} s, replays "
        f"{steps['b']['replays_by_class']}, idle estimated {share(idle['b']['idle_estimated'])}; "
        f"head {b['head']}, "
        f"finalized {b['finalized']}, justified {b['justified']}; the dev node's head "
        f"{dev_cp['head']}, finalized {dev_cp['finalized']}, justified {dev_cp['justified']}")
    say(f"node: (b) scrape {b['scrape'][1]} bytes in {b['scrape'][2]:.2f} ms: {got}; "
        f"notifier: {b['notifier']}")
    say(f"node: (c) both nodes closed in {rec['close_s']:.2f} s (the dev node's linger "
        f"included); no thread, server or socket left; phase {wall:.1f} s")
    return {"dev_s": rec["dev_s"], "dev_imports_s": a_imports, "anchored_imports_s": b_imports,
            "replays": {k: steps[k]["replays_by_class"] for k in ("a", "b")},
            "fp_replayed": {k: steps[k]["fp_replayed"] for k in ("a", "b")},
            "idle": idle, "replay_ms_class8": replay_ms8,
            "busy_ms_class8": busy_ms8, "fetch_state_s": rec["fetch_state_s"],
            "fetch_blocks_s": rec["fetch_blocks_s"], "anchor_slot": rec["anchor_slot"],
            "head": b["head"], "finalized": b["finalized"], "justified": b["justified"],
            "dev": dev_cp, "scrape": {"bytes": b["scrape"][1], "ms": b["scrape"][2],
                                      "compared": got},
            "notifier": b["notifier"], "close_s": rec["close_s"], "wall_s": wall,
            "replayed": replayed_total}


# --- comparison with an earlier commit's kernels (--compare-parent) -----------


def compare_kernels(parent, main_run, dev, smi):
    """Each kernel of the parent's library against its plain version, and its
    device time beside this source's, in turns (parent, this, this, parent),
    at the row counts of N_TIMED and of one merged verify and one 2048-set
    prep; ms per verify and per prep = launches x time at each row count."""
    import numpy as np
    import torch

    from lodestar_tpu_torch.ops import fp, fp_cuda

    libs = {"parent": parent, "this": fp_cuda._load()}
    rng = np.random.default_rng(11)
    result = {}
    for name in fp_cuda.KERNELS:
        plain = getattr(fp, f"plain_{name}")
        us = {t: {} for t in libs}
        runs_rows = {label: main_run[f"per_{label}_rows"][name] for label in ("verify", "prep")}
        for n in sorted({*N_TIMED, *runs_rows["verify"], *runs_rows["prep"]}):
            args = kernel_inputs(name, n, rng, dev)
            want = plain(*args)
            runs = {t: [] for t in libs}
            for tag in ("parent", "this", "this", "parent"):
                lib = libs[tag]
                if not torch.equal(fp_cuda.launch(name, *args, lib=lib), want):
                    fail(f"compare: {name} of the {tag} build differs from its plain "
                         f"version at N={n}")
                runs[tag].append(graph_ms(lambda: fp_cuda.launch(name, *args, lib=lib)))
            for t in libs:
                us[t][n] = 1e3 * sum(runs[t]) / len(runs[t])
            say(f"compare: {name} N={n}: parent {us['parent'][n]:.2f} us, this "
                f"{us['this'][n]:.2f} us (graph replay, in turns)")
        result[name] = {"us": us}
        for label, by_rows in runs_rows.items():
            per_run = {t: sum(c * us[t][n] for n, c in by_rows.items()) / 1e3 for t in libs}
            result[name][f"ms_per_2048_{label}"] = per_run
            say(f"compare: {name} ms per {label} parent {per_run['parent']:.2f}, this "
                f"{per_run['this']:.2f} on {smi}")
    say("compare: " + json.dumps(result))
    return result


# --- phase 11 ----------------------------------------------------------------


def check_against_cpu(dev):
    import numpy as np
    import torch

    from lodestar_tpu_torch.crypto.bls import curve as C
    from lodestar_tpu_torch.crypto.bls import fields as F
    from lodestar_tpu_torch.ops import fp, pairing as prg, tower as tw

    pairs = [(C.g1_mul(C.G1_GEN, 5), C.g2_mul(C.G2_GEN, 7)),
             (C.g1_mul(C.G1_GEN, 35), C.G2_GEN)]
    px = np.stack([fp.mont_limbs_from_int(p[0]) for p, _ in pairs])
    py = np.stack([fp.mont_limbs_from_int(p[1]) for p, _ in pairs])
    qx = np.stack([tw._fp2_mont_limbs_host(*q[0]) for _, q in pairs])
    qy = np.stack([tw._fp2_mont_limbs_host(*q[1]) for _, q in pairs])

    def run(device):
        t = [torch.from_numpy(a).to(device) for a in (px, py, qx, qy)]
        return prg.final_exponentiation(prg.miller_loop((t[0], t[1]), (t[2], t[3])))

    on_card = run(dev).cpu()
    on_cpu = run("cpu")
    if not torch.equal(on_card, on_cpu):
        fail("pairing limbs on the card differ from the CPU path")
    std = fp.ints_from_limbs(fp.from_mont(on_cpu.reshape(-1, fp.LIMBS)).numpy())
    vals = [std[i:i + 12] for i in (0, 12)]
    # e(5P, 7Q) == e(35P, Q), and each is a nontrivial element of order r
    if vals[0] != vals[1] or vals[0] == [1] + [0] * 11:
        fail("pairing bilinearity check failed")
    f = tuple(tuple((vals[0][6 * h + 2 * k], vals[0][6 * h + 2 * k + 1]) for k in range(3))
              for h in range(2))
    if F.fp12_pow(f, C.R) != F.FP12_ONE:
        fail("pairing value is not in the order-r subgroup")
    say("check: pairing of 2 pairs on the card == CPU path limb for limb; bilinear; order r")


def native_builds():
    """The native host libraries' loaders (g++ builds into
    `lodestar_tpu_torch/native/_build/` at their first call)."""
    from lodestar_tpu_torch import native
    from lodestar_tpu_torch.native import bls as native_bls

    return [native.sha256_available, native_bls.available]


def timed_build(load):
    t0 = time.perf_counter()
    return load(), time.perf_counter() - t0


def native_report(natives):
    """Fail unless both native libraries built, loaded and (the BLS one)
    passed its self-test; print the hasher's backend and the build s."""
    from lodestar_tpu_torch import native

    (sha_ok, sha_s), (bls_ok, bls_s) = natives
    if not sha_ok:
        fail("the native SHA-256 library did not build or load")
    if not bls_ok:
        fail("the native BLS library did not build, load or pass its self-test")
    say(f"build: native host libraries built and loaded: sha256_batch {sha_s:.1f} s (backend "
        f"{native.sha256_backend()}), bls_host {bls_s:.1f} s (self-test passed), beside nvcc")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare-parent", metavar="DIR",
                        help="also time the kernels of the checkout in DIR beside these")
    args = parser.parse_args()
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "lodestar_tpu_torch")):
        fail("lodestar_tpu_torch/ not found beside chip_smoke.py: run it from a checkout")
    sys.path.insert(0, repo)
    import torch

    t_start = time.perf_counter()
    phase_s = {}  # wall s of each phase, printed before the report

    def phase(name, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        phase_s[name] = time.perf_counter() - t0
        return out

    # 1. probe
    say(f"probe: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    say(f"probe: device {kind}; nvidia-smi: {smi}")

    # 2. build
    from lodestar_tpu_torch.ops import fp_cuda

    t0 = time.perf_counter()
    sources = [fp_cuda.SOURCE]
    if args.compare_parent:
        sources.append(os.path.join(args.compare_parent, SOURCE))
        if not os.path.exists(sources[1]):
            fail(f"no kernel source in the parent checkout at {sources[1]}")
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 2) as pool:  # one compiler each
        natives = [pool.submit(timed_build, build) for build in native_builds()]
        paths = list(pool.map(lambda src: fp_cuda.build(verbose=True, source=src), sources))
        natives = [f.result() for f in natives]
    fp_cuda._load()
    parent = fp_cuda.load_library(paths[1]) if args.compare_parent else None
    phase_s["build"] = time.perf_counter() - t0
    say(f"build: fp kernels built and loaded in {phase_s['build']:.1f} s")
    native_report(natives)

    # 3. kernels vs plain versions
    report = phase("kernels", check_kernels, dev)
    # 4. main path
    main_run = phase("main", main_path, dev, smi)
    # 5. profile of one merged verify and one 2048-set prep
    per_ms, profiled_ms = phase("profile", profile_main, main_run, smi)
    # 6. single launch, and the J-job verify
    single = phase("single", single_launch, dev, smi, main_run)
    many_s = phase("many", verify_many, dev, smi, main_run)
    # 7. serving through the verifier pool
    served = phase("serve", serve, dev, smi, main_run)
    # 7b. the offload host on the device mesh
    offloaded = phase("offload", offload, dev, smi, main_run, served)
    # 7c. the offload client over two hosts on the card
    clients = phase("client", offload_client, dev, smi, main_run, served, offloaded)
    # 7d. the sharded verify and the pool's sharded bulk road
    shard_run = phase("sharded", sharded, dev, smi, main_run, single)
    # 8. the state hashTreeRoot
    hashed = phase("htr", htr, dev, smi)
    # 9. KZG at a mainnet block
    kzged = phase("kzg", kzg, dev, smi)
    # 10. a mainnet-preset Capella block imported on the card
    blocked = phase("block", block_import, dev, smi)
    # 10b. the same block, gossip and a produced block through the port's BeaconChain
    chained = phase("chain", chain_phase, dev, smi, blocked)
    # 10c. range sync, backfill and gossip over the wire into the port's chain
    synced = phase("sync", sync_phase, dev, smi, blocked)
    # 10d. discovery, range sync and gossip between two libp2p services
    p2ped = phase("p2p", p2p_phase, dev, smi, blocked, synced)
    # 10e. full sync aggregates on the chain and a light client following it
    lced = phase("lightclient", lightclient_phase, dev, smi, blocked, synced)
    # 10f. a validator client's duties over the REST API on that chain
    rested = phase("rest", rest_phase, dev, smi, blocked, synced)
    # 10g. the node and the CLI: a dev chain finalizing on the card, a node synced from it
    noded = phase("node", node_phase, dev, smi)
    # 11. check against the CPU path
    phase("check", check_against_cpu, dev)
    if parent is not None:
        phase("compare", compare_kernels, parent, main_run, dev, smi)

    # 12. report
    from lodestar_tpu_torch.models import batch_verify as bv

    runs = {"verify": main_run["per_verify_rows"], "prep": main_run["per_prep_rows"]}
    kernels = []
    for name in fp_cuda.KERNELS:
        entry = {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "status": "ok",
            "launches": main_run["launches"][name],
            "launches_per_2048_single_launch": single["graph"].launches[name],
            "launches_per_2048_single_launch_by_rows": single["graph"].rows[name],
            "single_launch_replayed": single["replayed"][name],
            "launches_per_replay_by_class": {
                size: g.launches[name]
                for (idx, size), g in sorted(bv._SINGLE_LAUNCH_GRAPHS.graphs.items())
                if idx == dev.index},
            "serve_replayed": served["replayed"][name],
            "offload_replayed": offloaded["replayed"][name],
            "offload_client_replayed": clients["replayed"][name],
            "sharded_replayed": shard_run["replayed"][name],
            "kzg_launches": kzged["launches"][name],
            "launches_per_kzg_commitment": kzged["commitment"]["fp_launches_per_replay"][name],
            "launches_per_kzg_commitment_by_rows": kzged["msm_rows"][name],
            "ms_per_kzg_commitment": kzged["ms_per_commitment"][name],
            "bound_ms_per_kzg_commitment": sum(c * bound(name, n)[0]
                                               for n, c in kzged["msm_rows"][name].items()),
            "launches_per_kzg_check": kzged["check"]["fp_launches_per_replay"][name],
            "launches_per_kzg_check_by_rows": kzged["check_rows"][name],
            "ms_per_kzg_check": kzged["ms_per_check"][name],
            "bound_ms_per_kzg_check": sum(c * bound(name, n)[0]
                                          for n, c in kzged["check_rows"][name].items()),
            "block_import_replayed": blocked["import"]["fp_replayed"][name],
            "launches_per_block_import": blocked["fp_launches_per_replay"][name],
            "chain_replayed": chained["replayed"][name],
            "sync_replayed": synced["replayed"][name],
            "p2p_replayed": p2ped["replayed"][name],
            "lc_replayed": lced["replayed"][name],
            "rest_replayed": rested["replayed"][name],
            "node_replayed": noded["replayed"][name],
        }
        for label, per_rows in runs.items():
            by_rows = per_rows[name]
            entry.update({
                f"launches_per_2048_{label}": sum(by_rows.values()),
                f"launches_per_2048_{label}_by_rows": by_rows,
                f"ms_per_2048_{label}": per_ms[label][name],
                f"bound_ms_per_2048_{label}": sum(c * bound(name, n)[0] for n, c in by_rows.items()),
                f"profiler_ms_per_2048_{label}": profiled_ms[label][name],
            })
        entry.update({
            "max_abs_err": report[name]["max_abs_err"],
            "ms": report[name]["ms"],
            "plain_ms": report[name]["plain_ms"],
            "bound_ms": report[name]["bound_ms"],
            "bound_by": report[name]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a Montgomery product
            "n": report[name]["n"],
            "at_rows": [{"n": n, **v} for n, v in report[name]["at_rows"].items()],
        })
        kernels.append(entry)
    merged = BATCH * MERGE_JOBS
    g = single["graph"]
    say("single: " + json.dumps({
        "bytes_to_verdict_s": single["bytes_to_verdict_s"], "sigs_per_s": single["sigs_per_s"],
        "host_bytes_s": single["host_s"], "replay_s": single["replay_s"],
        "replay_device_ms": single["replay_device_ms"],
        "replay_share": single["replay_share"],
        "nodes": g.nodes, "capture_s": g.capture_s,
        "instantiate_s": g.instantiate_s, "pool_bytes": g.pool_bytes,
        "fp_launches_per_replay": g.launches, "many_16x128_s": many_s}))
    say("main: native prep " + json.dumps(main_run["native"]))
    say("serve: " + json.dumps({
        "warm_s": served["warm_s"], "scrape": served["scrape"],
        "per_class": {size: {k: v for k, v in c.items() if k != "launches"}
                      for size, c in served["per_class"].items()},
        "runs": served["runs"]}))
    say("offload: " + json.dumps({k: v for k, v in offloaded.items()
                                  if k not in ("replayed", "server")}))
    say("offload-client: " + json.dumps({k: v for k, v in clients.items() if k != "replayed"},
                                        default=str))
    say("sharded: " + json.dumps({k: v for k, v in shard_run.items() if k != "replayed"}))
    say("htr: " + json.dumps(hashed))
    say("kzg: " + json.dumps({k: v for k, v in kzged.items() if not k.endswith("_rows")}))
    say("block: " + json.dumps({k: v for k, v in blocked.items() if k != "setup"}))
    say("chain: " + json.dumps({k: v for k, v in chained.items() if k != "replayed"}))
    say("sync: " + json.dumps({k: v for k, v in synced.items()
                               if k not in ("replayed", "chains")}))
    say("p2p: " + json.dumps({k: v for k, v in p2ped.items() if k != "replayed"}))
    say("lightclient: " + json.dumps({k: v for k, v in lced.items() if k != "replayed"},
                                     default=str))
    say("rest: " + json.dumps({k: v for k, v in rested.items() if k != "replayed"}))
    say("node: " + json.dumps({k: v for k, v in noded.items() if k != "replayed"}))
    say(f"result: {main_run['sigs_per_s']:.1f} sigs/s verify-only, "
        f"{main_run['bytes_to_verdict_sigs_per_s']:.1f} sigs/s bytes to verdict ({merged}-set "
        f"merged batch, split schedule, device prep {main_run['prep_s']:.3f} s); single launch "
        f"{single['sigs_per_s']:.1f} sigs/s bytes to verdict on {smi}")
    say("timing: " + json.dumps({**{k: round(v, 1) for k, v in phase_s.items()},
                                 "total_s": round(time.perf_counter() - t_start, 1)}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
