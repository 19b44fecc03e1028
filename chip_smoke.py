#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`lodestar_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. probe    torch version, CUDA device, `nvidia-smi` name and power limit.
2. build    compile the Fp kernels (ops/csrc/fp_kernels.cu) from source.
3. kernels  each of the five kernels against its plain PyTorch version on
            the card, bit for bit (tolerance 0), at the tile edges of the
            kernels and the main path's row counts (N_KERNEL_CHECK), on
            random relaxed signed limbs made with numpy from a fixed seed:
            +-LIMB_LOOSE rows, exact-zero rows, and for redc signed sums of
            three accumulators. Then each kernel's DEVICE time at the row
            counts of N_TIMED: 50 launches captured in one CUDA graph, the
            replays timed with CUDA events (so the wrappers' host work is
            not in it), each time beside its bound.
4. main     the port's main path through its entry points: 128 synthetic
            sets (bench.py's seed 17) verify True, two swapped signatures
            verify False, then 16 x 128 = 2048 sets merged into one
            `device_batch_verify` with fresh blinding (1 warm-up, 3 timed
            runs), all True. Launch counts are reset just before and read
            just after; every kernel must have launched.
5. profile  where the time of one merged 2048-set verify goes: each
            kernel's launches per verify by row count, and its kernel ms per
            verify (launches x graph-replay time at each of those row
            counts); one more verify split at its three stage boundaries
            (wall time and kernel launches per stage), then one under
            `torch.profiler` for the card's busy time, its idle share of the
            unprofiled verify's wall time, and the device time per kernel.
6. check    a Miller loop + final exponentiation of two pairs on the card
            equals the CPU path (the plain versions) limb for limb, and
            equals e(P, Q) from the host pairing check on canonical values.
7. report   one JSON line of kernels, the `nvidia-smi` line, and the last
            line {"ok": true, "device": {...}}.

With `--compare-parent DIR` (a checkout of an earlier commit, for example
unpacked with `git archive` into a directory that .gitignore lists),
phase 2 also builds DIR's kernel source, beside this one's, and a step
between phases 6 and 7 checks each of its kernels against the plain
version and times it beside this source's, in turns (parent, this, this,
parent), at the row counts of N_TIMED and of one merged verify, each
with its ms per verify.

Host prep is the pure-Python oracle (tens of ms per set); it runs outside
every timed window and is printed on its own line.
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

# Row counts the main path launches the Fp kernels at (a 2048-set verify:
# 1 in the Fermat chains, 12/36 in the final exponentiation, 2048 in the
# Fermat chain of the blinded public keys, 4096-6147 in the curve and tower
# steps, 24588-73764 in the Miller loop), the edges of the kernels' paths
# (one row, one 16- or 32-row tile), tiles, 128-row blocks and share counts
# (eight a row up to 16 rows per SM: 2112 on an H100 SXM), the two sides of
# redc's switch to its column-range body (past five 32-row tiles per SM:
# 21120), and 110646, the row count the first kernel table was measured at.
N_TIMED = (1, 12, 36, 2048, 4096, 6147, 21120, 21121, 24588, 73764, 110646)
N_KERNEL_CHECK = tuple(sorted({*N_TIMED, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65, 511, 512,
                               513, 2049, 2112, 2113, 4098}))
N_COMPARE = 110646
BATCH = 128  # sets per gossip job
MERGE_JOBS = 16  # jobs merged into one RLC batch
TIMED_RUNS = 3

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
# Each kernel's function name as a profiler trace shows it (demangled).
SYMBOL = {
    "mul_acc": "mul_acc_kernel(",
    "sq_acc": "sq_acc_kernel(",
    "redc": "redc_kernel<",  # every <PATH, W> instantiation
    "mont_mul": "mont_mul_kernel<",
    "mont_sq": "mont_sq_kernel<",
}


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


def check_kernels(dev):
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
        for n in N_KERNEL_CHECK:
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
        say(f"kernel {name}: bit-exact at N={list(N_KERNEL_CHECK)}; at N={N_COMPARE}: "
            f"{report[name]['ms']:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {by})")
    return report


# --- phase 4 -----------------------------------------------------------------


def main_path(dev, smi):
    import dataclasses

    import torch

    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import fp_cuda

    t0 = time.perf_counter()
    sets = bv.make_synthetic_sets(BATCH, seed=17)
    say(f"host: made {BATCH} synthetic signature sets in {time.perf_counter() - t0:.1f} s")
    tampered = list(sets)
    tampered[0] = dataclasses.replace(sets[0], signature=sets[1].signature)
    tampered[1] = dataclasses.replace(sets[1], signature=sets[0].signature)

    fp_cuda.reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    if bv.verify_signature_sets_device(sets) is not True:
        fail(f"the valid {BATCH}-set batch did not verify")
    say(f"main: {BATCH}-set batch verifies True ({time.perf_counter() - t0:.2f} s with host prep)")
    t0 = time.perf_counter()
    if bv.verify_signature_sets_device(tampered) is not False:
        fail("the batch with two swapped signatures verified")
    say(f"main: swapped-signature batch verifies False ({time.perf_counter() - t0:.2f} s)")

    t0 = time.perf_counter()
    inputs = bv.build_device_inputs(sets, size=BATCH)
    if inputs is None:
        fail("host prep rejected the synthetic sets")
    say(f"host: prep of {BATCH} sets (pure-Python oracle) {time.perf_counter() - t0:.2f} s, "
        "outside the timed window")
    pk, h, sig, _, _ = inputs
    merged = BATCH * MERGE_JOBS

    def tile(x):
        return torch.cat([x] * MERGE_JOBS, dim=0)

    pk_m, h_m, sig_m = (tuple(tile(c) for c in pt) for pt in (pk, h, sig))
    mask_m = torch.ones(merged, dtype=torch.bool, device=dev)

    def fresh_bits():
        bits, _ = bv._blinding_and_mask(merged, merged)
        return torch.as_tensor(bits, device=dev)

    if not bool(bv.device_batch_verify(pk_m, h_m, sig_m, fresh_bits(), mask_m)):
        fail("warm-up merged batch did not verify")
    times, per_verify_rows = [], None
    for i in range(TIMED_RUNS):
        bits = fresh_bits()
        before_rows = {k: dict(v) for k, v in fp_cuda.ROWS.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = bool(bv.device_batch_verify(pk_m, h_m, sig_m, bits, mask_m))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not ok:
            fail(f"timed merged batch {i} did not verify")
        if per_verify_rows is None:
            per_verify_rows = {
                k: {n: c - before_rows[k].get(n, 0) for n, c in sorted(fp_cuda.ROWS[k].items())
                    if c > before_rows[k].get(n, 0)}
                for k in fp_cuda.KERNELS
            }
    launches = dict(fp_cuda.LAUNCHES)  # the main path's run ends here
    per_verify = {k: sum(rows.values()) for k, rows in per_verify_rows.items()}
    mean = sum(times) / len(times)
    say(f"main: {merged}-set merged batch x{TIMED_RUNS}: "
        f"{', '.join(f'{t:.3f}' for t in times)} s; {merged / mean:.1f} sigs/s on {smi}")
    say(f"main: launches over the main path {launches}")
    say(f"main: launches per {merged}-set verify {per_verify}")
    missing = [k for k in fp_cuda.KERNELS if launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    return (launches, per_verify, per_verify_rows, merged / mean,
            (pk_m, h_m, sig_m, mask_m, fresh_bits))


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


def busy_ms(events):
    """Union of the device kernel intervals of a profiler trace, in ms."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
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


def kernel_ms_per_verify(per_verify_rows, dev):
    """{name: ms}: launches x graph-replay device time, summed over the row
    counts one merged verify launches the kernel at."""
    import numpy as np

    from lodestar_tpu_torch.ops import fp_cuda

    rng = np.random.default_rng(7)
    out = {}
    for name, by_rows in per_verify_rows.items():
        kernel = getattr(fp_cuda, name)
        total = 0.0
        for n, count in by_rows.items():
            args = kernel_inputs(name, n, rng, dev)
            total += count * graph_ms(lambda: kernel(*args), iters=20, replays=3)
        out[name] = total
    return out


def profile_merged(merged_inputs, per_verify_rows, smi):
    import torch

    from lodestar_tpu_torch.models import batch_verify as bv

    pk, h, sig, mask, fresh_bits = merged_inputs
    for name, by_rows in per_verify_rows.items():
        say(f"profile: {name} launches per {mask.numel()}-set verify by row count "
            f"{{rows: launches}}: {json.dumps(by_rows)}")
    per_verify_ms = kernel_ms_per_verify(per_verify_rows, mask.device)
    ok, stages = verify_by_stage(pk, h, sig, fresh_bits(), mask)
    if not ok:
        fail("the stage-split merged batch did not verify")
    wall = sum(t for t, _ in stages.values())
    say(f"profile: stage-split {mask.numel()}-set verify {wall:.3f} s on {smi}")
    for name, (t, n) in stages.items():
        say(f"profile: stage {name}: {t:.3f} s ({100 * t / wall:.1f}%), {n} kernel launches")

    bits = fresh_bits()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = bool(bv.device_batch_verify(pk, h, sig, bits, mask))
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    if not ok:
        fail("the profiled merged batch did not verify")
    events = prof.events()
    host_ops = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
                   and e.cpu_parent is None and e.name.startswith("aten::"))
    say(f"profile: profiled verify {prof_wall_ms:.1f} ms wall (profiler on), "
        f"{host_ops} top-level aten calls")
    busy = busy_ms(events)
    if busy == 0:
        say("profile: device busy time: not measured (the trace holds no device events)")
        for name, ms in per_verify_ms.items():
            say(f"profile: {name} kernel ms per verify {ms:.2f} (graph replay x launches); "
                "profiler: not measured")
        return per_verify_ms, dict.fromkeys(per_verify_ms)
    # The profiler slows the host, not the card: the idle share is read
    # against the unprofiled stage-split verify's wall time.
    say(f"profile: device busy {busy:.1f} ms; idle {100 * (1 - busy / (wall * 1e3)):.1f}% of "
        f"the unprofiled {wall * 1e3:.1f} ms ({100 * (1 - busy / prof_wall_ms):.1f}% of the "
        f"profiled wall) on {smi}")
    by_kernel = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = by_kernel.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    for name, (count, ms) in top[:8]:
        say(f"profile: kernel {ms:9.2f} ms {count:7d}x  {name[:90]}")
    profiled = {}
    for name, symbol in SYMBOL.items():
        hits = [(c, ms) for n, (c, ms) in by_kernel.items() if symbol in n]
        profiled[name] = sum(ms for _, ms in hits)
        say(f"profile: fp kernel {name}: {per_verify_ms[name]:.2f} ms per verify from graph "
            f"replay x launches; profiler {profiled[name]:.2f} ms over "
            f"{sum(c for c, _ in hits)} launches")
    say(f"profile: fp kernels {sum(profiled.values()):.2f} ms of {busy:.1f} ms busy "
        f"(graph replay x launches: {sum(per_verify_ms.values()):.2f} ms)")
    return per_verify_ms, profiled


# --- comparison with an earlier commit's kernels (--compare-parent) -----------


def compare_kernels(parent, per_verify_rows, dev, smi):
    """Each kernel of the parent's library against its plain version, and its
    device time beside this source's, in turns (parent, this, this, parent),
    at the row counts of N_TIMED and of one merged verify; ms per verify =
    launches x time at each row count."""
    import numpy as np
    import torch

    from lodestar_tpu_torch.ops import fp, fp_cuda

    libs = {"parent": parent, "this": fp_cuda._load()}
    rng = np.random.default_rng(11)
    result = {}
    for name in fp_cuda.KERNELS:
        plain = getattr(fp, f"plain_{name}")
        us = {t: {} for t in libs}
        for n in sorted({*N_TIMED, *per_verify_rows[name]}):
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
        per_verify = {t: sum(c * us[t][n] for n, c in per_verify_rows[name].items()) / 1e3
                      for t in libs}
        result[name] = {"us": us, "ms_per_2048_verify": per_verify}
        say(f"compare: {name} ms per verify parent {per_verify['parent']:.2f}, this "
            f"{per_verify['this']:.2f} on {smi}")
    say("compare: " + json.dumps(result))
    return result


# --- phase 6 -----------------------------------------------------------------


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
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each
        paths = list(pool.map(lambda src: fp_cuda.build(verbose=True, source=src), sources))
    fp_cuda._load()
    parent = fp_cuda.load_library(paths[1]) if args.compare_parent else None
    say(f"build: fp kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    # 3. kernels vs plain versions
    report = check_kernels(dev)
    # 4. main path
    launches, per_verify, per_verify_rows, sigs_per_s, merged_inputs = main_path(dev, smi)
    # 5. profile of one merged verify
    per_verify_ms, profiled_ms = profile_merged(merged_inputs, per_verify_rows, smi)
    # 6. check against the CPU path
    check_against_cpu(dev)
    if parent is not None:
        compare_kernels(parent, per_verify_rows, dev, smi)

    # 7. report
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "status": "ok",
            "launches": launches[name],
            "launches_per_2048_verify": per_verify[name],
            "launches_per_2048_verify_by_rows": per_verify_rows[name],
            "ms_per_2048_verify": per_verify_ms[name],
            "bound_ms_per_2048_verify": sum(count * bound(name, n)[0]
                                            for n, count in per_verify_rows[name].items()),
            "profiler_ms_per_2048_verify": profiled_ms[name],
            "max_abs_err": report[name]["max_abs_err"],
            "ms": report[name]["ms"],
            "plain_ms": report[name]["plain_ms"],
            "bound_ms": report[name]["bound_ms"],
            "bound_by": report[name]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a Montgomery product
            "n": report[name]["n"],
            "at_rows": [{"n": n, **v} for n, v in report[name]["at_rows"].items()],
        }
        for name in fp_cuda.KERNELS
    ]
    say(f"result: {sigs_per_s:.1f} sigs/s ({BATCH * MERGE_JOBS}-set merged batch) on {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
