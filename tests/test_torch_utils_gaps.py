"""The gaps filled in otherwise-ported modules: `utils`' retry helpers,
`tracing.export` (the Chrome-trace export and its retention), the ledger
half of `telemetry`, and `ssz.tree.merkle_proof`, against the JAX package.

Tolerance: none. Each case of the JAX package's
`tests/utils/test_retry_backoff.py`, `tests/tracing/test_export_retention.py`
and the seam-free part of `tests/telemetry/test_launches.py` runs on the
port: the JAX test module's source with every import of `lodestar_tpu`
rewritten to `lodestar_tpu_torch` (`port_copy`), its assertions unchanged,
its tests collected here as `test_port_*`. The cases of `test_launches.py`
that drive a JAX seam (fused prep, the single launch, an HTR level, a mesh
lane) are written here on the port's own seams (`ops/prep.py` `_dispatch`,
`ssz/device_htr.py`, `chain/bls/mesh.py` `mesh_launch`); the one that reads
the JAX metrics registry waits for the port's metrics module. Beside them:
the retry helpers and the launch ledger give equal sleeps, entries and views
in both packages, a Chrome-trace export of one trace is the same JSON in
both, and `merkle_proof` on every field of a `BeaconState` gives the JAX
package's leaf and branch.

`port_copy` is the helper the other files of this slice use to run a JAX
test module through the port.
"""

from __future__ import annotations

import asyncio
import importlib.util
import json
import pathlib
import re
import sys
import types

import numpy as np
import pytest

_PORTED = re.compile(r"\blodestar_tpu\b(?!_torch)")


def _is_fixture(obj) -> bool:
    return (type(obj).__name__ == "FixtureFunctionDefinition"
            or getattr(obj, "_pytestfixturefunction", None) is not None)


def port_copy(modname: str, into: dict, names=None, prefix: str = "port_"):
    """Run the JAX package's test module `modname` with every import of
    `lodestar_tpu` rewritten to `lodestar_tpu_torch`, and adopt its tests
    (all, or those in `names`) into the namespace `into` as
    `test_<prefix><name>` (classes as `Test<Prefix><Name>`), with its
    fixtures under their own names. Returns the rewritten module."""
    spec = importlib.util.find_spec(modname)
    source = _PORTED.sub("lodestar_tpu_torch", pathlib.Path(spec.origin).read_text())
    package, _, leaf = modname.rpartition(".")
    name = f"{package}._port_{leaf}"
    module = sys.modules.get(name)
    if module is None:
        module = types.ModuleType(name)
        module.__file__, module.__package__ = spec.origin, package
        sys.modules[name] = module
        exec(compile(source, spec.origin, "exec"), module.__dict__)
    for key, obj in list(vars(module).items()):
        if _is_fixture(obj):
            into[key] = obj
        elif names is not None and key not in names:
            continue
        elif key.startswith("test_") and callable(obj):
            into[f"test_{prefix}{key[5:]}"] = obj
        elif key.startswith("Test") and isinstance(obj, type):
            into["Test" + prefix.title().replace("_", "") + key[4:]] = obj
    return module


J, T = "lodestar_tpu", "lodestar_tpu_torch"


def both(name):
    return [importlib.import_module(f"{root}.{name}") for root in (J, T)]


# --- utils: retry, sleep, byte helpers -----------------------------------------

port_copy("tests.utils.test_retry_backoff", globals())


def test_retry_sleeps_and_results_agree(monkeypatch):
    """The same failing and flaky callables through both packages' `retry`
    and `retry_sync`, every backoff mode: equal sleeps, attempts and
    results (or exception class and message)."""
    seen = []
    for utils in both("utils"):
        sleeps = []

        async def fake_sleep(d, sleeps=sleeps):
            sleeps.append(("async", d))

        monkeypatch.setattr(utils.time, "sleep", lambda d, sleeps=sleeps: sleeps.append(("sync", d)))
        monkeypatch.setattr(utils.asyncio, "sleep", fake_sleep)
        runs = []
        for kw in ({"retry_delay": 0.2}, {"retry_delay": 0.1, "backoff_factor": 3.0},
                   {"retry_delay": 0.1, "backoff_factor": 2.0, "max_delay": 0.25},
                   {"retry_delay": 0.0}):
            calls = [0]

            def flaky(calls=calls):
                calls[0] += 1
                if calls[0] < 3:
                    raise ValueError(f"attempt {calls[0]}")
                return calls[0]

            async def aflaky(calls=calls):
                return flaky(calls)

            for fn, retries in ((flaky, 5), (flaky, 2)):
                calls[0] = 0
                try:
                    runs.append(("sync", utils.retry_sync(fn, retries=retries, **kw)))
                except ValueError as e:
                    runs.append(("sync raised", str(e)))
            calls[0] = 0
            runs.append(("async", asyncio.run(utils.retry(aflaky, retries=4, **kw))))
            calls[0] = 0
            try:
                utils.retry_sync(flaky, retries=5, should_retry=lambda e: False, **kw)
            except ValueError as e:
                runs.append(("not retried", str(e), calls[0]))
        with pytest.raises(ValueError, match="retries must be >= 1"):
            utils.retry_sync(flaky, retries=0)
        helpers = (utils.bytes_to_int(b"\x01\x02"), utils.bytes_to_int(b"\x01\x02", "big"),
                   utils.int_to_bytes(258, 4), utils.to_hex(b"\xab"), utils.from_hex("0xab"),
                   utils.from_hex("cd"), utils.xor_bytes(b"\x0f\xf0", b"\xff\xff"),
                   utils.int_div_ceil(7, 2), utils.bit_length(1024),
                   issubclass(utils.ErrorAborted, Exception), utils.TimeoutError_)
        seen.append((runs, sleeps, helpers))
    assert seen[1] == seen[0]


# --- tracing.export ------------------------------------------------------------

port_copy("tests.tracing.test_export_retention", globals())


@pytest.fixture(autouse=True)
def _fresh_tracers():
    yield
    for tracing in both("tracing"):
        tracing.reset()


def test_chrome_trace_export_agrees(tmp_path):
    """One trace of two spans (a root and a child on the same thread) with
    pinned clock readings: `to_chrome_trace` gives the same JSON in both
    packages, and `write_chrome_trace` the same file bytes."""
    out = []
    for tracing in both("tracing"):
        export = importlib.import_module(f"{tracing.__name__}.export")
        tracing.configure(enabled=True, slow_slot_ms=1e9)
        with tracing.root("block_import", slot=7):
            with tracing.span("bls_verify") as sp:
                sp.set(sets=3)
        trace = tracing.get_tracer().recent_traces(1)[0]
        for i, s in enumerate(trace.spans):
            s.start_ns, s.end_ns, s.tid = 1_000_000 * (i + 1), 5_000_000 * (i + 1), 1
        trace.trace_id = "t1"
        for i, s in enumerate(trace.spans):
            s.span_id = f"s{i}"
            if s.parent_id is not None:
                s.parent_id = "s0"
        doc = export.to_chrome_trace([trace, trace])
        path = export.write_chrome_trace(str(tmp_path / f"{tracing.__name__}.json"), [trace])
        out.append((json.dumps(doc, sort_keys=True), pathlib.Path(path).read_bytes()))
        tracing.reset()
    assert out[1] == out[0]


# --- telemetry: the ledger half ------------------------------------------------

_launches = port_copy(
    "tests.telemetry.test_launches", globals(),
    names={"test_ledger_is_bounded", "test_ledger_deterministic_order_and_fields",
           "test_launch_ledger_count_slicing", "test_compile_hit_miss_detection_across_size_classes",
           "test_slow_slot_launches_compact_view", "test_mode_semantics", "test_size_helpers"})


def test_launch_ledger_views_agree():
    """The same records through both packages' ledgers (a bounded ledger, a
    probe sink, every mode): equal entries (but their clock stamp), totals,
    programs and slow-slot views."""
    seen = []
    for tel in both("telemetry"):
        tel.reset_launch_telemetry()
        try:
            probe = _launches._Probe()
            tel.configure_launch_telemetry(mode="on", metrics=probe, ledger_size=8)
            for i in range(12):
                tel.record_launch(f"prog{i % 3}", tel.size_class_of(i + 1), 0.001 * i,
                                  lane="dev1" if i % 4 == 0 else None)
            prev = tel.configure_launch_telemetry(mode="off")
            assert tel.record_launch("ignored", 8, 1.0) is None
            entries = [{k: v for k, v in e.items() if k != "t_mono_ns"}
                       for e in tel.launch_ledger()]
            seen.append((prev, entries, tel.launch_ledger(3)[0]["seq"], tel.launch_totals(),
                         sorted(tel.known_programs()), tel.slow_slot_launches(5),
                         [(e[0], e[1], round(e[2], 9)) for e in probe.compile_misses.events]))
        finally:
            tel.reset_launch_telemetry()
    assert seen[1] == seen[0]


@pytest.fixture
def port_tel():
    from lodestar_tpu_torch import telemetry

    telemetry.reset_launch_telemetry()
    telemetry.configure_launch_telemetry(mode="on")
    yield telemetry
    telemetry.reset_launch_telemetry()


def test_prep_seam_fills_the_ledger(port_tel):
    """`ops/prep.py`'s `_dispatch` on the CPU: every dispatch of the fused and
    of the unfused prep schedule on 2 sets lands in the ledger, with the JAX
    package's program names, count and pow-2 size class (2 sets -> 8)."""
    import torch

    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.ops import prep

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        parsed = bv._parse_host_arrays(bv.make_synthetic_sets(2, seed=5), 8)
        pk_limbs, pk_sign, _, sig_limbs, sig_sign, _, lo, hi = parsed
        args = [torch.as_tensor(np.ascontiguousarray(a))
                for a in (pk_limbs, pk_sign, sig_limbs, sig_sign, lo, hi)]
        programs = []
        for schedule in (prep.prepare_arrays_fused, prep.prepare_arrays_unfused):
            base = len(port_tel.launch_ledger())
            schedule(*args)
            entries = port_tel.launch_ledger()[base:]
            assert all(e["size_class"] == 8 for e in entries)
            programs.append([e["program"] for e in entries])
    finally:
        torch.set_num_threads(prev)
    assert programs == [
        ["_prep_field_stage", "_prep_subgroup_stage", "hash_finish"],
        ["g1_decompress_subgroup", "g2_decompress_subgroup", "mont_from_wide",
         "map_to_g2_jac", "hash_finish"],
    ]
    assert len(programs[0]) == prep.FUSED_PREP_LAUNCHES
    assert len(programs[1]) == prep.UNFUSED_PREP_LAUNCHES
    view = port_tel.slow_slot_launches(2)
    # hash_finish/8 ends both schedules: its second dispatch is a hit
    assert view["launches_total"] == 8 and view["compiles_total"] == 7
    assert [r.split()[0] for r in view["recent"]] == ["map_to_g2_jac/8", "hash_finish/8"]


def test_htr_seam_fills_the_ledger(port_tel):
    """`ssz/device_htr.py` on the CPU: one ledger entry per level launch of a
    flush, with the JAX test's program name and size classes."""
    from lodestar_tpu_torch.ssz import device_htr as dh

    prev = dh.configure_device_htr(mode="on", device="cpu")
    prev_min = dh.DEVICE_MIN_FLUSH_PAIRS
    dh.DEVICE_MIN_FLUSH_PAIRS = 1
    try:
        depth = 4
        n = 1 << depth
        levels = [np.zeros((n >> k, 32), dtype=np.uint8) for k in range(depth + 1)]
        levels[0][:] = np.random.default_rng(7).integers(0, 256, size=(n, 32), dtype=np.uint8)
        coll = dh.DirtyCollector()
        coll.add_stack_job(levels, range(n))
        stats = coll.flush()
        assert stats["backend"] == "device"
        entries = port_tel.launch_ledger()
        assert len(entries) == stats["launches"] == depth
        assert all(e["program"] == "merkle_level" for e in entries)
        assert [e["size_class"] for e in entries] == [
            dh.pad_pow2_pairs((n >> k) // 2) for k in range(depth)]
    finally:
        dh.DEVICE_MIN_FLUSH_PAIRS = prev_min
        dh.configure_device_htr(mode=prev, device="cuda")


def _lane_sets(n):
    from lodestar_tpu_torch.crypto.bls.api import SignatureSet

    return [SignatureSet(pubkey=bytes([1, i]) + bytes(46), message=bytes([2, i]) * 16,
                         signature=bytes([3, i]) + bytes(94)) for i in range(n)]


def test_lane_seam_fills_the_ledger(port_tel):
    """`chain/bls/mesh.py` `mesh_launch` over the port's `FakeLaneRig`: one
    entry per lane launch with the lane's label, none for a staged reject,
    none with the mode off (the JAX test's mesh cases)."""
    from lodestar_tpu_torch import telemetry
    from lodestar_tpu_torch.chain.bls.mesh import PreparedSets, mesh_launch
    from lodestar_tpu_torch.testing.mesh import FakeLaneRig

    ok, served = mesh_launch(FakeLaneRig(2, with_sharded=False).mesh, _lane_sets(3))
    assert ok
    (e,) = port_tel.launch_ledger()
    assert (e["program"], e["lane"], e["size_class"]) == ("bls_lane_verify", served.label, 8)
    port_tel.reset_launch_telemetry()
    port_tel.configure_launch_telemetry(mode="on")
    rig = FakeLaneRig(1, with_prepared=True, with_sharded=False)
    ok, _ = mesh_launch(rig.mesh, _lane_sets(2), prepared=PreparedSets(inputs=None))
    assert not ok and port_tel.launch_ledger() == []
    telemetry.configure_launch_telemetry(mode="off")
    ok, _ = mesh_launch(FakeLaneRig(1, with_sharded=False).mesh, _lane_sets(2))
    assert ok and telemetry.launch_ledger() == []


# --- ssz.tree.merkle_proof -----------------------------------------------------


def test_merkle_proof_agrees_on_every_beacon_state_field():
    """`merkle_proof` on every field of a minimal-preset Altair `BeaconState`
    (the JAX package's, carried into the port as SSZ bytes, a few fields
    set): the same leaf and branch as the JAX package's, the branch proving
    the leaf under the state's root; a gindex outside the field layer and a
    non-container type raise ValueError in both."""
    jp, tp = both("params")
    jt, tt = both("types")
    jtree, ttree = both("ssz.tree")
    jm, tm = both("ssz.merkle")
    jstate = jt.ssz_types(jp.MINIMAL).altair.BeaconState.default()
    jstate.slot = 77
    jstate.finalized_checkpoint.epoch = 3
    jstate.finalized_checkpoint.root = b"\x42" * 32
    jstate.balances = [32_000_000_000 + i for i in range(5)]
    typ = jstate.type
    tstate = tt.ssz_types(tp.MINIMAL).altair.BeaconState.deserialize(typ.serialize(jstate))
    n = len(typ.fields)
    width = 1 << max(1, (n - 1).bit_length())
    root = typ.hash_tree_root(jstate)
    assert tstate.type.hash_tree_root(tstate) == root
    for i in range(n):
        got = ttree.merkle_proof(tstate.type, tstate, width + i)
        assert got == jtree.merkle_proof(typ, jstate, width + i)
        leaf, branch = got
        assert tm.verify_merkle_branch(leaf, branch, i, root)
        assert jm.verify_merkle_branch(leaf, branch, i, root)
    for tree, state in ((jtree, jstate), (ttree, tstate)):
        with pytest.raises(ValueError, match="outside the field layer"):
            tree.merkle_proof(state.type, state, 2 * width)
    with pytest.raises(ValueError, match="container"):
        ttree.merkle_proof(tstate.type.fields[0][1], 0, 1)
