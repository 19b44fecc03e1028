"""The port's CLI (`lodestar_tpu_torch.cli`, `python -m lodestar_tpu_torch`)
against the JAX package's (`lodestar_tpu.cli`).

Tolerance: none. Beside each other:

* every subcommand's parser has the same dests, option strings, defaults,
  choices, types and actions as the JAX parser's, apart from the port's
  `--device` of `dev`, `beacon` and `bench` (ROADMAP Queue 3);
* the literal mode choices the CLI keeps (it must not import the layers
  that own them) are the canonical tuples of both packages;
* `--rc-config` (a YAML file's values as the defaults, flags still winning;
  dashes or underscores; unknown keys, a file that is not a mapping and a
  missing path refused) parses the same in both, or refuses with the same
  message;
* `bench --device cpu` runs the port's benchmark (`lodestar_tpu_torch.bench`,
  here at 2 jobs of 8 sets) and prints one JSON line; `python -m
  lodestar_tpu_torch` runs the CLI, and its `bench` without CUDA fails
  with nothing on stdout.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

J, T = "lodestar_tpu", "lodestar_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBCOMMANDS = ("dev", "beacon", "validator", "lightclient", "bench")
PORT_ONLY = {"dev": {"device"}, "beacon": {"device"}, "bench": {"device"}}


def cli(root):
    return importlib.import_module(f"{root}.cli")


def subparsers(root) -> dict:
    ap = cli(root)._build_parser()
    sub = next(a for a in ap._actions if isinstance(a, argparse._SubParsersAction))
    return dict(sub.choices)


def described(parser, skip=()) -> dict:
    """{dest: what an argument is, help text aside}."""
    return {a.dest: (tuple(a.option_strings), a.default, a.choices and list(a.choices), a.nargs,
                     a.type, a.const, a.required, type(a).__name__)
            for a in parser._actions if a.dest not in skip and a.dest != "help"}


@pytest.mark.parametrize("command", SUBCOMMANDS)
def test_every_subcommand_parses_as_the_jax_one(command):
    jax, port = subparsers(J), subparsers(T)
    assert set(jax) == set(port) == set(SUBCOMMANDS)
    extra = PORT_ONLY.get(command, set())
    assert described(port[command], skip=extra) == described(jax[command])
    if extra:
        device = {a.dest: a for a in port[command]._actions}["device"]
        assert device.option_strings == ["--device"]
        assert device.default == "cuda" and list(device.choices) == ["cuda", "cpu"]
        node = importlib.import_module(f"{T}.node")
        assert tuple(device.choices) == node.NODE_DEVICES


def test_top_level_parser_is_the_jax_one():
    assert described(cli(T)._build_parser()) == described(cli(J)._build_parser())


MODE_FLAGS = {
    "bls_device_prep": ("models.batch_verify", "PREP_MODES"),
    "bls_pipeline": ("chain.bls.pool", "PIPELINE_MODES"),
    "bls_single_launch": ("models.batch_verify", "SINGLE_LAUNCH_MODES"),
    "htr_device": ("ssz.device_htr", "HTR_MODES"),
    "bls_mesh": ("chain.bls.mesh", "MESH_MODES"),
    "launch_telemetry": ("telemetry", "TELEMETRY_MODES"),
}


@pytest.mark.parametrize("dest", sorted(MODE_FLAGS))
@pytest.mark.parametrize("command", ("dev", "beacon"))
def test_mode_choices_are_the_canonical_tuples(command, dest):
    module, name = MODE_FLAGS[dest]
    canonical = getattr(importlib.import_module(f"{T}.{module}"), name)
    assert canonical == getattr(importlib.import_module(f"{J}.{module}"), name)
    action = {a.dest: a for a in subparsers(T)[command]._actions}[dest]
    assert tuple(action.choices) == canonical
    ap = cli(T)._build_parser()
    for mode in canonical:
        assert getattr(ap.parse_args([command, f"--{dest.replace('_', '-')}", mode]), dest) == mode
    with pytest.raises(SystemExit):
        ap.parse_args([command, f"--{dest.replace('_', '-')}", "bogus"])


def parsed(root, argv):
    """The namespace `main` would dispatch on, as a dict (the port's
    `device` left out), or the message of the SystemExit it raises."""
    mod = cli(root)
    ap, subs = mod._build_parser(with_subparsers=True)
    try:
        rest = mod._apply_rc_config(ap, subs, list(argv))
        args = vars(ap.parse_args(rest))
    except SystemExit as e:
        return ("exit", str(e.code))
    args.pop("device", None)
    return args


RC_CASES = {
    "defaults_from_file": ("validators: 8\nslot-time: 0.5\nbls_mesh: 'off'\n", ["dev"]),
    "flags_win": ("validators: 8\n", ["dev", "--validators", "4"]),
    "equals_form": ("rest-port: 9999\n", ["beacon", "--rc-config={path}"]),
    "flag_after_command": ("genesis-validators: 32\n", ["beacon", "--rc-config", "{path}"]),
    "empty_file": ("", ["lightclient"]),
    "unknown_key": ("validators: 8\nbogus_key: 1\n", ["dev"]),
    "not_a_mapping": ("- 1\n- 2\n", ["dev"]),
    "missing_path": (None, ["dev", "--rc-config"]),
}


@pytest.mark.parametrize("case", sorted(RC_CASES))
def test_rc_config_parses_as_in_the_jax_package(case, tmp_path):
    text, argv = RC_CASES[case]
    path = tmp_path / "rc.yaml"
    if text is not None:
        path.write_text(text)
        if not any("{path}" in a for a in argv):
            argv = ["--rc-config", "{path}", *argv]
    argv = [a.replace("{path}", str(path)) for a in argv]
    jax, port = parsed(J, argv), parsed(T, argv)
    assert port == jax
    if case == "defaults_from_file":
        assert (port["validators"], port["slot_time"], port["bls_mesh"]) == (8, 0.5, "off")
    elif case == "flags_win":
        assert port["validators"] == 4
    elif case == "unknown_key":
        assert port == ("exit", f"--rc-config {path}: unknown keys ['bogus_key']")
    elif case == "not_a_mapping":
        assert port == ("exit", f"--rc-config {path}: expected a mapping")
    elif case == "missing_path":
        assert port == ("exit", "--rc-config requires a file path")


def test_rc_config_sets_the_ports_device(tmp_path):
    """`device` is a key of the port's rc files (a dest of its parser); the
    JAX CLI has no such dest and refuses it."""
    path = tmp_path / "rc.yaml"
    path.write_text("device: cpu\n")
    mod = cli(T)
    ap, subs = mod._build_parser(with_subparsers=True)
    assert ap.parse_args(mod._apply_rc_config(ap, subs, ["--rc-config", str(path), "dev"])).device == "cpu"
    assert parsed(J, ["--rc-config", str(path), "dev"]) == (
        "exit", f"--rc-config {path}: unknown keys ['device']")


def test_bench_says_the_benchmark_is_missing_and_exits_2(capsys, monkeypatch):
    """(The name is the stub's: `bench` now runs the port's benchmark.)
    `bench --device cpu` in-process, at 2 jobs of 8 sets and one timed
    launch on one ATen thread, returns 0 and prints exactly one JSON line
    with bench.py's keys and strings."""
    from lodestar_tpu_torch import bench

    monkeypatch.setattr(bench, "BATCH", 8)
    monkeypatch.setattr(bench, "MERGE_JOBS", 2)
    monkeypatch.setattr(bench, "ITERS", 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli(T).main(["bench", "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    out, _ = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1 and out.endswith("\n")
    line = json.loads(lines[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "bls_batch_verify_sigs_per_sec" and line["unit"] == "sigs/s"
    assert line["value"] > 0 and line["vs_baseline"] == round(line["value"] / 2200.0, 2)


def test_bench_takes_a_device(tmp_path, capsys):
    """`bench --device` is "cuda" by default and takes only "cuda" and
    "cpu"; an rc file's `device` sets it, as for `dev` and `beacon`."""
    ap, subs = cli(T)._build_parser(with_subparsers=True)
    assert ap.parse_args(["bench"]).device == "cuda"
    assert ap.parse_args(["bench", "--device", "cpu"]).device == "cpu"
    for bad in ("tpu", "cuda:0", "gpu"):
        with pytest.raises(SystemExit):
            ap.parse_args(["bench", "--device", bad])
        assert "invalid choice" in capsys.readouterr().err
    path = tmp_path / "rc.yaml"
    path.write_text("device: cpu\n")
    rc = cli(T)._apply_rc_config(ap, subs, ["--rc-config", str(path), "bench"])
    assert ap.parse_args(rc).device == "cpu"


def test_python_dash_m_runs_the_cli():
    env = {**os.environ, "PYTHONPATH": REPO}
    usage = subprocess.run([sys.executable, "-m", T], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
    assert usage.returncode == 2 and "usage: lodestar-tpu-torch" in usage.stderr
    assert "{dev,beacon,validator,lightclient,bench}" in usage.stderr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: `bench` on the default device would run")
    bench = subprocess.run([sys.executable, "-m", T, "bench"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
    assert bench.returncode != 0 and bench.stdout == ""
    assert "CUDA is not available" in bench.stderr
