"""The repo's static analysis over the PyTorch/CUDA port.

`tests/analysis/test_gate.py` holds `lodestar_tpu/` to every rule of
`tools/analysis` with no finding; this holds `lodestar_tpu_torch/` to the
same rules and the same pragma hygiene (a suppression needs a reason and
must still suppress something). A new finding is fixed, or earns an
inline `# lint: allow(rule) — reason`.
"""

from __future__ import annotations

import pathlib

from tools.analysis import analyze

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_port_is_clean_under_every_rule():
    findings = analyze([REPO / "lodestar_tpu_torch"], repo_root=REPO)
    assert findings == [], "\n" + "\n".join(f.format() for f in findings)


def wiring_findings(root: pathlib.Path) -> list[str]:
    """The metrics-and-cli-wiring rule over `root`: the rule reads the JAX
    package's fixed places (`lodestar_tpu/cli.py`, `lodestar_tpu/node/`,
    the metric families under `lodestar_tpu/`, `dashboards/`), so `root`
    holds the port under that name."""
    from tools.analysis.rules.wiring import MetricsCliWiringRule

    return [f.message for f in MetricsCliWiringRule().check_project(root)]


def test_ports_cli_flags_node_options_and_metrics_are_wired(tmp_path):
    """Every `--flag` of the port's `cli.py` is consumed, every option
    `BeaconNodeOptions` stores is read as `opts.X` (the port's `device`
    too), and every metric family of the port is on a dashboard."""
    (tmp_path / "lodestar_tpu").symlink_to(REPO / "lodestar_tpu_torch")
    (tmp_path / "dashboards").symlink_to(REPO / "dashboards")
    assert wiring_findings(tmp_path) == []


def test_wiring_rule_sees_an_unwired_device_in_the_port(tmp_path):
    """The same rule over copies of the port's CLI and node in which
    `--device` is never passed on and the node stores `device` under
    another name: each fault is found."""
    pkg = tmp_path / "lodestar_tpu"
    (pkg / "node").mkdir(parents=True)
    cli = (REPO / "lodestar_tpu_torch" / "cli.py").read_text()
    node = (REPO / "lodestar_tpu_torch" / "node" / "__init__.py").read_text()
    assert cli.count("device=args.device,") == 2
    assert node.count("self.device = device") == 1
    (pkg / "cli.py").write_text(cli.replace("device=args.device,", ""))
    (pkg / "node" / "__init__.py").write_text(
        node.replace("self.device = device", "self.device_x = device"))
    found = wiring_findings(tmp_path)
    assert any("--device (dest 'device') is declared but never consumed" in m for m in found)
    assert any("BeaconNodeOptions.device_x is stored but the node never reads" in m
               for m in found)
    assert any("node reads opts.device but BeaconNodeOptions never stores it" in m
               for m in found)
    assert len(found) == 3, found
