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
