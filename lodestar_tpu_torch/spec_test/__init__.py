"""Directory-driven spec-test harness.

Counterpart of the reference `packages/spec-test-util/src/single.ts:93`
(`describeDirectorySpecTest`) and the exhaustive iterator
`beacon-node/test/spec/utils/specTestIterator.ts:23-40`, whose core
property this keeps: **unknown runners/handlers are errors, not skips** —
a vector directory that nothing claims fails the suite, so fixture trees
can never silently rot.

Layout (the official consensus-spec-tests structure):

    tests/<config>/<fork>/<runner>/<handler>/<suite>/<case>/<files>

Each case directory's files are loaded by extension: `.yaml` via
yaml.safe_load, `.ssz` as raw bytes (official tarballs use ssz_snappy;
our committed fixtures are plain ssz — no snappy dependency in image).
PyYAML is imported on the first `.yaml` load, not with the module.

The port of `lodestar_tpu.spec_test` (host Python and numpy, as there).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = ["SpecCase", "iterate_spec_tests", "run_spec_tests", "SkipOpts"]

_ARTIFACTS = {".DS_Store", "._.DS_Store", "version.txt"}


@dataclass
class SpecCase:
    """One test-case directory, files loaded lazily by stem."""

    config: str
    fork: str
    runner: str
    handler: str
    suite: str
    name: str
    path: str
    _cache: dict[str, Any] = field(default_factory=dict, repr=False)

    def files(self) -> list[str]:
        return sorted(f for f in os.listdir(self.path) if f not in _ARTIFACTS)

    def load(self, stem: str) -> Any:
        """Load `<stem>.yaml` (parsed) or `<stem>.ssz` (raw bytes)."""
        if stem in self._cache:
            return self._cache[stem]
        ypath = os.path.join(self.path, stem + ".yaml")
        spath = os.path.join(self.path, stem + ".ssz")
        if os.path.exists(ypath):
            import yaml  # only where a case has a .yaml file: the GPU host may lack PyYAML

            with open(ypath) as f:
                out = yaml.safe_load(f)
        elif os.path.exists(spath):
            with open(spath, "rb") as f:
                out = f.read()
        else:
            raise FileNotFoundError(f"{self.path}: no {stem}.yaml / {stem}.ssz")
        self._cache[stem] = out
        return out

    @property
    def test_id(self) -> str:
        return f"{self.config}/{self.fork}/{self.runner}/{self.handler}/{self.suite}/{self.name}"


@dataclass
class SkipOpts:
    skipped_prefixes: tuple[str, ...] = ()
    skipped_forks: tuple[str, ...] = ()
    skipped_runners: tuple[str, ...] = ()
    skipped_handlers: tuple[str, ...] = ()


def _ls(path: str) -> list[str]:
    return sorted(e for e in os.listdir(path) if e not in _ARTIFACTS)


def iterate_spec_tests(root: str, skip: SkipOpts | None = None) -> list[SpecCase]:
    """Walk a `tests/` fixture tree into SpecCase leaves (no runners yet —
    matching happens in run_spec_tests so unknowns can error)."""
    skip = skip or SkipOpts()
    cases: list[SpecCase] = []
    for config in _ls(root):
        for fork in _ls(os.path.join(root, config)):
            if fork in skip.skipped_forks:
                continue
            for runner in _ls(os.path.join(root, config, fork)):
                if runner in skip.skipped_runners:
                    continue
                for handler in _ls(os.path.join(root, config, fork, runner)):
                    if handler in skip.skipped_handlers:
                        continue
                    hpath = os.path.join(root, config, fork, runner, handler)
                    for suite in _ls(hpath):
                        for case in _ls(os.path.join(hpath, suite)):
                            c = SpecCase(
                                config, fork, runner, handler, suite, case,
                                os.path.join(hpath, suite, case),
                            )
                            if any(c.test_id.startswith(p) for p in skip.skipped_prefixes):
                                continue
                            cases.append(c)
    return cases


def run_spec_tests(
    root: str,
    runners: dict[str, dict[str, Callable[[SpecCase], None]]],
    skip: SkipOpts | None = None,
) -> int:
    """Run every case through runners[runner][handler].

    Raises KeyError for an unknown runner or handler (the reference's
    exhaustiveness guarantee). Returns the number of cases run. Each
    handler fn asserts internally.
    """
    n = 0
    for case in iterate_spec_tests(root, skip):
        by_handler = runners.get(case.runner)
        if by_handler is None:
            raise KeyError(f"unknown spec-test runner: {case.test_id}")
        fn = by_handler.get(case.handler)
        if fn is None:
            raise KeyError(f"unknown spec-test handler: {case.test_id}")
        fn(case)
        n += 1
    return n
