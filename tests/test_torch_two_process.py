"""The JAX package's `tests/node/test_two_process_sync.py` on the port
(`port_copy`): two OS processes of the CLI peer over TCP on 127.0.0.1
(noise XX, mplex, gossipsub, req/resp); `beacon --dev-genesis --bootnode`
range-syncs from `dev` across the altair fork (epoch 1) and follows it over
gossip to slot 10.

Tolerance: none; the assertions are the JAX test's. The test's commands
run `python -m lodestar_tpu_torch`, each with `--device cpu` added (the
port's CLI runs its nodes on CUDA unless told otherwise): a stand-in for
the copied module's `subprocess` adds it, and records each command. One
more case mixes the packages: the JAX package's `dev` as process A and the
port's `beacon` as process B. The card's version, both processes the
port's on CUDA, is in `tests/test_torch_node_cuda.py`.
"""

from __future__ import annotations

import subprocess

import pytest

from .test_torch_utils_gaps import port_copy

J, T = "lodestar_tpu", "lodestar_tpu_torch"

COPIED = port_copy("tests.node.test_two_process_sync", globals())


class Commands:
    """The copied module's `subprocess`: `Popen` of `python -m
    lodestar_tpu_torch <command> ...` with `--device cpu` after the command,
    or, for the commands in `jax`, with the JAX package's module instead."""

    STDOUT = subprocess.STDOUT

    def __init__(self, jax=()):
        self.jax, self.commands = set(jax), []

    def Popen(self, argv, **kwargs):
        argv = list(argv)
        i = argv.index("-m")
        assert argv[i + 1] == T
        if argv[i + 2] in self.jax:
            argv[i + 1] = J
        else:
            argv[i + 3:i + 3] = ["--device", "cpu"]
        self.commands.append(argv[i + 1:i + 5])
        return subprocess.Popen(argv, **kwargs)


@pytest.fixture(autouse=True)
def commands(monkeypatch):
    cmds = Commands()
    monkeypatch.setattr(COPIED, "subprocess", cmds)
    yield cmds
    assert [c[:2] for c in cmds.commands] in ([], [[T, "dev"], [T, "beacon"]])
    assert all(c[2:4] == ["--device", "cpu"] for c in cmds.commands)


def test_jax_dev_and_port_beacon_sync(tmp_path, monkeypatch):
    """Process A the JAX package's `dev`, process B the port's `beacon`."""
    cmds = Commands(jax={"dev"})
    monkeypatch.setattr(COPIED, "subprocess", cmds)
    COPIED.test_two_process_range_sync_and_gossip_follow(tmp_path)
    assert [c[:2] for c in cmds.commands] == [[J, "dev"], [T, "beacon"]]
    assert cmds.commands[1][2:4] == ["--device", "cpu"]
