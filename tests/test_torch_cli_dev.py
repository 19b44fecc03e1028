"""`python -m lodestar_tpu_torch dev --validators 16 --slots 32 --preset minimal
--device cpu` against `JAX_PLATFORMS=cpu python -m lodestar_tpu dev ...` (the
same flags, no `--device`), each in a process of its own, and
`chip_smoke.py` phase 10g(b)'s scenario on what they serve.

Tolerance: none. Both processes run at once, each with a REST server and
`--linger`; as soon as one prints `dev chain done`, this test reads from its
REST server the head's root and finality checkpoints, the finalized
state's JSON (`/eth/v2/debug/beacon/states/finalized`) and the blocks after
it (`/eth/v2/beacon/blocks/{slot}`). Then:

* both print the same slot lines, end with `dev chain done: head slot 32,
  finalized epoch 2` and exit 0; their heads and checkpoints have the same
  roots;
* each package's `fetch_checkpoint_state` decodes either package's
  finalized state to the same root, the finalized block's state root;
* phase 10g(b): each package's `BeaconNode` anchored on its own dev node's
  finalized state (slot 16; db in a temp dir, metrics and REST servers on
  free ports, a manual clock at slot 32) imports blocks 17-32; both end at
  the same head, finalized and justified checkpoints, and the port's is
  the dev nodes' head and finalized checkpoint (`chip_smoke.anchored_node`,
  the phase's own function, on the port's side) with the same notifier
  line as the JAX node's.

The dev runs take ~35 s each on the CPU, at once; the rest ~20 s.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import subprocess
import sys
import threading
import urllib.request

import pytest

import chip_smoke

from .test_torch_chain import minimal_cpu  # noqa: F401 - the minimal preset in both packages
from .test_torch_node import jax_node_settings_restored

J, T = "lodestar_tpu", "lodestar_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS, LINGER = 32, 30
DONE = f"dev chain done: head slot {SLOTS}, finalized epoch 2"


def get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


def read_served(url, slots=SLOTS):
    """What a lingering dev node serves: the head's root, the finality
    checkpoints, the finalized state's JSON and the blocks' JSON after it."""
    fin = get(url, "/eth/v1/beacon/states/head/finality_checkpoints")["data"]
    state = get(url, "/eth/v2/debug/beacon/states/finalized")
    anchor_slot = int(state["data"]["slot"])
    header = get(url, f"/eth/v1/beacon/headers/{fin['finalized']['root']}")["data"]
    return {"head_root": get(url, "/eth/v1/beacon/blocks/head/root")["data"]["root"],
            "finality": fin, "state": state,
            "finalized_state_root": header["header"]["message"]["state_root"],
            "blocks": [get(url, f"/eth/v2/beacon/blocks/{s}")
                       for s in range(anchor_slot + 1, slots + 1)]}


@pytest.fixture(scope="module")
def dev_runs(tmp_path_factory):
    """{root: {"rc", "lines", "served"}} of both packages' dev processes."""
    tmp = tmp_path_factory.mktemp("dev")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO, "PYTHONUNBUFFERED": "1",
           "OMP_NUM_THREADS": "1"}
    runs = {}
    for root in (J, T):
        port = chip_smoke.free_port()
        argv = [sys.executable, "-m", root, "dev", "--validators", "16", "--slots", str(SLOTS),
                "--preset", "minimal", "--rest-port", str(port), "--linger", str(LINGER)]
        if root == T:
            argv += ["--device", "cpu"]
        log = open(tmp / f"{root}.log", "w")
        proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                stderr=log, text=True)
        runs[root] = {"proc": proc, "log": log, "lines": [], "url": f"http://127.0.0.1:{port}"}

    def follow(run):
        for line in run["proc"].stdout:
            run["lines"].append(line.rstrip("\n"))
            if line.startswith("dev chain done"):
                try:
                    run["served"] = read_served(run["url"])
                except Exception as e:  # the test reports it
                    run["served"] = e

    threads = [threading.Thread(target=follow, args=(run,)) for run in runs.values()]
    for th in threads:
        th.start()
    try:
        for root, run in runs.items():
            run["rc"] = run["proc"].wait(timeout=600)
    finally:
        for run in runs.values():
            if run["proc"].poll() is None:
                run["proc"].kill()
            run["log"].close()
        for th in threads:
            th.join(30)
    for root, run in runs.items():
        run["stderr"] = (tmp / f"{root}.log").read_text()[-3000:]
    return runs


def test_dev_runs_print_the_same_lines_and_exit_0(dev_runs):
    jax, port = dev_runs[J], dev_runs[T]
    assert (jax["rc"], port["rc"]) == (0, 0), (jax["stderr"], port["stderr"])
    slot_lines = [[line for line in run["lines"] if line.startswith(("slot", "dev chain"))]
                  for run in (jax, port)]
    assert slot_lines[1] == slot_lines[0]
    assert len(slot_lines[1]) == SLOTS + 1 and slot_lines[1][-1] == DONE
    assert all(": block atts=  2 " in line for line in slot_lines[1][:-1])


def test_dev_nodes_serve_the_same_chain(dev_runs):
    served = {root: dev_runs[root]["served"] for root in (J, T)}
    for root, s in served.items():
        assert isinstance(s, dict), (root, s)
    assert served[T]["head_root"] == served[J]["head_root"]
    assert served[T]["finality"] == served[J]["finality"]
    assert served[T]["finality"]["finalized"]["epoch"] == "2"
    assert served[T]["state"] == served[J]["state"]
    assert served[T]["blocks"] == served[J]["blocks"]


class Recorded:
    """A client that answers `get_debug_state_v2` with a recorded reply."""

    def __init__(self, reply):
        self.reply = reply

    def get_debug_state_v2(self, state_id):
        assert state_id == "finalized"
        return self.reply


def decoded(root, served):
    """`root`'s `fetch_checkpoint_state` of the recorded finalized state and
    its blocks decoded by `root`'s types."""
    sync = importlib.import_module(f"{root}.node.checkpoint_sync")
    params = importlib.import_module(f"{root}.params")
    ssz_json = importlib.import_module(f"{root}.ssz.json")
    types = importlib.import_module(f"{root}.types")
    t = types.ssz_types(params.MINIMAL)
    state = sync.fetch_checkpoint_state(Recorded(served["state"]), p=params.MINIMAL,
                                        current_slot=SLOTS)
    blocks = [ssz_json.from_json(getattr(t, b["version"]).SignedBeaconBlock, b["data"])
              for b in served["blocks"]]
    return {"state": state, "blocks": blocks}


@pytest.mark.parametrize("server", [J, T])
@pytest.mark.parametrize("client", [J, T])
def test_checkpoint_state_decodes_to_the_finalized_root(dev_runs, server, client):
    served = dev_runs[server]["served"]
    state = decoded(client, served)["state"]
    assert int(state.slot) == 16
    root = "0x" + bytes(state.type.hash_tree_root(state)).hex()
    assert root == served["finalized_state_root"]


async def jax_anchored_node(fetched, tmp):
    """Phase 10g(b) on the JAX package: its node anchored on the state, the
    dev chain config, the blocks imported; checkpoints and notifier line."""
    from lodestar_tpu import params
    from lodestar_tpu.config import minimal_chain_config
    from lodestar_tpu.node import BeaconNode, BeaconNodeOptions

    far = 2**64 - 1
    cc = minimal_chain_config().replace(ALTAIR_FORK_EPOCH=far, BELLATRIX_FORK_EPOCH=far,
                                        CAPELLA_FORK_EPOCH=far, DENEB_FORK_EPOCH=far)
    opts = BeaconNodeOptions(db_path=str(tmp / "wal.log"), metrics_enabled=True,
                             metrics_port=chip_smoke.free_port(),
                             rest_port=chip_smoke.free_port(), manual_clock=True)
    node = await BeaconNode.init(anchor_state=fetched["state"], chain_config=cc, opts=opts,
                                 p=params.MINIMAL, time_fn=lambda: SLOTS * cc.SECONDS_PER_SLOT)
    try:
        for signed in fetched["blocks"]:
            await node.chain.process_block(signed)
        out = chip_smoke.checkpoints(node.chain)
        out["notifier"] = node.notifier.on_slot(SLOTS)
        out["verifier"] = type(node.bls).__name__
    finally:
        await node.close()
    return out


def test_phase_10g_b_scenario_in_both_packages(dev_runs, tmp_path):
    from lodestar_tpu_torch import params

    served = {root: dev_runs[root]["served"] for root in (J, T)}
    with chip_smoke.node_settings_restored():
        port = asyncio.run(chip_smoke.anchored_node(decoded(T, served[T]), "cpu",
                                                    params.MINIMAL, SLOTS,
                                                    db_dir=str(tmp_path)))
    with jax_node_settings_restored():
        jax = asyncio.run(jax_anchored_node(decoded(J, served[J]), tmp_path))
    assert port["verifier"] == jax["verifier"] == "BlsSingleThreadVerifier"
    for key in ("head", "finalized", "justified"):
        assert port[key] == jax[key], key
    assert port["notifier"] == jax["notifier"]
    fin = served[T]["finality"]["finalized"]
    assert port["head"] == [SLOTS, served[T]["head_root"]]
    assert port["finalized"] == [int(fin["epoch"]), fin["root"]]
    samples = port["scrape"][0]
    assert chip_smoke.sample_sum(samples, "beacon_head_slot") == SLOTS
    assert chip_smoke.sample_sum(samples, "beacon_finalized_epoch") == 2
