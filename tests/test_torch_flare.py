"""The port's `flare` (the debug CLI's self-slash commands) against the JAX
package's, minimal preset.

Tolerance: none. The JAX package's `tests/api/test_flare.py` runs on the
port (`port_copy`). Beside it, both packages' `flare` against their own
package's REST server over the same phase0 genesis (the JAX package's, as
SSZ bytes; mock verifier, the pool routes verifying on the host through the
state transition): the proposer and attester slashings that land in each
node's op pool are equal as SSZ bytes, what each command prints is equal,
and a key range outside the validator set fails alike.
"""

from __future__ import annotations

import argparse
import importlib

from .test_torch_chain import minimal_cpu  # noqa: F401 - the minimal preset in both packages
from .test_torch_utils_gaps import port_copy

port_copy("tests.api.test_flare", globals())

J, T = "lodestar_tpu", "lodestar_tpu_torch"


def _flare_run(root, capsys):
    from .test_torch_rest_validator import FAR, genesis_bytes, pkg

    P = pkg(root)
    flare = importlib.import_module(f"{root}.flare")
    genesis = P.t.phase0.BeaconState.deserialize(genesis_bytes(False))
    chain = P.chain.BeaconChain(anchor_state=genesis, bls_verifier=P.bls.BlsVerifierMock(True),
                                db=P.db.MemoryDbController(), cfg=P.cfg(FAR), current_slot=1)
    server = P.api.BeaconRestApiServer(P.api.BeaconApiImpl(chain), port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}"

    def args(**kw):
        base = dict(cmd=None, server=url, interop_index=0, count=2, slot=0, preset="minimal")
        base.update(kw)
        return argparse.Namespace(**base)

    try:
        codes = [flare.self_slash_proposer(args()),
                 flare.self_slash_attester(args(interop_index=2, count=3, slot=3)),
                 flare.main(["self-slash-attester", "--server", url, "--interop-index", "64",
                             "--count", "2", "--preset", "minimal"])]
        printed = capsys.readouterr()
    finally:
        server.stop()
    pool = chain.op_pool
    return (codes, printed.out, printed.err,
            [P.t.ProposerSlashing.serialize(s) for s in pool._proposer_slashings.values()],
            [P.t.AttesterSlashing.serialize(s) for s in pool._attester_slashings.values()])


def test_flare_slashings_are_byte_equal_between_the_packages(capsys):
    jax_run, port_run = _flare_run(J, capsys), _flare_run(T, capsys)
    assert port_run == jax_run
    codes, out, err, proposer, attester = port_run
    assert codes == [0, 0, 1] and len(proposer) == 2 and len(attester) == 1
    assert "no provided keys are active validators" in err
