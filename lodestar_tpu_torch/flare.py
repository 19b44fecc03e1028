"""flare — the debug CLI (reference `packages/flare/src`, `cli.ts` +
`cmds/selfSlashProposer.ts` / `cmds/selfSlashAttester.ts`).

Testing-only tooling for exercising a running beacon node's slashing
pipeline: construct REAL (verifiable) ProposerSlashing /
AttesterSlashing objects for validators whose keys the operator holds,
and submit them over the Beacon API pool routes. The reference derives
keys from a mnemonic; this build's key scheme is the interop/keystore
index range, so keys come from `--interop-index/--count` (matching the
`dev` chain and the validator client's `--interop-keys`).

Usage:
  python -m lodestar_tpu_torch.flare self-slash-proposer --server http://127.0.0.1:9596 \
      --interop-index 0 --count 2 [--slot 0]
  python -m lodestar_tpu_torch.flare self-slash-attester ...same flags...

DANGER: submitting these against a chain where the validators are live
gets them slashed and ejected. That is the point of the tool.

The port of `lodestar_tpu.flare`, with its imports rewritten.
"""

from __future__ import annotations

import argparse
import sys

from lodestar_tpu_torch import params
from lodestar_tpu_torch.api.client import BeaconApiClient
from lodestar_tpu_torch.config import compute_domain, compute_signing_root
from lodestar_tpu_torch.crypto.bls import api as bls
from lodestar_tpu_torch.ssz.json import to_json
from lodestar_tpu_torch.state_transition.genesis import interop_secret_keys
from lodestar_tpu_torch.types import ssz_types

__all__ = ["main"]


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="flare", description="lodestar-tpu debug CLI (reference packages/flare)"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, help_ in (
        ("self-slash-proposer", "submit ProposerSlashings for own validators"),
        ("self-slash-attester", "submit AttesterSlashings for own validators"),
    ):
        c = sub.add_parser(name, help=help_)
        c.add_argument("--server", default="http://127.0.0.1:9596")
        c.add_argument("--interop-index", type=int, default=0, help="first interop key index")
        c.add_argument("--count", type=int, default=1, help="number of validators to slash")
        c.add_argument("--slot", type=int, default=0, help="slashing header/attestation slot")
        c.add_argument("--preset", default="minimal", choices=["minimal", "mainnet"])
    return ap


def _setup(args):
    params.set_active_preset(args.preset)
    t = ssz_types()
    client = BeaconApiClient(args.server)
    genesis = client.get_genesis()["data"]
    gvr = bytes.fromhex(genesis["genesis_validators_root"][2:])
    fork = client.get_state_fork("head")["data"]
    # the node verifies at the SLASHING's epoch: pick previous_version for
    # epochs before the head fork boundary (state_transition get_domain)
    p = params.active_preset()
    epoch = args.slot // p.SLOTS_PER_EPOCH
    key = "previous_version" if epoch < int(fork["epoch"]) else "current_version"
    fork_version = bytes.fromhex(fork[key][2:])

    # map our keys to on-chain validator indices by pubkey
    n_keys = args.interop_index + args.count
    sks = interop_secret_keys(n_keys)[args.interop_index :]
    validators = client.get_state_validators("head")["data"]
    index_by_pubkey = {v["validator"]["pubkey"]: int(v["index"]) for v in validators}
    pairs = []
    for sk in sks:
        pk_hex = "0x" + sk.to_pubkey().hex()
        if pk_hex not in index_by_pubkey:
            print(f"skip: pubkey {pk_hex[:18]}… not in the validator set", file=sys.stderr)
            continue
        pairs.append((index_by_pubkey[pk_hex], sk))
    if not pairs:
        raise RuntimeError("no provided keys are active validators on this chain")
    return t, client, gvr, fork_version, pairs


def self_slash_proposer(args) -> int:
    t, client, gvr, fork_version, pairs = _setup(args)
    domain = compute_domain(params.DOMAIN_BEACON_PROPOSER, fork_version, gvr)
    sent = 0
    for index, sk in pairs:
        def header(body_root: bytes):
            h = t.BeaconBlockHeader.default()
            h.slot = args.slot
            h.proposer_index = index
            h.parent_root = b"\xaa" * 32
            h.state_root = b"\xbb" * 32
            h.body_root = body_root
            return h

        slashing = t.ProposerSlashing.default()
        for slot_attr, root in (("signed_header_1", b"\xcc" * 32), ("signed_header_2", b"\xdd" * 32)):
            h = header(root)
            signed = t.SignedBeaconBlockHeader.default()
            signed.message = h
            signed.signature = bls.sign(
                sk, compute_signing_root(t.BeaconBlockHeader, h, domain)
            )
            setattr(slashing, slot_attr, signed)
        client.submit_pool_proposer_slashing(to_json(t.ProposerSlashing, slashing))
        sent += 1
        print(f"ProposerSlashing submitted for validator {index}")
    print(f"done: {sent}/{len(pairs)} proposer slashings accepted")
    return 0


def self_slash_attester(args) -> int:
    t, client, gvr, fork_version, pairs = _setup(args)
    p = params.active_preset()
    epoch = args.slot // p.SLOTS_PER_EPOCH
    domain = compute_domain(params.DOMAIN_BEACON_ATTESTER, fork_version, gvr)
    # one double-vote AttesterSlashing covering ALL provided validators
    indices = sorted(i for i, _ in pairs)
    by_index = dict(pairs)

    def indexed(beacon_root: bytes):
        data = t.AttestationData.default()
        data.slot = args.slot
        data.index = 0
        data.beacon_block_root = beacon_root
        data.source.epoch = 0
        data.source.root = b"\x00" * 32
        data.target.epoch = epoch
        data.target.root = beacon_root
        root = compute_signing_root(t.AttestationData, data, domain)
        sigs = [bls.sign(by_index[i], root) for i in indices]
        ia = t.IndexedAttestation.default()
        ia.attesting_indices = indices
        ia.data = data
        ia.signature = bls.aggregate_signatures(sigs)
        return ia

    slashing = t.AttesterSlashing.default()
    slashing.attestation_1 = indexed(b"\xaa" * 32)
    slashing.attestation_2 = indexed(b"\xbb" * 32)  # same target, different root
    client.submit_pool_attester_slashing(to_json(t.AttesterSlashing, slashing))
    print(f"AttesterSlashing submitted for validators {indices}")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    try:
        if args.cmd == "self-slash-proposer":
            return self_slash_proposer(args)
        if args.cmd == "self-slash-attester":
            return self_slash_attester(args)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
