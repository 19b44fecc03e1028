"""Prover (reference `packages/prover/src`): a verified web3 provider over
light-client-tracked payloads.

The port holds `mpt` (keccak-256, RLP and Merkle-Patricia proof
verification), which discv5 needs for ENRs. The prover itself
(`lodestar_tpu.prover`'s `PayloadStore` and `ProofProvider`) comes with the
light client.
"""
