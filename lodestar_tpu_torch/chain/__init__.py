"""The chain layer of the port (reference `beacon-node/src/chain/`): BLS
verification serving (``chain/bls``) and the beacon chain (``chain.py``
with its regen, archiver, gossip validation, block production, op and
sync-committee pools, and clock)."""
