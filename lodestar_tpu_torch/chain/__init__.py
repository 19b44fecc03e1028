"""The chain layer of the port: BLS verification serving (``chain/bls``)."""
