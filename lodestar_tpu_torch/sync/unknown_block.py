"""Unknown-block sync: resolve gossip orphans by walking parent roots.

Reference `sync/unknownBlock.ts:27`: a gossip block/attestation names an
unknown root -> fetch it (blocksByRoot), walk parents until a known
ancestor, then process the fetched chain forward.

The port of `lodestar_tpu.sync.unknown_block` (host Python, as there), with
one departure: a fetched block's root is taken with its slot's fork type
(`chain.block_type_at_slot`), where the JAX package takes the phase0 type's
and so refuses every post-phase0 block as the wrong block for its root.
"""

from __future__ import annotations

from lodestar_tpu_torch.logger import get_logger

__all__ = ["UnknownBlockSync"]

MAX_PARENT_DEPTH = 32  # give up beyond this (reference bounds the walk)


class UnknownBlockSync:
    def __init__(self, *, chain, network, peers: list[str]):
        self.chain = chain
        self.network = network  # async blocks_by_root(peer, roots) -> list
        self.peers = list(peers)
        self.log = get_logger(name="lodestar.unknown-block-sync")

    async def resolve(self, unknown_root: bytes) -> int:
        """Fetch unknown_root and any unknown ancestors, process forward.
        Returns the number of blocks imported."""
        chain_to_process = []
        root = unknown_root
        for _depth in range(MAX_PARENT_DEPTH):
            if self.chain.fork_choice.proto_array.has_block("0x" + root.hex()):
                break
            fetched = None
            for peer in self.peers:
                try:
                    blocks = await self.network.blocks_by_root(peer, [root])
                    if blocks:
                        fetched = blocks[0]
                        break
                except Exception as e:
                    self.log.warn(f"blocksByRoot failed on {peer}: {e!r}")
            if fetched is None:
                raise RuntimeError(f"no peer served block 0x{root.hex()[:16]}")
            block_type, _ = self.chain.block_type_at_slot(int(fetched.message.slot))
            got_root = block_type.hash_tree_root(fetched.message)
            if got_root != root:
                raise RuntimeError("peer served wrong block for root")
            chain_to_process.append(fetched)
            root = bytes(fetched.message.parent_root)
        else:
            raise RuntimeError("parent chain too deep")

        imported = 0
        for signed in reversed(chain_to_process):
            await self.chain.process_block(signed)
            imported += 1
        return imported
