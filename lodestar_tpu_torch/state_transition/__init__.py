"""Consensus state transition: so far, the state hashTreeRoot
(`state_transition/htr.py`, the port of `lodestar_tpu.state_transition.htr`)."""

from .htr import StateRootTracker, drop_tracker, state_hash_tree_root

__all__ = ["state_hash_tree_root", "drop_tracker", "StateRootTracker"]
