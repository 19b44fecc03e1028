"""Genesis + interop state construction.

Reference `beacon-node/src/chain/genesis/genesis.ts` +
`node/utils/interop/` (deterministic validators for dev/test networks) —
the spec's initialize_beacon_state_from_eth1 specialized to interop
deposits: deterministic secret keys sk_i = int(sha256(le64(i))) mod r,
every validator at MAX_EFFECTIVE_BALANCE and active at genesis.

The port of `lodestar_tpu.state_transition.genesis` (host Python and numpy, as there).
"""

from __future__ import annotations

import hashlib

from lodestar_tpu_torch.crypto.bls.api import SecretKey
from lodestar_tpu_torch.crypto.bls.fields import R
from lodestar_tpu_torch.params import FAR_FUTURE_EPOCH, GENESIS_EPOCH, BeaconPreset, active_preset
from lodestar_tpu_torch.types import ssz_types

__all__ = ["interop_secret_keys", "interop_pubkeys", "create_interop_genesis_state"]


def interop_secret_keys(n: int) -> list[SecretKey]:
    """Deterministic interop keys (eth2 interop convention: sk =
    int_le(sha256(le64(i))) mod r)."""
    out = []
    for i in range(n):
        h = hashlib.sha256(i.to_bytes(32, "little")).digest()
        out.append(SecretKey(int.from_bytes(h, "little") % R))
    return out


def interop_pubkeys(n: int) -> list[bytes]:
    return [sk.to_pubkey() for sk in interop_secret_keys(n)]


def create_interop_genesis_state(
    n_validators: int,
    genesis_time: int = 0,
    p: BeaconPreset | None = None,
    eth1_block_hash: bytes = b"\x42" * 32,
    pubkeys: list[bytes] | None = None,
    genesis_fork_version: bytes = b"\x00\x00\x00\x00",
):
    """Phase0 genesis BeaconState with n active interop validators."""
    p = p or active_preset()
    t = ssz_types(p)
    state = t.phase0.BeaconState.default()
    state.genesis_time = genesis_time
    # spec: previous == current == GENESIS_FORK_VERSION at genesis
    fork = t.Fork.default()
    fork.previous_version = genesis_fork_version
    fork.current_version = genesis_fork_version
    state.fork = fork

    # latest block header points at the empty body
    header = t.BeaconBlockHeader.default()
    header.body_root = t.phase0.BeaconBlockBody.hash_tree_root(t.phase0.BeaconBlockBody.default())
    state.latest_block_header = header

    state.randao_mixes = [eth1_block_hash] * p.EPOCHS_PER_HISTORICAL_VECTOR

    if pubkeys is None:
        pubkeys = interop_pubkeys(n_validators)
    validators = []
    balances = []
    for pk in pubkeys:
        v = t.Validator.default()
        v.pubkey = pk
        v.withdrawal_credentials = b"\x00" + hashlib.sha256(pk).digest()[1:]
        v.effective_balance = p.MAX_EFFECTIVE_BALANCE
        v.activation_eligibility_epoch = GENESIS_EPOCH
        v.activation_epoch = GENESIS_EPOCH
        v.exit_epoch = FAR_FUTURE_EPOCH
        v.withdrawable_epoch = FAR_FUTURE_EPOCH
        validators.append(v)
        balances.append(p.MAX_EFFECTIVE_BALANCE)
    state.validators = validators
    state.balances = balances

    eth1 = t.Eth1Data.default()
    eth1.deposit_count = n_validators
    eth1.block_hash = eth1_block_hash
    state.eth1_data = eth1
    state.eth1_deposit_index = n_validators

    vtype = state.type.fields[state.type.field_index("validators")][1]
    state.genesis_validators_root = vtype.hash_tree_root(validators)
    return state
