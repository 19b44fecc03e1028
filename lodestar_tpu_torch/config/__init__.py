"""Runtime chain configuration: fork schedule, domains, networks.

Counterpart of the reference `packages/config/src`
(`beaconConfig.ts:17,25` createChainForkConfig/createBeaconConfig,
`chainConfig/` value tables, `networks.ts`). A ChainConfig is runtime data
(fork epochs, genesis parameters); the preset remains a separate
compile-frozen value (see `params`).

The port of `lodestar_tpu.config` (host Python and numpy, as there).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from functools import lru_cache

from lodestar_tpu_torch.params import FAR_FUTURE_EPOCH

__all__ = [
    "ChainConfig",
    "ForkInfo",
    "BeaconConfig",
    "mainnet_chain_config",
    "minimal_chain_config",
    "gnosis_chain_config",
    "goerli_chain_config",
    "sepolia_chain_config",
    "create_beacon_config",
    "compute_fork_data_root",
    "compute_domain",
    "compute_signing_root",
    "NETWORKS",
]

FORK_ORDER = ("phase0", "altair", "bellatrix", "capella", "deneb")


@dataclass(frozen=True)
class ChainConfig:
    """Spec runtime config values (reference `chainConfig/types.ts`)."""

    PRESET_BASE: str = "mainnet"
    CONFIG_NAME: str = "mainnet"
    # genesis
    MIN_GENESIS_ACTIVE_VALIDATOR_COUNT: int = 16384
    MIN_GENESIS_TIME: int = 1606824000
    GENESIS_FORK_VERSION: bytes = bytes.fromhex("00000000")
    GENESIS_DELAY: int = 604800
    # forks
    ALTAIR_FORK_VERSION: bytes = bytes.fromhex("01000000")
    ALTAIR_FORK_EPOCH: int = FAR_FUTURE_EPOCH
    BELLATRIX_FORK_VERSION: bytes = bytes.fromhex("02000000")
    BELLATRIX_FORK_EPOCH: int = FAR_FUTURE_EPOCH
    CAPELLA_FORK_VERSION: bytes = bytes.fromhex("03000000")
    CAPELLA_FORK_EPOCH: int = FAR_FUTURE_EPOCH
    DENEB_FORK_VERSION: bytes = bytes.fromhex("04000000")
    DENEB_FORK_EPOCH: int = FAR_FUTURE_EPOCH
    # merge
    TERMINAL_TOTAL_DIFFICULTY: int = 2**256 - 2**10
    TERMINAL_BLOCK_HASH: bytes = b"\x00" * 32
    TERMINAL_BLOCK_HASH_ACTIVATION_EPOCH: int = FAR_FUTURE_EPOCH
    # time
    SECONDS_PER_SLOT: int = 12
    SECONDS_PER_ETH1_BLOCK: int = 14
    ETH1_FOLLOW_DISTANCE: int = 2048
    # validator cycle
    EJECTION_BALANCE: int = 16_000_000_000
    MIN_PER_EPOCH_CHURN_LIMIT: int = 4
    CHURN_LIMIT_QUOTIENT: int = 65536
    INACTIVITY_SCORE_BIAS: int = 4
    INACTIVITY_SCORE_RECOVERY_RATE: int = 16
    PROPOSER_SCORE_BOOST: int = 40
    # deposit contract
    DEPOSIT_CHAIN_ID: int = 1
    DEPOSIT_NETWORK_ID: int = 1
    DEPOSIT_CONTRACT_ADDRESS: bytes = bytes(20)

    def replace(self, **overrides) -> "ChainConfig":
        return replace(self, **overrides)

    def fork_version(self, fork: str) -> bytes:
        if fork == "phase0":
            return self.GENESIS_FORK_VERSION
        return getattr(self, f"{fork.upper()}_FORK_VERSION")

    def fork_epoch(self, fork: str) -> int:
        if fork == "phase0":
            return 0
        return getattr(self, f"{fork.upper()}_FORK_EPOCH")


@dataclass(frozen=True)
class ForkInfo:
    name: str
    epoch: int
    version: bytes
    prev_version: bytes
    prev_fork_name: str


def fork_name_at_epoch(cfg: ChainConfig, epoch: int) -> str:
    """Active fork name at an epoch for a plain ChainConfig (shared by
    the chain runtime and restart/checkpoint loaders)."""
    name = FORK_ORDER[0]
    for fork in FORK_ORDER[1:]:
        if cfg.fork_epoch(fork) <= epoch:
            name = fork
    return name


def _fork_schedule(cfg: ChainConfig) -> tuple[ForkInfo, ...]:
    out = []
    prev_version = cfg.GENESIS_FORK_VERSION
    prev_name = "phase0"
    for name in FORK_ORDER:
        epoch = cfg.fork_epoch(name)
        version = cfg.fork_version(name)
        out.append(ForkInfo(name, epoch, version, prev_version, prev_name))
        prev_version, prev_name = version, name
    return tuple(out)


def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    """hash_tree_root(ForkData) — 2-leaf merkle (spec compute_fork_data_root)."""
    leaf0 = current_version.ljust(32, b"\x00")
    return hashlib.sha256(leaf0 + genesis_validators_root).digest()


def compute_domain(
    domain_type: bytes, fork_version: bytes, genesis_validators_root: bytes
) -> bytes:
    return domain_type + compute_fork_data_root(fork_version, genesis_validators_root)[:28]


def compute_signing_root(ssz_type, value, domain: bytes) -> bytes:
    """hash_tree_root(SigningData) (spec compute_signing_root)."""
    object_root = ssz_type.hash_tree_root(value)
    return hashlib.sha256(object_root + domain).digest()


# Module-level caches keyed on pure inputs: instance-method lru_cache would
# pin every BeaconConfig (and its fork schedule) in a class-global cache.
@lru_cache(maxsize=512)
def _cached_domain(domain_type: bytes, fork_version: bytes, gvr: bytes) -> bytes:
    return compute_domain(domain_type, fork_version, gvr)


@lru_cache(maxsize=128)
def _cached_fork_digest(fork_version: bytes, gvr: bytes) -> bytes:
    return compute_fork_data_root(fork_version, gvr)[:4]


@dataclass(frozen=True)
class BeaconConfig:
    """ChainConfig bound to a genesis_validators_root with cached domains
    (reference `beaconConfig.ts:25` createBeaconConfig + forkDigest caches)."""

    chain: ChainConfig
    genesis_validators_root: bytes
    forks: tuple[ForkInfo, ...] = field(default_factory=tuple)

    def fork_name_at_epoch(self, epoch: int) -> str:
        name = "phase0"
        for f in self.forks:
            if epoch >= f.epoch:
                name = f.name
        return name

    def fork_info_at_epoch(self, epoch: int) -> ForkInfo:
        info = self.forks[0]
        for f in self.forks:
            if epoch >= f.epoch:
                info = f
        return info

    def fork_name_at_slot(self, slot: int, slots_per_epoch: int) -> str:
        return self.fork_name_at_epoch(slot // slots_per_epoch)

    def fork_digest(self, fork_name: str) -> bytes:
        """4-byte digest for gossip topics / ENR (spec compute_fork_digest)."""
        version = self.chain.fork_version(fork_name)
        return _cached_fork_digest(version, self.genesis_validators_root)

    def get_domain_by_version(self, domain_type: bytes, fork_version: bytes) -> bytes:
        return _cached_domain(domain_type, fork_version, self.genesis_validators_root)

    def get_domain(self, domain_type: bytes, epoch: int) -> bytes:
        """Domain for signing at an epoch, using that epoch's fork version
        (spec get_domain with state fork resolved from the schedule)."""
        return self.get_domain_by_version(
            domain_type, self.fork_info_at_epoch(epoch).version
        )


def create_beacon_config(chain: ChainConfig, genesis_validators_root: bytes) -> BeaconConfig:
    return BeaconConfig(
        chain=chain,
        genesis_validators_root=genesis_validators_root,
        forks=_fork_schedule(chain),
    )


def mainnet_chain_config() -> ChainConfig:
    """Ethereum mainnet (reference `networks/mainnet.ts`)."""
    return ChainConfig(
        PRESET_BASE="mainnet",
        CONFIG_NAME="mainnet",
        ALTAIR_FORK_EPOCH=74240,
        BELLATRIX_FORK_EPOCH=144896,
        CAPELLA_FORK_EPOCH=194048,
        TERMINAL_TOTAL_DIFFICULTY=58_750_000_000_000_000_000_000,
        DEPOSIT_CONTRACT_ADDRESS=bytes.fromhex("00000000219ab540356cbb839cbe05303d7705fa"),
    )


def minimal_chain_config() -> ChainConfig:
    """Minimal-preset dev config (all forks at genesis, fast slots)."""
    return ChainConfig(
        PRESET_BASE="minimal",
        CONFIG_NAME="minimal",
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=64,
        MIN_GENESIS_TIME=1578009600,
        GENESIS_FORK_VERSION=bytes.fromhex("00000001"),
        ALTAIR_FORK_VERSION=bytes.fromhex("01000001"),
        ALTAIR_FORK_EPOCH=0,
        BELLATRIX_FORK_VERSION=bytes.fromhex("02000001"),
        BELLATRIX_FORK_EPOCH=0,
        CAPELLA_FORK_VERSION=bytes.fromhex("03000001"),
        CAPELLA_FORK_EPOCH=0,
        DENEB_FORK_VERSION=bytes.fromhex("04000001"),
        GENESIS_DELAY=300,
        SECONDS_PER_SLOT=6,
        ETH1_FOLLOW_DISTANCE=16,
        DEPOSIT_CHAIN_ID=5,
        DEPOSIT_NETWORK_ID=5,
    )


def gnosis_chain_config() -> ChainConfig:
    """Gnosis chain (reference `chainConfig/networks/gnosis.ts` — public
    chain constants from the eth-clients configs)."""
    return ChainConfig(
        PRESET_BASE="gnosis",
        CONFIG_NAME="gnosis",
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=4096,
        MIN_GENESIS_TIME=1638968400,
        GENESIS_FORK_VERSION=bytes.fromhex("00000064"),
        GENESIS_DELAY=6000,
        ALTAIR_FORK_VERSION=bytes.fromhex("01000064"),
        ALTAIR_FORK_EPOCH=512,
        BELLATRIX_FORK_VERSION=bytes.fromhex("02000064"),
        BELLATRIX_FORK_EPOCH=385536,
        CAPELLA_FORK_VERSION=bytes.fromhex("03000064"),
        TERMINAL_TOTAL_DIFFICULTY=8626000000000000000000058750000000000000000000,
        SECONDS_PER_SLOT=5,
        SECONDS_PER_ETH1_BLOCK=6,
        ETH1_FOLLOW_DISTANCE=1024,
        CHURN_LIMIT_QUOTIENT=4096,
        DEPOSIT_CHAIN_ID=100,
        DEPOSIT_NETWORK_ID=100,
        DEPOSIT_CONTRACT_ADDRESS=bytes.fromhex("0b98057ea310f4d31f2a452b414647007d1645d9"),
    )


def goerli_chain_config() -> ChainConfig:
    """Goerli/Prater testnet (reference `chainConfig/networks/goerli.ts`)."""
    return ChainConfig(
        PRESET_BASE="mainnet",
        CONFIG_NAME="goerli",
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=16384,
        MIN_GENESIS_TIME=1614588812,
        GENESIS_FORK_VERSION=bytes.fromhex("00001020"),
        GENESIS_DELAY=1919188,
        ALTAIR_FORK_VERSION=bytes.fromhex("01001020"),
        ALTAIR_FORK_EPOCH=36660,
        BELLATRIX_FORK_VERSION=bytes.fromhex("02001020"),
        BELLATRIX_FORK_EPOCH=112260,
        CAPELLA_FORK_VERSION=bytes.fromhex("03001020"),
        CAPELLA_FORK_EPOCH=162304,
        TERMINAL_TOTAL_DIFFICULTY=10790000,
        DEPOSIT_CHAIN_ID=5,
        DEPOSIT_NETWORK_ID=5,
        DEPOSIT_CONTRACT_ADDRESS=bytes.fromhex("ff50ed3d0ec03ac01d4c79aad74928bff48a7b2b"),
    )


def sepolia_chain_config() -> ChainConfig:
    """Sepolia testnet (reference `chainConfig/networks/sepolia.ts`)."""
    return ChainConfig(
        PRESET_BASE="mainnet",
        CONFIG_NAME="sepolia",
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=1300,
        MIN_GENESIS_TIME=1655647200,
        GENESIS_FORK_VERSION=bytes.fromhex("90000069"),
        ALTAIR_FORK_VERSION=bytes.fromhex("90000070"),
        ALTAIR_FORK_EPOCH=50,
        BELLATRIX_FORK_VERSION=bytes.fromhex("90000071"),
        BELLATRIX_FORK_EPOCH=100,
        CAPELLA_FORK_VERSION=bytes.fromhex("90000072"),
        CAPELLA_FORK_EPOCH=56832,
        TERMINAL_TOTAL_DIFFICULTY=17000000000000000,
        DEPOSIT_CHAIN_ID=11155111,
        DEPOSIT_NETWORK_ID=11155111,
        DEPOSIT_CONTRACT_ADDRESS=bytes.fromhex("7f02c3e3c98b133055b8b348b2ac625669ed295d"),
    )


NETWORKS = {
    "mainnet": mainnet_chain_config,
    "minimal": minimal_chain_config,
    "gnosis": gnosis_chain_config,
    "goerli": goerli_chain_config,
    "sepolia": sepolia_chain_config,
}
