"""BLS verification seam + device pool (reference `chain/bls/`): the
PyTorch port's copy of ``lodestar_tpu/chain/bls``, serving batch
verification through the port's device model."""

from .fallback import DegradingBlsVerifier  # noqa: F401
from .interface import (  # noqa: F401
    BlsSingleThreadVerifier,
    BlsVerifierMock,
    IBlsVerifier,
    VerifySignatureOpts,
)
from .mesh import (  # noqa: F401
    MESH_MODES,
    MeshLane,
    VerifierMesh,
    build_device_mesh,
    single_lane_mesh,
)
from .pool import (  # noqa: F401
    BATCHABLE_MIN_PER_CHUNK,
    MAX_BUFFER_WAIT_MS,
    MAX_BUFFERED_SIGS,
    MAX_JOBS_CAN_ACCEPT_WORK,
    MAX_PACKAGE_SETS,
    MAX_SIGNATURE_SETS_PER_JOB,
    BlsDeviceVerifierPool,
    chunkify_maximize_chunk_size,
)
