"""BLS12-381 pure-Python oracle copies used by the port's host prep.

The port keeps its own copies (fields, curve, hash_to_curve, serdes and
the parts of the API it needs) so that it imports nothing of the JAX
package.
"""

from .api import (
    G2_INFINITY,
    PointDecodeError,
    SecretKey,
    SignatureSet,
    aggregate_pubkeys,
    aggregate_signatures,
    aggregate_verify,
    eth_fast_aggregate_verify,
    fast_aggregate_verify,
    sign,
    sk_to_pk,
    verify,
    verify_signature_sets,
)

__all__ = [
    "G2_INFINITY",
    "PointDecodeError",
    "SecretKey",
    "SignatureSet",
    "aggregate_pubkeys",
    "aggregate_signatures",
    "aggregate_verify",
    "eth_fast_aggregate_verify",
    "fast_aggregate_verify",
    "sign",
    "sk_to_pk",
    "verify",
    "verify_signature_sets",
]
