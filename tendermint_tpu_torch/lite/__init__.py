"""Light client: header verification that trusts no full node, over the
batched commit-verify path (ref lite/; the port's copy of the reference
package's ``lite/`` package)."""

from tendermint_tpu_torch.lite.provider import DBProvider, Provider, ProviderError
from tendermint_tpu_torch.lite.types import FullCommit, LiteError, SignedHeader
from tendermint_tpu_torch.lite.verifier import BaseVerifier, DynamicVerifier

__all__ = [
    "BaseVerifier",
    "DBProvider",
    "DynamicVerifier",
    "FullCommit",
    "LiteError",
    "Provider",
    "ProviderError",
    "SignedHeader",
]
