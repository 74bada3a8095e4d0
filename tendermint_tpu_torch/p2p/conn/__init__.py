from tendermint_tpu_torch.p2p.conn.secret_connection import SecretConnection
from tendermint_tpu_torch.p2p.conn.connection import (
    ChannelDescriptor,
    MConnection,
    MConnConfig,
)

__all__ = ["SecretConnection", "ChannelDescriptor", "MConnection", "MConnConfig"]
