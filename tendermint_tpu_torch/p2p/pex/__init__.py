"""Peer exchange: the address book and the PEX reactor (ref p2p/pex/), the
port's copy of the reference package's ``p2p/pex/`` with the same exports."""

from tendermint_tpu_torch.p2p.pex.addrbook import AddrBook, KnownAddress
from tendermint_tpu_torch.p2p.pex.pex_reactor import PEXReactor

__all__ = ["AddrBook", "KnownAddress", "PEXReactor"]
