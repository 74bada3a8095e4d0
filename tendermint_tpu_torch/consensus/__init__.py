"""The consensus state machine (ref consensus/): its messages, round types,
timeout ticker, write-ahead log, ``ConsensusState`` and the crash-recovery
replay with the ABCI ``Handshaker``."""
