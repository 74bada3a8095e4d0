"""The validator's signers: on disk (``file_pv.FilePV``) and remote
(``remote_signer``: the node's endpoint and the signer that dials it)."""
