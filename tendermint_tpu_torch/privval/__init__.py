"""The validator's signer on disk (``file_pv.FilePV``); the remote signer is
not ported (ROADMAP queue 1 item 17 (d))."""
