"""PyTorch/CUDA port of tendermint_tpu's batched signature verification.

The JAX package (``tendermint_tpu``) is the reference; this package imports
none of it. Slice 1 covers the commit-verification main path:
``types.validator_set.ValidatorSet.verify_commit`` ->
``crypto.batch.TorchBatchVerifier`` -> ``ops.ed25519_cuda.verify_batch`` ->
the two hand-written CUDA kernels (SHA-512/mod-L prologue, Straus ladder).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no device given and no CUDA present they raise (``device.resolve_device``).
"""
