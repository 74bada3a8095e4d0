"""PyTorch/CUDA port of tendermint_tpu's batched signature verification.

The JAX package (``tendermint_tpu``) is the reference; this package imports
none of it. Commit verification runs
``types.validator_set.ValidatorSet.verify_commit`` ->
``crypto.batch.verify_generic`` (split by key type) ->
``crypto.batch.TorchBatchVerifier``: ed25519 rows go to
``ops.ed25519_cuda.verify_batch`` and its two hand-written CUDA kernels
(SHA-512/mod-L prologue, Straus ladder), secp256k1 rows to
``ops.secp256k1_cuda.verify_batch`` and its ECDSA ladder kernel.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no device given and no CUDA present they raise (``device.resolve_device``).
"""
