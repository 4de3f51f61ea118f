"""drand_tpu_torch: the PyTorch + CUDA port of drand_tpu for NVIDIA Hopper.

The JAX package (drand_tpu) stays the reference; this package imports none
of it and never imports jax.  Layout mirrors the JAX package:

  ops/limbs.py, ops/tower.py, ops/curve.py, ops/h2c.py, ops/pairing.py
      the plain PyTorch engine (Fp on (..., 24) int64 limbs and up)
  ops/kernels.py, ops/csrc/*.cu
      the hand-written Hopper kernels, their ctypes binding and build
  crypto/host/...
      the port's own copies of the host constants and big-int helpers
  crypto/schemes.py, crypto/batch.py, crypto/partials.py
      the three beacon schemes (pedersen-bls-chained, pedersen-bls-unchained,
      bls-unchained-on-g1), their batched verifier, batched signing and
      threshold recovery, and batched threshold-partial verification
  convert.py
      moves state between the JAX package and the port (tests)

Entry points, each on CUDA unless the caller passes ``device="cpu"``:
``crypto.batch.BatchBeaconVerifier(scheme, public_key_bytes, device=None)``,
``crypto.batch.sign_batch(scheme, secret, msgs, device=None)``,
``crypto.batch.recover_batch(scheme, indices, partial_sigs, device=None)``
and ``crypto.partials.BatchPartialVerifier(scheme, pub_poly, n_nodes,
device=None)``.
"""
