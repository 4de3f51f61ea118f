"""drand_tpu_torch: the PyTorch + CUDA port of drand_tpu for NVIDIA Hopper.

The JAX package (drand_tpu) stays the reference; this package imports none
of it and never imports jax.  Layout mirrors the JAX package:

  ops/limbs.py, ops/tower.py, ops/curve.py, ops/h2c.py, ops/pairing.py
      the plain PyTorch engine (Fp on (..., 24) int64 limbs and up)
  ops/kernels.py, ops/csrc/*.cu
      the hand-written Hopper kernels, their ctypes binding and build
  crypto/host/...
      the port's own copies of the host constants and big-int helpers
  crypto/schemes.py, crypto/batch.py
      the three beacon schemes (pedersen-bls-chained, pedersen-bls-unchained,
      bls-unchained-on-g1) and their batched verifier
  convert.py
      moves state between the JAX package and the port (tests)

Entry point: ``crypto.batch.BatchBeaconVerifier(scheme, public_key_bytes,
device=None)`` runs on CUDA unless the caller passes ``device="cpu"``.
"""
