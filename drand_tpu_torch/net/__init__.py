"""The net layer's resilience policy (the port's copy of
drand_tpu/net/resilience.py; the gRPC transport is not ported yet)."""
