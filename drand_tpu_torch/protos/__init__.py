"""The wire messages (the port's copy of drand_tpu/protos/)."""
