"""The net layer: the resilience policy (`resilience.py`) and the
serving plane's admission control (`admission.py`), the port's copies of
drand_tpu/net/resilience.py and drand_tpu/net/admission.py.  The gRPC
transport is not ported yet, and nothing here imports grpc at module
import."""
