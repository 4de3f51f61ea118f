"""Regenerate drand_pb2.py from drand.proto (the port's copy of
drand_tpu/protos/gen.py).

The serialized descriptor must stay byte for byte the reference's: both
packages load in one process, and the protobuf runtime refuses a second,
different file that defines the same symbols (drand.NodeVersion, ...).

Run: `python -m drand_tpu_torch.protos.gen`.  Only message codegen is used
(`protoc --python_out`); gRPC service plumbing is hand-built from the
message classes in drand_tpu_torch/net/rpc.py (no grpc protoc plugin in this
environment).
"""

import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent


def main() -> int:
    proc = subprocess.run(
        ["protoc", f"--proto_path={HERE}", f"--python_out={HERE}",
         str(HERE / "drand.proto")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr)
        return proc.returncode
    print("wrote", HERE / "drand_pb2.py")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
