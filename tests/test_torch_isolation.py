"""The port stands alone: drand_tpu_torch never imports jax or drand_tpu.

A fresh interpreter imports the package and runs a CPU ``verify_batch``;
afterwards neither ``jax`` nor any ``drand_tpu`` module may be in
``sys.modules``.  Every source file of the package is also read for import
statements that name either.  And the entry point runs on CUDA unless the
caller asks for the CPU: without a GPU it raises instead of carrying on.

The public edge (the REST server, the client, the relays, admission
control) runs where grpc is absent: no edge module imports grpc or
google.protobuf at module import, and a fresh interpreter in which both
are unimportable serves one REST get and one verified client get.  The
daemon's gRPC plane (``GRPC_PLANE`` below) imports grpc at module top, as
the reference's does; a fresh interpreter that imports the daemon and its
CLI holds neither jax nor drand_tpu.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.crypto import schemes as S

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "drand_tpu_torch"

_CHILD = r"""
import json, sys
import drand_tpu_torch
from drand_tpu_torch import convert
from drand_tpu_torch.crypto import batch as B, schemes as S
from drand_tpu_torch.crypto.host.curve import G2
from drand_tpu_torch.crypto.host.serialize import g2_to_bytes
from drand_tpu_torch.ops import kernels, limbs, tower, curve, h2c, pairing
sch = S.scheme_from_name(S.SHORT_SIG_SCHEME_ID)
v = B.BatchBeaconVerifier(sch, g2_to_bytes(G2.mul(G2.gen, 5)), device="cpu")
ok = v.verify_batch([1], [b"\x00" * 48]).tolist()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "drand_tpu"
             or m.startswith("drand_tpu."))
print(json.dumps({"ok": ok, "bad": bad}))
"""


def test_import_and_cpu_verify_leave_jax_out():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"ok": [False], "bad": []}


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_file_imports_jax_or_drand_tpu(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "drand_tpu"), (path, mod)


def test_entry_point_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    sch = S.scheme_from_name(S.SHORT_SIG_SCHEME_ID)
    pk = bytes.fromhex(
        "876f6fa8073736e22f6ff4badaab35c637503718f7a452d178ce69c45d2d8129"
        "a54ad2f988ab10c9666f87ab603c59bf013409a5b500555da31720f8eec294d9"
        "809b8796f40d5372c71a44ca61226f1eb978310392f98074a608747f77e66c5a")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        B.BatchBeaconVerifier(sch, pk)
    with pytest.raises(RuntimeError):
        B.BatchBeaconVerifier(sch, pk, device="cuda")
    assert B.BatchBeaconVerifier(sch, pk, device="cpu").device.type == "cpu"


EDGE = ["http_server.py", "relay.py", "s3.py", "log.py", "fs.py",
        "client", "net", "core"]
# the daemon's gRPC plane: `import grpc` at module top, as in the reference
GRPC_PLANE = {"net/rpc.py", "net/client.py", "net/identity.py",
              "net/listener.py", "core/daemon.py"}


def _edge_files():
    for name in EDGE:
        p = PKG / name
        for f in (sorted(p.rglob("*.py")) if p.is_dir() else [p]):
            if str(f.relative_to(PKG)) not in GRPC_PLANE:
                yield f


def _module_level_imports(path):
    """Imports that run when the module is imported: the module body's,
    not those inside a function."""
    tree = ast.parse(path.read_text(), filename=str(path))
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, (ast.If, ast.Try, ast.With, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", list(_edge_files()),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_edge_module_imports_no_grpc(path):
    for mod in _module_level_imports(path):
        assert mod.split(".")[0] != "grpc" \
            and not mod.startswith("google.protobuf"), (path, mod)


_NO_GRPC_CHILD = r"""
import json, sys, urllib.request
sys.modules["grpc"] = None
sys.modules["google.protobuf"] = None
sys.path.insert(0, "tests")
import drand_tpu_torch.http_server, drand_tpu_torch.client
import drand_tpu_torch.relay, drand_tpu_torch.net.admission
from drand_tpu_torch.chain import MemDBStore, genesis_beacon
from drand_tpu_torch.client import From, HttpTransport, new_client
from drand_tpu_torch.client import with_chain_hash
from drand_tpu_torch.http_server import RestServer
from drand_tpu_torch.net.admission import AdmissionController
from torch_beacon_harness import MockChain, ShimDaemon, ShimProcess
chain = MockChain(n=2)
store = MemDBStore(buffer_size=16)
store.put(genesis_beacon(chain.info.genesis_seed))
store.put_many(chain.beacons[r] for r in (1, 2))
server = RestServer(ShimDaemon(ShimProcess.of_store(chain.info, store)),
                    "127.0.0.1:0", admission=AdmissionController())
server.start()
try:
    url = f"http://127.0.0.1:{server.port}"
    rest = json.loads(urllib.request.urlopen(url + "/public/2").read())
    got = new_client(From(HttpTransport(url)),
                     with_chain_hash(chain.info.hash_string())).get(1)
finally:
    server.stop()
bad = sorted(m for m in sys.modules
             if sys.modules[m] is not None and (
                 m.split(".")[0] in ("grpc", "jax", "drand_tpu")
                 or m.startswith("google.protobuf")))
print(json.dumps({"rest": rest["signature"] ==
                  chain.beacons[2].signature.hex(),
                  "client": got.randomness ==
                  chain.beacons[1].randomness(), "bad": bad}))
"""


def test_edge_serves_and_verifies_without_grpc():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _NO_GRPC_CHILD], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"rest": True, "client": True, "bad": []}


_DAEMON_CHILD = r"""
import json, sys
import drand_tpu_torch.cli
import drand_tpu_torch.core.daemon
from drand_tpu_torch.core import DrandDaemon
from drand_tpu_torch.net import ProtocolClient
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "drand_tpu"
             or m.startswith("drand_tpu."))
print(json.dumps({"grpc": "grpc" in sys.modules, "bad": bad}))
"""


def test_daemon_and_cli_import_leaves_jax_out():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _DAEMON_CHILD], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"grpc": True, "bad": []}


def test_grpc_plane_is_exactly_the_modules_importing_grpc():
    """Only the gRPC plane's modules import grpc at module top."""
    found = {str(p.relative_to(PKG)) for p in sorted(PKG.rglob("*.py"))
             if any(m.split(".")[0] == "grpc"
                    for m in _module_level_imports(p))}
    assert found == GRPC_PLANE
