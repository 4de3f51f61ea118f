"""The port stands alone: drand_tpu_torch never imports jax or drand_tpu.

A fresh interpreter imports the package and runs a CPU ``verify_batch``;
afterwards neither ``jax`` nor any ``drand_tpu`` module may be in
``sys.modules``.  Every source file of the package is also read for import
statements that name either.  And the entry point runs on CUDA unless the
caller asks for the CPU: without a GPU it raises instead of carrying on.
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
