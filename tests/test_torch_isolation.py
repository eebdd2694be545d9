"""The port stands alone: tpudl_torch never loads jax, flax or tpudl, and
chip_smoke.py refuses to run without a card.

Each check runs in a fresh interpreter, since this test process already
holds jax (tests/conftest.py imports it).
"""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import tpudl_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "tpudl_torch")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PACKAGE], prefix="tpudl_torch.")
    ) + ["tpudl_torch"]


def test_every_module_imports_without_jax_flax_or_tpudl():
    names = _modules()
    for name in ("tpudl_torch.serve.engine", "tpudl_torch.train.loop",
                 "tpudl_torch.models.bert", "tpudl_torch.models.lora",
                 "tpudl_torch.ops.flash_attention",
                 "tpudl_torch.ops.fused_attention",
                 "tpudl_torch.ops.segmented_lora", "tpudl_torch.models.paged",
                 "tpudl_torch.serve.lora", "tpudl_torch.ops.library",
                 "tpudl_torch.export", "tpudl_torch.export.export",
                 "tpudl_torch.export.parity", "tpudl_torch.export.latency",
                 "tpudl_torch.export.decode"):
        assert name in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpudl'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_line_imports_jax_flax_or_tpudl():
    pattern = re.compile(r"^\s*(import|from) (jax|flax|tpudl)\b")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PACKAGE):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offending = []
    for path in files:
        with open(path) as f:
            offending += [f"{path}:{i}" for i, line in enumerate(f, 1)
                          if pattern.match(line)]
    assert offending == []


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_package_is_imported_from_this_checkout():
    assert os.path.dirname(tpudl_torch.__file__) == PACKAGE
