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


#: Checkpointing and fault tolerance (ROADMAP queue A item 6).
_FT_MODULES = ("tpudl_torch.checkpoint", "tpudl_torch.ft",
               "tpudl_torch.ft.chaos", "tpudl_torch.ft.data",
               "tpudl_torch.ft.manager", "tpudl_torch.ft.preemption",
               "tpudl_torch.ft.store", "tpudl_torch.ft.supervisor",
               "tpudl_torch.ft.writer")


#: Mixed precision and fp8 (ROADMAP queue A item 8).
_PRECISION_MODULES = ("tpudl_torch.rules", "tpudl_torch.ops.fp8_dot",
                      "tpudl_torch.train.precision")


#: The quantized tiers and the MoE MLP (ROADMAP queue A item 4).
_QUANT_MODULES = ("tpudl_torch.quant", "tpudl_torch.quant.quantize",
                  "tpudl_torch.quant.dense", "tpudl_torch.ops.quant_dot",
                  "tpudl_torch.ops.moe")


#: The data layer and the run's logs, goodput and profile (ROADMAP queue
#: A item 13, and item 10's train-side observability).
_DATA_MODULES = ("tpudl_torch.data", "tpudl_torch.data.converter",
                 "tpudl_torch.data.tokenizer", "tpudl_torch.data.bpe",
                 "tpudl_torch.data.datasets", "tpudl_torch.data.ingest",
                 "tpudl_torch.train.logging", "tpudl_torch.train.profiling",
                 "tpudl_torch.obs.goodput")


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
                 "tpudl_torch.export.decode", *_FT_MODULES,
                 *_PRECISION_MODULES, *_QUANT_MODULES, *_DATA_MODULES):
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


def test_checkpoint_and_ft_import_without_ml_dtypes():
    """The fault-tolerance layer reads and writes bf16 leaves without
    ml_dtypes (which comes with jax): it imports, and a bf16 leaf
    round-trips, where ml_dtypes cannot be imported."""
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import importlib, tempfile, torch\n"
        f"for name in {_FT_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from tpudl_torch.ft.store import CheckpointStore\n"
        "store = CheckpointStore(tempfile.mkdtemp())\n"
        "leaf = torch.tensor([1.5, -3.0], dtype=torch.bfloat16)\n"
        "store.write(1, [('a', leaf)])\n"
        "assert torch.equal(store.read(1)[1]['a'], leaf)\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None "
        "and m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tpudl', "
        "'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_data_converter_imports_alone_without_jax():
    """The converter, on its own in a fresh interpreter, loads none of
    jax, flax or tpudl, and reads back the Parquet it writes."""
    code = (
        "import sys, tempfile\n"
        "import numpy as np\n"
        "from tpudl_torch.data.converter import make_converter, "
        "write_parquet\n"
        "d = tempfile.mkdtemp()\n"
        "write_parquet(d, {'x': np.arange(12).reshape(4, 3)})\n"
        "(b,) = make_converter(d).make_batch_iterator(4)\n"
        "assert b['x'].shape == (4, 3)\n"
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
