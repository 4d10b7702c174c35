"""The port stands alone: no JAX, no flax, nothing of the JAX package.

An AST scan of every module of ``pytorch_distributed_training_tpu_torch``
and of ``chip_smoke.py``, plus a fresh interpreter that imports the serving
CLI and reports which modules came in.  ``pytorch_distributed_training_tpu``
is a prefix of the port's own name, so a name is banned only when it equals
a banned root or starts with one followed by a dot.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "pytorch_distributed_training_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "pytorch_distributed_training_tpu")


def _banned(name: str) -> bool:
    return any(name == root or name.startswith(root + ".") for root in BANNED)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_guard_matches_names_exactly():
    assert _banned("jax.numpy") and _banned("pytorch_distributed_training_tpu.ops")
    assert _banned("pytorch_distributed_training_tpu")
    assert not _banned("pytorch_distributed_training_tpu_torch.ops")
    assert not _banned("jaxtyping") and not _banned("flaxen")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_banned_import(path):
    offenders = [f"{path.name}:{line} imports {name}" for line, name in _imports(path)
                 if _banned(name)]
    assert not offenders, offenders


def test_serving_cli_imports_no_jax():
    code = (
        "import json, sys\n"
        "import pytorch_distributed_training_tpu_torch.serving.__main__\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        check=True,
    ).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert "pytorch_distributed_training_tpu_torch.serving.engine" in loaded
    assert not [m for m in loaded if _banned(m)]


def test_trainer_and_fault_layer_import_no_jax():
    """The training CLI, the fault layer (``engine/fault.py``,
    ``watchdog.py``, ``topology.py``, ``utils/retry.py``: their JAX
    counterparts import no JAX either, and the port keeps its own copies)
    and the sequence-parallel layer (``parallel/mesh.py``,
    ``parallel/sequence.py``)."""
    mods = ["pytorch_distributed_training_tpu_torch.train_distributed",
            "pytorch_distributed_training_tpu_torch.engine.fault",
            "pytorch_distributed_training_tpu_torch.engine.watchdog",
            "pytorch_distributed_training_tpu_torch.engine.topology",
            "pytorch_distributed_training_tpu_torch.utils.retry",
            "pytorch_distributed_training_tpu_torch.parallel.mesh",
            "pytorch_distributed_training_tpu_torch.parallel.sequence"]
    for m in mods[1:]:
        assert (PORT / (m.split(".", 1)[1].replace(".", "/") + ".py")).is_file(), m
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        check=True,
    ).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert set(mods) <= set(loaded)
    assert not [m for m in loaded if _banned(m)]
