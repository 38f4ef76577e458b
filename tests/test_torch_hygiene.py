"""The port stands alone and keeps its device rule.

* No module of exemplar_vae_tpu_torch/ and not chip_smoke.py imports jax,
  flax, optax, the JAX package or tools/ (AST scan, and a fresh interpreter
  that imports the whole port and finds none of them loaded).
* Entry points default to CUDA and raise when no card is present, rather
  than fall back to the CPU.
* chip_smoke.py exits non-zero and prints no result without a card, and
  when it is alone in a directory.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "exemplar_vae_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "flax", "optax", "exemplar_vae_tpu", "tools")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import exemplar_vae_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'exemplar_vae_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def _entry_points():
    from exemplar_vae_tpu_torch.classify_mnist import main as classify
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.device import resolve_device
    from exemplar_vae_tpu_torch.export_serving import main as export
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.main import main
    from exemplar_vae_tpu_torch.serve import ServingBundle
    from exemplar_vae_tpu_torch.train.trainer import Experiment
    return {
        "resolve_device": lambda: resolve_device(),
        "create_model": lambda: create_model(Config(hidden_size=8, z1_size=2)),
        "ServingBundle.load": lambda: ServingBundle.load("no-such-bundle"),
        "Experiment": lambda: Experiment(Config(
            dataset_name="synthetic", training_set_size=8, val_set_size=4,
            test_set_size=4, hidden_size=8, z1_size=2)),
        "main": lambda: main(["--dataset_name", "synthetic",
                              "--training_set_size", "8", "--val_set_size",
                              "4", "--test_set_size", "4"]),
        "classify_mnist": lambda: classify(["--train_first",
                                            "--dataset_name", "synthetic",
                                            "--training_set_size", "8"]),
        "export_serving": lambda: export(["--vae_dir", "no-such-run"]),
    }


@pytest.mark.parametrize("name", ["resolve_device", "create_model",
                                  "ServingBundle.load", "Experiment", "main",
                                  "classify_mnist", "export_serving"])
def test_entry_points_raise_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_cuda_kernel_wrapper_refuses_non_cuda_non_cpu():
    from exemplar_vae_tpu_torch.ops.pairwise_lse import pairwise_lse
    z = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pairwise_lse(z, z, torch.zeros((), device="meta"), None,
                     torch.zeros(2, dtype=torch.int32, device="meta"),
                     torch.ones(2, dtype=torch.bool, device="meta"))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(alone, tmp_path):
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = dict(os.environ)
    if not alone:          # alone, the port's import fails even with a card
        env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
