"""Import and device guards of the PyTorch port.

* Nothing under src/repro_torch/, not chip_smoke.py and no
  examples/*_torch.py imports jax or the reference package ``repro``
  (AST scan of every import, plus a fresh interpreter that imports every
  module of the port and every example twin).
* Entry points default to CUDA and raise when the process has none.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_import_all_modules_without_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            f"for i, p in enumerate({[str(p) for p in EXAMPLES]!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'ex{i}', p)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _cpu_only():
    if torch.cuda.is_available():
        pytest.skip("this process has CUDA; the guard is for CPU-only hosts")


def test_runtime_defaults_to_cuda_and_raises_without_it():
    _cpu_only()
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import EdgeCloudRuntime
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EdgeCloudRuntime(get_smoke_config("elasticbert12"))
    rt = EdgeCloudRuntime(get_smoke_config("elasticbert12"), device="cpu")
    assert rt.device == torch.device("cpu")


def test_model_constructor_and_bridge_raise_without_cuda():
    _cpu_only()
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import init_params
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(get_smoke_config("elasticbert12"))
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"w": np.zeros(3, np.float32)})


def test_runtime_rejects_params_on_another_device():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import EdgeCloudRuntime
    cfg = dataclasses.replace(get_smoke_config("elasticbert12"), num_layers=1)
    rt = EdgeCloudRuntime(cfg, device="cpu")
    params = init_params(cfg, device="cpu").to("meta")
    with pytest.raises(ValueError, match="params on"):
        rt.edge_fn(params, {"tokens": np.ones((1, 4), np.int32)}, 0)


def test_launch_counts_cover_every_kernel():
    from repro_torch.kernels import SOURCES, launch_counts, reset_launch_counts
    reset_launch_counts()
    assert launch_counts() == {"flash_attention": 0, "exit_confidence": 0,
                               "exit_confidence_fused": 0,
                               "exit_confidence_combine": 0, "wkv6": 0,
                               "wkv6_backward": 0,
                               "flash_attention_backward": 0}
    assert all(Path(s).exists() for s in SOURCES)


DISTRIBUTED = ("serving/kvstore.py", "serving/faults.py",
               "serving/distributed.py")


@pytest.mark.parametrize("name", DISTRIBUTED)
def test_distributed_modules_are_scanned_and_use_no_collective(name):
    """The distributed runtime's modules are among the scanned files, and
    exchange host-side bytes only: no process group, no NCCL."""
    path = PORT / name
    assert path in FILES
    source = path.read_text()
    for word in ("init_process_group", "nccl", "NCCL", "all_gather("):
        assert word not in source, f"{name} mentions {word}"


def test_every_example_has_its_port_twin():
    """The five examples' twins are among the scanned files."""
    originals = sorted(p.stem for p in (ROOT / "examples").glob("*.py")
                       if not p.stem.endswith("_torch"))
    assert [p.stem for p in EXAMPLES] == [f"{s}_torch" for s in originals]
    assert len(EXAMPLES) == 5 and all(p in FILES for p in EXAMPLES)
