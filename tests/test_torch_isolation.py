"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback.

* An AST scan of ``src/repro_torch/**.py`` and ``chip_smoke.py`` finds no
  import of ``jax``, of ``repro`` / ``repro.*`` (``repro_torch`` is fine)
  or of ``msgpack`` (which the card's machine does not have).
* A subprocess in which ``import jax`` and ``import repro`` fail imports
  every module of the port.
* The entry points default to ``device="cuda"`` and raise where CUDA is
  absent instead of running on the CPU.
"""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) > 20
    # the full-sequence and warm-cache slices' modules are among them
    rel = {str(p.relative_to(PORT)) for p in files if PORT in p.parents}
    assert {"kernels/flash_attention.py", "rewards/prm.py",
            "rewards/__init__.py", "serving/snapshot.py"} <= rel
    bad = []
    for path in files:
        for name in _imported(ast.parse(path.read_text(), str(path))):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_every_port_module_imports_without_jax_or_reference():
    modules = sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("")
                 .parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import random_params
    from repro_torch.serving import GSIServingEngine
    cfgs = tuple(dataclasses.replace(c, num_layers=1)
                 for c in serve.toy_triple())
    params = [random_params(c, i, "cpu") for i, c in enumerate(cfgs)]
    with pytest.raises(RuntimeError, match="cuda"):
        GSIServingEngine(*cfgs, *params, GSIConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        serve.build_engine(cfgs, GSIConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--config", "toy", "--layers", "1"])
    # the same engine is fine when the caller asks for the CPU
    GSIServingEngine(*cfgs, *params, GSIConfig(), device="cpu")


def test_unported_options_raise():
    """The multi-GPU options still raise; the fleet, the SLO options and
    the warm cache, ported, no longer do (a fleet of one shared engine is
    refused as in the reference)."""
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import random_params
    from repro_torch.serving import GSIScheduler, GSIServingEngine
    cfgs = tuple(dataclasses.replace(c, num_layers=1)
                 for c in serve.toy_triple())
    params = [random_params(c, i, "cpu") for i, c in enumerate(cfgs)]
    args = (*cfgs, *params, GSIConfig())
    with pytest.raises(NotImplementedError):
        GSIServingEngine(*args, device="cpu", mesh=object())
    eng = GSIServingEngine(*args, device="cpu", paged=True)
    with pytest.raises(ValueError, match="share engine"):
        serve.make_frontend([eng, eng], capacity=1)
    with pytest.raises(NotImplementedError):
        serve.main(["--config", "toy", "--device", "cpu", "--tp", "2"])
    # ported: the replica fleet behind its router
    serve.main(["--config", "toy", "--device", "cpu", "--layers", "1",
                "--paged", "--replicas", "2", "--requests", "2",
                "--max-steps", "1", "--max-step-tokens", "4"])
    # ported: chunked prefill, cache-aware ordering, the pipelined loop,
    # priorities, deadlines, streams, extend and the snapshot codec
    sched = GSIScheduler(eng, capacity=1, chunk_tokens=8, cache_aware=True,
                         sync=False)
    assert sched.pipeline_stats()["sync"] is False
    sched.submit([5, 6, 4], max_steps=1, priority=1, deadline_s=1.0,
                 stream=print)
    state = eng.extend(sched.state, [False], [[0]], [False])
    snap = eng.save_cache(state)
    assert snap["pages"].size == 0
    assert eng.load_cache(state, snap) is state
