"""Build the port's CUDA sources with nvcc at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/lib<name>-<digest>.so`` at the repository root (``build/``
is git-ignored); the digest covers the source, every shared header
``csrc/*.cuh`` (``hopper.cuh``: the TMA, mbarrier and wgmma building
blocks) and the flags, so an edited source or header rebuilds its users
and an unchanged one is reused.  No library links ``-lcuda``: the one
driver function used (``cuTensorMapEncodeTiled``) is reached through the
runtime's ``cudaGetDriverEntryPoint``.  Libraries are loaded with
``ctypes``.  Nothing here runs at import time: the CPU tests import every
module on machines with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "paged_attention_quant", "logprob_gather",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_hopper", "rwkv6_scan", "rwkv6_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}
# replica threads may reach a kernel's first call together
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc``, else ``PATH``)."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put it on PATH")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the source, the shared
    headers ``csrc/*.cuh`` (any source may include any of them) and the
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(b"\0" + path.name.encode() + b"\0")
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together.

    Returns name -> the compiler's output (``-Xptxas -v``: registers,
    shared memory, spills), or ``""`` for a library that was already built.
    Raises with the compiler's output if a build fails.  Each library is
    written under a per-process name and renamed into place, so concurrent
    builders never load a half-written file.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs, procs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = ""
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed
    (once, whichever threads ask at the same time)."""
    lib = _loaded.get(name)
    if lib is None:
        with _LOCK:
            lib = _loaded.get(name)
            if lib is None:
                build((name,))
                lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
