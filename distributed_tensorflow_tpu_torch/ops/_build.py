"""Build a CUDA source of ``ops/csrc/`` into a shared library and load it.

Each kernel source has a plain C interface (pointers, ints, the stream) and
is bound with ``ctypes``.  The library is compiled with ``nvcc`` for
``sm_90a`` at first use, into ``ops/_build/`` inside the package, under a
name keyed by a hash of the source and the flags: an edited source builds
anew, an unchanged one loads the library already there.  Nothing is
compiled at import time.  ``ptxas -v`` reports each kernel's registers,
spills and shared memory; the report is kept beside the library
(``<name>-<hash>.log``) and in ``build_logs``.

``set_build_dir`` points the cache elsewhere (the CLI's
``--compile-cache DIR``: repeat runs with the same directory load the
libraries already built there).  A program ledger
(``observability.xla_stats.ProgramLedger``) given to ``watch_builds``
records each library built while it is watched as ``nvcc_<name>`` with
the ``nvcc`` wall time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# seconds each library took to build in this process (0.0 = loaded as built)
build_seconds: dict[str, float] = {}
# nvcc's output (the ptxas report) of each library loaded in this process
build_logs: dict[str, str] = {}
# the program ledgers recording each build (watch_builds)
_ledgers: list = []


def set_build_dir(path) -> Path:
    """Build and load the libraries under ``path`` from now on."""
    global BUILD_DIR
    BUILD_DIR = Path(path).expanduser().resolve()
    return BUILD_DIR


@contextlib.contextmanager
def watch_builds(ledger):
    """Record every library built inside the block in ``ledger``."""
    _ledgers.append(ledger)
    try:
        yield ledger
    finally:
        _ledgers.remove(ledger)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: building the port's CUDA kernels "
                       "needs the CUDA toolkit (PATH, CUDA_HOME or "
                       "/usr/local/cuda)")


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, then
    ``ctypes``-load it."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{digest}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = Path(tmp) / lib.name
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {src.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr)
            os.replace(out, lib)   # atomic: a reader never sees half a file
        build_seconds[name] = time.perf_counter() - t0
        for ledger in _ledgers:
            ledger.record(f"nvcc_{name}", compile_s=build_seconds[name])
    else:
        build_seconds.setdefault(name, 0.0)
    build_logs[name] = log.read_text() if log.exists() else ""
    return ctypes.CDLL(str(lib))
