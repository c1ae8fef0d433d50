"""nvcc builds of the port's hand-written CUDA kernels.

Each source under `csrc/` has a plain C interface.  It is compiled with
nvcc for sm_90a into a shared library at first use, under `build/` at
the root of the checkout, in `build/<stem>-<hash>/lib<stem>.so` with the
hash taken over the source and the flags, so two sources, or one source
under two sets of flags, never share a library.  The wrappers load the
library with ctypes.  Importing this module needs neither nvcc nor a
card.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "csrc/*.cu on a machine with the CUDA toolkit")


def library_path(src: Path, extra_flags: tuple = ()) -> Path:
    """Where the library of `src` built with NVCC_FLAGS + extra_flags
    lies: `build/<stem>-<hash of source and flags>/lib<stem>.so`."""
    flags = NVCC_FLAGS + tuple(extra_flags)
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return (BUILD_ROOT / f"{src.stem}-{h.hexdigest()[:16]}"
            / f"lib{src.stem}.so")


def build(src: Path, extra_flags: tuple = ()) -> tuple[Path, str]:
    """Compile `src` if its hashed library is missing.  Returns (library
    path, compiler log); the log holds ptxas' register and shared-memory
    report of a fresh build.  `extra_flags` go to nvcc after NVCC_FLAGS."""
    so = library_path(src, extra_flags)
    log_path = so.with_suffix(".log")
    if so.exists():
        return so, log_path.read_text() if log_path.exists() else ""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".tmp-{os.getpid()}-{so.name}")
    cmd = [nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):"
                           f"\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)
    return so, log
