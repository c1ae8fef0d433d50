"""Native (C++) front-end search, built at first use and loaded with ctypes.

Grid search is irregular host-side work, so it stays native C++
(`jps.cpp`, the port's own copy, byte for byte the JAX package's).  The
library is compiled with `g++ -O3 -shared -fPIC` at first use into
`build/jps-<hash>/libjps.so` at the root of the checkout, keyed by a hash
of the source and the flags, as the wavefront kernels are.  A build that
cannot run (no `g++`, a compiler error) raises RuntimeError; there is no
fallback search.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "jps.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_ROOT / f"jps-{h.hexdigest()[:16]}" / "libjps.so"


def build() -> Path:
    """Compile jps.cpp if the hashed library is missing; returns its path."""
    so = library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the JPS front end is built from "
                           f"{SRC.name} with a C++ compiler")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".tmp-{os.getpid()}-{so.name}")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def load_jps():
    """The ctypes handle of the JPS library, building it if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.jps_plan.restype = ctypes.c_int
            lib.jps_plan.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ]
            _LIB = lib
    return _LIB
