"""Native (C++) components, built at first use and loaded with ctypes.

Grid search and the transport datapath are irregular host-side work, so
they stay native C++: `jps.cpp` (the front end's JPS) and `bus.cpp` (the
UDP bus core behind `runtime/native_transport.py`), the port's own
copies, byte for byte the JAX package's.  Each library is compiled with
`g++` at first use into `build/<name>-<hash>/` at the root of the
checkout, keyed by a hash of the source and the flags, as the wavefront
kernels are.  A build that cannot run (no `g++`, a compiler error)
raises RuntimeError; there is no fallback (no Python search, no Python
bus).
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
BUS_SRC = Path(__file__).resolve().parent / "bus.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
BUS_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LIB = None
_BUS_LIB = None
_LOCK = threading.Lock()


def library_path(src: Path = SRC, flags=GXX_FLAGS,
                 name: str = "libjps.so") -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_ROOT / f"{src.stem}-{h.hexdigest()[:16]}" / name


def build(src: Path = SRC, flags=GXX_FLAGS, name: str = "libjps.so") -> Path:
    """Compile `src` if the hashed library is missing; returns its path."""
    so = library_path(src, flags, name)
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {src.name} is built with a C++ "
                           "compiler")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".tmp-{os.getpid()}-{so.name}")
    proc = subprocess.run([gxx, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {src.name} ({proc.returncode}):\n"
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


def load_bus():
    """The ctypes handle of the UDP bus library (every function's argtypes
    and restype declared), building it if needed."""
    global _BUS_LIB
    c = ctypes
    with _LOCK:
        if _BUS_LIB is not None:
            return _BUS_LIB
        lib = c.CDLL(str(build(BUS_SRC, BUS_FLAGS, "libalorebus.so")))
        lib.alore_bus_create.restype = c.c_void_p
        lib.alore_bus_create.argtypes = [c.c_char_p, c.c_int,
                                         c.POINTER(c.c_int)]
        lib.alore_bus_add_peer.restype = c.c_int
        lib.alore_bus_add_peer.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
        lib.alore_bus_publish.restype = c.c_int
        lib.alore_bus_publish.argtypes = [
            c.c_void_p, c.c_char_p, c.c_char, c.c_int,
            c.POINTER(c.c_uint32), c.c_void_p, c.c_longlong]
        lib.alore_bus_poll.restype = c.c_longlong
        lib.alore_bus_poll.argtypes = [
            c.c_void_p, c.c_int, c.c_char_p, c.c_int,
            c.POINTER(c.c_char), c.POINTER(c.c_int),
            c.POINTER(c.c_uint32), c.c_int, c.c_void_p, c.c_longlong]
        lib.alore_bus_latest.restype = c.c_longlong
        lib.alore_bus_latest.argtypes = [
            c.c_void_p, c.c_char_p,
            c.POINTER(c.c_char), c.POINTER(c.c_int),
            c.POINTER(c.c_uint32), c.c_int, c.c_void_p, c.c_longlong]
        lib.alore_bus_dropped.restype = c.c_uint64
        lib.alore_bus_dropped.argtypes = [c.c_void_p]
        lib.alore_bus_close.restype = None
        lib.alore_bus_close.argtypes = [c.c_void_p]
        _BUS_LIB = lib
        return _BUS_LIB
