"""Native (C++) k-let shuffle of the training negatives, loaded via ctypes.

``rnaelem_native.cpp`` is compiled with g++ at first use into
``build/native/<source hash>/`` beside the package.  A failed build
raises: the trainer's negatives come from this walk alone, and no other
walk gives the same pseudo-random stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "rnaelem_native.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "librnaelem_native.so"

_lib = None
_lock = threading.Lock()


def build() -> Path:
    """Compile the source (if not built yet); returns the library path."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    out_dir = SRC.parent.parent.parent / "build" / "native" / \
        h.hexdigest()[:16]
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / (LIB_NAME + ".%d.tmp" % os.getpid())
    r = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError("g++ failed to build %s:\n%s" % (SRC, r.stdout))
    os.replace(tmp, lib_path)
    return lib_path


def lib():
    """The loaded native library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(str(build()))
            L.klet_shuffle.restype = ctypes.c_int
            L.klet_shuffle.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_uint64]
            _lib = L
    return _lib


def klet_shuffle_native(seq: str, k: int, seed: int) -> str:
    """Uniform k-let-preserving shuffle of ``seq``, deterministic in
    ``seed``."""
    n = len(seq)
    out = ctypes.create_string_buffer(n)
    rc = lib().klet_shuffle(seq.encode(), out, n, k,
                            ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF))
    if rc != 0:
        raise RuntimeError("klet_shuffle failed (%d) on a read of %d nt"
                           % (rc, n))
    return out.raw.decode()
