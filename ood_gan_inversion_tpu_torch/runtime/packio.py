"""OGIPack: a packed-blob dataset file, its writer and reader (counterpart
of runtime/packio.py; the same format, see packio.cpp).

The reader is the native mmap library built from packio.cpp with g++ into
`build/packio/` at the root of the checkout (keyed by a hash of the
source); a build that fails raises. The JAX package's pure-Python reader
is the reference of the tests.
"""

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path

MAGIC = b"OGIPACK1"
SOURCE = Path(__file__).resolve().parent / "packio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "packio"
_lock = threading.Lock()
_lib = None


def so_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpackio-{digest}.so"


def build_native() -> str:
    """Compiles packio.cpp unless its library exists; returns its path."""
    out = so_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                        "-o", str(tmp), str(SOURCE)], check=True)
        os.replace(tmp, out)     # atomic: a concurrent loader never sees half a file
    return str(out)


def _load_native():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(build_native())
        except (OSError, subprocess.CalledProcessError) as e:
            raise RuntimeError("packio: the native reader did not build or load "
                               f"(g++ compiles it from {SOURCE.name}): {e}") from e
        lib.ogipack_open.restype = ctypes.c_void_p
        lib.ogipack_open.argtypes = [ctypes.c_char_p]
        lib.ogipack_count.restype = ctypes.c_long
        lib.ogipack_count.argtypes = [ctypes.c_void_p]
        lib.ogipack_blob_size.restype = ctypes.c_long
        lib.ogipack_blob_size.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.ogipack_name_len.restype = ctypes.c_long
        lib.ogipack_name_len.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.ogipack_name.restype = ctypes.c_long
        lib.ogipack_name.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                     ctypes.c_char_p, ctypes.c_long]
        lib.ogipack_read.restype = ctypes.c_long
        lib.ogipack_read.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                     ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
        lib.ogipack_prefetch.restype = None
        lib.ogipack_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.ogipack_close.restype = None
        lib.ogipack_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def write_pack(out_path, items):
    """items: iterable of (name, bytes). Writes the OGIPACK1 file; returns
    the count."""
    entries = []
    with open(out_path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<QQ", 0, 0))  # placeholders
        for name, blob in items:
            entries.append((f.tell(), len(blob), name))
            f.write(blob)
        index_offset = f.tell()
        for off, size, name in entries:
            nb = name.encode("utf-8")
            f.write(struct.pack("<QQI", off, size, len(nb)))
            f.write(nb)
        f.seek(len(MAGIC))
        f.write(struct.pack("<QQ", len(entries), index_offset))
    return len(entries)


class PackReader:
    """The native mmap reader of one OGIPACK file."""

    def __init__(self, path):
        self.path = path
        self._lib = _load_native()
        self._h = self._lib.ogipack_open(str(path).encode())
        if not self._h:
            raise IOError(f"packio: cannot open {path} as an OGIPACK file")

    def __len__(self):
        return self._lib.ogipack_count(self._h)

    def name(self, idx):
        n = self._lib.ogipack_name_len(self._h, idx)
        buf = ctypes.create_string_buffer(n)
        self._lib.ogipack_name(self._h, idx, ctypes.cast(buf, ctypes.c_char_p), n)
        return buf.raw.decode("utf-8")

    def read(self, idx) -> bytes:
        n = self._lib.ogipack_blob_size(self._h, idx)
        buf = (ctypes.c_ubyte * n)()
        k = self._lib.ogipack_read(self._h, idx, buf, n)
        if k != n:
            raise IOError(f"packio: read {k} of {n} bytes of blob {idx}")
        return bytes(buf)

    def prefetch(self, idx):
        self._lib.ogipack_prefetch(self._h, idx)

    def close(self):
        if self._h:
            self._lib.ogipack_close(self._h)
            self._h = None
