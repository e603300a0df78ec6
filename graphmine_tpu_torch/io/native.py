"""ctypes bindings of the port's streaming edge-list parser
(``csrc/graph_builder.cpp``).

Counterpart of ``graphmine_tpu/io/native.py::load_edge_list_chunked``. The
source is compiled with the host C++ compiler (``c++``, the flags of the
JAX package's ``native/Makefile``) into ``build/graphmine_tpu_torch/``
under the checkout at first use, under a name that carries a hash of the
source and flags, and loaded with ``ctypes``. There is no fallback: a
library that cannot be built or loaded raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "graph_builder.cpp"
BUILD_DIR = _PKG.parent / "build" / "graphmine_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None


def _cxx() -> str:
    found = shutil.which("c++") or shutil.which("g++")
    if not found:
        raise RuntimeError("no host C++ compiler (c++ or g++) to build the edge-list parser")
    return found


def library_path() -> Path:
    """Where :func:`build` puts the library; its name carries a hash of
    the source and flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgraph_builder_{digest}.so"


def build() -> float:
    """Compile the parser if the library for this source is missing, and
    load it; returns the seconds spent. Several processes may build at
    once: each writes its own temporary file and renames it into place."""
    lib = library_path()
    t0 = time.perf_counter()
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building {SOURCE.name} failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    _load(lib)
    return time.perf_counter() - t0


def _load(path: Path) -> None:
    global _lib
    if _lib is not None:
        return
    lib = ctypes.CDLL(str(path))
    lib.gb_interner_new.restype = ctypes.c_void_p
    lib.gb_interner_new.argtypes = []
    lib.gb_interner_free.restype = None
    lib.gb_interner_free.argtypes = [ctypes.c_void_p]
    lib.gb_interner_names.restype = ctypes.c_int64
    lib.gb_interner_names.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char_p)),
    ]
    lib.gb_parse_edge_chunk.restype = ctypes.c_int64
    lib.gb_parse_edge_chunk.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
    ]
    lib.gb_free.restype = None
    lib.gb_free.argtypes = [ctypes.c_void_p]
    lib.gb_free_names.restype = None
    lib.gb_free_names.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64]
    _lib = lib


def _library():
    if _lib is None:
        build()
    return _lib


def load_edge_list_chunked(path: str, comments: str = "#",
                           weight_col: int | None = None,
                           chunk_bytes: int = 64 << 20):
    """Streaming native parse: newline-aligned chunks of ~``chunk_bytes``
    through one shared interner. Ids follow first appearance line by line
    (source, then destination). Returns an
    :class:`~graphmine_tpu_torch.io.edges.EdgeTable`, weighted when
    ``weight_col`` is given. Raises ValueError on a data line with fewer
    than 2 tokens, a change of column count, or a missing or unparseable
    weight, with the JAX package's messages; MemoryError when the parser
    runs out of memory."""
    from graphmine_tpu_torch.io.edges import edge_table_from_parts, iter_line_chunks

    lib = _library()
    comment = comments[:1].encode() or b"#"
    wcol = -1 if weight_col is None else int(weight_col)
    it = lib.gb_interner_new()
    if not it:
        raise MemoryError("the edge-list parser could not allocate its interner")
    src_parts, dst_parts, w_parts = [], [], []
    num_rows = 0
    try:
        for buf in iter_line_chunks(path, chunk_bytes):
            src_p = ctypes.POINTER(ctypes.c_int32)()
            dst_p = ctypes.POINTER(ctypes.c_int32)()
            w_p = ctypes.POINTER(ctypes.c_float)()
            ne = lib.gb_parse_edge_chunk(it, buf, len(buf), comment, wcol,
                                         ctypes.byref(src_p), ctypes.byref(dst_p),
                                         ctypes.byref(w_p))
            if ne == -2:
                raise ValueError(
                    f"edge list {path!r}: weight_col={wcol} missing "
                    "on a data line or not parseable as a float"
                )
            if ne == -3:
                raise ValueError(f"edge list {path!r} needs >= 2 columns")
            if ne == -4:
                raise ValueError(
                    f"edge list {path!r}: number of columns changed "
                    "between data lines"
                )
            if ne < 0:
                raise MemoryError(f"the edge-list parser ran out of memory on {path!r}")
            try:
                if ne:
                    src_parts.append(np.ctypeslib.as_array(src_p, shape=(ne,)).copy())
                    dst_parts.append(np.ctypeslib.as_array(dst_p, shape=(ne,)).copy())
                    if wcol >= 0:
                        w_parts.append(np.ctypeslib.as_array(w_p, shape=(ne,)).copy())
                num_rows += int(ne)
            finally:
                lib.gb_free(src_p)
                lib.gb_free(dst_p)
                if wcol >= 0:
                    lib.gb_free(w_p)
        names_p = ctypes.POINTER(ctypes.c_char_p)()
        nv = lib.gb_interner_names(it, ctypes.byref(names_p))
        if nv < 0:
            raise MemoryError(f"the edge-list parser ran out of memory on {path!r}")
        try:
            names = (np.array([names_p[i].decode() for i in range(nv)])
                     if nv else np.empty(0, dtype=object))
        finally:
            lib.gb_free_names(names_p, nv)
    finally:
        lib.gb_interner_free(it)
    return edge_table_from_parts(src_parts, dst_parts, names, num_rows,
                                 w_parts if wcol >= 0 else None)
