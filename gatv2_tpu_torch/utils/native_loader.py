"""ctypes bindings to the native C++ library: the text parser
(native/loader.cpp) and the minibatch sampler (native/sampler.cpp). Port of
gatv2_tpu/utils/native_loader.py with the same C ABI.

The port builds its own copy of the library, at first use, with g++ and
native/Makefile's flags, into `gatv2_tpu_torch/_build/` under a key that
hashes the sources and the flags (as ops/build.py does for nvcc), so a
library built from other sources is never loaded. It never writes into
native/. A failed build raises: every function here either runs the native
code or raises, it never returns None for "not available".
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("loader.cpp", "sampler.cpp")
HEADERS = ("cpuinfo.h",)
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-Wextra")
LD_FLAGS = ("-shared", "-pthread")

_I32 = ctypes.POINTER(ctypes.c_int32)
_LL = ctypes.c_longlong

_lib: ctypes.CDLL | None = None


def library_path() -> pathlib.Path:
    """Where the library built from the current native/ sources lives."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    return BUILD_DIR / f"libgatv2_loader-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile native/*.cpp with g++ unless a library built from these
    exact sources exists; returns its path. Raises if g++ is missing or the
    build fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "g++ not found: the native loader/sampler cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, *(str(NATIVE_DIR / s) for s in SOURCES), "-o",
         str(tmp), *LD_FLAGS],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed on native/{' '.join(SOURCES)}:\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def _get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed, with every signature
    declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.parse_floats.restype = _LL
    lib.parse_floats.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), _LL]
    lib.parse_ints.restype = _LL
    lib.parse_ints.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                               _LL]
    lib.count_numbers.restype = _LL
    lib.count_numbers.argtypes = [ctypes.c_char_p]
    lib.sample_batch.restype = _LL
    lib.sample_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int64),  # row_ptr
        _I32,  # col_idx
        _LL,  # graph_nodes
        _I32,  # seeds
        _LL,  # num_seeds
        _I32,  # fanouts
        ctypes.c_int,  # num_layers
        _LL,  # max_nodes
        _LL,  # max_edges
        ctypes.c_uint64,  # rng_seed
        _I32,  # out_nodes
        _I32,  # out_src
        _I32,  # out_dst
        ctypes.POINTER(_LL),  # out_num_edges
    ]
    lib.emit_tiles.restype = _LL
    lib.emit_tiles.argtypes = [
        _I32, _I32,  # src, dst
        _LL, _LL, _LL, _LL,  # num_edges, max_nodes, te, want
        _I32, _I32, _I32,  # out src / dst flat, tile_offsets
        _I32, _I32, _I32, _I32,  # src_sorted_ids, gather_perm, dst_of_src,
        #                          src_tile_offsets
    ]
    # looked up, not required: a library without it keeps every other
    # native path, and only emit_sell_tiles raises
    sell = getattr(lib, "emit_sell_tiles", None)
    if sell is not None:
        sell.restype = _LL
        sell.argtypes = (
            [_I32, _I32]  # src, dst
            + [_LL] * 7  # num_edges, max_nodes, split_cap, cols_d, cols_s,
            #              tiles_d, tiles_s
            + [_I32] * 13  # per side perm, vsort, sids, gather, cnt,
            #                col_off; then ell_perm
        )
    lib.gather_rows_f32.restype = None
    lib.gather_rows_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # src
        _LL,  # src_rows
        _LL,  # row_len
        _I32,  # idx
        _LL,  # k
        ctypes.POINTER(ctypes.c_float),  # out
        _LL,  # out_rows
        ctypes.c_int,  # num_threads
    ]
    _lib = lib
    return lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(_I32)


def _parse_error(kind: str, got: int, want: int, path) -> str:
    reasons = {
        -1: "cannot read the file",
        -2: "token count changed between passes",
        -3: "token count mismatch",
        -4: f"malformed token (non-numeric text or out-of-range {kind})",
    }
    why = reasons.get(got, f"parsed {got}/{want} {kind}")
    return f"native loader: {path}: {why}"


def parse_float_file(path: os.PathLike) -> np.ndarray:
    """Parse a whitespace-float file into a flat float32 array."""
    lib = _get_lib()
    p = str(path).encode()
    n = lib.count_numbers(p)
    if n < 0:
        raise IOError(f"native loader: cannot read {path}")
    out = np.empty(n, dtype=np.float32)
    got = lib.parse_floats(
        p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    if got != n:
        raise IOError(_parse_error("floats", got, n, path))
    return out


def parse_int_file(path: os.PathLike) -> np.ndarray:
    """Parse a whitespace-int file into a flat int32 array."""
    lib = _get_lib()
    p = str(path).encode()
    n = lib.count_numbers(p)
    if n < 0:
        raise IOError(f"native loader: cannot read {path}")
    out = np.empty(n, dtype=np.int32)
    got = lib.parse_ints(p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                         n)
    if got != n:
        raise IOError(_parse_error("ints", got, n, path))
    return out


def sample_batch(
    row_ptr: np.ndarray,  # [N+1] int64
    col_idx: np.ndarray,  # [E] int32
    seeds: np.ndarray,  # [S] int32
    fanouts: np.ndarray,  # [L] int32
    max_nodes: int,
    max_edges: int,
    rng_seed: int,
):
    """Native neighbour sample (native/sampler.cpp). Returns
    (nodes [max_nodes] int32, src [max_edges], dst [max_edges], num_nodes,
    num_edges)."""
    lib = _get_lib()
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    seeds = np.ascontiguousarray(seeds, np.int32)
    fanouts = np.ascontiguousarray(fanouts, np.int32)
    out_nodes = np.empty(max_nodes, np.int32)
    out_src = np.empty(max_edges, np.int32)
    out_dst = np.empty(max_edges, np.int32)
    out_num_edges = _LL(0)
    nn = lib.sample_batch(
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _i32p(col_idx), len(row_ptr) - 1, _i32p(seeds), len(seeds),
        _i32p(fanouts), len(fanouts), max_nodes, max_edges, rng_seed,
        _i32p(out_nodes), _i32p(out_src), _i32p(out_dst),
        ctypes.byref(out_num_edges),
    )
    if nn < 0:
        raise ValueError("native sampler: invalid arguments")
    return out_nodes, out_src, out_dst, int(nn), int(out_num_edges.value)


def emit_tiles(
    src: np.ndarray,  # [>=num_edges] int32, local ids
    dst: np.ndarray,  # [>=num_edges] int32, dst-sorted
    num_edges: int,
    max_nodes: int,  # multiple of 128
    te: int,
    fixed_edge_tiles: int,
) -> dict:
    """Native fixed-budget tile emission (native/sampler.cpp emit_tiles),
    byte-identical to the flat layouts of prepare_edge_tiles(...,
    fixed_edge_tiles, num_chunks=1). Returns a dict of int32 arrays; raises
    ValueError when the fixed budget does not fit."""
    lib = _get_lib()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    want = fixed_edge_tiles * te
    num_tiles = max_nodes // 128
    out = {
        "src": np.empty(want, np.int32),
        "dst": np.empty(want, np.int32),
        "tile_offsets": np.empty(num_tiles + 1, np.int32),
        "src_sorted_ids": np.empty(want, np.int32),
        "gather_perm": np.empty(want, np.int32),
        "dst_of_src": np.empty(want, np.int32),
        "src_tile_offsets": np.empty(num_tiles + 1, np.int32),
    }
    rc = lib.emit_tiles(
        _i32p(src), _i32p(dst), num_edges, max_nodes, te, want,
        *(_i32p(out[k]) for k in (
            "src", "dst", "tile_offsets", "src_sorted_ids", "gather_perm",
            "dst_of_src", "src_tile_offsets")),
    )
    if rc != 0:
        raise ValueError(
            f"native emit_tiles: fixed budget {fixed_edge_tiles} tiles x "
            f"te={te} does not fit (or bad inputs: {num_edges} edges, "
            f"{max_nodes} nodes)"
        )
    return out


def sell_output_lengths(fixed: tuple[int, int, int, int]) -> dict:
    """emit_sell_tiles' int32 outputs in its argument order, with their
    lengths under fixed = (cols_d, cols_s, tiles_d, tiles_s): per side
    ('d', 's') perm, vsort and sids [tiles*128], gather [cols*128], cnt
    [cols] and col_off [tiles+1]; then ell_perm [cols_s*128]."""
    cols_d, cols_s, tiles_d, tiles_s = fixed
    out = {}
    for tag, cols, tiles in (("d", cols_d, tiles_d), ("s", cols_s, tiles_s)):
        out.update({
            f"perm_{tag}": tiles * 128, f"vsort_{tag}": tiles * 128,
            f"sids_{tag}": tiles * 128, f"gather_{tag}": cols * 128,
            f"cnt_{tag}": cols, f"col_off_{tag}": tiles + 1,
        })
    out["ell_perm"] = cols_s * 128
    return out


def emit_sell_tiles(
    src: np.ndarray,  # [>=num_edges] int32, local ids
    dst: np.ndarray,  # [>=num_edges] int32, dst-sorted
    num_edges: int,
    max_nodes: int,
    split_cap: int,
    fixed: tuple[int, int, int, int],  # (cols_d, cols_s, tiles_d, tiles_s)
) -> dict:
    """Native fixed-geometry SELL layout of one sampled batch
    (native/sampler.cpp emit_sell_tiles), byte-identical to
    ops.sell_attention.prepare_minibatch_sell_tiles. Returns a dict of
    int32 arrays (sell_output_lengths) for sell_tiles_from_native; raises
    RuntimeError when the library lacks the symbol and ValueError when the
    fixed geometry does not fit or the edges are not dst-sorted."""
    fn = getattr(_get_lib(), "emit_sell_tiles", None)
    if fn is None:
        raise RuntimeError(
            f"native library {library_path().name} has no emit_sell_tiles")
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    out = {k: np.empty(n, np.int32)
           for k, n in sell_output_lengths(fixed).items()}
    rc = fn(_i32p(src), _i32p(dst), num_edges, max_nodes, split_cap,
            *fixed, *(_i32p(a) for a in out.values()))
    if rc != 0:
        raise ValueError(
            f"native emit_sell_tiles: fixed geometry {fixed} does not fit "
            f"(or bad inputs: {num_edges} edges, {max_nodes} nodes)"
        )
    return out


def gather_rows(
    src: np.ndarray,  # [R, F] float32
    idx: np.ndarray,  # [k] int32
    out_rows: int,
    *,
    num_threads: int = 8,
) -> np.ndarray:
    """Parallel out[i] = src[idx[i]], rows >= len(idx) zeroed: [out_rows, F]
    float32."""
    lib = _get_lib()
    src = np.ascontiguousarray(src, np.float32)
    idx = np.ascontiguousarray(idx, np.int32)
    out = np.empty((out_rows, src.shape[1]), np.float32)
    lib.gather_rows_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), src.shape[0],
        src.shape[1], _i32p(idx), len(idx),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_rows,
        num_threads,
    )
    return out
