"""ctypes bindings for the native host runtime (the symbols the ported
paths call).

The port builds its own copy of the library from the repo's native/
sources (`make -C native LIB=<build dir>/...`), because a committed
binary built with -march=native on another host may not run here. The
build happens at first use, into asm_tpu_torch/build/.
`load_native(required=False)` returns None if it cannot be built, and the
host functions then fall back to numpy; the headline passes
`required=True`, since its checksum holds only for the native corpus.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess

import numpy as np

from asm_tpu_torch.utils.build import REPO_DIR, build_once, source_hash

_NATIVE_DIR = os.path.join(REPO_DIR, "native")

_lib = None
_load_failed = False


def _configure(lib):
    c = ctypes
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")

    lib.asm_generate_dataset.restype = None
    lib.asm_generate_dataset.argtypes = [
        c.c_int64, c.c_int32, c.c_double, c.c_double, c.c_int32, c.c_uint64,
        c.c_int32, i8p, i32p, i8p, i32p,
    ]
    lib.asm_host_alloc.restype = c.c_void_p
    lib.asm_host_alloc.argtypes = [c.c_int64, c.c_int32]
    lib.asm_host_free.restype = None
    lib.asm_host_free.argtypes = [c.c_void_p, c.c_int64]
    lib.asm_prefault.restype = None
    lib.asm_prefault.argtypes = [c.c_void_p, c.c_int64, c.c_int32]
    lib.asm_difficulty_sort.restype = None
    lib.asm_difficulty_sort.argtypes = [
        i8p, i8p, c.c_int64, c.c_int32, i64p, c.c_int32,
    ]
    lib.asm_apply_perm_rows.restype = None
    lib.asm_apply_perm_rows.argtypes = [
        c.c_void_p, i64p, c.c_void_p, c.c_int64, c.c_int64, c.c_int32,
    ]
    lib.asm_stage_planes_t.restype = None
    lib.asm_stage_planes_t.argtypes = [
        u32p, c.c_void_p, c.c_int64, c.c_int32, u32p, c.c_int32,
    ]
    lib.asm_stage_planes_tiled_t.restype = None
    lib.asm_stage_planes_tiled_t.argtypes = [
        u32p, c.c_void_p, c.c_int64, c.c_int32, c.c_int32, u32p, c.c_int32,
    ]
    lib.asm_read_into.restype = c.c_int64
    lib.asm_read_into.argtypes = [
        c.c_char_p, c.c_int64, c.c_void_p, c.c_int64, c.c_int32,
    ]
    lib.asm_write_from.restype = c.c_int64
    lib.asm_write_from.argtypes = [c.c_char_p, c.c_int64, c.c_void_p, c.c_int64]
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.asm_coverage_batch.restype = c.c_int64
    lib.asm_coverage_batch.argtypes = [
        c.c_int64, c.c_int32, i8p, i32p, i8p, i32p, c.c_int32, i8p,
        c.c_int32, c.c_int32, c.c_int32, u8p,
    ]
    return lib


def build_native() -> tuple[str, bool]:
    """Compile native/src into the port's build directory (once per
    source hash). Returns (library path, built_now)."""
    srcs = glob.glob(os.path.join(_NATIVE_DIR, "src", "*.cpp"))
    srcs.append(os.path.join(_NATIVE_DIR, "Makefile"))
    name = f"libasm_native_{source_hash(srcs)}.so"

    def make(out):
        subprocess.run(["make", "-s", "-C", _NATIVE_DIR, f"LIB={out}"],
                       check=True, capture_output=True)

    return build_once(name, make)


def load_native(required: bool = False):
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed and not required:
        return None
    try:
        path, _ = build_native()
        _lib = _configure(ctypes.CDLL(path))
        return _lib
    except (OSError, subprocess.CalledProcessError) as exc:
        _load_failed = True
        if required:
            raise RuntimeError(f"native library unavailable: {exc}") from exc
        return None


def coverage_batch_native(read_codes, read_len, g_ops, g_runs, nw_cols,
                          threshold1=1, threshold2=3) -> np.ndarray:
    """Batched LCM-coverage check (benchmark_coverage.h semantics) in C++.

    g_ops/g_runs: greedy (op, run) slot buffers [n, C]; nw_cols: NW
    traceback per-column ops [n, 2L] in reverse order (the kernels'
    layout). Returns bool[n]."""
    lib = load_native(required=True)
    n = read_codes.shape[0]
    covered = np.empty(n, np.uint8)
    lib.asm_coverage_batch(
        n, read_codes.shape[1],
        np.ascontiguousarray(read_codes, np.int8),
        np.ascontiguousarray(read_len, np.int32),
        np.ascontiguousarray(g_ops, np.int8),
        np.ascontiguousarray(g_runs, np.int32),
        g_ops.shape[1],
        np.ascontiguousarray(nw_cols, np.int8),
        nw_cols.shape[1], threshold1, threshold2, covered,
    )
    return covered.astype(bool)
