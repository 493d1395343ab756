"""ctypes bindings for the native host runtime (the symbols the ported
paths call): the generator, host memory, staging, sort, I/O, coverage,
and the read mapper's FM-index, FASTA / FASTQ readers and CIGAR decoder.

The port builds its own copy of the library from the repo's native/
sources (`make -C native LIB=<build dir>/...`), because a committed
binary built with -march=native on another host may not run here. The
build happens at first use, into asm_tpu_torch/build/.
`load_native(required=False)` returns None if it cannot be built, and the
host functions then fall back to numpy; the headline passes
`required=True`, since its checksum holds only for the native corpus.
The mapper's bindings (`FMIndex`, `read_fasta_native`,
`read_fastq_native`, `cigar_strings_packed`) load it with
`required=True` and have no fallback.
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

    # the read mapper: FASTA / FASTQ readers, CIGAR decoder, FM-index
    lib.asm_read_fasta.restype = c.c_int64
    lib.asm_read_fasta.argtypes = [
        c.c_char_p, i8p, c.c_int64, i64p, c.c_int64, i64p,
    ]
    lib.asm_read_fastq.restype = c.c_int64
    lib.asm_read_fastq.argtypes = [c.c_char_p, c.c_int64, c.c_int32, i8p, i32p]
    lib.asm_read_fastq_names.restype = c.c_int64
    lib.asm_read_fastq_names.argtypes = [
        c.c_char_p, c.c_int64, c.c_int32, c.c_char_p,
    ]
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.asm_cigar_strings.restype = c.c_int64
    lib.asm_cigar_strings.argtypes = [
        u16p, c.c_int64, c.c_int32, u8p, c.c_int64, i32p,
    ]
    lib.asm_fm_build.restype = c.c_void_p
    lib.asm_fm_build.argtypes = [i8p, c.c_int64]
    lib.asm_fm_free.restype = None
    lib.asm_fm_free.argtypes = [c.c_void_p]
    lib.asm_fm_length.restype = c.c_int64
    lib.asm_fm_length.argtypes = [c.c_void_p]
    lib.asm_fm_search.restype = c.c_int64
    lib.asm_fm_search.argtypes = [
        c.c_void_p, i8p, c.c_int32,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64),
    ]
    lib.asm_fm_locate.restype = c.c_int64
    lib.asm_fm_locate.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, c.c_int64, i64p,
    ]
    lib.asm_fm_candidates.restype = c.c_int64
    lib.asm_fm_candidates.argtypes = [
        c.c_void_p, i8p, i32p, c.c_int64, c.c_int32, c.c_int32,
        c.c_int32, c.c_int32, i64p, i32p,
    ]
    lib.asm_fm_save.restype = c.c_int32
    lib.asm_fm_save.argtypes = [c.c_void_p, c.c_char_p]
    lib.asm_fm_load.restype = c.c_void_p
    lib.asm_fm_load.argtypes = [c.c_char_p]
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


# ---- the read mapper ------------------------------------------------------

def read_fasta_native(path, capacity=1 << 26, max_records=1 << 16):
    """FASTA -> (codes int8[total], record_starts int64[n_records])."""
    lib = load_native(required=True)
    codes = np.empty(capacity, np.int8)
    starts = np.empty(max_records, np.int64)
    nrec = np.zeros(1, np.int64)
    total = lib.asm_read_fasta(
        path.encode(), codes, capacity, starts, max_records, nrec
    )
    if total < 0:
        raise IOError(f"cannot read FASTA {path} (code {total})")
    return codes[:total].copy(), starts[: int(nrec[0])].copy()


def read_fastq_native(path, max_reads, max_len=128, name_cap=64):
    """FASTQ -> (codes int8[n, max_len], lens int32[n], names list[str]),
    in two native passes over the file (sequences, then names); a file
    that changes between them keeps the first min(n, n2) names."""
    lib = load_native(required=True)
    codes = np.empty((max_reads, max_len), np.int8)
    lens = np.empty(max_reads, np.int32)
    n = lib.asm_read_fastq(path.encode(), max_reads, max_len, codes, lens)
    if n < 0:
        raise IOError(f"cannot read FASTQ {path}")
    buf = ctypes.create_string_buffer(int(max_reads) * name_cap)
    n2 = lib.asm_read_fastq_names(path.encode(), max_reads, name_cap, buf)
    names = [
        buf.raw[i * name_cap: (i + 1) * name_cap].split(b"\0", 1)[0].decode()
        for i in range(int(min(n, n2)))
    ]
    return codes[:n], lens[:n], names


def cigar_strings_packed(packed: np.ndarray) -> list[str]:
    """Packed uint16 greedy slots [n, slots] (op << 13 | run; run-0 slots
    are empty) -> CIGAR strings, through the threaded native decoder."""
    lib = load_native(required=True)
    packed = np.ascontiguousarray(packed, np.uint16)
    if packed.ndim != 2:
        raise ValueError(f"packed must be [n, slots], got {packed.shape}")
    n, slots = packed.shape
    stride = 5 * slots  # a run < 8192 has at most 4 digits, then its op
    out = np.empty((n, stride), np.uint8)
    lens = np.empty(n, np.int32)
    lib.asm_cigar_strings(packed, n, slots, out, stride, lens)
    ob = out.tobytes()
    return [ob[i * stride: i * stride + lens[i]].decode() for i in range(n)]


class FMIndex:
    """Handle over the native FM-index (native/src/fmindex.cpp): exact
    backward search, locate, and the mapper's pigeonhole candidates.
    Its file format is the native one, shared with asm_tpu's."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib

    @classmethod
    def build(cls, codes: np.ndarray) -> "FMIndex":
        lib = load_native(required=True)
        codes = np.ascontiguousarray(codes, np.int8)
        if codes.ndim != 1:
            raise ValueError(f"codes must be 1-D, got {codes.shape}")
        h = lib.asm_fm_build(codes, codes.shape[0])
        if not h:
            raise RuntimeError("FM-index build failed")
        return cls(h, lib)

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        lib = load_native(required=True)
        h = lib.asm_fm_load(path.encode())
        if not h:
            raise IOError(f"cannot load index {path}")
        return cls(h, lib)

    def _handle(self):
        if not self._h:
            raise ValueError("the FM-index was freed")
        return self._h

    def save(self, path: str) -> None:
        if self._lib.asm_fm_save(self._handle(), path.encode()) != 0:
            raise IOError(f"cannot save index {path}")

    def __len__(self) -> int:
        return int(self._lib.asm_fm_length(self._handle()))

    def search(self, pattern: np.ndarray) -> tuple[int, int]:
        """Exact backward search; returns the SA range (lo, hi)."""
        pattern = np.ascontiguousarray(pattern, np.int8)
        lo = ctypes.c_int64()
        hi = ctypes.c_int64()
        self._lib.asm_fm_search(self._handle(), pattern, pattern.shape[0],
                                ctypes.byref(lo), ctypes.byref(hi))
        return lo.value, hi.value

    def locate(self, lo: int, hi: int, cap: int = 1024) -> np.ndarray:
        """Text positions of SA range [lo, hi), at most `cap` of them."""
        pos = np.empty(cap, np.int64)
        k = self._lib.asm_fm_locate(self._handle(), lo, hi, cap, pos)
        return pos[:k].copy()

    def candidates_batch(
        self,
        read_codes: np.ndarray,
        read_lens: np.ndarray,
        max_errors: int = 3,
        max_hits_per_seed: int = 16,
        max_candidates: int = 64,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Pigeonhole candidate starts for a whole read batch in one
        threaded native call (a seed's SA range above max_hits_per_seed
        is sampled evenly, not skipped). Returns (starts int64
        [n, max_candidates], counts int32 [n]); row r's first counts[r]
        starts are sorted and distinct."""
        read_codes = np.ascontiguousarray(read_codes, np.int8)
        read_lens = np.ascontiguousarray(read_lens, np.int32)
        if read_codes.ndim != 2 or read_lens.shape != read_codes.shape[:1]:
            raise ValueError(f"read_codes [n, L] and read_lens [n] expected, "
                             f"got {read_codes.shape} and {read_lens.shape}")
        n, stride = read_codes.shape
        starts = np.zeros((n, max_candidates), np.int64)
        counts = np.zeros(n, np.int32)
        self._lib.asm_fm_candidates(
            self._handle(), read_codes, read_lens, n, stride, max_errors,
            max_hits_per_seed, max_candidates, starts, counts,
        )
        return starts, counts

    def free(self) -> None:
        """Release the native index (idempotent)."""
        if self._h:
            self._lib.asm_fm_free(self._h)
            self._h = None

    def __del__(self):
        self.free()
