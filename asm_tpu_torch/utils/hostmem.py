"""Pre-faulted host arrays (copy of `asm_tpu.utils.hostmem`).

Fresh multi-GB numpy allocations pay their first-touch page faults on one
thread; the native runtime maps regions with MADV_NOHUGEPAGE and touches
them with all cores. Everything degrades to plain numpy when the native
library is unavailable — results are identical, only slower.
"""

from __future__ import annotations

import ctypes
import mmap

import numpy as np

from asm_tpu_torch.native import load_native


def host_array(shape, dtype, nthreads: int = 0) -> np.ndarray:
    """np.zeros(shape, dtype), backed by a parallel-prefaulted mmap.

    The mapping is a python mmap object, so its lifetime follows the
    buffer protocol: every numpy view (and a torch.from_numpy tensor)
    keeps it alive.
    """
    shape = (shape,) if np.isscalar(shape) else tuple(shape)
    dtype = np.dtype(dtype)
    size = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    lib = load_native()
    if lib is None or size == 0:
        return np.zeros(shape, dtype)
    m = mmap.mmap(-1, size)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(m))
    MADV_NOHUGEPAGE = 15
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.madvise(ctypes.c_void_p(addr), ctypes.c_size_t(size),
                     MADV_NOHUGEPAGE)
    except Exception:
        pass
    lib.asm_prefault(ctypes.c_void_p(addr), size, nthreads)
    return np.frombuffer(m, dtype=dtype).reshape(shape)


def take_rows(src: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """src[perm] for 1-D/2-D arrays, gathered in parallel into a
    prefaulted buffer."""
    src = np.ascontiguousarray(src)
    perm = np.ascontiguousarray(perm, np.int64)
    lib = load_native()
    if lib is None:
        return src[perm]
    dst = host_array((perm.shape[0],) + src.shape[1:], src.dtype)
    rowbytes = src.dtype.itemsize * int(
        np.prod(src.shape[1:], dtype=np.int64))
    lib.asm_apply_perm_rows(
        src.ctypes.data_as(ctypes.c_void_p), perm,
        dst.ctypes.data_as(ctypes.c_void_p),
        perm.shape[0], rowbytes, 0,
    )
    return dst


def read_into(path: str, offset: int, arr: np.ndarray) -> None:
    """Parallel positioned read of arr.nbytes at offset into arr."""
    lib = load_native(required=True)
    got = lib.asm_read_into(
        path.encode(), offset, arr.ctypes.data_as(ctypes.c_void_p),
        arr.nbytes, 0,
    )
    if got != arr.nbytes:
        raise IOError(f"short read from {path}: {got} != {arr.nbytes}")


def write_from(path: str, offset: int, arr: np.ndarray) -> None:
    lib = load_native(required=True)
    arr = np.ascontiguousarray(arr)
    put = lib.asm_write_from(
        path.encode(), offset, arr.ctypes.data_as(ctypes.c_void_p),
        arr.nbytes,
    )
    if put != arr.nbytes:
        raise IOError(f"short write to {path}: {put} != {arr.nbytes}")
