"""Encoded-corpus persistence (copy of `asm_tpu.utils.corpus_cache`, same
on-disk formats, so either package reads the other's caches).

- raw (preferred): `<base>.json` header (params + array dtypes/shapes/
  offsets) next to `<base>.bin` holding the arrays back to back, read
  with the native parallel reader into prefaulted host arrays;
- npz: a numpy archive, used when the native runtime is unavailable; a
  raw cache is written beside it after a successful npz load.
A cache whose parameters differ from the expected ones counts as absent.
"""

from __future__ import annotations

import json
import os

import numpy as np

from asm_tpu_torch import native

_ARRAYS = ("read_codes", "read_len", "ref_codes", "ref_len")


def _base(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def _save_raw(base: str, arrays, params) -> None:
    from asm_tpu_torch.utils.hostmem import write_from

    header = {"params": {k: str(v) for k, v in params.items()}, "arrays": []}
    off = 0
    tmp_bin = base + ".bin.tmp"
    open(tmp_bin, "wb").close()  # truncate any stale file
    for name, a in zip(_ARRAYS, arrays):
        a = np.ascontiguousarray(a)
        header["arrays"].append({
            "name": name, "dtype": a.dtype.str, "shape": list(a.shape),
            "offset": off,
        })
        write_from(tmp_bin, off, a)
        off += a.nbytes
    tmp_json = base + ".json.tmp"
    with open(tmp_json, "w") as f:
        json.dump(header, f)
    os.replace(tmp_bin, base + ".bin")
    os.replace(tmp_json, base + ".json")  # header last: commit point


def _load_raw(base: str, expected_params):
    from asm_tpu_torch.utils.hostmem import host_array, read_into

    jpath, bpath = base + ".json", base + ".bin"
    if not (os.path.exists(jpath) and os.path.exists(bpath)):
        return None
    try:
        with open(jpath) as f:
            header = json.load(f)
        params = header["params"]
        for k, v in expected_params.items():
            if k not in params or params[k] != str(v):
                return None
        end = header["arrays"][-1]
        need = end["offset"] + int(
            np.prod(end["shape"], dtype=np.int64)
        ) * np.dtype(end["dtype"]).itemsize
        if os.path.getsize(bpath) < need:
            return None
        out = []
        for spec in header["arrays"]:
            a = host_array(tuple(spec["shape"]), np.dtype(spec["dtype"]))
            read_into(bpath, spec["offset"], a)
            out.append(a)
        return tuple(out)
    except (OSError, KeyError, ValueError):
        return None


def save_corpus(path: str, read_codes, read_len, ref_codes, ref_len,
                **params) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = (read_codes, read_len, ref_codes, ref_len)
    if native.load_native() is not None:
        _save_raw(_base(path), arrays, params)
        return
    meta = np.array(sorted(params.items()), dtype=object)
    np.savez(
        path if path.endswith(".npz") else path + ".npz",
        read_codes=read_codes, read_len=read_len,
        ref_codes=ref_codes, ref_len=ref_len, _params=meta,
    )


def load_corpus(path: str, **expected_params):
    """Returns (read_codes, read_len, ref_codes, ref_len) or None when the
    cache is absent or was generated with different parameters."""
    if native.load_native() is not None:
        got = _load_raw(_base(path), expected_params)
        if got is not None:
            return got
    npz = path if path.endswith(".npz") else path + ".npz"
    if not os.path.exists(npz):
        return None
    try:
        z = np.load(npz, allow_pickle=True)
        params = dict(map(tuple, z["_params"]))
        for k, v in expected_params.items():
            if k not in params or str(params[k]) != str(v):
                return None
        got = (z["read_codes"], z["read_len"], z["ref_codes"], z["ref_len"])
    except (OSError, KeyError, ValueError):
        return None
    if native.load_native() is not None:
        try:  # next load takes the parallel raw path
            _save_raw(_base(path), got, expected_params)
        except OSError:
            pass
    return got
