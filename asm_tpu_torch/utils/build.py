"""Build-once helper for the port's compiled artifacts.

Both the host runtime (native/libasm_native.so, built from the repo's
native/ sources) and the CUDA kernels are compiled at first use into
`asm_tpu_torch/build/` (gitignored). Artifact names carry a hash of
their sources, so an edited source never loads a stale build; a file
lock makes concurrent first uses (test workers) build once.
"""

from __future__ import annotations

import fcntl
import hashlib
import os

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "build")


def source_hash(paths) -> str:
    h = hashlib.sha1()
    for p in sorted(paths):
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def build_once(name: str, build) -> tuple[str, bool]:
    """Path of BUILD_DIR/name, calling `build(tmp_path)` to make it first
    if it is missing. Returns (path, built_now)."""
    path = os.path.join(BUILD_DIR, name)
    if os.path.exists(path):
        return path, False
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path, False
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            build(tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path, True
