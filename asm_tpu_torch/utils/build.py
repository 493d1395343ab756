"""Build-once helpers for the port's compiled artifacts.

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
import shutil
import subprocess

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


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def ptxas_report_path(stem: str, source: str) -> str:
    """Path of the ptxas report (registers, spills) of `source`'s build."""
    return os.path.join(BUILD_DIR, f"lib{stem}_{source_hash([source])}"
                                    ".ptxas.txt")


def nvcc_library(stem: str, source: str) -> tuple[str, bool]:
    """nvcc `source` (a .cu with a plain C interface) ->
    BUILD_DIR/lib<stem>_<hash>.so for sm_90a; the ptxas report lands
    beside it (`ptxas_report_path`). Returns (library path, built_now)."""

    def nvcc(out):
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", out, source]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        with open(ptxas_report_path(stem, source), "w") as f:
            f.write(res.stdout + res.stderr)

    return build_once(f"lib{stem}_{source_hash([source])}.so", nvcc)
