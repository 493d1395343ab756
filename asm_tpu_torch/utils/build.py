"""Build-once helpers for the port's compiled artifacts.

Both the host runtime (native/libasm_native.so, built from the repo's
native/ sources) and the CUDA kernels are compiled at first use into
`asm_tpu_torch/build/` (gitignored). Artifact names carry a hash of
their sources, so an edited source never loads a stale build; a file
lock makes concurrent first uses (test workers) build once. A kernel
library built for one shape outside its source's tuned table carries
the shape in its stem and -D defines on its nvcc line
(kernels/shapes.py).
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import re
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


def ptxas_usage(report: str) -> dict:
    """Per kernel of an `nvcc -Xptxas -v` report (its text): the mangled
    name -> registers, spill_stores and spill_loads (bytes)."""
    out, name, spill = {}, None, (0, 0)
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m[1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = (int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            out[name] = dict(registers=int(m[1]), spill_stores=spill[0],
                             spill_loads=spill[1])
            name, spill = None, (0, 0)
    return out


def nvcc_command(source: str, out: str, defines=()) -> list[str]:
    """The nvcc line that builds `source` into the library `out` for
    sm_90a, with -D<name>=<value> for each (name, value) of `defines`."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", *(f"-D{k}={v}" for k, v in defines), "-o", out,
            source]


def nvcc_library(stem: str, source: str, defines=()) -> tuple[str, bool]:
    """nvcc `source` (a .cu with a plain C interface) ->
    BUILD_DIR/lib<stem>_<hash>.so for sm_90a, with `defines` ((name,
    value) pairs, each a -D; the stem must name them, as it names the
    library); the ptxas report lands beside it (`ptxas_report_path`).
    Returns (library path, built_now)."""

    def nvcc(out):
        cmd = nvcc_command(source, out, defines)
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        with open(ptxas_report_path(stem, source), "w") as f:
            f.write(res.stdout + res.stderr)

    return build_once(f"lib{stem}_{source_hash([source])}.so", nvcc)
