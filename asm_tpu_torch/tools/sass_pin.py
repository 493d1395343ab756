"""The SASS of the kernels a long-row redesign leaves alone, pinned: the
greedy and LEAP kernels' short-row instantiations, the NW full and trace
kernels' (nw_kernel), the long-row NW trace kernel
(nw_long_kernel<W, true>) and the NW band's short and wide paths
(band_kernel<BW, W>, W 4/8/16, BW 4-64: the 67.1M NW headline's kernel;
band_wide_kernel<128, W>).

csrc/greedy.cu, csrc/leap.cu, csrc/nw.cu and csrc/nw_band.cu hold a
long-row path (max_len above 512; the band's also serves BW 128) beside
the short one; every instantiation at max_len <= 512, the long NW trace
kernel and the band's wide path must compile to the SASS they had before
the long NW full kernel was redesigned (UNPINNED: that kernel,
nw_long_kernel<W, false> before, nw_long_full_kernel<W> since).
`digests` hashes each kernel of a built library (`cuobjdump -sass`, the function's own name
line dropped and the anonymous namespace's per-source hash taken out of
every symbol), keyed by the mangled name from the kernel's own name on.
SHORT_SHAPES names the libraries held: the tuned tables, the W <= 16
per-shape libraries chip_smoke's phase 17 builds, and NW at max_len 1024
and 2048 (W 32 and 64). PIN_PATH holds their
digests as the nvcc of the card's machine built them from the sources
of the commit before the redesign; `check` builds (or finds built) this
checkout's libraries and compares them with it, where this nvcc is the
pin's: another nvcc compiles other SASS from the same source, so there
`check` compares nothing and says so. The pin was taken from the csrc of
commit d1a0d02, before the long NW full kernel's redesign.

The pin holds while no change is meant to reach the short-row kernels.
A change that does (a new short-row design, a new tuned shape), or a new
nvcc on the card's machine, takes it anew from the sources it should
hold: `--source-dir <that checkout's csrc> --out
asm_tpu_torch/tools/short_sass.json`.

    python -m asm_tpu_torch.tools.sass_pin [--source-dir DIR] [--out F]
        [--check]

--source-dir builds another checkout's csrc/greedy.cu, csrc/leap.cu,
csrc/nw.cu and csrc/nw_band.cu instead of this one's (that is how the pin
was taken: the parent's sources); --out writes the digests as JSON;
--check compares this checkout's with the pin and exits 1 if any kernel
moved (0, with "compared": false, under another nvcc). Needs nvcc and
cuobjdump (no card).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

PIN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "short_sass.json")
# (kernel, build_kernel arguments): the tuned tables, then phase 17's
# per-shape libraries at max_len <= 512, then NW's long-row libraries
SHORT_SHAPES = ([("greedy", ()), ("leap", ()), ("nw", ()), ("nw_band", ())]
                + [("leap", (k, 256, pens)) for k in (0, 1, 5, 8)
                   for pens in ((1, 1, 1), (2, 3, 1))]
                + [("greedy", (5, 160)), ("leap", (5, 160, (1, 1, 1))),
                   ("leap", (5, 160, (1, 4, 2)))]
                + [("greedy", (3, L)) for L in (160, 384)]
                + [("leap", (3, L, (1, 1, 1))) for L in (160, 384)]
                + [("nw", (L,)) for L in (160, 384, 1024, 2048)])
_KERNEL_AT = re.compile(
    r"\d+((?:greedy|leap|nw|band)(?:_long|_wide|_long_full)?_kernelI.*)")
# kernels of those libraries that are not held: the long-row NW full
# kernel, redesigned after the pin's sources (its name then and now)
UNPINNED = re.compile(r"^(?:nw_long_kernelILi\d+ELb0E|nw_long_full_kernelI)")
_ANON = re.compile(r"\S*_GLOBAL__N_\S*")


def _module(kernel: str):
    from asm_tpu_torch.kernels import greedy_cuda, leap_cuda, nw_band, nw_cuda

    return dict(greedy=greedy_cuda, leap=leap_cuda, nw=nw_cuda,
                nw_band=nw_band)[kernel]


def stem(kernel: str, args: tuple) -> str:
    return _module(kernel).plan(*args).stem


def build(kernel: str, args: tuple, source_dir: str | None = None) -> str:
    """Path of the library of (kernel, args), built from this checkout's
    source or from `source_dir`'s (under a stem of its own)."""
    from asm_tpu_torch.utils.build import nvcc_library

    mod = _module(kernel)
    if source_dir is None:
        return mod.build_kernel(*args)[0]
    p = mod.plan(*args)
    src = os.path.join(source_dir, os.path.basename(mod.SOURCE))
    return nvcc_library(f"ref_{p.stem}", src, p.defines)[0]


def digests(lib_path: str) -> dict:
    """Mangled name (from the kernel's own name on) -> sha256 of its SASS
    without the name line and the anonymous namespace's hash, each run of
    blanks one space (cuobjdump pads the instruction column to the longest
    instruction of the whole library, so a kernel added beside another
    would otherwise move its digest)."""
    from asm_tpu_torch.tools.roofline import _sections, sass_listing

    out = {}
    for name, text in _sections(sass_listing(lib_path)):
        m = _KERNEL_AT.search(name)
        key = m[1] if m else _ANON.sub("ANON", name)
        if UNPINNED.match(key):
            continue
        body = _ANON.sub("ANON", "\n".join(
            " ".join(ln.split()) for ln in text.splitlines()[1:]))
        out[key] = hashlib.sha256(body.encode()).hexdigest()
    return out


def nvcc_version() -> str:
    from asm_tpu_torch.utils.build import _nvcc

    res = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[-1]


def collect(source_dir: str | None = None, jobs: int | None = None) -> dict:
    """{library stem: digests} of every SHORT_SHAPES library, built and
    listed at once (one nvcc, then one cuobjdump, each)."""
    with ThreadPoolExecutor(jobs or os.cpu_count() or 8) as ex:
        paths = list(ex.map(lambda s: build(*s, source_dir), SHORT_SHAPES))
        return dict(zip(map(lambda s: stem(*s), SHORT_SHAPES),
                        ex.map(digests, paths)))


def compare(got: dict, pin: dict) -> dict:
    """Kernels held, and those moved, missing or new against the pin."""
    moved, missing, new, held = [], [], [], 0
    for lib, want in pin.items():
        have = got.get(lib, {})
        for key, dig in want.items():
            held += 1
            if key not in have:
                missing.append(f"{lib}:{key}")
            elif have[key] != dig:
                moved.append(f"{lib}:{key}")
        new += [f"{lib}:{key}" for key in have if key not in want]
    return dict(held=held, moved=moved, missing=missing, new=new)


def check(got: dict | None = None, version: str | None = None) -> dict:
    """This checkout's short-row kernels against the pin; raises if one
    moved or went missing. Under another nvcc than the pin's (`version`,
    default this machine's) it compares nothing and returns compared
    False with both versions."""
    with open(PIN_PATH) as f:
        pin = json.load(f)
    version = nvcc_version() if version is None else version
    if version != pin["nvcc"]:
        return dict(compared=False, pin_nvcc=pin["nvcc"], nvcc=version)
    res = compare(collect() if got is None else got, pin["libraries"])
    if res["moved"] or res["missing"]:
        raise AssertionError(f"short-row SASS differs from the pin: "
                             f"{len(res['moved'])} moved, "
                             f"{len(res['missing'])} missing of "
                             f"{res['held']}: {res['moved'][:4]} "
                             f"{res['missing'][:4]}")
    return dict(res, compared=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source-dir", help="a csrc directory to build from")
    ap.add_argument("--out", help="write the digests here (JSON)")
    ap.add_argument("--check", action="store_true",
                    help="compare this checkout's with the pin")
    args = ap.parse_args(argv)
    if args.check:
        print(json.dumps(check()))
        return 0
    got = collect(args.source_dir)
    doc = dict(nvcc=nvcc_version(), sources=args.source_dir or "this "
               "checkout", libraries=got)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
    print(json.dumps(dict(libraries=len(got),
                          kernels=sum(map(len, got.values())))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
