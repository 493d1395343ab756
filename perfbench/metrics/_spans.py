"""The program's own spans in a traced stretch, as sorted disjoint
(start, end) pairs on the trace's one clock. The port names them
`asm.<stage>` (`asm_tpu_torch.utils.profiling.span`): an entry span,
`asm.<kind>` with one dot, wraps each call perfbench makes, and a span
whose name ends in ".wait" is time the host spends blocked on the
device."""

from perfbench import trace


def _named(tr, keep) -> list:
    return trace.union(iv for iv in tr.host
                       if iv[2].startswith("asm.") and keep(iv[2]))


def entries(tr) -> list:
    return _named(tr, lambda name: name.count(".") == 1)


def waits(tr) -> list:
    return _named(tr, lambda name: name.endswith(".wait"))


def intersect(a, b) -> list:
    """The overlap of two sorted disjoint lists of (start, end) pairs."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> list:
    """The part of `a` that `b` does not cover (both sorted, disjoint)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def length(pairs) -> float:
    return sum(e - s for s, e in pairs)


def host_work(tr) -> list | None:
    """The window's time inside the program's entry spans and outside
    its waits, or None where the trace holds no entry span (a program
    without spans, the control) or no device record (a run on the CPU)."""
    ent = entries(tr)
    if not ent or not (tr.kernels or tr.copies):
        return None
    lo, hi = tr.window
    return trace.clip(subtract(ent, waits(tr)), lo, hi)
