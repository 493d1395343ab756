"""Band passes that certified nothing, per pair entering the exact-NW
entry: (pairs the band stages took - pairs they certified) / pairs in,
from the port's counter `nw_band.PAIRS` over every call of the process
(warm-up and window). None for other job kinds, or where nothing was
counted (a program without the counter, the control)."""


def read(ctx):
    if ctx.kind != "nw":
        return None
    from asm_tpu_torch.kernels import nw_band

    pairs = getattr(nw_band, "PAIRS", None)
    if not pairs or not pairs["in"]:
        return None
    def total(stage):
        return sum(v for k, v in pairs.items()
                   if isinstance(k, tuple) and k[0] == stage)

    return (total("band") - total("certified")) / pairs["in"]
