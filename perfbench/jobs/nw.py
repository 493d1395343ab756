"""An exact-NW job: the Gotoh penalties of a batch of pairs, through
`asm_tpu_torch.kernels.nw_band.nw_penalty_partitioned` with no band
hints: band passes over the frozen widths, the certificate on the host,
the full kernel on the residue. Its answer comes back on the host."""

from __future__ import annotations

OUTPUTS = ("penalty",)


def setup(config: dict, device):
    from asm_tpu_torch.kernels import nw_band

    x, o, e = config["x"], config["o"], config["e"]

    def run(read, read_len, ref, ref_len) -> dict:
        return {"penalty": nw_band.nw_penalty_partitioned(
            read, read_len, ref, ref_len, x=x, o=o, e=e, bws=nw_band.BWS)}

    return run
