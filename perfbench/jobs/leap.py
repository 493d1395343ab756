"""A LEAP job: lv_bag's verdict, penalty and lane shift for a batch of
pairs, through `asm_tpu_torch.kernels.leap_cuda.leap_align_cuda`."""

from __future__ import annotations

OUTPUTS = ("passed", "penalty", "lane_shift")


def setup(config: dict, device):
    from asm_tpu_torch.config import AlignConfig, LeapMode
    from asm_tpu_torch.kernels.leap_cuda import leap_align_cuda

    cfg = AlignConfig(x=config["x"], o=config["o"], e=config["e"],
                      k=config["k"], max_len=config["max_len"],
                      leap_af_threshold=config["leap_af_threshold"],
                      leap_mode=LeapMode[config["leap_mode"]])

    def run(read, read_len, ref, ref_len) -> dict:
        return leap_align_cuda(read, read_len, ref, ref_len, cfg,
                               semantics="lv_bag")

    return run
