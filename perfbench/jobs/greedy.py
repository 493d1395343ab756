"""A greedy job: the costs and step counts of a batch of pairs, through
`asm_tpu_torch.kernels.greedy_cuda.greedy_align_cuda` without CIGARs."""

from __future__ import annotations

OUTPUTS = ("cost", "steps")


def setup(config: dict, device):
    from asm_tpu_torch.config import AlignConfig, AlignmentType
    from asm_tpu_torch.kernels.greedy_cuda import greedy_align_cuda

    cfg = AlignConfig(x=config["x"], o=config["o"], e=config["e"],
                      k=config["k"], max_len=config["max_len"],
                      max_steps=config["max_steps"],
                      alignment_type=AlignmentType[config["alignment_type"]])

    def run(read, read_len, ref, ref_len) -> dict:
        out = greedy_align_cuda(read, read_len, ref, ref_len, cfg,
                                want_cigar=False)
        return {"cost": out["cost"], "steps": out["steps"]}

    return run
