"""The three-way benchmark harness and its CLI (`python -m asm_tpu_torch.bench`)."""
