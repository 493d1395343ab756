"""Measurement tools of the port (`python -m asm_tpu_torch.tools.roofline`)."""
