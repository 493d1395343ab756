"""Host data generators and pair files."""

from asm_tpu_torch.data.generator import dataset_filename, generate_dataset
from asm_tpu_torch.data.io import read_pair_file, write_pair_file

__all__ = [
    "generate_dataset",
    "dataset_filename",
    "read_pair_file",
    "write_pair_file",
]
