"""Read-mapper application (port of `asm_tpu.mapper`, GASMA's my-indexer
and my-mapper, indexer.cpp:23-93, main.cpp:26-163).

The candidate windows of a whole read batch come from the native FM-index
(pigeonhole exact seeding, one threaded call) and are rescored on the card
by the greedy kernel (csrc/greedy.cu), then emitted as SAM.
"""

from asm_tpu_torch.mapper.core import MapperConfig, build_index, map_reads

__all__ = ["build_index", "map_reads", "MapperConfig"]
