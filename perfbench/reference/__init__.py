"""Plain references, one module a job kind: `reference(read, read_len,
ref, ref_len, config)` gives the answers the configuration states, and
`control(...)` the same with one stated guarantee broken (PERF.md). They
import torch and nothing of the program."""
