"""Job kinds: `<kind>.py` holds the one call into the program for a job
of that kind (`setup(config, device)` returns it) and `OUTPUTS`, the
names of what the call returns, which the check compares with
`perfbench/reference/<kind>.py`."""
