"""Host memory, corpus cache and build helpers."""
