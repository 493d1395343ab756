"""Host data generators."""
