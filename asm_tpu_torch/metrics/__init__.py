"""Alignment quality metrics."""
