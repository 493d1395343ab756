"""Batch scheduling and the single-device greedy runner."""
