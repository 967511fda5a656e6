"""Benchmark scenario factory."""
