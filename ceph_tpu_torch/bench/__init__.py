"""Benchmark CLIs."""
