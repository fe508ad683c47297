"""Benchmark helpers: synthetic data, recall and the streaming runbook."""
