"""Benchmark scenes shared by the bench entry point and the smoke check."""
