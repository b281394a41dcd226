"""Experiments and their shared plumbing."""
