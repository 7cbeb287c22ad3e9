"""Batched network simulators."""
