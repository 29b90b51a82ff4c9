"""Benchmarks of the port on the card."""
