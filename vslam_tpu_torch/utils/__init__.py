"""Profiling and FLOP-count utilities of the port."""
