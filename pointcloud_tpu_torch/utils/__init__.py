"""Utilities: host step timing and device traces."""
