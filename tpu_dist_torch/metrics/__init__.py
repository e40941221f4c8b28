"""Meters and rank-0 logging."""
