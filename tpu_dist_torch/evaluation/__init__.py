"""Distributed evaluation."""
