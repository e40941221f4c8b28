"""Resilience of the port: the transient-I/O retry and the cooperative
SIGTERM contract (exit 75)."""
