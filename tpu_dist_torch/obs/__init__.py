"""Host-side telemetry of the port: the counter/gauge registry and spans."""
