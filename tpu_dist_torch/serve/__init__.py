"""The inference path of the port: the batching engine and its latency stats."""
