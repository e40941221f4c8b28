"""The inference path of the port: the batching engine with its
checkpoint loading, int8 weights and SLO rules (``engine.py``), its
latency stats and serve report (``slo.py``), and ``python -m
tpu_dist_torch.serve report`` (``__main__.py``)."""
