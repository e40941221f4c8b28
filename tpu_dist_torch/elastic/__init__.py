"""Mesh-shape-portable checkpoints: the port's copy of
``tpu_dist/elastic/{errors,remap,supervisor}.py``, and the elastic drill
(``python -m tpu_dist_torch.elastic.drill``). The relaunch policy
(``supervisor.py``) is imported by the launcher, not from here."""

from tpu_dist_torch.elastic.errors import ConfigMismatchError, ElasticShapeMismatch
from tpu_dist_torch.elastic.remap import (
    Remapper,
    classify,
    elastic_stamp,
    make_remapper,
    params_len,
)

__all__ = [
    "ConfigMismatchError",
    "ElasticShapeMismatch",
    "Remapper",
    "classify",
    "elastic_stamp",
    "make_remapper",
    "params_len",
]
