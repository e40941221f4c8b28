"""Mesh-shape-portable checkpoints: the port's copy of
``tpu_dist/elastic/{errors,remap}.py``. The relaunch supervisor and the
elastic drill are not ported."""

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
