"""The one place the port reaches torch's private API: the counterpart of
``tpu_dist/comm/compat.py`` (which holds JAX's moving imports), and the
module lint rule TD004 exempts.

Every name here is private to torch and may move between releases; a
module of the port imports it from here, so a release that moves one
breaks this file alone.
"""

from __future__ import annotations

import torch
from torch._utils import _flatten_dense_tensors  # noqa: F401
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes  # noqa: F401


def current_raw_stream(device: int) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream (the capture
    stream under a CUDA graph), for a kernel launched through a plain C
    entry point."""
    return torch._C._cuda_getCurrentRawStream(device)
