"""Device ops and the two hand-written CUDA kernels of the LSMC engine.

``backward_update`` (ops/backward.py) and ``forward_sim`` (ops/forward.py)
launch their CUDA kernels for CUDA tensors and run their plain PyTorch
versions for CPU tensors.  Each launch of a kernel adds one to its count in
:func:`launch_counts`, so a run can show that it went through the kernels.
"""
from __future__ import annotations

from typing import Dict

_LAUNCHES: Dict[str, int] = {"backward_update": 0, "forward_sim": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1
