"""Routing of the protocol MSMs between the device and the host.

:func:`dispatch_msm` is the one MSM entry point of the verifiers (the
range-proof mega-check, the IPP check).  Host points: from
:data:`_DEVICE_MIN` on it runs :func:`.msm.msm_host_points` on ``device``,
below that the host Pippenger (``StarkPoint.msm``).  A point tensor is
already on the device and always takes the device MSM.  This is a routing
by size, the JAX package's own (``mpc_bulletproof_tpu/ops/backend.py``),
not a fallback: a card asked for and missing raises whatever the size.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from .curve import StarkPoint

# Below this size the host Pippenger serves.  The JAX package's crossover,
# measured against TPU dispatch latency and kept so both packages route
# alike; the card's own crossover is not measured yet.
_DEVICE_MIN = 32


def dispatch_msm(scalars, points, *, device="cuda") -> StarkPoint:
    """``sum_i s_i P_i`` for host scalars (``Scalar`` or ints in ``[0, r)``)
    and host ``StarkPoint``s, or a ``(3, NW, n)`` point tensor on the device
    (cached generators); returns a ``StarkPoint``."""
    from . import msm as msm_mod

    dev = resolve_device(device)
    n = points.shape[-1] if isinstance(points, torch.Tensor) else len(points)
    if len(scalars) != n:
        raise ValueError("dispatch_msm: scalar/point length mismatch")
    if isinstance(points, torch.Tensor) or n >= _DEVICE_MIN:
        return msm_mod.msm_host_points(scalars, points, device=dev)
    return StarkPoint.msm(scalars, points)
