"""Routing of the protocol MSMs between a mesh, the device and the host.

:func:`dispatch_msm` is the one MSM entry point of the protocols.  Host
points: from :data:`_DEVICE_MIN` on it runs :func:`.msm.msm_host_points` on
``device``, below that the host Pippenger (``StarkPoint.msm``).  A point
tensor is already on the device and always takes the device MSM.
:func:`gens_msm` serves the MSMs over the Bulletproof generators (the
range-proof and R1CS mega-checks, the R1CS phase MSMs): it picks the route
by size before anything moves.  This is a routing by size, the JAX
package's own (``mpc_bulletproof_tpu/ops/backend.py``), not a fallback: a
card asked for and missing raises whatever the size.

A mesh (:class:`..parallel.sharded.Mesh`) installed with :func:`set_mesh`
takes every MSM that :func:`mesh_shardable` passes to
:func:`..parallel.sharded.sharded_msm` on its lead device: the range-proof
and IPP verifiers, the R1CS phase MSMs and verifier, the MPC fabric's MSMs
and the shared IPP all reach it through these two functions.  The port has
no native split table, so its verifiers take the plain gate, as the JAX
verifier does when its split table is ``None``; the JAX gate for a caller
that would leave a native split-table path for the mesh (``over_split``)
has no counterpart here.  A mesh whose device type differs from the
caller's ``device`` raises.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from .curve import StarkPoint

# Below this size the host Pippenger serves.  The JAX package's crossover,
# measured against TPU dispatch latency and kept so both packages route
# alike; the card's own crossover is not measured yet.
_DEVICE_MIN = 32
# Below this many points a shard, one device serves (the JAX package's gate).
_SHARD_MIN_PER_DEVICE = 16

_ACTIVE_MESH = None


def set_mesh(mesh) -> None:
    """Install a :class:`..parallel.sharded.Mesh` for the protocol MSMs, or
    clear it with ``None``."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def mesh_shardable(n: int) -> bool:
    """Whether an ``n``-point protocol MSM goes to the installed mesh: one
    is installed, and ``n`` is at least :data:`_DEVICE_MIN` and at least
    :data:`_SHARD_MIN_PER_DEVICE` a shard."""
    mesh = _ACTIVE_MESH
    return mesh is not None and n >= max(_DEVICE_MIN, mesh.size * _SHARD_MIN_PER_DEVICE)


def dispatch_msm(scalars, points, *, device="cuda") -> StarkPoint:
    """``sum_i s_i P_i`` for host scalars (``Scalar`` or ints in ``[0, r)``)
    and host ``StarkPoint``s, or a ``(3, NW, n)`` point tensor on the device
    (cached generators); returns a ``StarkPoint``."""
    from . import curve_t
    from . import msm as msm_mod

    dev = resolve_device(device)
    mesh = _ACTIVE_MESH
    if mesh is not None and mesh.lead.type != dev.type:
        raise ValueError(f"the installed mesh {mesh} is not on the caller's device type {dev.type}")
    n = points.shape[-1] if isinstance(points, torch.Tensor) else len(points)
    if len(scalars) != n:
        raise ValueError("dispatch_msm: scalar/point length mismatch")
    if mesh_shardable(n):
        from ..parallel import sharded

        s, p = msm_mod.device_operands(scalars, points, mesh.lead)
        return curve_t.points_to_host(sharded.sharded_msm(s, p, mesh)[..., None])[0]
    if isinstance(points, torch.Tensor) or n >= _DEVICE_MIN:
        return msm_mod.msm_host_points(scalars, points, device=dev)
    return StarkPoint.msm(scalars, points)


def gens_msm(bp_gens, scalars, lead, n: int, m: int = 1, *, lo: int = 0, hi: int | None = None,
             with_h: bool = True, device="cuda") -> StarkPoint:
    """``sum scalars * (lead + G(n, m)[lo:hi] + H(n, m)[lo:hi])`` over the
    aggregated generators of ``bp_gens`` (H only ``with_h``; party j's
    vectors are ``lo = j n``, ``hi = (j + 1) n``).  Below
    :data:`_DEVICE_MIN` points the host Pippenger over the host generators,
    the card untouched; else the ``lead`` host points go to ``device`` once
    and meet the cached generator tensor (:func:`..generators.device_gens`)
    in :func:`dispatch_msm`, which takes the mesh when one is installed."""
    from .. import generators
    from . import curve_t

    dev = resolve_device(device)
    if len(scalars) < _DEVICE_MIN:
        pts = list(lead) + bp_gens.G(n, m)[lo:hi] + (bp_gens.H(n, m)[lo:hi] if with_h else [])
        return dispatch_msm(scalars, pts, device=dev)
    G, H = generators.device_gens(bp_gens, n, m, dev)
    parts = [torch.as_tensor(curve_t.points_from_host(lead), device=dev), G[..., lo:hi]]
    if with_h:
        parts.append(H[..., lo:hi])
    return dispatch_msm(scalars, torch.cat(parts, dim=-1), device=dev)
