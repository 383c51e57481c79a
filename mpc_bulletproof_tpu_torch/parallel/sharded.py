"""The bulk algebra split over a mesh of devices: the port's counterpart of
``mpc_bulletproof_tpu/parallel/sharded.py``.

One controller, a mesh of devices.  The JAX package's mesh is one process
over ``jax.devices()`` running a single-controller SPMD program
(``shard_map``).  Here one Python process launches each shard's work on
that shard's device, copies the partials to the mesh's lead device and
combines them there.  The work the JAX program replicates on every device
(the elementwise vectors, ``fixed_commit``, the keccak transcript) runs
once, on the lead.  Devices may repeat: ``Mesh([dev] * k)`` is a virtual
mesh of k shards on one device (the CPU tests, one card).  A mesh of one
device is the unsharded case: every function here then runs its one
partial on that device, with no padding, copy or collective, so the
provers take a single path with or without a mesh.

The lane partition is the JAX package's: ``ck = ceil(n / size)`` lanes a
shard, shard d takes lanes ``[d ck, (d + 1) ck)``, and the lanes past n
are zero scalars and identity points (:func:`shard_pad_msm`; a table MSM
pads with the table's identity record).  A zero scalar's digits all fall
in bucket 0, which no window sum reads, so the padding adds nothing.

The collective is each shard's partial copied to the lead and one
segmented sum there (:func:`..ops.msm._reduce_sum`, the ``point_reduce``
kernel), where the JAX package all-gathers and adds by a tree of
``point_add``.  Inner products reduce each shard's slice mod r and add the
partials mod r on the lead, where the JAX package psums wide limbs and
reduces once: the canonical result is the same.

==================================  =========================================
JAX package                         here
==================================  =========================================
``make_mesh``                       :func:`make_mesh` (cards only), :class:`Mesh`
``sharded_msm``, ``insh_msm``       :func:`sharded_msm`
``sharded_point_sum``,              :func:`sharded_point_sum`
``insh_point_sum``
``sharded_inner_product``,          :func:`sharded_inner_product`
``insh_inner_product``
``shard_pad_msm``                   :func:`shard_pad_msm`
``insh_slice``                      :func:`_lanes`
the table MSMs of ``fused_device``  :func:`sharded_table_msm`
and ``fused_ipp_body(shard=...)``
==================================  =========================================

The ``insh_*`` helpers exist in the JAX package because a ``shard_map``
body has replicated operands; here every function takes its operands on
the lead and returns its result there.
"""

from __future__ import annotations

import threading

import torch

from ..ops import limb
from ..ops import msm as msm_mod
from ..ops.curve_t import identity
from ..ops.limb import FR, NW
from ..utils.device import normalize_device

# Calls of each sharded function since the last reset_calls(): the routes'
# witness (a verifier's MSM counted here went through the mesh).
calls = {"sharded_msm": 0, "sharded_table_msm": 0, "sharded_point_sum": 0, "sharded_inner_product": 0}
_LOCK = threading.Lock()


def reset_calls() -> None:
    with _LOCK:
        for name in calls:
            calls[name] = 0


def _count(name: str) -> None:
    with _LOCK:
        calls[name] += 1


class Mesh:
    """Devices in shard order.  The first is the lead: the sharded
    functions take their operands there and return their results there.
    Devices may repeat (a virtual mesh); they are of one type.  Hashable,
    so caches can key on a mesh."""

    __slots__ = ("devices",)

    def __init__(self, devices):
        devs = tuple(normalize_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices are of one type, got {devs}")
        self.devices = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The first ``n_devices`` cards (every card by default) as a mesh.
    Raises when there is no card or fewer cards than asked for: it never
    takes the CPU and never repeats a card (``Mesh([dev] * k)`` builds a
    virtual mesh on purpose)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (a CPU mesh is Mesh([torch.device('cpu')] * k))")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"make_mesh: {n} devices asked for")
    if n > count:
        raise RuntimeError(f"make_mesh: {n} cards asked for, {count} present")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def _shard_width(n: int, mesh: Mesh) -> int:
    return -(-n // mesh.size)


def _lanes(x: torch.Tensor, mesh: Mesh, ck: int) -> list:
    """Shard d's ``ck``-lane slice of a lanes-last tensor, on its device."""
    return [x[..., d * ck : (d + 1) * ck].to(dev) for d, dev in enumerate(mesh.devices)]


def _pad_zeros(x: torch.Tensor, total: int) -> torch.Tensor:
    pad = total - x.shape[-1]
    return x if pad == 0 else torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], dim=-1)


def _pad_identity(points: torch.Tensor, total: int) -> torch.Tensor:
    pad = total - points.shape[-1]
    return points if pad == 0 else torch.cat([points, identity((pad,), points.device)], dim=-1)


def _pad_records(recs: torch.Tensor, total: int, ident: int) -> torch.Tensor:
    pad = total - recs.shape[-1]
    return recs if pad == 0 else torch.cat([recs, recs.new_full((pad,), ident)])


def _gather_sum(parts: list, mesh: Mesh) -> torch.Tensor:
    """The collective: per-shard ``(3, NW, *batch)`` partials, each copied to
    the lead, summed there by one segmented ``point_reduce`` -> ``(3, NW,
    *batch)``.  One shard's partial is the sum."""
    if mesh.size == 1:
        return parts[0]
    stacked = torch.stack([p.to(mesh.lead) for p in parts], dim=-1).contiguous()
    return msm_mod._reduce_sum(stacked)[..., 0]


def shard_pad_msm(scalars: torch.Tensor, points: torch.Tensor, total: int):
    """Pad an MSM's ``(NW, k)`` scalars and ``(3, NW, k)`` points to
    ``total`` lanes with zero scalars and identity points, which add
    nothing (a zero scalar's digits fall in bucket 0)."""
    return _pad_zeros(scalars, total), _pad_identity(points, total)


def sharded_msm(scalars: torch.Tensor, points: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``sum_i s_i P_i`` over ``(NW, n)`` canonical scalars and ``(3, NW, n)``
    points on the lead -> ``(3, NW)`` on the lead.  Each shard runs the
    variable-base Pippenger (:func:`..ops.msm._msm_device_impl`) over its
    ``ck = ceil(n / size)`` lanes on its device, in windows of
    ``select_window(ck)`` bits; the partials meet in one collective."""
    if scalars.dim() != 2 or scalars.shape[0] != NW or tuple(points.shape) != (3, NW, scalars.shape[-1]):
        raise ValueError("sharded_msm: expected (NW, n) scalars and (3, NW, n) points")
    _count("sharded_msm")
    n = scalars.shape[-1]
    if n == 0:
        return identity((), mesh.lead).contiguous()
    ck = _shard_width(n, mesh)
    scalars, points = shard_pad_msm(scalars, points, ck * mesh.size)
    c = msm_mod.select_window(ck)
    parts = [msm_mod._msm_device_impl(s, p, c)
             for s, p in zip(_lanes(scalars, mesh, ck), _lanes(points, mesh, ck))]
    return _gather_sum(parts, mesh)


def sharded_table_msm(parts, tables: dict, mesh: Mesh, c: int,
                      bits: int = msm_mod.SPLIT_CHUNK_BITS) -> torch.Tensor:
    """``k`` same-width MSMs against one table
    (:func:`..ops.msm._msm_multi_table_impl`) split over the mesh.

    ``parts``: ``(scalars, records)`` pairs on the lead, ``(NW, n)``
    ``bits``-bit scalars and the ``(n,)`` table records of their points;
    ``tables``: ``{device: table}``, a copy of the table (its last record
    the identity) on each of the mesh's devices.  Each shard runs the k
    MSMs over its ``ck`` lanes against its device's copy, the lanes past n
    zero scalars on the identity record.  Returns ``(3, NW, k)`` on the
    lead: the shards' partials summed per output in one collective."""
    _count("sharded_table_msm")
    n = parts[0][0].shape[-1]
    ck = _shard_width(n, mesh)
    total = ck * mesh.size
    ident = tables[mesh.lead].shape[-1] - 1
    padded = [(_pad_zeros(s, total), _pad_records(r, total, ident)) for s, r in parts]
    lanes = [(_lanes(s, mesh, ck), _lanes(r, mesh, ck)) for s, r in padded]
    outs = [msm_mod._msm_multi_table_impl([(s[d], r[d]) for s, r in lanes], tables[dev], c, bits)
            for d, dev in enumerate(mesh.devices)]
    return _gather_sum(outs, mesh)


def sharded_point_sum(points: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of ``(3, NW, n)`` points on the lead -> ``(3, NW)`` on the lead:
    each shard's ``ck`` lanes summed on its device (one ``point_reduce``),
    then the collective."""
    if points.dim() != 3 or tuple(points.shape[:2]) != (3, NW):
        raise ValueError("sharded_point_sum: expected (3, NW, n) points")
    _count("sharded_point_sum")
    n = points.shape[-1]
    if n == 0:
        return identity((), mesh.lead).contiguous()
    ck = _shard_width(n, mesh)
    parts = [msm_mod._reduce_sum(p.contiguous())[..., 0]
             for p in _lanes(_pad_identity(points, ck * mesh.size), mesh, ck)]
    return _gather_sum(parts, mesh)


def sharded_inner_product(a: torch.Tensor, b: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``<a, b> mod r`` of ``(NW, n)`` canonical scalars on the lead ->
    ``(NW,)`` on the lead: each shard's slice by
    :func:`..ops.limb.inner_product_mod` on its device, the partials added
    mod r on the lead."""
    if a.shape != b.shape or a.dim() != 2 or a.shape[0] != NW:
        raise ValueError("sharded_inner_product: expected two (NW, n) vectors")
    _count("sharded_inner_product")
    n = a.shape[-1]
    if n == 0:
        return a.new_zeros((NW,))
    ck = _shard_width(n, mesh)
    total = ck * mesh.size
    parts = [limb.inner_product_mod(x, y, FR).to(mesh.lead)[:, None]
             for x, y in zip(_lanes(_pad_zeros(a, total), mesh, ck), _lanes(_pad_zeros(b, total), mesh, ck))]
    out = parts[0]
    for p in parts[1:]:
        out = limb.mod_add(out, p, FR)
    return out[:, 0]
