"""Pedersen bases and the deterministic Bulletproof generator chains.

The port's own ``PedersenGens`` / ``BulletproofGens``, giving the same points
as the JAX package's.  A chain is a keccak hash walk::

    state_0 = keccak256(pad_label(b"GeneratorsChain" || label))
    state_{i+1} = keccak256(state_i);  generator_i = hash_to_scalar(state_{i+1}) G

:class:`BulletproofGens` walks its 2m chains on ``device`` (:func:`chain_scalars`:
the ``keccak_chain`` and ``keccak256_32`` kernels of :mod:`.ops.kernels`, their
plain versions on the CPU), makes the ``scalar G`` products there through the
fixed-base path (:func:`.ops.msm.fixed_commit`), keeps the affine points
there for the device routes (:func:`device_gens`), and builds the host
point lists from the same tensors.  :class:`GeneratorsChain` walks one
chain a step at a time on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.curve import StarkPoint
from .ops.field import Scalar
from .ops.keccak import keccak256, keccak256_batch, pad_label
from .transcript import hash_to_scalar
from .utils.device import normalize_device, resolve_device

_TABLE_CACHE: dict = {}
# Device tensors per gens object: keyed by id() with a strong reference held
# beside, so a recycled id never aliases another object.
_GENS_CACHE: dict = {}


def device_point_table(pt: StarkPoint, device) -> torch.Tensor:
    """Fixed-base table of ``pt`` on ``device`` (:func:`.ops.msm.fixed_base_table`),
    cached per point and device: the curve generator serves the chains and,
    by default, both Pedersen bases."""
    from .ops import curve_t, msm

    key = (pt.to_bytes(), normalize_device(device))
    table = _TABLE_CACHE.get(key)
    if table is None:
        base = torch.as_tensor(curve_t.points_from_host([pt]), device=device)
        table = msm.fixed_base_table(base)
        _TABLE_CACHE[key] = table
    return table


# Scalars a fixed_commit call takes in fixed_base_points: its gather is 64
# records a scalar, ~0.8 GB of points at 2^17.
_FIXED_BASE_CHUNK = 1 << 17


def fixed_base_points(sc: torch.Tensor, pt: StarkPoint) -> torch.Tensor:
    """``(NW, k)`` canonical scalars on a device -> the ``(3, NW, k)``
    projective points ``s_i pt`` on it, through the fixed-base table
    (:func:`.ops.msm.fixed_commit`, ``_FIXED_BASE_CHUNK`` scalars a call)."""
    from .ops import msm

    table = device_point_table(pt, sc.device)
    parts = []
    for i in range(0, sc.shape[-1], _FIXED_BASE_CHUNK):
        part = sc[:, i : i + _FIXED_BASE_CHUNK]
        off = torch.zeros(part.shape[-1], dtype=torch.int64, device=sc.device)
        parts.append(msm.fixed_commit(table, off, part, off, torch.zeros_like(part)))
    return torch.cat(parts, dim=-1).contiguous()


def host_points(x: torch.Tensor, y: torch.Tensor, is_id: torch.Tensor) -> list[StarkPoint]:
    """Standard-form affine ``(NW, k)`` coordinates and flags -> host points."""
    from .ops.limb import words_to_ints

    xs, ys, ids = words_to_ints(x.cpu()), words_to_ints(y.cpu()), is_id.cpu().tolist()
    return [StarkPoint.identity() if i else StarkPoint(a, b) for a, b, i in zip(xs, ys, ids)]


def fixed_base_mul(scalars, pt: StarkPoint, device) -> list[StarkPoint]:
    """``[s pt for s in scalars]`` through the fixed-base table on ``device``."""
    from .ops import curve_t, transcript_t

    sc = torch.as_tensor(curve_t.scalars_from_host(scalars), device=device)
    return host_points(*transcript_t.lazy_points_to_affine(fixed_base_points(sc, pt)))


def gens_cache_entry(obj) -> dict:
    """The dict of device tensors cached for the generator object ``obj``."""
    ref, per = _GENS_CACHE.setdefault(id(obj), (obj, {}))
    if ref is not obj:
        raise RuntimeError("generator cache entry aliases another object")
    return per


def device_gens(bp_gens: "BulletproofGens", n: int, m: int, device):
    """Aggregated ``(G(n, m), H(n, m))`` as ``(3, NW, nm)`` tensors on
    ``device``: slices of the affine points ``bp_gens`` made on its own
    device (:meth:`BulletproofGens.increase_capacity`), cached per shape."""
    from .ops.limb import NW

    per = gens_cache_entry(bp_gens)
    key = ("gens", n, m, normalize_device(device))
    if key not in per:
        if n > bp_gens.gens_capacity or m > bp_gens.party_capacity:
            raise ValueError(f"generators for ({n}, {m}) exceed the capacity "
                             f"({bp_gens.gens_capacity}, {bp_gens.party_capacity})")
        chains = per["chains"].to(device)                   # (3, NW, 2, parties, capacity)
        per[key] = tuple(chains[:, :, i, :m, :n].reshape(3, NW, m * n).contiguous() for i in (0, 1))
    return per[key]


class PedersenGens:
    """The pair of Pedersen bases; both default to the curve generator."""

    __slots__ = ("B", "B_blinding")

    def __init__(self, B: StarkPoint | None = None, B_blinding: StarkPoint | None = None):
        self.B = B if B is not None else StarkPoint.generator()
        self.B_blinding = B_blinding if B_blinding is not None else StarkPoint.generator()

    def commit(self, value: Scalar, blinding: Scalar) -> StarkPoint:
        """``value B + blinding B_blinding``, on the host."""
        return StarkPoint.msm([value, blinding], [self.B, self.B_blinding])

    def commit_batch(self, values, blindings) -> list[StarkPoint]:
        """:meth:`commit` for each pair."""
        return [self.commit(v, b) for v, b in zip(values, blindings)]

    def commit_shared(self, value, blinding):
        """``value B + blinding B_blinding`` for values of any type whose
        product with a point is defined (a shared value's, where the MPC
        fabric's types define one)."""
        return value * self.B + blinding * self.B_blinding


def _chain_start(label: bytes) -> bytes:
    return keccak256(pad_label(b"GeneratorsChain" + label))


class GeneratorsChain:
    """One labelled chain, walked a step at a time (the batch of chains
    that :class:`BulletproofGens` walks side by side is
    :func:`chain_scalars`)."""

    __slots__ = ("state",)

    def __init__(self, label: bytes = b""):
        self.state = _chain_start(label)

    def fast_forward(self, n: int) -> "GeneratorsChain":
        """Skip ``n`` generators."""
        for _ in range(n):
            self.state = keccak256(self.state)
        return self

    def next_scalar(self) -> Scalar:
        self.state = keccak256(self.state)
        return hash_to_scalar(self.state)

    def take_scalars(self, n: int) -> list[Scalar]:
        return [self.next_scalar() for _ in range(n)]

    def take(self, n: int, *, device="cuda") -> list[StarkPoint]:
        """The next ``n`` generators: on the card by :func:`fixed_base_mul`,
        on ``device="cpu"`` by host scalar multiplications."""
        dev = resolve_device(device)
        scalars = self.take_scalars(n)
        gen = StarkPoint.generator()
        if dev.type == "cpu" or not scalars:
            return [gen.scalar_mul(s) for s in scalars]
        return fixed_base_mul(scalars, gen, dev)


def chain_scalars(labels: list[bytes], skip: int, count: int, device) -> torch.Tensor:
    """Scalars ``skip .. skip + count - 1`` of each labelled chain as
    ``(NW, len(labels) count)`` canonical words on ``device``, chain by
    chain: the walk (``kernels.keccak_chain``), the second keccak of
    ``hash_to_scalar`` over every walked state (``kernels.keccak256_32``),
    then ``LE(state || keccak256(state)) mod r`` on the device
    (:func:`.ops.transcript_t.bytes_to_scalar_mod_r`)."""
    from .ops import kernels, transcript_t

    msgs = [pad_label(b"GeneratorsChain" + l) for l in labels]
    if len({len(m) for m in msgs}) > 1:
        raise ValueError("chain_scalars: the labels must pad to one length")
    starts = keccak256_batch(np.frombuffer(b"".join(msgs), np.uint8).reshape(len(labels), -1))  # state_0
    walked = kernels.keccak_chain(torch.as_tensor(starts, device=device), skip, count)
    walked = walked.reshape(-1, 32)
    both = torch.cat([walked, kernels.keccak256_32(walked)], dim=1)        # (C count, 64)
    return transcript_t.bytes_to_scalar_mod_r(both.T.to(torch.int64))


def _party_label(prefix: bytes, party_index: int) -> bytes:
    return prefix + party_index.to_bytes(4, "little")


class BulletproofGens:
    """Generators for up to ``party_capacity`` aggregated proofs of up to
    ``gens_capacity`` bits each; party j's G and H chains are labelled
    ``b"G" || j`` and ``b"H" || j`` (u32 little-endian).  The points are
    derived on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, gens_capacity: int, party_capacity: int = 1, *, device="cuda"):
        self.gens_capacity = 0
        self.party_capacity = party_capacity
        self.device = resolve_device(device)
        self.G_vec: list[list[StarkPoint]] = [[] for _ in range(party_capacity)]
        self.H_vec: list[list[StarkPoint]] = [[] for _ in range(party_capacity)]
        self.increase_capacity(gens_capacity)

    def increase_capacity(self, new_capacity: int) -> None:
        """Extend every party's chains to ``new_capacity``: the new scalars
        and points made on the gens' device and appended to the affine
        ``(3, NW, 2, parties, capacity)`` tensor cached for it (G then H),
        the host lists built from the same points."""
        if self.gens_capacity >= new_capacity:
            return
        from .ops import curve_t
        from .ops.limb import NW

        extra = new_capacity - self.gens_capacity
        m = self.party_capacity
        labels = [_party_label(b"G", i) for i in range(m)] + [_party_label(b"H", i) for i in range(m)]
        scalars = chain_scalars(labels, self.gens_capacity, extra, self.device)
        mont, x, y, is_id = curve_t.affine_mont(fixed_base_points(scalars, StarkPoint.generator()))
        per = gens_cache_entry(self)
        new = mont.reshape(3, NW, 2, m, extra)
        per["chains"] = new if "chains" not in per else torch.cat([per["chains"], new], dim=-1)
        pts = host_points(x, y, is_id)
        for c in range(2 * m):
            vec = self.G_vec[c] if c < m else self.H_vec[c - m]
            vec.extend(pts[c * extra : (c + 1) * extra])
        self.gens_capacity = new_capacity

    def share(self, j: int) -> "BulletproofGensShare":
        return BulletproofGensShare(self, j)

    def as_mpc_values(self) -> "BulletproofGensShare":
        """The generators for the MPC provers: public points, so party 0's
        view (:meth:`share`)."""
        return self.share(0)

    def G(self, n: int, m: int) -> list[StarkPoint]:
        """Party-major aggregated G vector."""
        return [self.G_vec[j][i] for j in range(m) for i in range(n)]

    def H(self, n: int, m: int) -> list[StarkPoint]:
        return [self.H_vec[j][i] for j in range(m) for i in range(n)]


class BulletproofGensShare:
    """Party ``share``'s G and H chains; ``share(0).G(n)`` is ``G(n, 1)``."""

    __slots__ = ("gens", "share")

    def __init__(self, gens: BulletproofGens, share: int):
        self.gens = gens
        self.share = share

    def G(self, n: int) -> list[StarkPoint]:
        return self.gens.G_vec[self.share][:n]

    def H(self, n: int) -> list[StarkPoint]:
        return self.gens.H_vec[self.share][:n]
