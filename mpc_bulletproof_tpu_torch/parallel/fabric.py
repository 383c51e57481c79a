"""The 2-party MPC fabric: SPDZ-style authenticated sharing, Beaver
multiplication and batched MAC-checked openings.

The port's copy of the JAX package's ``parallel/fabric.py``.  Every
communication round is one batched exchange.  Value model:

* global MAC key ``alpha = alpha_0 + alpha_1``; party ``i`` holds
  ``alpha_i`` (from the pre-processing source);
* a shared value ``x`` is ``(x_i, m_i)`` with ``x_0 + x_1 = x`` and
  ``m_0 + m_1 = alpha x``;
* addition and products by public scalars are local; adding a public value
  changes party 0's share and both MAC shares;
* a product consumes a Beaver triple and one batched open round;
* ``open_authenticated*`` opens, then runs a commit-then-reveal exchange of
  ``sigma_i = m_i - alpha_i x``: each party first sends ``keccak256(sigmas
  || salt)``, then reveals.  A commitment mismatch or a nonzero sigma sum
  raises :class:`~..utils.errors.AuthenticationError`.  The commitment
  round defeats a rushing party that would wait for the honest sigma and
  answer with its negation;
* input sharing uses SPDZ input tuples (owner-known authenticated masks),
  so the owner broadcasts ``x - r`` and no mask is opened online.

The fabric's MSMs (:meth:`MpcFabric.shared_msm`, :meth:`MpcFabric.shared_gens_msm`)
and its device share vectors (:mod:`.device_shares`) run on the fabric's
``device``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Sequence

from ..constants import SCALAR_BYTES
from ..ops.curve import StarkPoint
from ..ops.field import Scalar
from ..ops.keccak import keccak256
from ..utils.device import resolve_device
from ..utils.errors import AuthenticationError, MPCError
from .beaver import SharedValueSource
from .network import PARTY0, TwoPartyNetwork


def _pack_scalars(values: Sequence[Scalar]) -> bytes:
    return struct.pack(">I", len(values)) + b"".join(v.to_bytes_be() for v in values)


def _unpack_scalars(data: bytes) -> list[Scalar]:
    (count,) = struct.unpack(">I", data[:4])
    return [Scalar.from_be_bytes_mod_order(data[4 + i * SCALAR_BYTES : 4 + (i + 1) * SCALAR_BYTES])
            for i in range(count)]


# Points on the party link: uncompressed x | y (32 LE bytes each) and an
# identity flag.  Proof codecs stay compressed; the link is the fabric's
# own, and decompression costs a square root per point.  A received point
# is checked to lie on the curve.
_POINT_WIRE = 65


def _pack_points(points: Sequence[StarkPoint]) -> bytes:
    parts = [struct.pack(">I", len(points))]
    for p in points:
        if p.is_identity():
            parts.append(b"\x00" * 64 + b"\x01")
        else:
            parts.append(p.x.to_bytes(32, "little") + p.y.to_bytes(32, "little") + b"\x00")
    return b"".join(parts)


def _unpack_points(data: bytes) -> list[StarkPoint]:
    (count,) = struct.unpack(">I", data[:4])
    out = []
    for i in range(count):
        raw = data[4 + i * _POINT_WIRE : 4 + (i + 1) * _POINT_WIRE]
        if raw[64]:
            out.append(StarkPoint.identity())
        else:
            out.append(StarkPoint.from_affine(int.from_bytes(raw[:32], "little"),
                                              int.from_bytes(raw[32:64], "little")))
    return out


class AuthenticatedScalarVector:
    """A vector of authenticated secret shares (this party's view)."""

    __slots__ = ("fabric", "shares", "macs")

    def __init__(self, fabric: "MpcFabric", shares: list[Scalar], macs: list[Scalar]):
        self.fabric = fabric
        self.shares = shares
        self.macs = macs

    def __len__(self) -> int:
        return len(self.shares)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return AuthenticatedScalarVector(self.fabric, self.shares[idx], self.macs[idx])
        return AuthenticatedScalarVector(self.fabric, [self.shares[idx]], [self.macs[idx]])

    @staticmethod
    def concat(parts: Iterable["AuthenticatedScalarVector"]) -> "AuthenticatedScalarVector":
        parts = list(parts)
        shares, macs = [], []
        for p in parts:
            shares.extend(p.shares)
            macs.extend(p.macs)
        return AuthenticatedScalarVector(parts[0].fabric, shares, macs)

    # -- linear (local) algebra ----------------------------------------------

    def __add__(self, other):
        if isinstance(other, AuthenticatedScalarVector):
            return AuthenticatedScalarVector(
                self.fabric,
                [a + b for a, b in zip(self.shares, other.shares)],
                [a + b for a, b in zip(self.macs, other.macs)],
            )
        return self.add_public(other)

    def __sub__(self, other):
        if isinstance(other, AuthenticatedScalarVector):
            return AuthenticatedScalarVector(
                self.fabric,
                [a - b for a, b in zip(self.shares, other.shares)],
                [a - b for a, b in zip(self.macs, other.macs)],
            )
        return self.add_public([-v for v in _as_public_list(other, len(self))])

    def __neg__(self):
        return AuthenticatedScalarVector(self.fabric, [-s for s in self.shares], [-m for m in self.macs])

    def add_public(self, public) -> "AuthenticatedScalarVector":
        """Add public constants: party 0 changes its shares, both their MACs."""
        values = _as_public_list(public, len(self))
        alpha = self.fabric.mac_key_share
        if self.fabric.party_id == PARTY0:
            shares = [s + v for s, v in zip(self.shares, values)]
        else:
            shares = list(self.shares)
        macs = [m + alpha * v for m, v in zip(self.macs, values)]
        return AuthenticatedScalarVector(self.fabric, shares, macs)

    def mul_public(self, public) -> "AuthenticatedScalarVector":
        values = _as_public_list(public, len(self))
        return AuthenticatedScalarVector(
            self.fabric,
            [s * v for s, v in zip(self.shares, values)],
            [m * v for m, v in zip(self.macs, values)],
        )

    def __mul__(self, other):
        if isinstance(other, AuthenticatedScalarVector):
            return self.fabric.beaver_mul(self, other)
        return self.mul_public(other)

    __rmul__ = mul_public

    def sum(self) -> "AuthenticatedScalarVector":
        return AuthenticatedScalarVector(self.fabric, [Scalar(sum(int(s) for s in self.shares))],
                                         [Scalar(sum(int(m) for m in self.macs))])

    # -- openings -------------------------------------------------------------

    def open(self) -> list[Scalar]:
        return self.fabric.open_batch(self)

    def open_authenticated(self) -> list[Scalar]:
        return self.fabric.open_authenticated_batch(self)


class AuthenticatedPoint:
    """An authenticated secret-shared curve point (value and MAC shares)."""

    __slots__ = ("fabric", "share", "mac")

    def __init__(self, fabric: "MpcFabric", share: StarkPoint, mac: StarkPoint):
        self.fabric = fabric
        self.share = share
        self.mac = mac

    def __add__(self, other: "AuthenticatedPoint") -> "AuthenticatedPoint":
        return AuthenticatedPoint(self.fabric, self.share + other.share, self.mac + other.mac)

    def add_public(self, point: StarkPoint) -> "AuthenticatedPoint":
        share = self.share + point if self.fabric.party_id == PARTY0 else self.share
        return AuthenticatedPoint(self.fabric, share, self.mac + self.fabric.mac_key_share * point)

    def open(self) -> StarkPoint:
        return self.fabric.open_points([self])[0]

    def open_authenticated(self) -> StarkPoint:
        return self.fabric.open_authenticated_points([self])[0]


class MpcFabric:
    """One party's MPC runtime (eager, round-batched).  Its MSMs and device
    share vectors run on ``device`` (the card unless the caller asks for
    the CPU); a card asked for and missing raises."""

    def __init__(self, network: TwoPartyNetwork, beaver_source: SharedValueSource, *,
                 device="cuda"):
        self.net = network
        self.beaver = beaver_source
        self.party_id = network.party_id
        self.mac_key_share = beaver_source.mac_key_share()
        self.device = resolve_device(device)
        self.mac_key_words = None  # its (NW, 1) words on the device (device_shares), made at first use

    def _vector(self, pairs) -> AuthenticatedScalarVector:
        return AuthenticatedScalarVector(self, [s for s, _ in pairs], [m for _, m in pairs])

    # -- allocation and sharing ------------------------------------------------

    def batch_share_scalars(self, values: Sequence[Scalar] | None, owner: int,
                            count: int | None = None) -> AuthenticatedScalarVector:
        """Secret-share ``values`` held by ``owner``; the other party passes
        ``None`` and the expected ``count``.  The owner knows the plain mask
        ``r`` of an SPDZ input tuple ``[r]`` and broadcasts ``x - r``;
        ``[x] = [r] + (x - r)``."""
        if self.party_id == owner:
            if values is None:
                raise MPCError("owner must supply values")
            k = len(values)
        else:
            if count is None:
                raise MPCError("non-owner must supply the expected count")
            k = count
        masks, plain = self.beaver.next_input_mask_batch(k, owner)
        if self.party_id == owner:
            deltas = [x - r for x, r in zip(values, plain)]
            self.net.send_bytes(_pack_scalars(deltas))
        else:
            deltas = _unpack_scalars(self.net.recv_bytes())
        return self._vector(masks).add_public(deltas)

    def share_scalar(self, value: Scalar | None, owner: int) -> AuthenticatedScalarVector:
        return self.batch_share_scalars([value] if value is not None else None, owner, count=1)

    def zeros_authenticated(self, k: int) -> AuthenticatedScalarVector:
        zero = Scalar(0)
        return AuthenticatedScalarVector(self, [zero] * k, [zero] * k)

    def one_authenticated(self) -> AuthenticatedScalarVector:
        return self.zeros_authenticated(1).add_public([Scalar(1)])

    def random_shared_scalars_authenticated(self, k: int) -> AuthenticatedScalarVector:
        return self._vector(self.beaver.next_shared_value_batch(k))

    def allocate_scalars(self, values: Sequence[Scalar]) -> AuthenticatedScalarVector:
        """Public constants in authenticated form (both parties know them)."""
        return self.zeros_authenticated(len(values)).add_public(list(values))

    def authenticate_preshared(self, raw_shares: Sequence[Scalar]) -> AuthenticatedScalarVector:
        """MACs for values the parties already hold as plain additive shares:
        open ``x - r`` against an authenticated random mask (one exchange)."""
        mask_vec = self._vector(self.beaver.next_shared_value_batch(len(raw_shares)))
        delta_shares = [x - r for x, r in zip(raw_shares, mask_vec.shares)]
        theirs = self.exchange_scalars(delta_shares)
        return mask_vec.add_public([a + b for a, b in zip(delta_shares, theirs)])

    def share_point(self, point: StarkPoint | None, owner: int) -> AuthenticatedPoint:
        """Secret-share a curve point held by ``owner``: the input tuple of
        :meth:`batch_share_scalars` in the group; the owner broadcasts
        ``P - r G`` and the mask point is ``([r] G, [alpha r] G)``."""
        gen = StarkPoint.generator()
        masks, plain = self.beaver.next_input_mask_batch(1, owner)
        mask_share, mask_mac = masks[0]
        mask_pt = AuthenticatedPoint(self, mask_share * gen, mask_mac * gen)
        if self.party_id == owner:
            if point is None:
                raise MPCError("owner must supply the point")
            delta = point + (-(plain[0] * gen))
            self.net.send_bytes(_pack_points([delta]))
        else:
            delta = _unpack_points(self.net.recv_bytes())[0]
        return mask_pt.add_public(delta)

    # -- raw exchange -------------------------------------------------------------

    def exchange_scalars(self, values: Sequence[Scalar]) -> list[Scalar]:
        return _unpack_scalars(self.net.exchange_bytes(_pack_scalars(values)))

    def exchange_points(self, points: Sequence[StarkPoint]) -> list[StarkPoint]:
        return _unpack_points(self.net.exchange_bytes(_pack_points(points)))

    def send_scalars(self, values: Sequence[Scalar]) -> None:
        self.net.send_bytes(_pack_scalars(values))

    def receive_scalars(self) -> list[Scalar]:
        return _unpack_scalars(self.net.recv_bytes())

    # -- opening --------------------------------------------------------------------

    def open_batch(self, vec: AuthenticatedScalarVector) -> list[Scalar]:
        theirs = self.exchange_scalars(vec.shares)
        return [a + b for a, b in zip(vec.shares, theirs)]

    def _committed_exchange(self, payload: bytes) -> bytes:
        """Commit-then-reveal exchange of ``payload``: both parties exchange
        ``keccak256(payload || salt)`` before the payloads, so neither can
        choose its message after seeing the other's.  Raises on a
        commitment mismatch."""
        salt = os.urandom(32)
        their_commit = self.net.exchange_bytes(keccak256(payload + salt))
        their_blob = self.net.exchange_bytes(payload + salt)
        if len(their_blob) < 32 or keccak256(their_blob) != their_commit:
            raise AuthenticationError("commitment mismatch in MAC-check reveal")
        return their_blob[:-32]

    def open_authenticated_batch(self, vec: AuthenticatedScalarVector) -> list[Scalar]:
        opened = self.open_batch(vec)
        sigmas = [m - self.mac_key_share * v for m, v in zip(vec.macs, opened)]
        their_sigmas = _unpack_scalars(self._committed_exchange(_pack_scalars(sigmas)))
        if len(their_sigmas) != len(sigmas):
            raise AuthenticationError("MAC check reveal length mismatch")
        for mine, theirs in zip(sigmas, their_sigmas):
            if not (mine + theirs).is_zero():
                raise AuthenticationError("MAC check failed on opening")
        return opened

    def open_points(self, pts: Sequence[AuthenticatedPoint]) -> list[StarkPoint]:
        theirs = self.exchange_points([p.share for p in pts])
        return [mine.share + other for mine, other in zip(pts, theirs)]

    def open_authenticated_points(self, pts: Sequence[AuthenticatedPoint]) -> list[StarkPoint]:
        opened = self.open_points(pts)
        sigmas = [p.mac - self.mac_key_share * v for p, v in zip(pts, opened)]
        their_sigmas = _unpack_points(self._committed_exchange(_pack_points(sigmas)))
        if len(their_sigmas) != len(sigmas):
            raise AuthenticationError("MAC check reveal length mismatch")
        for mine, theirs in zip(sigmas, their_sigmas):
            if not (mine + theirs).is_identity():
                raise AuthenticationError("MAC check failed on point opening")
        return opened

    # -- multiplication ----------------------------------------------------------------

    def beaver_mul(self, x: AuthenticatedScalarVector,
                   y: AuthenticatedScalarVector) -> AuthenticatedScalarVector:
        """Elementwise products, one triple per element and one batched open
        round of all ``(x - a, y - b)``: ``z = c + d b + e a + d e``."""
        k = len(x)
        if len(y) != k:
            raise MPCError("beaver_mul length mismatch")
        a_raw, b_raw, c_raw = self.beaver.next_triplet_batch(k)
        a, b, c = self._vector(a_raw), self._vector(b_raw), self._vector(c_raw)
        opened = self.open_batch(AuthenticatedScalarVector.concat([x - a, y - b]))
        d, e = opened[:k], opened[k:]
        z = c + b.mul_public(d) + a.mul_public(e)
        return z.add_public([di * ei for di, ei in zip(d, e)])

    def inner_product(self, x: AuthenticatedScalarVector,
                      y: AuthenticatedScalarVector) -> AuthenticatedScalarVector:
        """``<x, y>`` as a length-1 authenticated vector (one Beaver round)."""
        return self.beaver_mul(x, y).sum()

    # -- MSMs with shared scalars over public points ---------------------------------

    def shared_msm(self, scalars: AuthenticatedScalarVector,
                   points: Sequence[StarkPoint]) -> AuthenticatedPoint:
        """MSM of shared scalars over public points: local to each party.
        The share row and the MAC row are two MSMs over the same points,
        each through :func:`..ops.backend.dispatch_msm` on the fabric's
        device (host Pippenger below its size limit)."""
        from ..ops import backend

        pts = list(points)
        share = backend.dispatch_msm(scalars.shares, pts, device=self.device)
        mac = backend.dispatch_msm(scalars.macs, pts, device=self.device)
        return AuthenticatedPoint(self, share, mac)

    def shared_gens_msm(self, scalars: AuthenticatedScalarVector, bp_gens, lead, n: int, *,
                        lo: int = 0, with_h: bool = True) -> AuthenticatedPoint:
        """:meth:`shared_msm` over ``lead + G(n)[lo:] (+ H(n)[lo:])`` of
        ``bp_gens``' first party, both rows through
        :func:`..ops.backend.gens_msm` (the cached generator tensors on the
        device, the route picked by size)."""
        from ..ops import backend

        kw = dict(lo=lo, with_h=with_h, device=self.device)
        share = backend.gens_msm(bp_gens, scalars.shares, lead, n, **kw)
        mac = backend.gens_msm(bp_gens, scalars.macs, lead, n, **kw)
        return AuthenticatedPoint(self, share, mac)

    def shutdown(self) -> None:
        self.net.close()


def _as_public_list(public, k: int) -> list[Scalar]:
    if isinstance(public, Scalar):
        return [public] * k
    if isinstance(public, int):
        return [Scalar(public)] * k
    values = list(public)
    if len(values) != k:
        raise MPCError("public operand length mismatch")
    return [v if isinstance(v, Scalar) else Scalar(v) for v in values]
