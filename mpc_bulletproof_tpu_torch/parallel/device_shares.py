"""Authenticated share vectors on the device: the MPC device share plane.

A :class:`DeviceShareVector` is one party's view of k authenticated shares
as a pair of ``(NW, k)`` int64 word tensors (value shares and MAC shares)
on the fabric's device, in canonical standard form (not Montgomery form),
so :func:`..ops.limb.words_to_ints` and the MAC check read the integers
directly.  Every FR operation runs on the hand-written kernels of
``csrc/vec2.cu`` on a CUDA device, their plain versions on the CPU:
``+``, ``-``, ``add_public``, ``mul_public``, an opening's sum and the MAC
check are one elementwise launch a row (:func:`..ops.kernels.vec_mul`,
``vec_add``, ``vec_sub``); a Beaver round is three launches (the
difference :func:`..ops.kernels.beaver_diff`, the opening's sum, the
combination :func:`..ops.kernels.beaver_combine`) and a degree-3
evaluation one (:meth:`DeviceShareVector.poly3`,
:func:`..ops.kernels.poly3_eval`).  The triple and the coefficients go up
as one stack of share pairs each; the MAC key share's words are made
once a fabric.  ``sum`` is :func:`..ops.limb.sum_mod` in plain torch.
Openings ship the raw word bytes over the party link.

The host :class:`~.fabric.AuthenticatedScalarVector` is the golden model;
:meth:`DeviceShareVector.from_host` and :meth:`DeviceShareVector.to_host`
convert between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels, limb
from ..ops.field import Scalar
from ..ops.limb import FR
from ..utils.errors import AuthenticationError, MPCError
from .fabric import AuthenticatedScalarVector, MpcFabric


def _words_np(values) -> np.ndarray:
    """Scalars (or ints in ``[0, r)``) -> ``(NW, k)`` words."""
    return limb.ints_to_words([int(v) for v in values])


def _words(values, device) -> torch.Tensor:
    return torch.as_tensor(_words_np(values), device=device)


def _pair_stack(pairs, device) -> torch.Tensor:
    """``[(shares, macs), ...]`` of k scalars each -> one ``(len, 2, NW, k)``
    tensor on ``device``, one upload."""
    return torch.as_tensor(np.stack([np.stack([_words_np(s), _words_np(m)]) for s, m in pairs]), device=device)


def _alpha(fabric: MpcFabric) -> torch.Tensor:
    """The fabric's MAC key share as ``(NW, 1)`` words, made once a fabric."""
    if fabric.mac_key_words is None:
        fabric.mac_key_words = _words([fabric.mac_key_share], fabric.device)
    return fabric.mac_key_words


class DeviceShareVector:
    """Authenticated secret shares as device word tensors (this party's view)."""

    __slots__ = ("fabric", "shares", "macs")

    def __init__(self, fabric: MpcFabric, shares, macs):
        self.fabric = fabric
        self.shares = torch.as_tensor(shares, device=fabric.device).contiguous()
        self.macs = torch.as_tensor(macs, device=fabric.device).contiguous()

    # -- conversion -----------------------------------------------------------

    @staticmethod
    def from_host(vec: AuthenticatedScalarVector) -> "DeviceShareVector":
        dev = vec.fabric.device
        return DeviceShareVector(vec.fabric, _words(vec.shares, dev), _words(vec.macs, dev))

    def to_host(self) -> AuthenticatedScalarVector:
        return AuthenticatedScalarVector(self.fabric,
                                         [Scalar(v) for v in limb.words_to_ints(self.shares)],
                                         [Scalar(v) for v in limb.words_to_ints(self.macs)])

    def __len__(self) -> int:
        return int(self.shares.shape[-1])

    def __getitem__(self, idx):
        if not isinstance(idx, slice):
            idx = slice(idx, idx + 1)
        return DeviceShareVector(self.fabric, self.shares[:, idx], self.macs[:, idx])

    @staticmethod
    def concat(parts) -> "DeviceShareVector":
        parts = list(parts)
        return DeviceShareVector(parts[0].fabric, torch.cat([p.shares for p in parts], dim=-1),
                                 torch.cat([p.macs for p in parts], dim=-1))

    def _public(self, values) -> torch.Tensor:
        """A public operand: ``(NW, 1)`` for one scalar, else ``(NW, k)``."""
        if isinstance(values, (Scalar, int)):
            return _words([values], self.fabric.device)
        values = list(values)
        if len(values) != len(self):
            raise MPCError("public operand length mismatch")
        return _words(values, self.fabric.device)

    # -- linear (local) algebra -----------------------------------------------

    def __add__(self, other: "DeviceShareVector") -> "DeviceShareVector":
        return DeviceShareVector(self.fabric, kernels.vec_add(self.shares, other.shares, FR),
                                 kernels.vec_add(self.macs, other.macs, FR))

    def __sub__(self, other: "DeviceShareVector") -> "DeviceShareVector":
        return DeviceShareVector(self.fabric, kernels.vec_sub(self.shares, other.shares, FR),
                                 kernels.vec_sub(self.macs, other.macs, FR))

    def add_public(self, values) -> "DeviceShareVector":
        """Add public constants: party 0 changes its shares, both their MACs."""
        pub = self._public(values)
        shares = self.shares
        if self.fabric.party_id == 0:
            shares = kernels.vec_add(shares, pub, FR)
        macs = kernels.vec_add(self.macs, kernels.vec_mul(pub, _alpha(self.fabric), FR), FR)
        return DeviceShareVector(self.fabric, shares, macs)

    def mul_public(self, values) -> "DeviceShareVector":
        """Multiply by public scalars (one scalar broadcasts over the lanes)."""
        pub = self._public(values)
        return DeviceShareVector(self.fabric, kernels.vec_mul(self.shares, pub, FR),
                                 kernels.vec_mul(self.macs, pub, FR))

    def sum(self) -> "DeviceShareVector":
        return DeviceShareVector(self.fabric, limb.sum_mod(self.shares, FR)[:, None],
                                 limb.sum_mod(self.macs, FR)[:, None])

    # -- communication rounds (raw words over the party link) ------------------

    def _exchange_words(self, t: torch.Tensor, exchange, error) -> torch.Tensor:
        """The peer's words of the shape of ``t``, ``t``'s raw bytes sent by
        ``exchange``; a reply of another length raises ``error``."""
        mine = np.ascontiguousarray(t.cpu().numpy(), dtype=np.int64)
        theirs = exchange(mine.tobytes())
        if len(theirs) != mine.nbytes:
            raise error("share exchange length mismatch")
        arr = np.frombuffer(theirs, dtype=np.int64).reshape(mine.shape)
        return torch.as_tensor(arr.copy(), device=self.fabric.device)

    def _open_words(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of this party's ``(NW, k)`` share words ``t`` and the peer's."""
        theirs = self._exchange_words(t, self.fabric.net.exchange_bytes, MPCError)
        return kernels.vec_add(t, theirs, FR)

    def open(self) -> torch.Tensor:
        """Plain opening: the ``(NW, k)`` canonical words of the values."""
        return self._open_words(self.shares)

    def open_authenticated(self) -> torch.Tensor:
        """MAC-checked opening with the fabric's commit-then-reveal round on
        the sigmas; raises :class:`AuthenticationError`."""
        opened = self.open()
        sigma = kernels.vec_sub(self.macs, kernels.vec_mul(opened, _alpha(self.fabric), FR), FR)
        their_sigma = self._exchange_words(sigma, self.fabric._committed_exchange, AuthenticationError)
        if bool(kernels.vec_add(sigma, their_sigma, FR).any()):
            raise AuthenticationError("MAC check failed on device opening")
        return opened

    def beaver_mul(self, other: "DeviceShareVector") -> "DeviceShareVector":
        """Elementwise products with one triple per lane and one batched open
        round of ``[x - a | y - b]`` (shares only: the opening reads no
        MAC); ``z = c + d b + e a + d e`` and its MAC in one launch."""
        fabric = self.fabric
        k = len(self)
        if len(other) != k:
            raise MPCError("beaver_mul length mismatch")
        triple = _pair_stack([([s for s, _ in t], [m for _, m in t])
                              for t in fabric.beaver.next_triplet_batch(k)], fabric.device)
        opened = self._open_words(kernels.beaver_diff(self.shares, other.shares, triple))
        z = kernels.beaver_combine(opened, triple, int(fabric.mac_key_share), fabric.party_id)
        return DeviceShareVector(fabric, z[0], z[1])

    @staticmethod
    def poly3(coeffs, x: Scalar) -> "DeviceShareVector":
        """``c0 + c1 x + c2 x^2 + c3 x^3`` at a public ``x`` for the host
        vectors ``coeffs = [c0, c1, c2, c3]``: one upload, one launch."""
        fabric = coeffs[0].fabric
        out = kernels.poly3_eval(_pair_stack([(c.shares, c.macs) for c in coeffs], fabric.device), int(x))
        return DeviceShareVector(fabric, out[0], out[1])

    def inner_product(self, other: "DeviceShareVector") -> "DeviceShareVector":
        return self.beaver_mul(other).sum()
