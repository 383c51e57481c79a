"""Pre-processing (Beaver triple) sources.

The port's copy of the JAX package's ``parallel/beaver.py``: the
``SharedValueSource`` interface (shared bits, values, inverse pairs,
triples, MAC-key shares, SPDZ input masks) and the deterministic,
**insecure** :class:`PartyIdBeaverSource` that tests and benches use.  A
deployment plugs in a real offline phase.
"""

from __future__ import annotations

import abc

from ..ops.field import Scalar

PARTY0 = 0
PARTY1 = 1


class SharedValueSource(abc.ABC):
    """A source of pre-shared values for one party."""

    @abc.abstractmethod
    def mac_key_share(self) -> Scalar:
        """This party's additive share of the global MAC key alpha."""

    @abc.abstractmethod
    def next_triplet_batch(self, k: int):
        """``k`` Beaver triples: three lists of (share, mac_share) pairs
        for [a], [b], [c] with c = a * b."""

    @abc.abstractmethod
    def next_shared_value_batch(self, k: int):
        """``k`` random authenticated shares (blinding factors)."""

    @abc.abstractmethod
    def next_shared_bit_batch(self, k: int):
        """``k`` authenticated shared bits."""

    @abc.abstractmethod
    def next_shared_inverse_pair_batch(self, k: int):
        """``k`` pairs ([r], [r^-1])."""

    @abc.abstractmethod
    def next_input_mask_batch(self, k: int, owner: int):
        """``k`` SPDZ input tuples for ``owner``: a list of (share,
        mac_share) pairs of authenticated random values [r], and for the
        owner only the list of the plain ``r`` (``None`` for the other
        party).  Sharing an input is then one broadcast of ``x - r``."""

    def next_triplet(self):
        a, b, c = self.next_triplet_batch(1)
        return a[0], b[0], c[0]

    def next_shared_value(self):
        return self.next_shared_value_batch(1)[0]

    def next_shared_bit(self):
        return self.next_shared_bit_batch(1)[0]

    def next_shared_inverse_pair(self):
        r, rinv = self.next_shared_inverse_pair_batch(1)
        return r[0], rinv[0]


class PartyIdBeaverSource(SharedValueSource):
    """Deterministic, **insecure** source: triples [a] = (1, 1), [b] = (3,
    0), [c] = (2, 4), so a = 2, b = 3, c = 6; MAC key alpha = 13 + 29 = 42.
    MAC shares: party 0 holds ``alpha v - 11``, party 1 holds ``11``."""

    _ALPHA0 = Scalar(13)
    _ALPHA1 = Scalar(29)
    _ALPHA = Scalar(42)
    _MAC_SPLIT = Scalar(11)

    def __init__(self, party_id: int):
        if party_id not in (PARTY0, PARTY1):
            raise ValueError("party_id must be 0 or 1")
        self.party_id = party_id

    def mac_key_share(self) -> Scalar:
        return self._ALPHA0 if self.party_id == PARTY0 else self._ALPHA1

    def _auth_share(self, value: Scalar, my_share: Scalar):
        """(share, mac_share) of this party for the global ``value``."""
        mac = self._ALPHA * value
        if self.party_id == PARTY0:
            return (my_share, mac - self._MAC_SPLIT)
        return (my_share, self._MAC_SPLIT)

    def next_triplet_batch(self, k: int):
        if self.party_id == PARTY0:
            a = [self._auth_share(Scalar(2), Scalar(1))] * k
            b = [self._auth_share(Scalar(3), Scalar(3))] * k
            c = [self._auth_share(Scalar(6), Scalar(2))] * k
        else:
            a = [self._auth_share(Scalar(2), Scalar(1))] * k
            b = [self._auth_share(Scalar(3), Scalar(0))] * k
            c = [self._auth_share(Scalar(6), Scalar(4))] * k
        return a, b, c

    def _ones(self, k: int):
        share = Scalar(1) if self.party_id == PARTY0 else Scalar(0)
        return [self._auth_share(Scalar(1), share)] * k

    def next_shared_value_batch(self, k: int):
        return self._ones(k)

    def next_shared_bit_batch(self, k: int):
        return self._ones(k)

    def next_shared_inverse_pair_batch(self, k: int):
        pairs = self._ones(k)
        return pairs, list(pairs)

    def next_input_mask_batch(self, k: int, owner: int):
        plain = [Scalar(1)] * k if self.party_id == owner else None
        return self._ones(k), plain
