"""Pinned inputs and proof digests of the range prover and the R1CS shuffle.

Range proofs: the inputs are the deterministic ones of the JAX package's
fused-prover test: values and blindings from ``random.Random(909)`` and a
blinding stream of chained sha256 blocks.  :data:`DIGESTS` holds, per
``(n, m)``, the sha256 of ``proof bytes || V bytes || final transcript
state`` that the JAX package's host party/dealer path gives for them.

R1CS: a k-shuffle (:func:`shuffle_inputs`, the transcript of
:func:`shuffle_transcript`), its blinding RNG finalized with the first 32
bytes of :func:`det_stream`.  :data:`SHUFFLE_DIGESTS` holds, per k, the same
digest over the proof, the 2k commitments (inputs, then outputs) and the
final transcript state, from the JAX package's host prover.

Collaborative (2-party MPC) R1CS: :func:`mpc_range_party` is one party's
side of an m-value, n-bit range proof (party 0 owns the first half of
the values, party 1 the rest), on :func:`mpc_range_inputs` and the
transcript labelled :data:`MPC_LABEL`.  The deterministic pre-processing
(``PartyIdBeaverSource``) leaves nothing random in the opened proof.
:data:`MPC_RANGE_DIGESTS` holds, per ``(n, m)``, the same digest over the
opened proof, the m commitments and party 0's final transcript state,
from the JAX package's host path.  To recompute one (the (64, 64) one
takes a few seconds of CPU)::

    BP_FORCE_BACKEND=host JAX_PLATFORMS=cpu python -c \
        "from tests.test_torch_mpc import jax_mpc_range; print(jax_mpc_range(64, 64)[2])"

The inner-product argument alone: :func:`ipp_inputs` makes an n-wide
IPP's witness and generators from one fixed seed with numpy, the
generators with known discrete logs (``G_i = g_i B``, ``H_i = h_i B``, ``Q
= q B``, B the curve generator; ``G_factors`` all one, ``H_factors`` =
``y^-i``), so that wide inputs cost a fixed-base product each instead of a
walk of the keccak generator chains, which the proof does not depend on.
:data:`IPP_DIGESTS` holds, per n, the sha256 of ``proof bytes || final
transcript state`` (:func:`ipp_digest`, transcript labelled
:data:`IPP_LABEL`) from the JAX package's host ``InnerProductProof.create``.
To recompute them (n up to 2^16 takes about a minute of CPU with the JAX
package's native engine)::

    JAX_PLATFORMS=cpu python -c \
        "from tests.test_torch_ipp import jax_ipp_digest; print(jax_ipp_digest(1 << 16))"

The reference's sweeps (``chip_smoke.py``'s ``gens``, ``rp_sweep`` and
``r1cs_sweep`` phases) add four families, each from the JAX package's
host path with its native engine:

* :data:`GENS_DIGESTS`: per ``(n, m)``, :func:`gens_digest` of the affine
  points of ``BulletproofGens(n, m)`` (2^17 takes ~70 s)::

    JAX_PLATFORMS=cpu python -c "from mpc_bulletproof_tpu import BulletproofGens as B; \
        from mpc_bulletproof_tpu_torch import pinned; n, m = 1 << 17, 1; g = B(n, m); \
        pts = lambda v: [v[j][i] for j in range(m) for i in range(n)]; \
        print(pinned.gens_digest(pts(g.G_vec), pts(g.H_vec)))"

* :data:`DIGESTS` for config 1 (``(32, 1)``, :func:`single_inputs`) and
  config 2 at ``(64, m)``, m = 1 to 32, on :func:`inputs` as above::

    BP_FORCE_BACKEND=host JAX_PLATFORMS=cpu python -c "from tests.test_torch_range_proof \
        import jax_host_prove; from mpc_bulletproof_tpu_torch import pinned; \
        p, V, s, _ = jax_host_prove(32, 1); print(pinned.proof_digest(p, V, s))"

* :data:`SHUFFLE_DIGESTS` for k = 2 to 512 (and 1024 above)::

    JAX_PLATFORMS=cpu python -c "from tests.test_torch_sweeps import jax_shuffle_digest; \
        print(jax_shuffle_digest(512))"

* :data:`SQUARING_DIGESTS` for n = 2 to 1024: the R1CS bench's squaring
  chain (:func:`squaring_chain` on :func:`squaring_value`, from
  :func:`squaring_transcript`), the digest over the proof, no
  commitments and the final transcript state::

    JAX_PLATFORMS=cpu python -c "from tests.test_torch_sweeps import jax_squaring_digest; \
        print(jax_squaring_digest(1024))"

``chip_smoke.py`` holds the card's proofs to these digests, and the CPU
tests recompute them from the JAX package.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np

from .constants import R
from .ops.field import Scalar

TRANSCRIPT_LABEL = b"fused-rp"
SHUFFLE_LABEL = b"ShuffleProofTest"
MPC_LABEL = b"mpc-range"
IPP_LABEL = b"ipp-alone"
IPP_SEED = 1103
SQUARING_LABEL = b"r1cs-squaring"
SQUARING_SEED = 2718
SINGLE_VALUE = 1037578891  # the README's 32-bit range-proof secret
SINGLE_SEED = 3141

# (n, m) -> digest of the range proof on inputs(n, m)
DIGESTS = {
    (8, 2): "1f97185de6591a8a35c03ecf79378ba753cdf8182fd8eea9094da55091d8ec2c",
    (32, 1): "63ae4b6fa5a33b4506e3339292abe54e5e06827581101ef7ac0034393564db95",
    (64, 1): "edbac59c36524a396bceae417e3556851a697f0a9b7ab7ebab618221c03bb60a",
    (64, 2): "0fe30479ef28f770601c19d2735f80edf70f0119ae938c3dabad2377cab43922",
    (64, 4): "645529fb5e08ce8336735ce39539495e06d4f08b127010ced6ecb2a63e905346",
    (64, 8): "63c64981f3b363aea5e79db06ebd331e9a3b3d7887c93e1fd1aad0cf474c3353",
    (64, 16): "ae41ade269e93b69f557f13381ececdc9882a1a2697d3030993b7f1f8e0b418a",
    (64, 32): "716448e3387637b846204670325a23d675c5875e450e97ba606a04592de0ab89",
    (64, 64): "2f5823ea54cc5e9fb1e190f71d0b6c5cfde362ecbae7d94c1dcec34b7ebf1554",
}

# k -> digest of the k-shuffle proof on shuffle_inputs(k)
SHUFFLE_DIGESTS = {
    2: "31fa8cda39b0e22662f8c31988fd0689e95c0dfe3aa0f3452c5aa0ec5ae7184b",
    4: "6d8ce128ae5396c9ed4d3207fba0635980afc8360ca46308a7c749de8f72366a",
    8: "e1382b673117238e27ebb31468ebd671e323a124cd731c22304beb68d16339bd",
    16: "344e14748e5e33f48a3e520f89418346ee9199d7b01e59247405b40f7a35d2b8",
    32: "672d09865a62114e23de2ccf3a1832e882c9930e3f868641bbdc7607c9b7f80c",
    64: "876ad01999c28fcf4152deab8869134b15bb0258ea5beee11afa30cee35cb5f4",
    128: "7306a7fbed68be60a42508b3277b77716a5885d058eece109e650a988e2725fe",
    256: "a0e1cf6681794a5ba3ea30ed0f12832e69385f526ca2dd6aa54fa81cc737c670",
    512: "48070fd8b1447da91d6a12dc2fd39c27a7db4038e64db903a6a1b5c79855ec8b",
    1024: "6d443a4bd8c3020258ed1ab0698a145ac0ef0579d84826929cfba3dbcf6b7d17",
}

# n -> digest of the squaring chain of n multipliers (squaring_chain on
# squaring_value(), from squaring_transcript(n))
SQUARING_DIGESTS = {
    2: "7a8e625a56da83cb166816f71755d79c9f6fb3cce02dd655e6fb01d6f9cb157f",
    4: "08abb86f47a78fcca4dc12cf44eb714deb2b5854255f72bf3c9674efec6e22c8",
    8: "e259c0e788f55275ff531b328e8c9cd19678995280e27a8099ee15b7b393a3d4",
    16: "3275b4cf80649aed206227d5caf2e313760a820bee5e332de2938773ac46f142",
    32: "4ff1aaa796890cf6ea685d2ec84d5e3e2ce5ff7caa0cab131218de4c2482b85a",
    64: "0ff0041f4d69f75eea5ae73d14ee98020fc82c8f2d8e6088a6eceeaade1e6989",
    128: "f795ba68a0cd8b1cb0804f776518fdd7076b051797a12d7ae5687d7c599c52e7",
    256: "7ca71b50ed15359bb936a5d75beee8313689b8bcb7f27e5be32a2d33b226a975",
    512: "d392af5d51d02f5ef18efe7dbbd9754965baf8837b5cf0eb4f9e17e8d1c2fb85",
    1024: "d65ab22a3c197950b0ca18ce4c47df500170023ebc3ce64df30cf8f0d05465b5",
}

# (n, m) -> gens_digest(G(n, m), H(n, m)) of BulletproofGens(n, m)
GENS_DIGESTS = {
    (2, 1): "83e2da26b84a201a69f6df6d0387604e9a6c60dbdb422fbfdd719f9deee5c09a",
    (8, 1): "4036cf53f25be8c978e52e94ec04a170b772013ebfefa0728375d5632923f535",
    (64, 1): "6df0f1c503c9d40ff68d4621c82e1b93b8b78d87339ad334d6b02c9286d356e1",
    (64, 64): "2c63acb88bf1938d9a19aa4640fa7c02878afdf7b313079bde16b08fc429b152",
    (256, 1): "cb06af3d9bd6df48f5eadcd9de8b467413c1a8bfa2441247ff39eca8ce911345",
    (1024, 1): "6188136a0b39f4f62b10b6ab5931c18f4a0a4a7b5a86d6509aada2ee95a3291e",
    (1 << 17, 1): "a23a294a6eb21450f819c29a3369f2edf2195ea3a98c5573c108d550092bb3d8",
}


MPC_RANGE_DIGESTS = {
    (4, 2): "99799541d8825308e570fd3ef7281e4673587a8e419b9623f6b664efa6024e78",
    (8, 2): "da514356c3e56f6dad7761b9f3cdaaed65f141a9a4f1d9fa90fda11229faf0bb",
    (64, 64): "aff23d88bad49214ea128ce2962019dc8102b0e20e6f91127bf3ce9cb65286e1",
}

# n -> sha256(proof bytes || final transcript state) of the IPP alone on ipp_inputs(n)
IPP_DIGESTS = {
    2: "d4554d92fbb231ddb027c65e5e5c7431db8f42d716e907bd38b3a248e812cb0f",
    4: "25289e3b2ece834751bc056a14c5d4e0013e3b706da0894ff4d235d4772178ce",
    8: "691f6736b3ef3c72842016490477599ffe3dc958a57e2fb66ec2c70ddb1f4f3e",
    16: "c1513a76019e4a1efacbd45c3509742dba578b566bce9ffb1be454739fc8d406",
    32: "385c8051ad01a3c64e106042f13bd6d3b5963820ac9e11ff2bcd9f866ba2f084",
    64: "697cce42dd7f60c867f548f98abdde911173d48d3f6e3ac5536607c20b8e5c4f",
    128: "4bbe5b76c4e3e1e3f8aebba82f405748abf78054622b0d47e521c2ecd4e5d4ed",
    256: "01fd6b020764d77f6edd729b76049ddd73136a04691c73653ab1e075d64219f5",
    512: "1b48654ad8246965bb36ed767419cc93dc1ae58739aeb95959f1e58b9f502e3b",
    1024: "6ab831b6a58680b29f8d70df239f517e59333c589787c27afd4a4e3ac14c4cb1",
    2048: "da048731bf7f07550fedfe1dff7ea86abe0abef4b3109a88e5e49303ce51aab1",
    4096: "af6bfc226709fda2c5425aeab875d0024fd005877dc6a5bc11194795435b7cfa",
    8192: "41932e1ff1bc5bedd2e912409691582361e3d9c1772cb06ab598070a816455ea",
    16384: "6fdbebae2f3022476f38e515f23288a2084c06358ea47824e4a681dd96d283e1",
    32768: "23a0d8351a708bc067d6c318d4c74f2a534f42a9d2548f7a12d40d9b195cee8f",
    65536: "b15ac0fa92efb0b077fc1079ca7ecf4a4502e9f255c1d12210a4a37e8f6875e0",
}


def det_stream():
    """``rng_bytes(k)``: a deterministic blinding stream."""
    state = {"ctr": 0}

    def rng_bytes(k: int) -> bytes:
        out = b""
        while len(out) < k:
            out += hashlib.sha256(b"fused-test" + state["ctr"].to_bytes(4, "big")).digest()
            state["ctr"] += 1
        return out[:k]

    return rng_bytes


def inputs(n: int, m: int):
    """``(values, blindings)`` for an ``(n, m)`` proof: seeded, except for
    ``(32, 1)``, config 1's :func:`single_inputs`."""
    if (n, m) == (32, 1):
        return single_inputs()
    rng = random.Random(909)
    values = [rng.randrange(1 << n) for _ in range(m)]
    blindings = [Scalar(rng.getrandbits(251)) for _ in range(m)]
    return values, blindings


def shuffle_inputs(k: int):
    """``(inputs, outputs, blindings)`` of a k-shuffle: k values, the same
    values in a seeded permutation, and 2k blindings (inputs' first)."""
    rng = random.Random(4242)
    inputs = [Scalar(rng.getrandbits(251)) for _ in range(k)]
    perm = list(range(k))
    rng.shuffle(perm)
    outputs = [inputs[i] for i in perm]
    blindings = [Scalar(rng.getrandbits(251)) for _ in range(2 * k)]
    return inputs, outputs, blindings


def shuffle_transcript(k: int):
    """The transcript a k-shuffle proof starts from (prover and verifier)."""
    from .transcript import HashChainTranscript

    t = HashChainTranscript(SHUFFLE_LABEL)
    t.append_message(b"dom-sep", b"ShuffleProof")
    t.append_u64(b"k", k)
    return t


def proof_digest(proof, commitments, transcript_state: bytes) -> str:
    data = proof.to_bytes() + b"".join(v.to_bytes() for v in commitments) + transcript_state
    return hashlib.sha256(data).hexdigest()


def mpc_range_inputs(n: int, m: int):
    """``(values, blindings)`` of an m-value, n-bit collaborative range
    proof, as Python ints (either package's ``Scalar`` takes them)."""
    rng = random.Random(5150)
    values = [rng.randrange(1 << n) for _ in range(m)]
    blindings = [rng.getrandbits(251) for _ in range(m)]
    return values, blindings


def mpc_range_party(prover, fabric, n: int, values, blindings, scalar=Scalar):
    """Party ``fabric.party_id``'s side of the collaborative range proof on
    ``prover`` (an ``MpcProver`` over ``fabric``); returns the commitments.

    Each party commits the values it owns (party 0 the first half, party 1
    the rest) with one ``batch_commit``; per value its owner shares the n
    bit pairs ``(1 - b, b)`` in one ``batch_share_scalars`` call, and both
    parties allocate each pair as a multiplier and constrain ``a b = 0``,
    ``a + b = 1`` and ``v = sum b_i 2^i`` (the plain verifier's
    ``range_check_gadget``).  Only the owner reads ``values[j]`` and
    ``blindings[j]``.  ``scalar``: the ``Scalar`` class of the prover's
    package."""
    m = len(values)
    owned = [(0, range(m // 2)), (1, range(m // 2, m))]
    commitments, variables = [], []
    for owner, idx in owned:
        if fabric.party_id == owner:
            comms, vars_ = prover.batch_commit(owner, [scalar(values[j]) for j in idx],
                                               [scalar(blindings[j]) for j in idx])
        else:
            comms, vars_ = prover.batch_commit(owner, None, None, count=len(idx))
        commitments += comms
        variables += vars_
    for j, var in enumerate(variables):
        owner = 0 if j < m // 2 else 1
        bits = None
        if fabric.party_id == owner:
            bits = [scalar(x) for i in range(n) for x in (1 - (values[j] >> i & 1), values[j] >> i & 1)]
        pairs = fabric.batch_share_scalars(bits, owner, count=2 * n)
        lc = var.to_lc()
        exp_2 = scalar(1)
        for i in range(n):
            a, b, o = prover.allocate_multiplier((pairs[2 * i], pairs[2 * i + 1]))
            prover.constrain(o.to_lc())
            prover.constrain(a + (b - 1))
            lc = lc - b * exp_2
            exp_2 = exp_2 + exp_2
        prover.constrain(lc)
    return commitments


def ipp_inputs(n: int) -> dict:
    """The inputs of the n-wide IPP alone, from ``IPP_SEED`` with numpy:
    ``q`` and ``y`` (ints), then ``a``, ``b``, ``g``, ``h`` (``(NW, n)``
    int64 word arrays).  Every scalar is four random 64-bit words with the
    top one cut to 59 bits, so below ``2^251 < r``: reduced mod r."""
    rng = np.random.default_rng(IPP_SEED)

    def draw(k: int) -> np.ndarray:
        w = rng.integers(0, 1 << 64, size=(4, k), dtype=np.uint64, endpoint=False)
        w[3] &= np.uint64((1 << 59) - 1)
        return w.view(np.int64)

    qy = draw(2)
    q, y = (sum(int(qy[i, j]) % (1 << 64) << (64 * i) for i in range(4)) for j in range(2))
    return {"q": q, "y": y, **{name: draw(n) for name in ("a", "b", "g", "h")}}


def ipp_host_inputs(n: int, point_mul, scalar=Scalar) -> dict:
    """:func:`ipp_inputs` as host lists for ``InnerProductProof.create``:
    ``Q``, ``G_factors``, ``H_factors``, ``G``, ``H``, ``a``, ``b``.
    ``point_mul(ints)`` returns ``[k B for k in ints]`` as points of the
    prover's package; ``scalar`` is its ``Scalar`` class."""
    from .ops.limb import words_to_ints

    raw = ipp_inputs(n)
    y_inv = pow(raw["y"], -1, R)
    ints = {k: words_to_ints(raw[k]) for k in ("a", "b", "g", "h")}
    h_factors, cur = [], 1
    for _ in range(n):
        h_factors.append(scalar(cur))
        cur = cur * y_inv % R
    G, H = point_mul(ints["g"]), point_mul(ints["h"])
    return {"Q": point_mul([raw["q"]])[0], "G_factors": [scalar(1)] * n,
            "H_factors": h_factors, "G": G, "H": H,
            "a": [scalar(v) for v in ints["a"]], "b": [scalar(v) for v in ints["b"]]}


def ipp_device_inputs(n: int, device) -> dict:
    """:func:`ipp_inputs` on ``device``: the keys of :func:`ipp_host_inputs`,
    ``Q`` a host point, every vector a tensor (``(NW, n)`` scalars, ``(3,
    NW, n)`` points made there by :func:`..generators.fixed_base_points`)."""
    import torch

    from .generators import fixed_base_points
    from .ops import limb
    from .ops.curve import StarkPoint

    raw = ipp_inputs(n)
    t = lambda w: torch.as_tensor(w, device=device)
    B = StarkPoint.generator()
    y_inv = t(limb.ints_to_words([pow(raw["y"], -1, R)]))[:, 0]
    return {"Q": B.scalar_mul(Scalar(raw["q"])),
            "G_factors": limb.from_const(1, (n,), device).contiguous(),
            "H_factors": limb.powers(y_inv, n, limb.FR).contiguous(),
            "G": fixed_base_points(t(raw["g"]), B), "H": fixed_base_points(t(raw["h"]), B),
            "a": t(raw["a"]), "b": t(raw["b"])}


def ipp_digest(proof, transcript_state: bytes) -> str:
    return hashlib.sha256(proof.to_bytes() + transcript_state).hexdigest()


def single_inputs():
    """``(values, blindings)`` of the 32-bit single range proof:
    :data:`SINGLE_VALUE` and a blinding drawn from :data:`SINGLE_SEED`."""
    return [SINGLE_VALUE], [Scalar(random.Random(SINGLE_SEED).getrandbits(251))]


def squaring_value() -> int:
    """The public value the squaring chain starts from."""
    return random.Random(SQUARING_SEED).getrandbits(251)


def squaring_chain(cs, n_constraints: int, value) -> None:
    """The R1CS benchmark circuit: ``value`` committed as a public input,
    then squared ``n_constraints`` times, each square one multiplier.
    ``cs`` is a prover or verifier of either package, ``value`` a
    ``Scalar`` of its package."""
    var = cs.commit_public(value)
    for _ in range(n_constraints):
        _, _, var = cs.multiply(var.to_lc(), var.to_lc())


def squaring_transcript(n: int, transcript_cls=None):
    """The transcript a squaring-chain proof of ``n`` multipliers starts
    from (prover and verifier); ``transcript_cls``: the package's
    ``HashChainTranscript``, by default the port's."""
    if transcript_cls is None:
        from .transcript import HashChainTranscript as transcript_cls
    t = transcript_cls(SQUARING_LABEL)
    t.append_u64(b"n", n)
    return t


def gens_digest(G, H) -> str:
    """sha256 of the affine ``x || y`` (32 bytes each, big-endian) of every
    point of G, then of H: one generator set's fingerprint."""
    h = hashlib.sha256()
    for p in list(G) + list(H):
        h.update(p.x.to_bytes(32, "big") + p.y.to_bytes(32, "big"))
    return h.hexdigest()
