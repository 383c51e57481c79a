"""The port's field layer (ops/limb.py) against the JAX package's limb layer
and the exact Python-int scalar field, for FP and FR.

Inputs are made from a seeded numpy generator and include the edge values
0, 1, m - 1, m - 2 and values near 2^252; the comparison is on canonical
integers."""

import os

import numpy as np
import pytest
import torch


from mpc_bulletproof_tpu.ops import field as jfield
from mpc_bulletproof_tpu.ops import limb as jlimb
from mpc_bulletproof_tpu_torch.ops import limb
from mpc_bulletproof_tpu_torch.ops import field as tfield

# Under pytest-xdist several worker processes share the cores: split them,
# or torch's default of one intra-op thread per core in every worker
# oversubscribes the machine.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

FIELDS = {"FP": (limb.FP, jlimb.FP), "FR": (limb.FR, jlimb.FR)}


def _values(m: int, k: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**63, size=(k, 4), dtype=np.int64).tolist()
    rand = [sum(w << (63 * i) for i, w in enumerate(ws)) % m for ws in words]
    near = [(1 << 252) % m, m - (1 << 200), (1 << 251) - 1]
    return [0, 1, m - 1, m - 2] + near + rand


def _port(vals):
    return torch.as_tensor(limb.ints_to_words(vals))


def _jax(vals):
    return jlimb.ints_to_limbs(vals)


@pytest.mark.parametrize("name", ["FP", "FR"])
def test_mul_add_sub_match_jax_and_ints(name):
    mp, jmp = FIELDS[name]
    m = mp.modulus
    xs = _values(m, 41, 1)
    ys = list(reversed(_values(m, 41, 2)))
    a, b = _port(xs), _port(ys)
    ja, jb = _jax(xs), _jax(ys)
    want = [x * y % m for x, y in zip(xs, ys)]
    assert limb.words_to_ints(limb.mod_mul(a, b, mp)) == want
    assert jlimb.limbs_to_ints(np.asarray(jlimb.mod_mul(ja, jb, jmp))) == want
    assert limb.words_to_ints(limb.mod_add(a, b, mp)) == [(x + y) % m for x, y in zip(xs, ys)]
    assert limb.words_to_ints(limb.mod_sub(a, b, mp)) == [(x - y) % m for x, y in zip(xs, ys)]
    assert limb.words_to_ints(limb.mod_neg(a, mp)) == [(-x) % m for x in xs]


@pytest.mark.parametrize("name", ["FP", "FR"])
def test_reductions_and_powers(name):
    mp, jmp = FIELDS[name]
    m = mp.modulus
    xs = _values(m, 60, 3)
    ys = _values(m, 60, 4)
    a, b = _port(xs), _port(ys)
    ip = limb.words_to_ints(limb.inner_product_mod(a, b, mp)[:, None])[0]
    assert ip == sum(x * y for x, y in zip(xs, ys)) % m
    if name == "FR":  # the prover's inner products are over FR
        jip = np.asarray(jlimb.inner_product_mod(_jax(xs), _jax(ys), jmp))[:, None]
        assert ip == jlimb.limbs_to_ints(jip)[0]
    assert limb.words_to_ints(limb.sum_mod(a, mp)[:, None]) == [sum(xs) % m]
    x = xs[10]
    pw = limb.words_to_ints(limb.powers(a[:, 10], 19, mp))
    assert pw == [pow(x, i, m) for i in range(19)]


def test_broadcast_and_scalar_field_type():
    m = limb.FR.modulus
    xs = _values(m, 9, 5)
    a = _port(xs)
    u = _port([xs[7]])
    assert limb.words_to_ints(limb.mod_mul(a, u, limb.FR)) == [x * xs[7] % m for x in xs]
    # the port's host Scalar agrees with the JAX package's
    for x, y in zip(xs, reversed(xs)):
        ps, js = tfield.Scalar(x) * tfield.Scalar(y), jfield.Scalar(x) * jfield.Scalar(y)
        assert int(ps) == int(js)
        if x:
            assert int(tfield.Scalar(x).inverse()) == int(jfield.Scalar(x).inverse())
        assert tfield.Scalar(x).to_bytes_be() == jfield.Scalar(x).to_bytes_be()


def test_reduce_512_and_word_codec():
    rng = np.random.default_rng(6)
    vals = [int.from_bytes(rng.bytes(64), "little") for _ in range(20)] + [0, (1 << 512) - 1]
    pieces = torch.tensor([[(v >> (16 * i)) & 0xFFFF for v in vals] for i in range(32)])
    for mp in (limb.FP, limb.FR):
        assert limb.words_to_ints(limb.reduce_512(pieces, mp)) == [v % mp.modulus for v in vals]
    big = [(1 << 256) - 1, 1 << 255, 12345]
    assert limb.words_to_ints(_port(big)) == big
