"""The generator chains on tensors against the JAX package.

The port walks ``BulletproofGens``' chains with two kernels
(``kernels.keccak_chain``, ``kernels.keccak256_32``), whose plain versions
run here on CPU tensors: the plain batched keccak-f against the numpy and
pure-Python keccak of ``ops/keccak.py``, the device-route scalars against
the JAX package's ``GeneratorsChain``, the points against the JAX package's
``BulletproofGens`` point for point, and ``pinned.GENS_DIGESTS`` against
the JAX package's host path.  Exact equality of integers and bytes
throughout.  The kernels themselves are held to these plain versions on the
card (``tests/test_torch_generators_card.py``, ``chip_smoke.py``'s ``gens``
phase)."""

import numpy as np
import pytest
import torch

from mpc_bulletproof_tpu import BulletproofGens as JGens
from mpc_bulletproof_tpu.generators import GeneratorsChain as JChain
from mpc_bulletproof_tpu_torch import BulletproofGens, generators, pinned
from mpc_bulletproof_tpu_torch.constants import R
from mpc_bulletproof_tpu_torch.ops import curve_t, keccak, keccak_t, kernels, transcript_t
from mpc_bulletproof_tpu_torch.ops.limb import NW, words_to_ints

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _rows(seed: int, k: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (k, 32), dtype=np.uint8)


@pytest.mark.parametrize("n", [1, 3, 64])
def test_plain_keccak_f_matches_numpy_and_python(n):
    states = np.random.default_rng(n).integers(0, 1 << 64, (25, n), dtype=np.uint64)
    got = keccak_t.keccak_f1600(torch.as_tensor(states.view(np.int64))).numpy().view(np.uint64)
    assert np.array_equal(got, keccak._keccak_f1600_np(states))
    for j in range(n):
        assert [int(v) for v in got[:, j]] == keccak.keccak_f1600([int(v) for v in states[:, j]])
    # the transcript's one-state call keeps its (25,) shape
    one = keccak_t.keccak_f1600(torch.as_tensor(states[:, 0].view(np.int64)))
    assert one.shape == (25,) and np.array_equal(one.numpy().view(np.uint64), got[:, 0])


@pytest.mark.parametrize("n", [1, 3, 64])
def test_plain_keccak256_32_matches_numpy_and_python(n):
    msgs = _rows(100 + n, n)
    got = kernels.keccak256_32(torch.as_tensor(msgs))
    assert got.dtype == torch.uint8 and got.shape == (n, 32)
    assert np.array_equal(got.numpy(), keccak.keccak256_batch32(msgs))
    assert [bytes(r) for r in got.numpy()] == [keccak.keccak256(bytes(r)) for r in msgs]


@pytest.mark.parametrize("chains, skip, count", [(1, 0, 1), (3, 0, 5), (4, 6, 3), (2, 5, 0)])
def test_plain_keccak_chain_matches_python_walk(chains, skip, count):
    starts = _rows(chains + skip, chains)
    got = kernels.keccak_chain(torch.as_tensor(starts), skip, count)
    assert got.shape == (chains, count, 32) and got.dtype == torch.uint8
    for c in range(chains):
        s = bytes(starts[c])
        for _ in range(skip):
            s = keccak.keccak256(s)
        for i in range(count):
            s = keccak.keccak256(s)
            assert bytes(got[c, i].numpy()) == s


@pytest.mark.parametrize("label", [b"G\0\0\0\0", b"H\x05\0\0\0"])
@pytest.mark.parametrize("skip", [0, 7])
def test_device_route_chain_scalars_match_jax_chain(label, skip):
    want = [int(s) for s in JChain(label).fast_forward(skip).take_scalars(40)]
    for count in (1, 40):
        got = generators.chain_scalars([label], skip, count, CPU)
        assert got.shape == (NW, count)
        assert words_to_ints(got) == want[:count]


def test_chain_scalars_are_chain_major_over_labels():
    labels = [b"G\0\0\0\0", b"H\x05\0\0\0", b"G\x01\0\0\0"]
    got = words_to_ints(generators.chain_scalars(labels, 2, 3, CPU))
    want = [int(s) for l in labels for s in JChain(l).fast_forward(2).take_scalars(3)]
    assert got == want
    assert generators.chain_scalars(labels, 4, 0, CPU).shape == (NW, 0)


def test_bytes_to_scalar_mod_r_over_a_batch():
    raw = np.random.default_rng(9).integers(0, 256, (64, 5), dtype=np.uint8)
    raw[:, 0] = 255                                            # 2^512 - 1
    got = transcript_t.bytes_to_scalar_mod_r(torch.as_tensor(raw.astype(np.int64)))
    assert got.shape == (NW, 5)
    assert words_to_ints(got) == [int.from_bytes(bytes(raw[:, j]), "little") % R for j in range(5)]
    one = transcript_t.bytes_to_scalar_mod_r(torch.as_tensor(raw[:, 1].astype(np.int64)))
    assert one.shape == (NW, 1) and torch.equal(one[:, 0], got[:, 1])


def _same_points(mine, theirs) -> bool:
    return [p.to_bytes() for p in mine] == [p.to_bytes() for p in theirs]


def test_bulletproof_gens_and_increase_capacity_match_jax():
    gens, jgens = BulletproofGens(8, 2, device="cpu"), JGens(8, 2)
    for grown in (False, True):
        if grown:
            gens.increase_capacity(24)
            jgens.increase_capacity(24)
        n = gens.gens_capacity
        assert n == jgens.gens_capacity == (24 if grown else 8)
        for j in range(2):
            assert _same_points(gens.G_vec[j], jgens.G_vec[j])
            assert _same_points(gens.H_vec[j], jgens.H_vec[j])
        # the device routes read the tensors the host lists were built from
        for m in (1, 2):
            G, H = generators.device_gens(gens, n, m, CPU)
            assert torch.equal(G, torch.as_tensor(curve_t.points_from_host(gens.G(n, m))))
            assert torch.equal(H, torch.as_tensor(curve_t.points_from_host(gens.H(n, m))))
    G, _ = generators.device_gens(gens, 5, 1, CPU)
    assert torch.equal(G, torch.as_tensor(curve_t.points_from_host(gens.G(5, 1))))
    with pytest.raises(ValueError, match="exceed the capacity"):
        generators.device_gens(gens, 25, 1, CPU)


@pytest.mark.parametrize("key", [(2, 1), (8, 1), (64, 1)])
def test_pinned_gens_digest_is_the_jax_package_gens(key):
    """chip_smoke.py holds the card's generators to these digests."""
    n, m = key
    g = JGens(n, m)
    G = [g.G_vec[j][i] for j in range(m) for i in range(n)]
    H = [g.H_vec[j][i] for j in range(m) for i in range(n)]
    assert pinned.gens_digest(G, H) == pinned.GENS_DIGESTS[key]


@pytest.mark.parametrize("key", [(2, 1), (8, 1)])
def test_port_gens_give_the_pinned_digest(key):
    n, m = key
    gens = BulletproofGens(n, m, device="cpu")
    assert pinned.gens_digest(gens.G(n, m), gens.H(n, m)) == pinned.GENS_DIGESTS[key]


def test_keccak_wrappers_check_their_operands():
    rows = torch.zeros((2, 32), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        kernels.keccak256_32(rows.to(torch.int64))
    with pytest.raises(ValueError, match=r"\(k, 32\)"):
        kernels.keccak_chain(torch.zeros((2, 31), dtype=torch.uint8), 0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.keccak256_32(torch.zeros((32, 2), dtype=torch.uint8).T)
    with pytest.raises(ValueError, match=">= 0"):
        kernels.keccak_chain(rows, -1, 1)


def test_keccak_wrappers_launch_for_card_tensors(monkeypatch):
    """On a card tensor the wrappers launch the kernel (recorded here with
    the device check patched) with the entry points' arguments, and skip
    the launch when there is nothing to compute."""
    calls = []
    monkeypatch.setattr(kernels, "_check_rows32", lambda t, what: "cuda")
    monkeypatch.setattr(kernels, "_launch", lambda name, device, *args: calls.append((name, args)))
    starts = torch.zeros((3, 32), dtype=torch.uint8)
    out = kernels.keccak_chain(starts, 5, 7)
    assert out.shape == (3, 7, 32)
    assert calls == [("keccak_chain", (starts.data_ptr(), out.data_ptr(), 3, 5, 7))]
    out = kernels.keccak256_32(starts)
    assert calls[-1] == ("keccak256_32", (starts.data_ptr(), out.data_ptr(), 3))
    kernels.keccak_chain(starts, 5, 0)
    kernels.keccak256_32(starts[:0])
    assert len(calls) == 2
    assert kernels.KERNELS["keccak_chain"][0] == kernels.KERNELS["keccak256_32"][0] == "keccak.cu"


def test_bulletproof_gens_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BulletproofGens(2, 1)
