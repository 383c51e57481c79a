"""The port's device mesh (``parallel/sharded.py``) and the routes through
it, on virtual CPU meshes (``Mesh([cpu] * k)``) and the plain versions of
the kernels.

The JAX package's own sharded ops are not run here: on its 8-device CPU
mesh they take minutes at these sizes.  The port is held instead to the
JAX package's exact host layer (``StarkPoint.msm``, its curve, Python
ints) and to its host party/dealer proof bytes, the reference its own
sharded prover test uses.  Every comparison is exact on canonical
integers or bytes.  Also the launch repair the mesh needs: a kernel
launches on its operand's card.
"""

import contextlib
import os
import random
import types

import pytest
import torch

from mpc_bulletproof_tpu import BulletproofGens as JGens
from mpc_bulletproof_tpu import HashChainTranscript as JTranscript
from mpc_bulletproof_tpu import PedersenGens as JPedersen
from mpc_bulletproof_tpu import Scalar as JScalar
from mpc_bulletproof_tpu import StarkPoint as JPoint
from mpc_bulletproof_tpu.models.range_proof import RangeProof as JRangeProof
from mpc_bulletproof_tpu_torch import (BulletproofGens, HashChainTranscript, PedersenGens,
                                       RangeProof, StarkPoint, pinned)
from mpc_bulletproof_tpu_torch.constants import R
from mpc_bulletproof_tpu_torch.models.range_proof.fused_device import prove_multiple_device
from mpc_bulletproof_tpu_torch.ops import backend, curve_t, kernels, limb
from mpc_bulletproof_tpu_torch.ops import msm as msm_mod
from mpc_bulletproof_tpu_torch.ops.limb import FR, NW
from mpc_bulletproof_tpu_torch.parallel import sharded
from mpc_bulletproof_tpu_torch.parallel.sharded import Mesh, make_mesh
from mpc_bulletproof_tpu_torch.utils.device import normalize_device
from test_torch_range_proof import jax_host_prove

# Under pytest-xdist several worker processes share the cores: split them,
# or torch's default of one intra-op thread per core in every worker
# oversubscribes the machine.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

CPU = torch.device("cpu")
K = 37  # lanes of the sharded checks: neither 2 nor 8 divides it


def cpu_mesh(k: int) -> Mesh:
    return Mesh([CPU] * k)


def _pt(p) -> StarkPoint:
    return StarkPoint.from_bytes(p.to_bytes())


@pytest.fixture
def mesh_cleared():
    """Whatever a test installs, the next test starts without a mesh."""
    backend.set_mesh(None)
    sharded.reset_calls()
    yield
    backend.set_mesh(None)


@pytest.fixture(scope="module")
def msm_case():
    """K random 251-bit scalars over K points of the JAX host curve, their
    MSM by the JAX package's ``StarkPoint.msm``, and the port's
    ``msm_device`` of the same."""
    rng = random.Random(4242)
    g = JPoint.generator()
    scalars = [JScalar(rng.getrandbits(251)) for _ in range(K)]
    pts = [g.scalar_mul(JScalar(rng.getrandbits(251))) for _ in range(K)]
    s = torch.as_tensor(curve_t.scalars_from_host([int(x) for x in scalars]))
    p = torch.as_tensor(curve_t.points_from_host([_pt(q) for q in pts]))
    single = curve_t.points_to_host(msm_mod.msm_device(s, p)[..., None])[0]
    return {"s": s, "p": p, "pts": pts, "ints": [int(x) for x in scalars],
            "want": JPoint.msm(scalars, pts).to_bytes(), "single": single.to_bytes()}


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_msm_equals_the_host_layer_and_msm_device(msm_case, ndev):
    sharded.reset_calls()
    out = sharded.sharded_msm(msm_case["s"], msm_case["p"], cpu_mesh(ndev))
    assert out.shape == (3, NW) and out.device == CPU
    got = curve_t.points_to_host(out[..., None])[0].to_bytes()
    assert got == msm_case["want"] == msm_case["single"]
    assert sharded.calls["sharded_msm"] == 1


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_inner_product_equals_python_ints(ndev):
    rng = random.Random(ndev)
    a = [rng.randrange(R) for _ in range(K)]
    b = [rng.randrange(R) for _ in range(K)]
    a[0], b[0] = R - 1, R - 1                               # the largest terms
    words = lambda xs: torch.as_tensor(limb.ints_to_words(xs))
    got = sharded.sharded_inner_product(words(a), words(b), cpu_mesh(ndev))
    assert got.shape == (NW,)
    assert limb.words_to_ints(got[:, None]) == [sum(x * y for x, y in zip(a, b)) % R]
    assert torch.equal(got, limb.inner_product_mod(words(a), words(b), FR))


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_point_sum_equals_the_jax_host_curve(msm_case, ndev):
    out = sharded.sharded_point_sum(msm_case["p"], cpu_mesh(ndev))
    want = JPoint.identity()
    for q in msm_case["pts"]:
        want = want + q
    assert curve_t.points_to_host(out[..., None])[0].to_bytes() == want.to_bytes()


def test_padding_adds_nothing():
    """Zero scalars on identity points (:func:`shard_pad_msm`) add nothing
    to a Pippenger sum; whole shards of padding add nothing to a point sum
    or an inner product (5 lanes over 8 shards: 3 shards all padding); a
    table MSM's padding sits on the table's identity record."""
    rng = random.Random(7)
    g = StarkPoint.generator()
    pts = torch.as_tensor(curve_t.points_from_host([g.scalar_mul(rng.randrange(1, R)) for _ in range(5)]))
    s64 = torch.zeros((NW, 5), dtype=torch.int64)
    s64[0] = torch.tensor([rng.getrandbits(63) for _ in range(5)])
    ps, pp = sharded.shard_pad_msm(s64, pts, 8)
    assert ps.shape == (NW, 8) and pp.shape == (3, NW, 8)
    assert torch.equal(ps[:, 5:], torch.zeros((NW, 3), dtype=torch.int64))
    assert torch.equal(pp[..., 5:], curve_t.identity((3,), CPU))
    c, bits = msm_mod.SPLIT_WINDOW, msm_mod.SPLIT_CHUNK_BITS
    plain = curve_t.points_to_host(msm_mod._msm_device_impl(s64, pts, c, bits)[..., None])[0]
    padded = curve_t.points_to_host(msm_mod._msm_device_impl(ps, pp, c, bits)[..., None])[0]
    assert padded == plain

    mesh = cpu_mesh(8)
    host_sum = curve_t.points_to_host(msm_mod._reduce_sum(pts)[..., 0][..., None])[0]
    assert curve_t.points_to_host(sharded.sharded_point_sum(pts, mesh)[..., None])[0] == host_sum
    ones = limb.from_const(1, (5,), CPU)
    assert limb.words_to_ints(sharded.sharded_inner_product(s64, ones, mesh)[:, None]) == [
        sum(limb.words_to_ints(s64)) % R]

    # a table MSM over 3 shards of 2 lanes, the last lane padding
    table = torch.cat([pts, curve_t.identity((1,), CPU)], dim=-1)
    recs = torch.tensor([4, 0, 2, 1, 3])
    got = sharded.sharded_table_msm([(s64, recs)], {CPU: table}, cpu_mesh(3), c, bits)
    want = msm_mod._msm_multi_table_impl([(s64, recs)], table, c, bits)
    assert got.shape == (3, NW, 1)
    assert curve_t.points_to_host(got)[0] == curve_t.points_to_host(want)[0]


@pytest.fixture(scope="module")
def jax_proofs():
    """Two (8, 2) proofs of the JAX host prover as the port's objects, with
    the port's generators: the pinned inputs' (the bytes the fused prover
    gives on a mesh, below) and one of the values 33, 150."""
    j_proof, j_V, _, _ = jax_host_prove(8, 2)
    j_second, j_V2 = JRangeProof.prove_multiple(JGens(8, 2), JPedersen(), JTranscript(b"mesh-verify-2"), [33, 150],
                                                [JScalar(11), JScalar(12)], 8)
    return BulletproofGens(8, 2, device="cpu"), [
        (label, RangeProof.from_bytes(p.to_bytes()), [_pt(v) for v in V])
        for label, p, V in ((pinned.TRANSCRIPT_LABEL, j_proof, j_V), (b"mesh-verify-2", j_second, j_V2))]


def test_mega_check_routes_through_mesh(jax_proofs, mesh_cleared):
    """A range-proof verification with a mesh installed runs its mega-check
    (48 points, 24 a shard) through ``sharded_msm`` and accepts the proof
    the fused prover gives on a mesh."""
    gens, [(label, proof, V), _] = jax_proofs
    backend.set_mesh(cpu_mesh(2))
    proof.verify_multiple(gens, PedersenGens(), HashChainTranscript(label), V, 8, device="cpu")
    assert sharded.calls["sharded_msm"] == 1


def test_verify_batch_routes_through_mesh(jax_proofs, mesh_cleared):
    gens, proofs = jax_proofs
    backend.set_mesh(cpu_mesh(2))
    RangeProof.verify_batch([p for _, p, _ in proofs], gens, PedersenGens(),
                            [HashChainTranscript(label) for label, _, _ in proofs], [V for _, _, V in proofs], 8,
                            device="cpu")
    assert sharded.calls["sharded_msm"] == 1


@pytest.fixture
def routes(monkeypatch, mesh_cleared):
    """``dispatch_msm``'s three routes recorded instead of run."""
    taken = []
    ident = curve_t.identity((), CPU).contiguous()
    monkeypatch.setattr(sharded, "sharded_msm", lambda s, p, mesh: taken.append(("mesh", mesh.size)) or ident)
    monkeypatch.setattr(msm_mod, "msm_host_points",
                        lambda s, p, device: taken.append(("device", str(device))) or StarkPoint.identity())
    monkeypatch.setattr(backend, "StarkPoint",
                        types.SimpleNamespace(msm=lambda s, p: taken.append(("host", None)) or StarkPoint.identity()))
    return taken


def _dispatch(n: int, tensor: bool = False):
    g = StarkPoint.generator()
    pts = torch.as_tensor(curve_t.points_from_host([g] * n)) if tensor else [g] * n
    return backend.dispatch_msm([1] * n, pts, device="cpu")


def test_routing_gates(routes):
    """Nothing goes to the mesh below 32 points or below 16 a shard, a
    point tensor takes the mesh like host points, and ``set_mesh(None)``
    restores the single-device route."""
    _dispatch(64)
    backend.set_mesh(cpu_mesh(2))
    _dispatch(31)
    _dispatch(32)
    _dispatch(32, tensor=True)
    backend.set_mesh(cpu_mesh(4))
    _dispatch(63)
    _dispatch(64)
    backend.set_mesh(cpu_mesh(8))
    _dispatch(127)
    _dispatch(128)
    assert backend.mesh_shardable(4095)
    backend.set_mesh(None)
    _dispatch(128)
    assert not backend.mesh_shardable(1 << 20)
    assert routes == [("device", "cpu"), ("host", None), ("mesh", 2), ("mesh", 2), ("device", "cpu"),
                      ("mesh", 4), ("device", "cpu"), ("mesh", 8), ("device", "cpu")]


def test_mesh_of_another_device_type_raises(routes):
    backend.set_mesh(Mesh([torch.device("cuda", 0)] * 2))
    for n in (8, 64):
        with pytest.raises(ValueError, match="device type"):
            _dispatch(n)
    assert routes == []


def test_fused_prover_on_a_2_shard_mesh_is_the_jax_host_proof(mesh_cleared):
    """The (8, 2) proof with its MSMs, bit sum and inner products split over
    2 shards: proof bytes, V and the final transcript state equal the JAX
    host party/dealer path's (which verifies through the mesh above)."""
    n, m = 8, 2
    bp_gens, pc_gens = BulletproofGens(n, m, device="cpu"), PedersenGens()
    values, blindings = pinned.inputs(n, m)
    tr = HashChainTranscript(pinned.TRANSCRIPT_LABEL)
    proof, V = prove_multiple_device(bp_gens, pc_gens, tr, values, blindings, n, device="cpu",
                                     rng_bytes=pinned.det_stream(), mesh=cpu_mesh(2))
    # the S MSM and the 4 IPP rounds' pairs, the A sum, t0, t2, t1's sum and zgamma
    assert sharded.calls == {"sharded_msm": 0, "sharded_table_msm": 5, "sharded_point_sum": 1,
                             "sharded_inner_product": 4}
    j_proof, j_V, j_state, _ = jax_host_prove(n, m)
    assert proof.to_bytes() == j_proof.to_bytes()
    assert [v.to_bytes() for v in V] == [v.to_bytes() for v in j_V]
    assert tr.state == j_state


def test_fused_prover_mesh_checks():
    with pytest.raises(ValueError, match="device type"):
        prove_multiple_device(None, PedersenGens(), HashChainTranscript(b"x"), [1], [1], 8, device="cpu",
                              mesh=Mesh([torch.device("cuda", 0)]))


def test_make_mesh_needs_enough_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="3 cards asked for, 2 present"):
        make_mesh(3)
    with pytest.raises(ValueError):
        make_mesh(0)
    assert make_mesh() == Mesh([torch.device("cuda", 0), torch.device("cuda", 1)])
    assert make_mesh(1).devices == (torch.device("cuda", 0),)


def test_mesh_devices():
    mesh = Mesh(["cpu", CPU, "cpu"])
    assert mesh.size == 3 and mesh.lead == CPU and mesh.devices == (CPU,) * 3
    assert hash(mesh) == hash(cpu_mesh(3)) and mesh == cpu_mesh(3) and mesh != cpu_mesh(2)
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(ValueError, match="one type"):
        Mesh([CPU, torch.device("cuda", 0)])


def test_cache_keys_name_the_card(monkeypatch):
    """``"cuda"`` and ``"cuda:0"`` key one entry of a per-device cache."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert normalize_device("cuda") == normalize_device("cuda:1") == torch.device("cuda", 1)
    assert normalize_device("cuda:0") == torch.device("cuda", 0)
    assert normalize_device("cpu") == CPU


def test_launch_runs_on_the_operands_card(monkeypatch):
    """``_launch`` makes the operand's card current and takes that card's
    stream (the ctypes entry launches on the calling thread's current
    device), switches nothing when that card is current already, and the
    wrappers pass their operand's device."""
    log = []

    @contextlib.contextmanager
    def device(dev):
        log.append(("enter", dev))
        yield
        log.append(("exit", dev))

    def stream(dev=None):
        log.append(("stream", dev))
        return types.SimpleNamespace(cuda_stream=77)

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(kernels, "_fn", lambda name: lambda *args: log.append(("launch", name, args)) or 0)
    kernels.reset_launches()
    card = torch.device("cuda", 1)
    kernels._launch("vec2", card, 5, 6)
    assert log == [("enter", card), ("stream", card), ("launch", "vec2", (5, 6, 77)), ("exit", card)]
    log.clear()
    kernels._launch("vec2", torch.device("cuda", 0), 5, 6)
    assert log == [("stream", None), ("launch", "vec2", (5, 6, 77))]
    assert kernels.launches["vec2"] == 2
    kernels.reset_launches()

    seen = []
    monkeypatch.setattr(kernels, "_check", lambda t, *a, **kw: "cuda")
    monkeypatch.setattr(kernels, "_launch", lambda name, dev, *args: seen.append((name, dev)))
    a = torch.zeros((3, NW, 4), dtype=torch.int64)
    kernels.point_add(a, a)
    kernels.point_reduce(a)
    assert seen == [("point_add", a.device), ("point_reduce", a.device)]
