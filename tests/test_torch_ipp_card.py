"""The inner-product argument alone on the card, without JAX (this file
imports only torch and the port, so it also runs on a machine with a card
and no JAX): the fused prover and the coefficient-tracking device prover
give ``pinned.IPP_DIGESTS`` on inputs made on the card, the card verifies
the proof from point tensors, and ``fold_points`` on the ``point_add``
kernel equals its composition on the plain add.  Skips without a card;
``chip_smoke.py``'s ``ipp`` phase runs the same checks up to n = 2^20."""

import pytest
import torch

from mpc_bulletproof_tpu_torch import HashChainTranscript, InnerProductProof, pinned
from mpc_bulletproof_tpu_torch.constants import FIELD_BITS
from mpc_bulletproof_tpu_torch.models import inner_product as ipp
from mpc_bulletproof_tpu_torch.ops import curve_t, fold, limb, msm


@pytest.mark.cuda
def test_card_ipp_matches_pinned_digests_and_verifies():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py's ipp phase runs n = 2 to 2^20 there)")
    dev = torch.device("cuda")
    for n in (32, 64):
        inp = pinned.ipp_device_inputs(n, dev)
        args = (inp["Q"], inp["G_factors"], inp["H_factors"], inp["G"], inp["H"], inp["a"], inp["b"])
        t = HashChainTranscript(pinned.IPP_LABEL)
        proof = InnerProductProof.create(t, *args, device=dev)
        assert pinned.ipp_digest(proof, t.state) == pinned.IPP_DIGESTS[n]
        t = HashChainTranscript(pinned.IPP_LABEL)
        t.innerproduct_domain_sep(n)
        assert pinned.ipp_digest(ipp._create_device(t, *args, device=dev), t.state) == pinned.IPP_DIGESTS[n]

        P_scalars = torch.cat([inp["a"], limb.mod_mul(inp["b"], inp["H_factors"], limb.FR),
                               limb.inner_product_mod(inp["a"], inp["b"], limb.FR)[:, None]], dim=-1)
        P_points = torch.cat([inp["G"], inp["H"], torch.as_tensor(curve_t.points_from_host([inp["Q"]]), device=dev)],
                             dim=-1)
        P = curve_t.points_to_host(msm.msm_device(P_scalars, P_points)[..., None])[0]
        G_factors = [1] * n
        H_factors = limb.words_to_ints(inp["H_factors"])
        proof.verify(n, HashChainTranscript(pinned.IPP_LABEL), G_factors, H_factors, P, inp["Q"],
                     inp["G"], inp["H"], device=dev)

    G_L, G_R = inp["G"][..., :32].contiguous(), inp["H"][..., :32].contiguous()
    bits = fold.scalar_bits(inp["a"][:, :32].contiguous())
    bits_r = fold.scalar_bits(inp["b"][:, :32].contiguous())
    got = fold.fold_points(bits, bits_r, G_L, G_R)
    want = fold._fold(bits, bits_r, G_L, G_R, curve_t._point_add)
    assert bits.shape == (FIELD_BITS, 32)
    assert torch.equal(got, want)
