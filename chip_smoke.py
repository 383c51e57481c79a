#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py    # from the repository root, on a machine with one card
    python3 chip_smoke.py --ab DIR    # also A/B against the one-block point_reduce, csrc in DIR
    python3 chip_smoke.py --seed N    # the transcript check's states and bytes from N (default 13)

Phases, one JSON object per line on standard output:

1. ``env``: torch and CUDA versions, the ``nvcc`` path, the card.
2. ``build``: all sixteen CUDA kernels built from ``mpc_bulletproof_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel), with each library's ptxas report.
   ``clock``: the SM clock ``nvidia-smi`` reports while the full xor chain
   (``probe_xor_chain``) runs, which every per-pipe bound below uses.
3. ``kernel``: each kernel against its plain PyTorch version on the card:
   ``point_add``, the inner scan and Horner at the shapes each of the
   prove, verify, msm, r1cs_prove, r1cs_verify, ipp and mesh paths launches
   them with (ipp: a round's pair of MSMs at 2^20, Horner at k = 2 and c =
   16; mesh: prove's round pair on one of 4 shards; ``ipp_fold``: the
   2^19-lane add of a fold of the 2^20 G),
   the segmented reduction (``point_reduce``) at every sum the paths run
   (prove's A bit sum, 1 x 2nm; every path's bucket tails; the mesh path's
   shard of the A sum and its collective, 2 x 4; the fixed-base
   commitments of prove, m + 2 x 64, and of the msm phase's set-up,
   2^17 x 64), at a ragged shape and at a one-level shape (S x 2), the
   ladder at the range
   and R1CS provers', ``point_scan_steps`` (which no
   path runs) at the prove scan's and the vector ops at (4, 4,096) (no
   path) and at (4, 36,864), the mpc path's t-polynomial (the product
   with a width-1 b timed too: ``public_b``), the share plane's entries
   at the mpc path's shapes (``beaver_diff`` at 2 x 36,864 lanes,
   ``beaver_combine`` at 36,864 for both parties, ``poly3_eval`` at
   4,096), and in turns (``share_plane_turns``: composed, fused, fused,
   composed) the device time of a Beaver round's local algebra and of an
   evaluation against the former composition of ``vec_mul/add/sub`` launches;
   both scans also at ``PART_BLOCK_SCAN`` (a part-filled
   last block of lanes); worst-case lanes (identity, doubling,
   P + (-P), coordinates near p, 0, 1, m - 1 and m - 2); equality is
   exact on the 64-bit words.
   Times by CUDA events around 20 back-to-back calls (``kernel_ms``, host
   launch gaps included), by torch.profiler's kernel rows (``device_ms``,
   the kernel alone; for ``point_reduce`` the sum of a call's passes), and
   of the one plain call checked (``plain_ms``).  Each row's bound
   (``bound_ms``, its ``bound_share`` of ``device_ms``) is the larger of
   the byte time (``bytes_bound_ms``: each input read and each output
   written once at 3.35 TB/s) and the per-pipe issue time
   (``pipe_bound_ms``: the instructions the function needs, counted from
   the field arithmetic of ``csrc/field.cuh``, each on its pipe at
   Hopper's issue rates and the ``clock``; ``pipe`` the one that sets
   it).  ``point_reduce`` rows
   carry their plan, the dependency bound
   (ceil(log2 n) adds at Horner's add latency from this run), the launches
   one call made (read from the counter), and in turns the former halving
   tree of ``point_add`` launches (``vs_halving_tree``); ``kernel_plans``
   holds every tree depth (1 to 6 levels a pass) and a fold, each run as
   its own plan, to the plain version of that plan word for word.
   ``point_add`` rows name the design the wrapper picked (``narrow``: 8
   lanes an add, up to ``POINT_ADD_NARROW_MAX`` lanes; ``wide``: a thread
   an add); ``mod_pow_static`` rows the branch of each case (``gcd`` for
   e = m - 2, ``ladder`` else; the inverse over edge lanes: 0, 1, m - 1,
   m - 2, powers of two, values just below 2^251).  Rows bound by one
   lane's chain (Horner, narrow ``point_add``, ``mod_pow_static``) carry
   ``serial``: the dependent products or GCD steps a lane and the
   measured ns a step.  ``point_add_sweep``: both designs at each width of
   ``ADD_SWEEP`` (16 to 262,144 lanes), held to the plain add and timed
   in turns (wide, narrow, narrow, wide); ``mod_pow_ab``: the inverse by
   the ladder and by the GCD at each inverse path shape, held to the
   plain version and timed in turns.
4. ``gens``: the generator chains.  ``keccak_chain`` (a warp a chain)
   and ``keccak256_32`` against their plain versions byte for byte at
   ``KECCAK_CHAIN_CHECKS`` and ``KECCAK_HASH_N`` messages, and the wide
   set-up's walk (2 chains of ``GENS_WIDE`` steps) with its last 256 steps
   held to the plain walk; their kernel lines (the chain's bound the
   larger of its issue time and its dependency bound: ``KECCAK_F_DEPTH``
   dependent instructions a step at ``DEP_LATENCY_CYCLES``; ``design``:
   the warp design's own floors, ``KECCAK_WARP_DEPTH`` and
   ``KECCAK_WARP_NEEDS``, and the shuffle latency the time implies).  Then
   ``BulletproofGens(size, 1)`` for ``GENS_SIZES`` (benches/generators.rs),
   ``GENS_WIDE`` (a k = 2^16 shuffle's capacity) and ``GENS_AGGREGATED``,
   each against ``pinned.GENS_DIGESTS`` from its host lists and from its
   device tensors, its seconds split into walk, keccak, reduction,
   fixed-base products, affine conversion and host lists; the launches of
   the wide set-up and a profile of it (counts must match).
   ``transcript``: ``keccak_transcript`` (a block a transcript: four
   warps stage the run's template, layout and message words in shared
   memory, warp 0 runs the blocks, warp 1 hashes and reduces each
   challenge mod r beside it) against its plain version, states and
   challenges word for word: runs of 1, 2, 3 and 64 absorbs at every block
   length of ``TRANSCRIPT_LENGTHS``, the challenges at the end, after
   every absorb or none, random and all-zero messages, 1 and
   ``TRANSCRIPT_MANY`` transcripts a launch, words from ``--seed``;
   ``transcript_t.absorb_many`` against the same run on the CPU and its
   refusal of 136 bytes; device ms at an IPP round's run, the V run (64
   absorbs; and V.., A, S, y, z as the prover runs it), a whole (64, 64)
   verification's replay and a batch of two, with the bound
   (:func:`transcript_bound`) and the design's floors; and the kernel's
   reduction mod r (``csrc/keccak.cu`` ``fr_reduce_u512``, built into
   ``tools/keccak_epilogue_check.cu`` beside the port's libraries) on its
   edge values and its borrow branch, against ``v mod r`` in Python ints.
5. ``main_path``: ``RangeProof.prove_multiple`` at (n, m) = (64, 64) on the
   pinned inputs; the digest of proof, commitments and transcript must equal
   the JAX package's (``mpc_bulletproof_tpu_torch/pinned.py``).  Launch
   counts are read around one proof, then the median of warm proofs.
   ``profile``: device time by kernel over one more warm proof
   (torch.profiler), each port kernel's sum (``port_kernels``), the sums
   by CUDA source beside the launch counters of the same proof
   (``by_source``, ``counts_match``), all device launches and the
   device's idle share; its device launches must be at least
   ``PROVE_LAUNCH_DROP`` under ``PARENT_PROFILES``' (the transcript left
   plain torch).
6. ``verify``: ``verify_multiple`` of that proof; two tampered copies (t_x + 1,
   L_1 swapped with R_1) must raise ``VerificationError``; ``verify_batch``
   of it and a second proof must pass, its two transcripts replayed in one
   ``keccak_transcript`` launch; ``replay``: the verification's whole
   transcript replayed on the card in one launch gives the host route's
   challenges and final state.  Launch counts around one verification,
   then the median of warm ones, split into the host terms (the replay
   included) and the MSM.
7. ``rp_sweep``: the reference's range-proof sweep on the main path's
   generators: config 1 (``prove_single`` of the README's 32-bit value,
   ``verify_single``) and config 2 at ``RP_SWEEP_M`` values, each a cold
   proof against ``pinned.DIGESTS``, a warm one and a verification; at m
   = 1 a tampered copy (t_x + 1) must raise ``VerificationError``, its
   replay must be the host route's (``replay``), and the
   verification is the median of ``VERIFY_MEDIAN_RUNS`` calls beside its
   host terms and its MSM.
8. ``party_dealer``: the same (64, 64) proof by the party/dealer protocol
   (``Party``, ``Dealer``; the 64 parties in order on one
   ``pinned.det_stream()``): its digest must be the fused prover's,
   ``verify_multiple`` on the card must accept it, ``receive_shares`` must
   audit the honest shares and assemble the same bytes, and a share with
   t_x + 1 must raise ``MPCError`` naming its party.  Launches of one
   proof, the median of warm proofs (host clock), the host split of one
   audited proof (the parties' phases, the dealer's rounds, the share
   audits, the inner-product argument) and a ``profile``.
9. ``msm``: ``msm_device`` at n = 2^20 on points P_i = k_i G made on the card;
   the result must equal (sum_i s_i k_i) G.  Launch counts around one MSM,
   the median of warm ones, peak memory, a device profile; then one MSM of
   8,286 points (the (64, 64) verification's width), checked the same way.
   ``mesh``: the port's device mesh (``parallel/sharded.py``) on virtual
   meshes of ``MESH_SHARDS`` shards on this card (``Mesh([dev] * k)``),
   and on every card when there are two or more (``make_mesh()``; with one
   card ``real_mesh`` says ``needs >= 2 cards``).  On each mesh:
   ``sharded_msm`` at 2^20 on the msm phase's inputs must equal
   ``msm_device``'s result and (sum s_i k_i) G (launches and peak memory of
   one, then in turns with ``msm_device``); the (64, 64) proof by
   ``prove_multiple_device(..., mesh=...)`` must give the pinned digest and
   the unsharded proof's bytes (cold, launches, then in turns with the
   unsharded prover; on ``MESH_PATH_SHARDS`` shards a ``profile``, and its
   launches are the ``mesh`` path's); with ``set_mesh(mesh)`` the
   8,286-point mega-check of ``verify_multiple`` and that of
   ``verify_batch`` must each run once through ``sharded_msm`` and accept,
   and the t_x + 1 copy raise ``VerificationError``, and after
   ``set_mesh(None)`` none; the sharded inner product and point sum at
   ``MESH_VEC_N`` lanes must equal the unsharded ones.  A virtual mesh
   shares one card: its times are the collective's and the extra launches'
   cost, not scaling.
10. ``r1cs``: the shuffle gadget at k = 2^10 (2,046 multipliers, n = 2,048)
   on the pinned inputs: commit and gadget seconds, the cold proof and the
   median of warm ``Prover.prove`` calls, the digest of proof, commitments
   and transcript against the JAX package's (``pinned.SHUFFLE_DIGESTS``);
   ``Verifier.verify`` of it, two tampered copies (t_x + 1, the IPP's first
   L and R swapped) must raise ``VerificationError``; launches around one
   proof and one verification, one more proof split into its phase MSMs,
   its inner-product argument and the host rest, one more inside the
   ``r1cs.prove`` span of ``utils/profiling.py`` (``profiling``: its
   ``snapshot()``, which must count the span once), warm verifications
   split into the host terms and the MSM; a device profile of one proof.
11. ``r1cs_sweep``: the reference's R1CS sweeps on the ``gens`` phase's
   ``BulletproofGens(1024, 1)``: the squaring chain (benches/r1cs.rs) at
   ``SQUARING_SWEEP`` multipliers and the shuffle at ``SHUFFLE_SWEEP``, one
   proof each against ``pinned.SQUARING_DIGESTS`` / ``SHUFFLE_DIGESTS``,
   split into phase MSMs, IPP and host rest (``rest_s_per_multiplier``),
   each verified on the card.
12. ``ipp``: the inner-product argument alone (BASELINE.json config 3) on
   ``pinned.ipp_inputs(n)`` (generators with known discrete logs, made on
   the card from n = 32).  For n = 2^1 to 2^16 (``IPP_SWEEP``):
   ``InnerProductProof.create`` (the host route below 32, the fused body
   from 32) must give ``pinned.IPP_DIGESTS[n]``, and ``verify`` must
   accept the proof (``verify_route``: the verifier's MSM of 1 + 2n + 2 lg
   n points runs on the card from 32 points, on the host for n <= 8);
   from n = 64 one warm proof, from 2^15 (``IPP_WARM_FROM``) the median
   of ``IPP_WARM`` (host clock).  At n = 2^18 and 2^20 (``IPP_FULL``),
   inputs made on the card: the fused proof (1 cold, with the launches and
   the peak memory around it, and ``IPP_FULL_WARM`` warm, at 2^20 the
   profiled one) and the
   coefficient-tracking prover's (``_create_device``, two ``msm_device``
   calls a round) must be equal byte for byte with equal transcript
   states; ``verify`` from the generator tensors must accept it, and at
   2^18 raise ``VerificationError`` for a + 1 and for L_1 swapped with
   R_1; a ``profile`` of the warm fused proof at 2^20.  Then ``fold_points_shared``
   at 2^19 lanes (one round's fold of the 2^20 G) and ``fold_points``
   with per-lane scalars (a first round's H factors) at
   ``FOLD_FACTOR_LANES``, each held to the host two-point MSM on
   ``FOLD_SAMPLES`` lanes (the latter also in full to the same fold on the
   plain add), 505 ``point_add`` launches each, their times;
   ``msm_device_pair`` at the 2^20 round's width against two
   ``msm_device`` calls (times in turns), at ``PAIR_HOST_POINTS`` against
   the host MSM, and refusing c = 9 at 252 bits; ``msm_device_split`` at
   ``SPLIT_POINTS`` against ``msm_device``.  ``phase_s``: the phase's
   seconds, ``parts_s`` those of its parts.
13. ``mpc``: the collaborative (2-party MPC) R1CS range proof over
   ``MPC_VALUES`` committed ``MPC_BITS``-bit values (n = 4,096
   multipliers), both parties as threads over the in-process link on one
   card (``MpcFabric(..., device="cuda")``): each party commits the values
   it owns, its bits shared one value at a time and allocated as
   multipliers (``pinned.mpc_range_party``).  The digest of the opened
   proof, the commitments and the final transcript state must equal the
   JAX package's (``pinned.MPC_RANGE_DIGESTS``); the port's ``Verifier``
   must accept the proof on the card; party 0's share of the IPP's ``a``
   plus one must make both parties' opening raise
   ``AuthenticationError``.  Launches of one proof (both parties
   together; ``vec2_family_launches``: those of ``csrc/vec2.cu``'s four
   entries), the median of warm proofs (host clock), each party's host
   split (commitments, the multipliers' Beaver rounds, phase MSMs, the
   t-polynomial on the device share plane, the IPP, the opening), the
   messages and bytes each party sent, a device profile (sums over both
   parties' work).  ``mpc_small``: the JAX package's ``bench.py`` MPC
   configuration (the example gadget, ``BulletproofGens(16, 1)``) at a
   one-way link delay of 0 and 5 ms, median of warm proofs, verified.
14. ``mpc_tcp``: the collaborative prover's two-process deployment: the
   integration harness (``mpc_bulletproof_tpu_torch/integration``), both
   parties as OS processes on this card over loopback TCP, started by its
   launcher once the kernels are built.  Every case of its registry must
   pass in both processes; its (64, 64) range proof, proved
   ``TCP_PROOFS`` times (1 cold), must give the pinned digest and the same
   opened bytes in both, and each party must send the messages and bytes
   of the ``mpc`` phase's threads; the launches summed over both
   processes must include the point kernels and the vec2 family.  Seconds
   per proof beside the threads' median.  A process failing or the
   deadline (``TCP_DEADLINE_S``) passing fails the run.
15. ``probes``: the three op-rate probes (``probe_chain``,
   ``probe_xor_chain``, ``probe_accum``), every op of their TPU benches at
   the TPU shapes: each held bit for bit to its plain version (NaN equal to
   NaN; ``probe_edges``: also the redesigned two at ``probes.EDGE_*``,
   ``probe_chain`` at reps 0, 1, U - 1, U, U + 1, 100 and 4,096 and
   ``probe_accum`` at 2,048, 2,047 and 4,099 lanes and at a 4-byte
   offset), then timed at the full repetition counts.  A ``probe``
   line: ms by events and by the profiler (``device_ms``), cycles a step
   at the ``clock``, the byte bound, the per-pipe bound
   (``pipe_bound_ms``: the instructions a lane-step the op needs per pipe,
   ``PROBE_NEEDS``, at Hopper's issue rates, ``pipe`` the one that sets
   it), the dependency bound (dependent instructions a step on one lane's
   chain x ``DEP_LATENCY_CYCLES``), their shares of the device time, and,
   as a diagnostic, the main loop's opcode histogram read from
   ``cuobjdump -sass`` of the built library, its instructions a lane-step
   per pipe and the time they take to issue (``sass_issue_ms``;
   ``probe_sass`` lists every row whose loop issues more than it needs).
16. with ``--ab DIR`` only, ``ab`` and ``ab_profile``: the one-block
   ``point_reduce`` this one replaced, built from DIR (an older tree's
   ``mpc_bulletproof_tpu_torch/csrc``), against this tree's at the A bit
   sum's shape: equal as points, device times in turns (base, this, this,
   base); then one warm prove and r1cs_prove proof each profiled in the
   same turns, the base on the former route (that kernel for the A sum, the
   halving tree of ``point_add`` launches for every other sum).
17. the ``kernels`` summary with launches per path (``pd`` the
   party/dealer proof, ``mesh`` one (64, 64) proof on a virtual mesh of
   ``MESH_PATH_SHARDS`` shards, ``ipp`` one fused IPP proof at 2^20, ``tcp`` both
   processes of ``mpc_tcp``, ``gens`` the 2^17 set-up, ``rp_sweep`` and
   ``r1cs_sweep`` each sweep whole; for the
   scans and Horner also their ptxas registers and spills, launch
   configurations and resident warps a scheduler), the card's
   ``profiles`` line (each profiled run's device launches and idle share
   beside ``PARENT_PROFILES``, the figures PERF.md §5 records for the tree
   before the transcript kernel; ``prove_launches``: the (64, 64)
   prove's beside ``PARENT_PROVE_LAUNCHES``, the parent tree's), the
   card's ``nvidia-smi`` name and power limit, and last ``{"ok": true,
   "device": {...}}``.

Each path asserts that the kernels it must run were launched.

Any failed phase raises and the script exits non-zero without the last
line.  Without a CUDA device it exits 1 at once.  It imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

N_BITS, M_PARTIES = 64, 64
WARM_PROOFS = 3
WARM_VERIFIES = 3
WARM_MSMS = 3
MSM_LOG2N = 20
# The mesh phase: virtual meshes of these many shards on one card (4 is a
# four-chip cell's count); the mesh path's launches are those of one (64,
# 64) proof on MESH_PATH_SHARDS shards; the sharded inner product and point
# sum at MESH_VEC_N lanes; WARM_MESH warm runs of each side in turns.
MESH_SHARDS = (2, 4)
MESH_PATH_SHARDS = 4
MESH_VEC_N = 4096
WARM_MESH = 3
VEC_N = 4096
MPC_BITS, MPC_VALUES = 64, 64
MPC_VEC_N = 9 * MPC_BITS * MPC_VALUES  # lanes of the t-polynomial's one Beaver round
WARM_MPC = 1  # cut from 3: the script's time limit (PERF.md §4)
MPC_SMALL_LATENCIES = (0.0, 0.005)  # one-way link delay of the example-gadget runs, s
WARM_MPC_SMALL = 3
TCP_PROOFS = 2  # collaborative range proofs of the two-process run: 1 cold, 1 warm (cut from 3)
TCP_DEADLINE_S = 300  # both processes killed, and the run failed, after this
SHUFFLE_K = 1 << 10
WARM_R1CS = 3
# The generator chains: the keccak kernels held to their plain versions at
# KECCAK_CHAIN_CHECKS (chains, skip, count) and KECCAK_HASH_N messages;
# BulletproofGens(size, 1) for the reference's sizes (benches/generators.rs),
# at GENS_WIDE (the capacity of a k = 2^16 shuffle) and at (64, 64), each
# against pinned.GENS_DIGESTS
KECCAK_CHAIN_CHECKS = ((2, 0, 256), (128, 64, 64), (33, 3, 1))
KECCAK_HASH_N = 1 << 18
# The transcript kernel held to its plain version: runs of 1, 2, 3 and 64
# absorbs, the length of each block (state, label, message words) cycling
# through TRANSCRIPT_LENGTHS (a run of one absorb takes each length in
# turn; a message is whole 64-bit words, so every length is a multiple of
# 8), the challenges at the end, after every absorb, or none, messages
# random or all zeros (identity points), 1 and TRANSCRIPT_MANY transcripts
# a launch; states and words from --seed.  Timed at the IPP round's run (L,
# R, u), the range prover's V run as the parent tree's row timed it (64 absorbs of 128
# bytes) and as the prover runs it now (V.., A, S, y, z at m = 64), and a
# whole (64, 64) verification's replay (TRANSCRIPT_VERIFY).
TRANSCRIPT_LENGTHS = (32, 40, 64, 72, 96, 104, 128)
TRANSCRIPT_RUNS = (1, 2, 3, 64)
TRANSCRIPT_MANY = 3
TRANSCRIPT_VERIFY = (64, 64)
GENS_SIZES = (2, 8, 64, 256, 1024)
GENS_WIDE = 1 << 17
GENS_AGGREGATED = (64, 64)
# The reference's sweeps: config 1 (32 bits, one value), config 2 at
# RP_SWEEP_M values of 64 bits (m = 64 is the main path), the m = 1
# verification the median of VERIFY_MEDIAN_RUNS calls; the squaring chain
# at SQUARING_SWEEP multipliers and the shuffle at SHUFFLE_SWEEP (k = 2^10
# is the r1cs phase)
RP_SWEEP_M = (1, 2, 4, 8, 16, 32)
VERIFY_MEDIAN_RUNS = 20
SQUARING_SWEEP = tuple(1 << i for i in range(1, 11))
SHUFFLE_SWEEP = tuple(1 << i for i in range(1, 10))
# The inner-product argument alone: n = 2^k against pinned.IPP_DIGESTS for k
# in IPP_SWEEP (from n = 64 one warm proof, from n = 2^IPP_WARM_FROM the
# median of IPP_WARM); at the widths 2^k, k in
# IPP_FULL, on inputs made on the card, 1 cold and IPP_FULL_WARM warm
# proofs (at the last width the warm proof is the profiled one), the
# tampered copies at the first width
IPP_SWEEP = range(1, 17)
IPP_WARM = 3
IPP_WARM_FROM = 15
IPP_FULL = (18, 20)
IPP_FULL_WARM = 1
FOLD_SAMPLES = 64  # lanes of a fold held to the host two-point MSM
FOLD_FACTOR_LANES = 4096  # lanes of the fold with per-lane scalars (a first round's factors)
PAIR_HOST_POINTS = 1000  # width at which msm_device_pair is held to the host MSM
SPLIT_POINTS = 1 << 16  # width of the msm_device_split check
SMS = 132
RESIDENT_THREADS = SMS * 2048  # H100 SXM: 132 SMs of 2,048 resident threads
PART_BLOCK_SCAN = (13, 1000)  # a scan shape (T, L) whose last block of 32 lanes is part-filled
BASE_LANES = 1 << 16  # random points made with their own scaling; wider inputs draw from them
# point_add's two designs, each held to the plain add and timed in turns at
# these widths (the crossover sweep); the dispatched one serves every path row
ADD_SWEEP = (16, 256, 2048, 4096, 8192, 13312, 16384, 65536, 262144)
# Dependent steps of one lane's chain, for the rows bound by a chain: the
# Montgomery products of one add on the critical path (3 levels split, 14
# in one thread) and the binary GCD's steps (17 rounds of 31).
ADD_PRODUCTS = {"wide": 14, "narrow": 3}
# the profiler's kernel name of each point_add design
ADD_KERNEL = {"wide": "point_add_kernel(", "narrow": "point_add_narrow_kernel("}
GCD_STEPS = 17 * 31
# point_reduce: a ragged row whose segments span blocks, a row of one
# 1-level pass (four sub-trees a block, the last block part-filled), the
# fixed-base commitments of the msm phase's set-up (2^17 points a call,
# generators._FIXED_BASE_CHUNK, 64 windows each)
RAGGED_REDUCE = (3, 1000)
ONE_LEVEL_REDUCE = (37, 2)
MSM_SETUP_COMMITS = 1 << 17

# Bounds.  Bytes: NVIDIA's published H100 SXM HBM rate (data sheet, 700
# W), 3.35 TB/s.  Operations: like the probes' (PIPE_RATE below), the
# instructions the function needs, each on the pipe it must use, at
# Hopper's issue rates and the SM clock under load (SM_CLOCK_MHZ, measured
# by main before the first kernel row).  Counted from the arithmetic of
# csrc/field.cuh, not from what ptxas emitted:
# - a Montgomery product (CIOS on 8 x 32-bit limbs), a round for each limb
#   b_i: a b_i as 8 mad.wide.u32 (IMAD.WIDE, FMA pipe) and a carry chain of
#   8 add.cc/addc (IADD3, ALU); the reduction for FP (m' = -1, limbs 0, 6
#   and 7 of p nonzero) u = -t0 (a two-input subtract, "int"), 2 mad.wide
#   and 9 carry adds, for FR u = t0 m' (one IMAD), 8 mad.wide and 8 carry
#   adds; then the conditional subtraction: 8 subtracts with borrow, the
#   borrow mask, 8 selects (LOP3);
# - a sum: 8 carry adds and the conditional subtraction; a difference: 8
#   subtracts with borrow, the mask, 8 carry adds and an AND of the mask
#   with each modulus limb that is neither 0 nor all ones (3 for p, 6 for r);
# - a complete point add (csrc/curve.cuh): 14 FP products, 17 sums, 6
#   differences;
# - a binary GCD step (csrc/mod_pow.cu): ~32 ALU operations (64-bit
#   subtract, compare, selects and shifts of a, b and four factors); a
#   round also ~40 to form the approximations and the updates of (a, b)
#   and (u, v): each two 8 x 1-limb products (8 mad.wide, 8 carry adds),
#   negations, the 9-limb adds, the shift by 31 (8 SHF) and for (u, v)
#   the Montgomery quotient's product and the conditional subtraction.
HBM_BYTES_PER_S = 3.35e12
SM_CLOCK_MHZ = None  # set by main: the SM clock under load (clock_under_load)
POINT_BYTES = 3 * 4 * 8
_REDUCE_ONCE = 8 + 1 + 8
FP_MUL_NEEDS = {"imad": 8 * (8 + 2), "alu": 8 * (8 + 9) + _REDUCE_ONCE, "int": 8}
FR_MUL_NEEDS = {"imad": 8 * (8 + 1 + 8), "alu": 8 * (8 + 8) + _REDUCE_ONCE}
FE_ADD_NEEDS = {"alu": 8 + _REDUCE_ONCE}
FP_SUB_NEEDS = {"alu": 8 + 1 + 8 + 3}
FR_SUB_NEEDS = {"alu": 8 + 1 + 8 + 6}


def needs(*terms) -> dict:
    """The instructions per pipe of ``(count, needs)`` terms, summed."""
    out: dict = {}
    for count, per in terms:
        for pipe, k in per.items():
            out[pipe] = out.get(pipe, 0) + count * k
    return out


POINT_ADD_NEEDS = needs((14, FP_MUL_NEEDS), (17, FE_ADD_NEEDS), (6, FP_SUB_NEEDS))
GCD_STEP_NEEDS = {"alu": 32}
_MUL_SMALL = {"imad": 8, "alu": 8}
_LIN_COMB = needs((2, _MUL_SMALL), (1, {"alu": 3 * 18 + 9 + 1 + 8}))     # negations, add, sign, shift
_MONT_COMB = {"fp": needs((2, _MUL_SMALL), (1, {"imad": 2, "alu": 16 + 16 + 9 + 1 + 1 + 10 + 8 + _REDUCE_ONCE})),
              "fr": needs((3, _MUL_SMALL), (1, {"imad": 1, "alu": 16 + 16 + 9 + 1 + 9 + 8 + _REDUCE_ONCE}))}


def gcd_needs(fr: bool) -> dict:
    """One lane's inverse by the binary GCD: 17 rounds of 31 steps."""
    mont = _MONT_COMB["fr" if fr else "fp"]
    return needs((17 * 31, GCD_STEP_NEEDS), (17, {"alu": 40}), (34, _LIN_COMB), (34, mont))


# What one keccak-f[1600] needs, in 32-bit instructions (the 64-bit lanes
# as halves, as csrc/keccak.cu's thread design keccak_f issues them), a
# round: the columns' parities 20 LOP3, their rotations by one 10 SHF,
# theta 50 LOP3, rho 48 SHF (24 lanes rotated, none by 0 or 32), chi 50
# LOP3, iota 2 LOP3; all on the ALU.  Its dependent depth, a
# round: two LOP3 levels for a parity, one SHF, one LOP3, one SHF, one LOP3
# (iota folds into the next parity): 6, 144 a permutation.
KECCAK_F_NEEDS = {"alu": 24 * (20 + 10 + 50 + 48 + 50 + 2)}
KECCAK_F_DEPTH = 24 * 6
# The warp design that keccak_chain and keccak_transcript run
# (csrc/keccak.cu keccak_f_warp: thread t < 25 holds word t).  A thread, a
# round: 18 SHFL (4 column words, C[x - 1] and C[x + 1], 3 rotated words
# for pi and chi, each two 32-bit halves) and 18 ALU (the parity with the
# folded iota 6 LOP3, the rotation by one 2 SHF, word 0's iota 2 LOP3,
# theta 2 LOP3, rho's select 2 SEL and shift 2 SHF, chi 2 LOP3), issued by
# all 32 lanes of the warp.  Its dependent path a round: 3 shuffles and 7
# ALU instructions (two parity levels, the rotation by one, theta, the
# select, rho, chi), and word 0's last iota.  That is the design's own
# floor; the bound stays the function's (KECCAK_F_NEEDS, KECCAK_F_DEPTH).
# Shuffle latency is not published; the design floor counts a shuffle at
# DEP_LATENCY_CYCLES (no instruction is faster), and each row reports the
# shuffle latency its measured time implies.
KECCAK_WARP_NEEDS = {"alu": 32 * 24 * 18, "shfl": 32 * 24 * 18}
KECCAK_WARP_DEPTH = {"shfl": 24 * 3, "alu": 24 * 7 + 1}

# The probes' dependency bound: dependent instructions a chain step puts on
# one lane's path through the accumulator (loop control and operands that
# do not depend on it are off that path), each at DEP_LATENCY_CYCLES at the
# SM clock nvidia-smi reports under load.  4 cycles is the dependent-issue
# latency of the fixed-latency ALU instructions (IMAD, IADD3, LOP3, SHF,
# FMUL, FADD) that microbenchmarks of Volta to Ampere report (Jia et al.,
# "Dissecting the NVIDIA Volta GPU Architecture via Microbenchmarking",
# 2018); NVIDIA publishes none for Hopper.  probe_chain measures it: its
# cycles a step hold one dependent instruction (two for the mul-adds)
# plus the loop's and the launch's share.  Ops through the conversion
# pipe (I2F, F2I, FRND) have no fixed latency and get no dependency
# bound (None).
DEP_LATENCY_CYCLES = 4
PROBE_DEP_STEPS = {
    # acc = op(acc, y): a * y + y is one IMAD; the shift-mask's LOP3 and SHF
    # run side by side before one IADD3; the float ops round twice, so a
    # mul-add is FMUL then FADD
    "probe_chain": {"i32_mul": 1, "i32_mul_add": 1, "i32_add": 1, "i32_shift_mask": 2,
                    "f32_mul": 1, "f32_mul_add": 2, "f32_add": 1, "f32_carry": None},
    # acc = op(acc, x) ^ i (float: + (i & 3)): the op, then the LOP3 (FADD)
    "probe_xor_chain": {"baseline_xor": 1, "i32_mul": 2, "i32_add": 2, "i32_mul_mask": 2,
                        "i32_shift": 3, "f32_mul": 2, "f32_add": 2, "f32_fma": 3, "i32_to_f32": None,
                        "f32_floor": None},
    # acc += op(a + i, b): the product does not depend on acc, so one add a step
    "probe_accum": {op: 1 for op in ("i32_mul", "i32_add", "i32_shift_and", "f32_mul", "f32_fma",
                                     "i32_mul16_masked", "i32_mul16_sext", "i32_mul16_one_side")},
}

# The probes' throughput bound, counted from what each probe's function
# needs: for each pipe, the instructions a lane-step must issue there over
# that pipe's lanes a clock an SM (CUDA C++ Programming Guide, "Throughput
# of Native Arithmetic Instructions", compute capability 9.0: 128 FP32
# add/mul/FMA, 64 of each 32-bit integer add, multiply(-add), shift,
# compare or bitwise op, 16 conversions, 32 warp shuffles), and all of them over the 128
# lanes a clock an SM dispatches (4 schedulers of one warp instruction a
# clock), at the clock under load.  The bound is the largest of these
# times.  Loop control, and whatever the compiler adds to a step or puts
# on a busier pipe, is time lost, not part of the bound: the SASS of the
# built loop is printed beside it (``sass_rows``), never counted in it.
# Pipes: "imad" an integer multiply(-add) (FMA pipe), "alu" a bitwise op,
# shift, three-input add or I2FP (ALU), "int" a two-input integer add,
# which issues on either (IADD3 on the ALU, VIADD on the FMA pipe, so
# "alu", "imad" and "int" together share 128 lanes a clock), "fp32",
# "conv" F2I and FRND.  Which pipe VIADD and I2FP take is not published;
# the card's times decide (PERF.md, PR 9): xor's baseline_xor, whose loop
# issues 5 VIADDs each 4 steps, runs at 97% of them on the FMA pipe and
# faster than they would take on the ALU; i32_to_f32 runs faster than
# its I2FP and F2I would take on the conversion pipe.
PIPE_RATE = {"fp32": 128, "alu": 64, "imad": 64, "conv": 16, "shfl": 32}
INT_RATE = 128
DISPATCH_RATE = 128
PROBE_NEEDS = {  # probe -> op -> instructions a lane-step per pipe
    "probe_chain": {  # acc = op(acc, y)
        "i32_mul": {"imad": 1}, "i32_mul_add": {"imad": 1}, "i32_add": {"int": 1},
        "i32_shift_mask": {"alu": 2, "int": 1},        # the mask, the shift, the add of three
        "f32_mul": {"fp32": 1}, "f32_mul_add": {"fp32": 2}, "f32_add": {"fp32": 1},
        "f32_carry": {"fp32": 4, "conv": 1},             # FMUL, FRND, FMUL, FADD, FADD
    },
    "probe_xor_chain": {  # acc = op(acc, x) ^ i (float: + (i & 3), a constant once unrolled)
        "baseline_xor": {"alu": 1}, "i32_mul": {"imad": 1, "alu": 1}, "i32_add": {"int": 1, "alu": 1},
        "i32_mul_mask": {"imad": 1, "alu": 1},           # the mask and the xor in one LOP3
        "i32_shift": {"alu": 2},                         # (a >> 13) + b in one LEA.HI, the xor
        "f32_mul": {"fp32": 2}, "f32_add": {"fp32": 2}, "f32_fma": {"fp32": 3},
        "i32_to_f32": {"alu": 2, "fp32": 1, "conv": 1},  # I2FP, FADD, F2I, LOP3
        "f32_floor": {"fp32": 3, "conv": 1},             # FMUL, FRND, FADD, FADD
    },
    "probe_accum": {  # acc += op(a + i, b): a + i is one add a lane-step
        "i32_mul": {"imad": 1, "int": 1},
        "i32_add": {"alu": 1, "int": 1},                 # acc + (a + i) + b in one IADD3
        "i32_shift_and": {"alu": 2, "int": 1},           # the mask, then the shift and add in one LEA.HI
        "f32_mul": {"fp32": 1}, "f32_fma": {"fp32": 1},  # op(a, b) is the same every step
        "i32_mul16_masked": {"alu": 1, "imad": 1, "int": 1},
        "i32_mul16_sext": {"alu": 1, "imad": 1, "int": 1},
        "i32_mul16_one_side": {"alu": 1, "imad": 1, "int": 1},
    },
}
# SASS opcode (up to its first '.') -> pipe, for the printed histograms;
# any other opcode (uniform datapath, loads, stores) counts for dispatch
# only ("other").
SASS_PIPE = {
    **dict.fromkeys(("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP"), "fp32"),
    **dict.fromkeys(("IADD3", "LOP3", "SHF", "ISETP", "IMNMX", "SEL", "LEA", "MOV", "PRMT", "SGXT",
                     "IABS", "BMSK", "I2FP"), "alu"),
    **dict.fromkeys(("IMAD", "VIADD"), "imad"),
    **dict.fromkeys(("I2F", "F2I", "FRND", "F2F", "F2IP"), "conv"),
    **dict.fromkeys(("BRA", "BRX", "JMP"), "branch"),
    "SHFL": "shfl",
}
# each probe's kernel function in csrc/probes.cu, and the lane-steps one
# iteration of its main loop runs: CHAIN_STEPS steps of one lane, 4 steps
# of one lane (unrolled by 4), ACCUM_STEPS steps of 4 lanes
PROBE_KERNEL = {"probe_chain": "chain_kernel", "probe_xor_chain": "xor_chain_kernel",
                "probe_accum": "accum_kernel"}
LOOP_LANE_STEPS = {"probe_chain": 32, "probe_xor_chain": 4, "probe_accum": 64 * 4}


def pipe_bound_ms(lane_steps: float, needs: dict, clock_mhz: float) -> tuple[float, str]:
    """The least time (ms) to issue ``lane_steps`` lane-steps of
    ``needs`` instructions each (per pipe, as in :data:`PROBE_NEEDS`;
    ``other`` counts for dispatch only, ``branch`` not at all) on all SMs
    at ``clock_mhz``; and the pipe (or ``int``, ``dispatch``) that sets
    it."""
    t = {p: needs.get(p, 0) / rate for p, rate in PIPE_RATE.items()}
    t["int"] = sum(needs.get(p, 0) for p in ("alu", "imad", "int")) / INT_RATE
    t["dispatch"] = sum(n for p, n in needs.items() if p != "branch") / DISPATCH_RATE
    pipe = max(t, key=t.get)
    return lane_steps * t[pipe] / (clock_mhz * 1e6 * SMS) * 1e3, pipe


def demangle_template(name: str) -> str:
    """``_Z12chain_kernelILi0EEv...`` -> ``chain_kernel<0>`` (the one-int
    templates of csrc/probes.cu); other names unchanged."""
    m = re.match(r"_Z(\d+)", name)
    if not m:
        return name
    base = name[m.end():m.end() + int(m.group(1))]
    t = re.match(r"ILi(\d+)E", name[m.end() + int(m.group(1)):])
    return f"{base}<{t.group(1)}>" if t else base


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` output -> ``{function: [(address, opcode, operands)]}``."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(demangle_template(m.group(1)), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return out


def main_loop(code: list) -> list:
    """The instructions of a function's main loop: of the loops that hold no
    other loop (a backward branch and its target), the longest."""
    loops = []
    for addr, op, args in code:
        t = re.findall(r"0x([0-9a-f]+)", args)
        if op.split(".")[0] == "BRA" and t and int(t[-1], 16) < addr:
            loops.append((int(t[-1], 16), addr))
    inner = [(a, b) for a, b in loops if not any((c, d) != (a, b) and a <= c and d <= b for c, d in loops)]
    if not inner:
        return []
    lo, hi = max(inner, key=lambda ab: sum(1 for x, op, _ in code if ab[0] <= x <= ab[1] and op != "NOP"))
    return [(x, op, args) for x, op, args in code if lo <= x <= hi and op != "NOP"]


def loop_pipes(body: list) -> tuple[dict, dict]:
    """A loop body's opcode histogram and its instructions per pipe."""
    hist: dict = {}
    pipes: dict = {}
    for _, op, _ in body:
        hist[op] = hist.get(op, 0) + 1
        pipe = SASS_PIPE.get(op.split(".")[0], "other")
        pipes[pipe] = pipes.get(pipe, 0) + 1
    return hist, pipes


def sass_rows(lib: str) -> dict:
    """For each probe kernel and op: its main loop's opcode histogram from
    ``cuobjdump -sass`` of the built library, and that loop's instructions
    a lane-step per pipe (a diagnostic: the bound counts
    :data:`PROBE_NEEDS`)."""
    from mpc_bulletproof_tpu_torch.ops import kernels, probes

    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs = sass_functions(text)
    ops = {"probe_chain": probes.CHAIN_OPS, "probe_xor_chain": probes.XOR_OPS,
           "probe_accum": probes.ACCUM_OPS}
    rows: dict = {}
    for name, names in ops.items():
        for i, op in enumerate(names):
            hist, pipes = loop_pipes(main_loop(funcs.get(f"{PROBE_KERNEL[name]}<{i}>", [])))
            per = {p: n / LOOP_LANE_STEPS[name] for p, n in pipes.items()}
            rows.setdefault(name, {})[op] = {"sass_hist": hist, "sass_per_lane_step": per}
    return rows


REPLACES = {
    "point_add": "mpc_bulletproof_tpu/ops/kernels.py:164",
    "point_scan_steps_inner": "mpc_bulletproof_tpu/ops/kernels.py:253",
    "point_scan_steps": "mpc_bulletproof_tpu/ops/kernels.py:221",
    "point_horner_multi": "mpc_bulletproof_tpu/ops/kernels.py:329",
    "point_reduce": "mpc_bulletproof_tpu/ops/kernels.py:419",
    "mod_pow_static": "mpc_bulletproof_tpu/ops/kernels.py:497",
    "vec2": "mpc_bulletproof_tpu/ops/kernels.py:541",
    "beaver_diff": "mpc_bulletproof_tpu/ops/kernels.py:541",
    "beaver_combine": "mpc_bulletproof_tpu/ops/kernels.py:541",
    "poly3_eval": "mpc_bulletproof_tpu/ops/kernels.py:541",
    "probe_chain": "benches/tpu_mul_bench.py:40",
    "probe_xor_chain": "benches/micro_vpu.py:46",
    "probe_accum": "benches/micro_mul.py:57",
    # no Pallas site: the native engine's keccak256 that the JAX package's
    # GeneratorsChain walks with, and hash_to_scalar's second keccak
    "keccak_chain": "mpc_bulletproof_tpu/generators.py:75 (no Pallas site: native keccak256)",
    "keccak256_32": "mpc_bulletproof_tpu/transcript.py:40 (no Pallas site: native keccak256)",
    # no Pallas site: the JAX package's on-device transcript hash is jnp,
    # compiled by XLA into its fused prover
    "keccak_transcript": "mpc_bulletproof_tpu/ops/keccak_jax.py:111 (no Pallas site: keccak256_device, jnp)",
}
# The entries of csrc/vec2.cu: the elementwise ops and the share plane's expressions.
VEC2_FAMILY = ("vec2", "beaver_diff", "beaver_combine", "poly3_eval")
# The kernels each path must launch (vec2: the IPP rounds' scalar products;
# keccak_transcript: every absorb and challenge of ops/transcript_t.py, which
# the fused range prover and the fused IPP rounds run, and the range-proof
# and IPP verifiers' replay).
PATH_KERNELS = {
    "prove": {"point_add", "point_scan_steps_inner", "point_horner_multi", "point_reduce",
              "mod_pow_static", "vec2", "keccak_transcript"},
    "verify": {"point_add", "point_scan_steps_inner", "point_horner_multi", "point_reduce",
               "keccak_transcript"},
    "msm": {"point_add", "point_scan_steps_inner", "point_horner_multi", "point_reduce"},
    "r1cs_prove": {"point_add", "point_scan_steps_inner", "point_horner_multi", "point_reduce",
                   "mod_pow_static", "vec2", "keccak_transcript"},
    "r1cs_verify": {"point_add", "point_scan_steps_inner", "point_horner_multi", "point_reduce"},
    "mpc": {"point_add", "point_scan_steps_inner", "point_horner_multi", "point_reduce", "vec2",
            "beaver_diff", "beaver_combine", "poly3_eval"},
    "pd": {"point_add", "point_scan_steps_inner", "point_horner_multi", "point_reduce", "mod_pow_static",
           "vec2", "keccak_transcript"},
    "mesh": {"point_add", "point_scan_steps_inner", "point_horner_multi", "point_reduce", "mod_pow_static",
             "vec2", "keccak_transcript"},
    "ipp": {"point_add", "point_scan_steps_inner", "point_horner_multi", "point_reduce", "mod_pow_static",
            "vec2", "keccak_transcript"},
    "tcp": {"point_add", "point_scan_steps_inner", "point_horner_multi", "point_reduce", "vec2",
            "beaver_diff", "beaver_combine", "poly3_eval"},
    "probes": {"probe_chain", "probe_xor_chain", "probe_accum"},
    "gens": {"keccak_chain", "keccak256_32", "point_reduce", "mod_pow_static"},
    "rp_sweep": {"point_add", "point_scan_steps_inner", "point_horner_multi", "point_reduce",
                 "mod_pow_static", "vec2", "keccak_transcript"},
    "r1cs_sweep": {"point_add", "point_scan_steps_inner", "point_horner_multi", "point_reduce",
                   "mod_pow_static", "vec2", "keccak_transcript"},
}


STARTED = time.monotonic()
SEED = 13  # set by main from --seed: the transcript check's states and bytes
# Each profile line's launches and idle share, by what it profiled (the
# first of each), for the closing ``profiles`` line; beside them the figures
# PERF.md §5 records for the tree before the transcript kernel (None where
# it records none; NVIDIA H100 80GB HBM3, 700 W).  The prove's launches
# must fall by PROVE_LAUNCH_DROP at least: the transcript's ~600 launches a
# hash left plain torch.
PROFILES: dict = {}
PARENT_PROFILES = {
    "prove": {"device_launches": 124116, "device_idle_share": 0.917},
    "party_dealer": {"device_launches": None, "device_idle_share": 0.916},
    "msm": {"device_launches": None, "device_idle_share": 0.037},
    "r1cs_prove": {"device_launches": None, "device_idle_share": 0.967},
    "mpc": {"device_launches": None, "device_idle_share": 0.987},
    "gens": {"device_launches": None, "device_idle_share": 0.61},
}
PROVE_LAUNCH_DROP = 70000
# The parent tree's (64, 64) prove, with the challenges reduced in plain
# torch (PERF.md §5: device launches, NVIDIA H100 80GB HBM3, 700 W), for
# the profiles line.
PARENT_PROVE_LAUNCHES = 28670


def emit(obj) -> None:
    """One JSON line; a phase line also gets ``t_s``, the seconds since the
    script started (the run has a time limit)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.monotonic() - STARTED}
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, work: dict) -> dict:
    """The least time of a function that moves ``bytes_moved`` bytes and
    needs ``work`` instructions per pipe (:func:`needs`): the larger of
    the byte time and the per-pipe issue time (:func:`pipe_bound_ms` at
    :data:`SM_CLOCK_MHZ`), which one sets it, and the pipe that sets the
    issue time."""
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    p_ms, pipe = pipe_bound_ms(1, work, SM_CLOCK_MHZ)
    return {"bound_ms": max(b_ms, p_ms), "bound_by": "bytes" if b_ms >= p_ms else "operations",
            "pipe": pipe, "pipe_bound_ms": p_ms, "bytes_bound_ms": b_ms}


def share(bound_ms: float, dev_ms: float | None) -> float | None:
    """The bound's share of a measured device time."""
    return None if not dev_ms else bound_ms / dev_ms


def scan_launch(L: int) -> dict:
    """The launch ``csrc/point_scan.cu`` makes: one warp per 32 lanes."""
    return {"grid": -(-L // 32), "block": [32, 1], "smem_bytes": 0}


def horner_launch(k: int) -> dict:
    """The launch ``csrc/point_horner.cu`` makes: one warp per output."""
    return {"grid": k, "block": [32, 1], "smem_bytes": None}


def scan_bound(T: int, L: int) -> dict:
    """A prefix scan of T steps over L lanes: each point read and written
    once, T - 1 adds a lane."""
    return bound(2 * POINT_BYTES * T * L, needs(((T - 1) * L, POINT_ADD_NEEDS)))


def ptxas_entries(log: str) -> dict:
    """Per entry function of an ``nvcc -Xptxas -v`` report: registers and
    spill bytes."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def warps_per_scheduler(registers: int, launch: dict) -> dict:
    """Resident warps a scheduler (of the 4 an SM has) for a launch: the
    blocks an SM holds by registers (allocated per warp in units of 256),
    threads (2,048), blocks (32) and shared memory (228 KB, 1 KB reserved
    a block), and how many of those this launch's grid fills."""
    threads = launch["block"][0] * launch["block"][1]
    warps = -(-threads // 32)
    regs_per_warp = -(-registers * 32 // 256) * 256
    smem = launch.get("smem_bytes") or 0
    per_sm = min(65536 // (regs_per_warp * warps), 2048 // (warps * 32), 32,
                 (228 * 1024) // (smem + 1024))
    capacity = per_sm * warps / 4
    return {"capacity": capacity,
            "this_launch": min(capacity, launch["grid"] * warps / (SMS * 4))}


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, per_call: bool = False, counts: dict | None = None) -> float | None:
    """Device time of one run of ``fn()``, which launches one kernel (or,
    ``per_call``, any number), from torch.profiler's kernel rows
    (:func:`device_ms_by_name`; ``counts[""]`` gets the launches recorded).
    Unlike :func:`cuda_ms` it leaves out the gaps in which the device waits
    for the host to launch: at small widths those are most of the events'
    time."""
    return device_ms_by_name([("", fn)], reps, counts, per_call)[""]


PROFILER_PAD = 100  # untimed launches that open each profiled session
PROFILER_ATTEMPTS = 3  # sessions at most for one measurement (see device_ms_by_name)


def device_ms_by_name(runs, reps: int, counts: dict | None = None, per_call: bool = False) -> dict:
    """Device time of one kernel launch per ``(kernel name prefix, fn)``,
    from ONE torch.profiler session over ``reps`` calls of each ``fn`` (one
    launch each, after one warm-up each): the kernel rows whose name, less
    a leading ``void``, starts with the prefix, over the launches the
    profiler recorded in the session's active step (a warm-up step runs
    :data:`PROFILER_PAD` sleeps and each ``fn`` once first; a session in
    which some prefix recorded no launch is run again, up to
    :data:`PROFILER_ATTEMPTS` in all; ``counts``, if given, gets the
    recorded launches per prefix).  None where the profiler saw no such kernel.  ``per_call``:
    the time of one call of ``fn``, however many kernels it launches
    (copies included; give one run, prefix ``""``): each kernel row's mean
    over its recorded launches times its whole launches a call (its
    recorded count over ``reps``, rounded up, since the profiler drops
    some), summed."""
    import math

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    # A warm-up step, traced and dropped: a session records none of its
    # first ~20 to 25 launches, so the step launches PROFILER_PAD untimed
    # sleeps (~50 us each) and one run of each fn.  Even so a short session
    # now and then records nothing at all; such a session is run again.
    for _ in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(PROFILER_PAD):
                torch.cuda._sleep(100_000)
            for _, fn in runs:
                fn()
            torch.cuda.synchronize()
            prof.step()
            for _, fn in runs:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
            prof.step()
        # device rows, less the step's own annotation, which spans the step
        rows = [(ev.key, ev.self_device_time_total, ev.count) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and not ev.key.startswith("ProfilerStep")
                and "spin_kernel" not in ev.key]
        if all(any(key.removeprefix("void ").startswith(prefix) and n for key, _, n in rows) for prefix, _ in runs):
            break
    out = {}
    for prefix, _ in runs:
        hits = [(us, n) for key, us, n in rows if key.removeprefix("void ").startswith(prefix) and n]
        total, calls = sum(us for us, _ in hits), sum(n for _, n in hits)
        if counts is not None:
            counts[prefix] = calls
        if per_call:
            out[prefix] = sum(us / n * math.ceil(n / reps) for us, n in hits) / 1e3
        else:
            out[prefix] = total / calls / 1e3 if total > 0 else None
    return out


def halving_tree(pts):
    """The former ``_reduce_sum_tree`` of ``ops/msm.py``, kept here for the A/B
    only: the sum along the last axis by a halving tree of ``point_add``
    launches, each level's halves copied to contiguous tensors."""
    import torch

    from mpc_bulletproof_tpu_torch.ops import kernels
    from mpc_bulletproof_tpu_torch.ops.curve_t import identity

    w = pts.shape[-1]
    while w > 1:
        half = (w + 1) // 2
        if 2 * half != w:
            pts = torch.cat([pts, identity((*pts.shape[2:-1], 2 * half - w), pts.device)], dim=-1)
        pts = kernels.point_add(pts[..., :half].contiguous(), pts[..., half:].contiguous())
        w = half
    return pts


def affine_equal(a, b) -> bool:
    """Whether two ``(3, NW, ..., 1)`` sums are the same points."""
    import torch

    from mpc_bulletproof_tpu_torch.ops import curve_t
    from mpc_bulletproof_tpu_torch.ops.limb import NW

    aff = lambda t: curve_t.to_affine_mont(t.reshape(3, NW, -1).contiguous())
    return bool(torch.equal(aff(a), aff(b)))


def read_launches(path: str) -> dict:
    """The launch counts since the last reset; raises if a kernel the path
    must run was not launched."""
    from mpc_bulletproof_tpu_torch.ops import kernels

    return require_launches(path, dict(kernels.launches))


def require_launches(path: str, launches: dict) -> dict:
    """``launches``, after checking that every kernel the path must run was launched."""
    missing = sorted(k for k in PATH_KERNELS[path] if launches[k] == 0)
    if missing:
        raise RuntimeError(f"{path}: kernels of the path not launched: {missing} ({launches})")
    return launches


def host_ms(fn, reps: int) -> list[float]:
    """Host-clock times of ``reps`` runs of ``fn()``, each ended by a synchronize."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def max_abs_err(a, b, word_dim: int) -> float:
    """Largest |a - b| over the canonical integers of two word tensors
    (the 64-bit words of an element on axis ``word_dim``)."""
    import torch

    from mpc_bulletproof_tpu_torch.ops.limb import NW, words_to_ints

    if torch.equal(a, b):
        return 0.0
    a, b = (t.movedim(word_dim, 0).reshape(NW, -1) for t in (a, b))
    return float(max(abs(x - y) for x, y in zip(words_to_ints(a), words_to_ints(b))))


def random_points(pool, count: int, gen):
    """``count`` points drawn from ``pool`` with random projective scaling
    (some lanes by p - 1, so coordinates lie near p) and every 7th lane the
    identity.  Above ``BASE_LANES`` the lanes are drawn from that many such
    points."""
    import torch

    from mpc_bulletproof_tpu_torch.constants import P
    from mpc_bulletproof_tpu_torch.ops import curve_t, limb

    dev = pool.device
    if count > BASE_LANES:
        base = random_points(pool, BASE_LANES, gen)
        return base[:, :, torch.randint(0, BASE_LANES, (count,), generator=gen, device=dev)].contiguous()
    idx = torch.randint(0, pool.shape[-1], (count,), generator=gen, device=dev)
    pts = pool[:, :, idx]
    lam = torch.randint(-(2**63), 2**63 - 1, (4, count), generator=gen, device=dev)
    lam[3] &= (1 << 58) - 1                                    # < 2^250 < p
    lam[0] |= 1                                                # nonzero
    lam[:, 1::3] = torch.as_tensor(limb.ints_to_words([P - 1]), device=dev)
    pts = torch.stack([limb.mod_mul(pts[c], lam, limb.FP) for c in range(3)])
    ident = curve_t.identity((count,), dev)
    return curve_t._point_select(torch.arange(count, device=dev) % 7 == 3, ident, pts).contiguous()


def add_operands(pool, count: int, gen):
    """Two point batches for ``point_add`` with every 5th lane a doubling
    and every 5th (offset 2) P + (-P), besides :func:`random_points`' lanes."""
    from mpc_bulletproof_tpu_torch.ops import curve_t

    a = random_points(pool, count, gen)
    b = random_points(pool, count, gen)
    b[:, :, 1::5] = a[:, :, 1::5]                            # doubling
    b[:, :, 2::5] = curve_t._point_neg(a[:, :, 2::5])        # P + (-P)
    return a.contiguous(), b.contiguous()


def serial_depth(unit: str, steps: int, dev_ms: float | None) -> dict:
    """A chain-bound row's serial depth: dependent steps of one lane and the
    measured ns a step (the kernel's device time over the chain)."""
    return {"unit": unit, "per_lane": steps,
            "ns_per_step": dev_ms * 1e6 / steps if dev_ms is not None else None}


def point_add_sweep(gpu: str, pool, gen) -> list:
    """Both point_add designs at each width of ``ADD_SWEEP``: held to the
    plain add, then timed by the profiler in turns (wide, narrow in one
    session, narrow, wide in the next)."""
    import torch

    from mpc_bulletproof_tpu_torch.ops import curve_t, kernels

    out = []
    for lanes in ADD_SWEEP:
        a, b = add_operands(pool, lanes, gen)
        want = curve_t._point_add(a, b)
        run = {d: (lambda d=d: kernels._point_add_launch(a, b, d)) for d in ADD_KERNEL}
        errs = {d: max_abs_err(fn(), want, 1) for d, fn in run.items()}
        torch.cuda.synchronize()
        order = list(run)
        turns = [device_ms_by_name([(ADD_KERNEL[d], run[d]) for d in o], 20)
                 for o in (order, order[::-1])]
        dms = {d: [t[ADD_KERNEL[d]] for t in turns] for d in run}
        row = {"phase": "point_add_sweep", "lanes": lanes, "dispatched": kernels.point_add_design(lanes),
               "max_abs_err": errs, "device_ms": dms,
               "serial": {d: serial_depth("product", ADD_PRODUCTS[d],
                                          min((t for t in dms[d] if t is not None), default=None))
                          for d in run},
               "bound_ms": bound(3 * POINT_BYTES * lanes, needs((lanes, POINT_ADD_NEEDS)))["bound_ms"], "gpu": gpu}
        emit(row)
        if any(errs.values()):
            raise RuntimeError(f"point_add disagrees with the plain add at {lanes} lanes: {errs}")
        out.append({k: row[k] for k in ("lanes", "dispatched", "max_abs_err", "device_ms")})
        del a, b, want
    return out


def mod_pow_ab(gpu: str, path: str, x, mp, e) -> dict:
    """The inverse by the ladder (the kernel's path for every other
    exponent) and by the GCD on the same lanes: both held to the plain
    version, then timed by the profiler in turns (ladder, GCD in one
    session, GCD, ladder in the next)."""
    from mpc_bulletproof_tpu_torch.ops import kernels
    from mpc_bulletproof_tpu_torch.ops.limb import FP

    want = kernels.mod_pow_plain(x, e, mp)
    run = {"ladder": lambda: kernels._mod_pow_launch(x, e, mp, False),
           "gcd": lambda: kernels._mod_pow_launch(x, e, mp, True)}
    errs = {b: max_abs_err(fn(), want, 0) for b, fn in run.items()}
    names = {"ladder": "mod_pow_kernel<", "gcd": "mod_inv_kernel<"}
    turns = [device_ms_by_name([(names[b], run[b]) for b in order], 20)
             for order in (("ladder", "gcd"), ("gcd", "ladder"))]
    dms = {b: [t[names[b]] for t in turns] for b in run}
    row = {"phase": "mod_pow_ab", "path": path, "n": x.shape[-1], "field": "FP" if mp is FP else "FR",
           "max_abs_err": errs, "device_ms": dms, "gpu": gpu}
    emit(row)
    if any(errs.values()):
        raise RuntimeError(f"mod_pow_static's inverse disagrees with the plain version: {row}")
    return {k: row[k] for k in ("path", "n", "field", "max_abs_err", "device_ms")}


def verify_width(n_bits: int, m_parties: int) -> int:
    """Points of the (n, m) mega-check: A, S, T_1, T_2, V.., B, B~, L.., R.., G, H."""
    nm = n_bits * m_parties
    return 4 + m_parties + 2 + 2 * (nm - 1).bit_length() + 2 * nm


def shuffle_phase_widths(k: int) -> dict:
    """Points of the k-shuffle prover's phase-2 MSMs (every multiplier is
    in phase 2): B~ and G, H over the 2 (k - 1) multipliers for A_I2 and
    S2, B~ and G for A_O2.  Each runs ``msm_device`` alone (k = 1)."""
    n2 = 2 * (k - 1)
    return {"A_I2,S2": 1 + 2 * n2, "A_O2": 1 + n2}


def shuffle_widths(k: int) -> tuple[int, int]:
    """(IPP width n, mega-check points) of a k-shuffle proof: 2 (k - 1)
    multipliers padded to n; A_I1..S2, the 2k V, T_1, T_3..T_6, B, B~, the
    L/R points, G and H."""
    n = 1 << (2 * (k - 1) - 1).bit_length()
    return n, 6 + 2 * k + 5 + 2 + 2 * (n - 1).bit_length() + 2 * n


def path_shapes(n_bits: int = N_BITS, m_parties: int = M_PARTIES, log2n: int = MSM_LOG2N,
                shuffle_k: int = SHUFFLE_K, ipp_log2n: int = IPP_FULL[-1]) -> dict:
    """The shapes at which each path launches the point kernels (``tail``:
    the bucket tails' segment sums, ``point_reduce``).  prove: an
    IPP round's L/R pair of split-table MSMs (``point_add`` at its chunk
    lane scan, Horner over 8 windows of both MSMs); verify: the (n, m)
    mega-check's MSM; msm: 2^log2n points (``point_add`` at the bucket
    tails, the widest of those paths); r1cs_prove: an IPP round's pair of
    252-bit MSMs over n + 1 points (both MSMs' windows in one bucket phase,
    Horner at k = 2), and under ``r1cs_prove:<MSMs>`` the phase-2 MSMs of
    at least ``_DEVICE_MIN`` points (:func:`shuffle_phase_widths`; the
    smaller ones run on the host); r1cs_verify: the shuffle's mega-check;
    ipp: a round of the IPP alone at 2^ipp_log2n, a pair of 252-bit MSMs
    over n + 1 points as r1cs_prove's; mesh: prove's round pair on one of
    ``MESH_PATH_SHARDS`` shards (its slice of the lanes)."""
    from mpc_bulletproof_tpu_torch.constants import FIELD_BITS
    from mpc_bulletproof_tpu_torch.ops import backend
    from mpc_bulletproof_tpu_torch.ops import msm as msm_mod

    nm = n_bits * m_parties

    def split_pair(n):
        W = 2 * 8
        nt, T = msm_mod._chunk_shape(W, n)
        return {"n": n, "c": msm_mod.SPLIT_WINDOW, "W": W, "nt": nt, "T": T, "add": (W, nt),
                "tail": (W, 1 << (msm_mod.SPLIT_WINDOW - 1)), "horner": (8, 2)}

    lanes = msm_mod.SPLIT_CHUNKS * (nm + 1)
    shapes = {"prove": split_pair(lanes), "mesh": split_pair(-(-lanes // MESH_PATH_SHARDS))}
    ipp_n, r1cs_width = shuffle_widths(shuffle_k)
    phase = [(f"r1cs_prove:{name}", n, 1) for name, n in shuffle_phase_widths(shuffle_k).items()
             if n >= backend._DEVICE_MIN]
    for path, n, k in (("verify", verify_width(n_bits, m_parties), 1), ("msm", 1 << log2n, 1),
                       ("r1cs_prove", ipp_n + 1, 2), *phase, ("r1cs_verify", r1cs_width, 1),
                       ("ipp", (1 << ipp_log2n) + 1, 2)):
        c = msm_mod.select_window(n)
        nw = -(-FIELD_BITS // c)
        W = msm_mod._window_group(k * nw, n)
        nt, T = msm_mod._chunk_shape(W, n)
        shapes[path] = {"n": n, "c": c, "W": W, "nt": nt, "T": T, "add": (W, 1 << (c - 1)),
                        "tail": (W, 1 << (c - 1)), "horner": (nw, k)}
    return shapes


def timed_ms(fn):
    """``fn()`` and its time in ms by CUDA events around that one call."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_kernels(gpu: str, dev, n_bits: int = N_BITS, m_parties: int = M_PARTIES,
                  log2n: int = MSM_LOG2N, shuffle_k: int = SHUFFLE_K, ipp_log2n: int = IPP_FULL[-1]) -> dict:
    """Each kernel against its plain version: the point kernels at the
    shapes each path launches them with (:func:`path_shapes`), the others
    at the prove path's or their own.  Returns per kernel the prove (or
    only) row, the rows of the other paths under ``at_paths``."""
    import torch

    from mpc_bulletproof_tpu_torch.constants import P, R
    from mpc_bulletproof_tpu_torch.ops import curve_t, kernels, limb
    from mpc_bulletproof_tpu_torch.ops import msm as msm_mod
    from mpc_bulletproof_tpu_torch.ops.curve import StarkPoint
    from mpc_bulletproof_tpu_torch.ops.limb import FP, FR, NW

    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    G = StarkPoint.generator()
    host_pool = [G]
    for _ in range(63):
        host_pool.append(host_pool[-1] + host_pool[-1] + G)
    pool = torch.as_tensor(curve_t.points_from_host(host_pool), device=dev)
    nm = n_bits * m_parties
    rows: dict = {}

    def check(name, path, args, fn, plain, bnd, shape, word_dim=1, launch=None, extra=None,
              serial=None):
        """``serial``: (unit, dependent steps of one lane's chain) for the
        rows bound by a chain; the row gets the ns a step it measured."""
        got = fn(*args)
        torch.cuda.synchronize()
        want, plain_ms = timed_ms(plain)
        res = {"phase": "kernel", "name": name, "path": path, "shape": shape, "tolerance": 0,
               "equal": bool(torch.equal(got, want)), "max_abs_err": max_abs_err(got, want, word_dim),
               "kernel_ms": cuda_ms(lambda: fn(*args), 20), "device_ms": device_ms(lambda: fn(*args), 20),
               "plain_ms": plain_ms, **bnd, **(extra or {}), "gpu": gpu}
        res["bound_share"] = share(res["bound_ms"], res["device_ms"])
        if launch is not None:
            res["launch"] = launch
        if serial is not None:
            res["serial"] = serial_depth(*serial, res["device_ms"])
        emit(res)
        rows.setdefault(name, {})[path] = res

    shapes = path_shapes(n_bits, m_parties, log2n, shuffle_k, ipp_log2n)
    for path, sh in shapes.items():
        aw, an = sh["add"]
        a, b = add_operands(pool, aw * an, gen)
        a, b = a.reshape(3, NW, aw, an).contiguous(), b.reshape(3, NW, aw, an).contiguous()
        design = kernels.point_add_design(aw * an)
        check("point_add", path, (a, b), kernels.point_add, lambda: curve_t._point_add(a, b),
              bound(3 * POINT_BYTES * aw * an, needs((aw * an, POINT_ADD_NEEDS))), {"W": aw, "lanes": an},
              extra={"design": design}, serial=("product", ADD_PRODUCTS[design]))
        del a, b
        T, L = sh["T"], sh["W"] * sh["nt"]
        scan_x = random_points(pool, T * L, gen).reshape(3, NW, T, L).contiguous()
        check("point_scan_steps_inner", path, (scan_x,), kernels.point_scan_steps_inner,
              lambda: kernels.point_scan_plain(scan_x), scan_bound(T, L), {"T": T, "L": L},
              launch=scan_launch(L))
        del scan_x
        nw, k = sh["horner"]
        c = sh["c"]
        horner_w = random_points(pool, nw * k, gen).reshape(3, NW, nw, k).permute(2, 0, 1, 3).contiguous()
        check("point_horner_multi", path, (horner_w, c), kernels.point_horner_multi,
              lambda: kernels.point_horner_plain(horner_w, c),
              bound(POINT_BYTES * (nw * k + k), needs(((nw - 1) * (c + 1) * k, POINT_ADD_NEEDS))),
              {"nw": nw, "c": c, "k": k}, launch=horner_launch(k),
              serial=("product", (nw - 1) * (c + 1) * ADD_PRODUCTS["narrow"]))
        torch.cuda.empty_cache()

    # the ipp phase's fold of the widest G: one round's 2^(ipp_log2n - 1) lanes, the wide design
    aw = 1 << (ipp_log2n - 1)
    a, b = add_operands(pool, aw, gen)
    check("point_add", "ipp_fold", (a, b), kernels.point_add, lambda: curve_t._point_add(a, b),
          bound(3 * POINT_BYTES * aw, needs((aw, POINT_ADD_NEEDS))), {"W": 1, "lanes": aw},
          extra={"design": kernels.point_add_design(aw)}, serial=("product", ADD_PRODUCTS[kernels.point_add_design(aw)]))
    del a, b
    torch.cuda.empty_cache()

    # no path launches point_scan_steps: the prove scan's shape, steps outside the words
    T, L = shapes["prove"]["T"], shapes["prove"]["W"] * shapes["prove"]["nt"]
    steps_x = random_points(pool, T * L, gen).reshape(3, NW, T, L).transpose(1, 2).contiguous()
    check("point_scan_steps", "none", (steps_x,), kernels.point_scan_steps,
          lambda: kernels.point_scan_steps_plain(steps_x), scan_bound(T, L), {"T": T, "L": L},
          word_dim=2, launch=scan_launch(L))
    # both scans where the last block of lanes is part-filled
    T, L = PART_BLOCK_SCAN
    part_x = random_points(pool, T * L, gen).reshape(3, NW, T, L).contiguous()
    check("point_scan_steps_inner", "part_block", (part_x,), kernels.point_scan_steps_inner,
          lambda: kernels.point_scan_plain(part_x), scan_bound(T, L), {"T": T, "L": L},
          launch=scan_launch(L))
    part_x = part_x.transpose(1, 2).contiguous()
    check("point_scan_steps", "part_block", (part_x,), kernels.point_scan_steps,
          lambda: kernels.point_scan_steps_plain(part_x), scan_bound(T, L), {"T": T, "L": L},
          word_dim=2, launch=scan_launch(L))
    del part_x
    nw_p, c_p = shapes["prove"]["horner"][0], shapes["prove"]["c"]
    add_ms = rows["point_horner_multi"]["prove"]["device_ms"] / ((nw_p - 1) * (c_p + 1))
    for path, (S, n) in reduce_cases(shapes, m_parties, nm).items():
        rows.setdefault("point_reduce", {})[path] = reduce_row(gpu, path, S, n, pool, gen, add_ms)
        torch.cuda.empty_cache()
    reduce_plans = reduce_plans_check(gpu, pool, gen)

    def scalars(count, mp):
        xs = torch.randint(-(2**63), 2**63 - 1, (NW, count), generator=gen, device=dev)
        xs[3] &= (1 << 58) - 1
        edge = torch.as_tensor(limb.ints_to_words([0, 1, mp.modulus - 1, mp.modulus - 2]), device=dev)
        k = min(4, count)
        xs[:, :k] = edge[:, :k]
        return xs.contiguous()

    def pow_scalars(count, mp):
        """:func:`scalars` with the inverse's edge lanes first, as many as
        fit: 0, 1, m - 1, m - 2, powers of two, values just below 2^251 and
        long runs of equal bits."""
        m = mp.modulus
        edge = ([0, 1, m - 1, m - 2] + [1 << k for k in (1, 31, 32, 63, 64, 127, 128, 192, 250)]
                + [(1 << 251) - i for i in (1, 2, 3)] + [int("10" * 125, 2), int("1" * 100 + "0" * 100, 2)])
        xs = scalars(count, mp)
        k = min(len(edge), count)
        xs[:, :k] = torch.as_tensor(limb.ints_to_words(edge[:k]), device=dev)
        return xs.contiguous()

    pow_paths = {  # per path (lanes, field, exponent); the first is timed
        # per IPP round the L/R affine conversion (FP, 2) and u^-1 (FR, 1); V affine (FP, m);
        # the split table's affine conversion
        "prove": [(2, FP, P - 2), (1, FR, R - 2), (m_parties, FP, P - 2),
                  (msm_mod.SPLIT_CHUNKS * (2 * nm + 1), FP, P - 2)],
        "r1cs_prove": [(1, FR, R - 2), (2, FP, P - 2)],
        # no path: the ladder at a general exponent, the FR inverse over all edge lanes
        "none": [(64, FP, 65537), (64, FR, 65537), (64, FR, R - 2)],
    }

    def ladder_products(e):
        ndig = (e.bit_length() + 3) // 4
        return 2 + 14 + 4 * (ndig - 1) + sum(1 for d in range(ndig) if (e >> (4 * d)) & 15)

    def pow_cost(k, mp, e):
        """(bound, serial depth) of k lanes of x^e."""
        if kernels.is_inverse(e, mp):
            return bound(2 * 32 * k, needs((k, gcd_needs(mp is FR)))), ("gcd_step", GCD_STEPS)
        work = needs((k * ladder_products(e), FP_MUL_NEEDS if mp is FP else FR_MUL_NEEDS))
        return bound(2 * 32 * k, work), ("product", ladder_products(e))

    inverse_cases = []
    for path, cases in pow_paths.items():
        pow_inputs = [(pow_scalars(k, mp), mp, e) for k, mp, e in cases]
        errs, equal = [], True
        for x, mp, e in pow_inputs:
            got = kernels.mod_pow_static(x, e, mp)
            want = kernels.mod_pow_plain(x, e, mp)
            equal &= bool(torch.equal(got, want))
            errs.append(max_abs_err(got, want, 0))
            if kernels.is_inverse(e, mp) and path != "none":
                inverse_cases.append((path, x, mp, e))
        x0, mp0, e0 = pow_inputs[0]
        bnd, serial = pow_cost(x0.shape[-1], mp0, e0)
        dms = device_ms(lambda: kernels.mod_pow_static(x0, e0, mp0), 20)
        res = {"phase": "kernel", "name": "mod_pow_static", "path": path,
               "shape": [{"n": k, "field": "FP" if mp is FP else "FR",
                          "branch": "gcd" if kernels.is_inverse(e, mp) else "ladder"} for k, mp, e in cases],
               "tolerance": 0, "equal": equal, "max_abs_err": max(errs),
               "kernel_ms": cuda_ms(lambda: kernels.mod_pow_static(x0, e0, mp0), 20),
               "device_ms": dms,
               "plain_ms": timed_ms(lambda: kernels.mod_pow_plain(x0, e0, mp0))[1],
               **bnd, "bound_share": share(bnd["bound_ms"], dms), "serial": serial_depth(*serial, dms),
               "gpu": gpu}
        emit(res)
        rows.setdefault("mod_pow_static", {})[path] = res
    pow_ab = [mod_pow_ab(gpu, *case) for case in inverse_cases]
    sweep = point_add_sweep(gpu, pool, gen)
    results = check_vec_ops(gpu, scalars)
    rows["point_add"]["prove"]["sweep"] = sweep
    rows["point_reduce"]["prove"]["plans_check"] = reduce_plans["max_abs_err"]
    rows["mod_pow_static"]["prove"]["gcd_vs_ladder"] = pow_ab
    for name, by_path in rows.items():
        first = by_path.get("prove", next(iter(by_path.values())))
        results[name] = {**first, "equal": all(r["equal"] for r in by_path.values()),
                         "max_abs_err": max(r["max_abs_err"] for r in by_path.values()),
                         "at_paths": {p: {k: r[k] for k in ("shape", "max_abs_err", "kernel_ms", "device_ms",
                                                            "plain_ms", "bound_ms", "bound_by", "pipe",
                                                            "pipe_bound_ms", "bytes_bound_ms", "bound_share", "launch",
                                                            "design", "serial", "plan", "launches_per_call",
                                                            "dependency_bound_ms", "vs_halving_tree")
                                          if k in r}
                                      for p, r in by_path.items()}}
    bad = [n for n, r in results.items() if not r["equal"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    return results


def reduce_cases(shapes: dict, m_parties: int, nm: int) -> dict:
    """``{row: (S, n)}``, every segmented sum the paths run: prove's A bit
    sum (one segment of 2nm points), its bucket tails and its fixed-base
    commitments (m + 2 of 64 windows); each other path's bucket tails
    (:func:`path_shapes`); the mesh path's shard of the A bit sum and its
    collective (an IPP round's pair of partials, one a shard); the msm
    phase's set-up commitments; and a ragged shape whose segments span
    blocks and a shape of one 1-level pass."""
    from mpc_bulletproof_tpu_torch.ops import msm as msm_mod

    windows = 2 * msm_mod.FB_WINDOWS
    cases = {"prove": (1, 2 * nm), "prove:tail": shapes["prove"]["tail"],
             "prove:fixed_commit": (m_parties + 2, windows),
             "mesh:A": (1, -(-2 * nm // MESH_PATH_SHARDS)), "mesh:collective": (2, MESH_PATH_SHARDS)}
    # the mesh path's bucket tails are prove's shape
    cases.update({path: sh["tail"] for path, sh in shapes.items() if path not in ("prove", "mesh")})
    cases.update({"msm_setup:fixed_commit": (MSM_SETUP_COMMITS, windows), "ragged": RAGGED_REDUCE,
                  "one_level": ONE_LEVEL_REDUCE})
    return cases


def reduce_row(gpu: str, path: str, S: int, n: int, pool, gen, add_ms: float) -> dict:
    """``point_reduce`` on S segments of n random points against its plain
    version (word for word); the launches of one call, read from the
    counter and held to the plan's passes; its time by events and per call
    by the profiler (every pass); the throughput bound and the dependency
    bound (ceil(log2 n) dependent adds at ``add_ms``, Horner's add on one
    warp, measured in this run).  Below 2^20 points also, in turns, the
    former halving tree of ``point_add`` launches (``vs_halving_tree``; a
    different association, so the sums are held equal as points)."""
    import math

    import torch

    from mpc_bulletproof_tpu_torch.ops import kernels
    from mpc_bulletproof_tpu_torch.ops.limb import NW

    x = random_points(pool, S * n, gen)
    x = (x if S == 1 else x.reshape(3, NW, S, n)).contiguous()
    plan = kernels.point_reduce_plan(S, n)
    kernels.reset_launches()
    got = kernels.point_reduce(x)
    launches = kernels.launches["point_reduce"]
    if launches != len(plan):
        raise RuntimeError(f"point_reduce made {launches} launches at {path}, its plan {len(plan)}")
    torch.cuda.synchronize()
    want, plain_ms = timed_ms(lambda: kernels.point_reduce_plain(x))
    run = lambda: kernels.point_reduce(x)
    recorded: dict = {}
    bnd = bound(POINT_BYTES * (S * n + S), needs((S * (n - 1), POINT_ADD_NEEDS)))
    res = {"phase": "kernel", "name": "point_reduce", "path": path, "shape": {"S": S, "n": n},
           "tolerance": 0, "equal": bool(torch.equal(got, want)), "max_abs_err": max_abs_err(got, want, 1),
           "plan": plan, "launches_per_call": launches, "kernel_ms": cuda_ms(run, 20),
           "device_ms": device_ms(run, 20, True, recorded), "device_launches_recorded": recorded[""] / 20,
           "plain_ms": plain_ms, **bnd,
           "dependency_bound_ms": math.ceil(math.log2(n)) * add_ms if n > 1 else 0.0,
           "add_latency_ms": add_ms, "gpu": gpu}
    res["bound_share"] = share(bnd["bound_ms"], res["device_ms"])
    if S * n < 1 << 20:
        if not affine_equal(halving_tree(x), got):
            raise RuntimeError(f"point_reduce and the halving tree disagree as points at {path}")
        t = {"halving_tree": [], "point_reduce": []}
        rec = {"halving_tree": {}, "point_reduce": {}}
        for who in ("halving_tree", "point_reduce", "point_reduce", "halving_tree"):
            t[who].append(device_ms(lambda: halving_tree(x) if who == "halving_tree" else run(), 20, True,
                                    rec[who]))
        res["vs_halving_tree"] = {k: {"device_ms": v, "launches_recorded": rec[k][""] / 20}
                                  for k, v in t.items()}
    emit(res)
    if not res["equal"]:
        raise RuntimeError(f"point_reduce disagrees with its plain version at {path}: {res['max_abs_err']}")
    return res


def reduce_plans_check(gpu: str, pool, gen) -> dict:
    """Every tree depth the kernel has (1 to 6 levels a pass, each repeated
    until one point is left) and a fold, each run as its own plan on 3
    segments of 300 points, against :func:`point_reduce_plain` of the same
    plan, word for word."""
    import torch

    from mpc_bulletproof_tpu_torch.ops import kernels
    from mpc_bulletproof_tpu_torch.ops.limb import NW

    x = random_points(pool, 3 * 300, gen).reshape(3, NW, 3, 300).contiguous()
    plans = {f"tree{lv}": [("tree", lv)] * -(-9 // lv) for lv in range(1, kernels.REDUCE_TREE_LEVELS + 1)}
    plans["fold4"] = [("fold", 4)] + kernels.point_reduce_plan(3, 75)
    errs = {k: max_abs_err(kernels._point_reduce_launch(x, p), kernels.point_reduce_plain(x, p), 1)
            for k, p in plans.items()}
    res = {"phase": "kernel_plans", "name": "point_reduce", "shape": {"S": 3, "n": 300}, "tolerance": 0,
           "plans": plans, "max_abs_err": errs, "equal": all(e == 0 for e in errs.values()), "gpu": gpu}
    emit(res)
    if not res["equal"]:
        raise RuntimeError(f"point_reduce plans disagree with their plain versions: {errs}")
    return res


def check_vec_ops(gpu: str, scalars) -> dict:
    """vec_mul, vec_add and vec_sub against their plain versions at three
    widths: ``VEC_N`` (no path), 2^IPP_FULL[-1] (the IPP's full-width
    coefficient products and witness folds, the folds by one challenge
    column) and ``MPC_VEC_N`` (the mpc path's t-polynomial Beaver
    products), each FR at (NW, n), FR with a width-1 b (the MAC key and
    public scalars of the share plane, the IPP's challenges), and FP; the
    FR full-width case and the width-1 product are timed.  Then the share
    plane's entries at the mpc path's shapes (:func:`check_share_plane`).
    Returns ``{"vec2": row, ...}``: the vec_mul row at the mpc path's width
    with every op's row under ``ops`` and every width under ``at_paths``,
    and a row per share-plane entry."""
    import torch

    from mpc_bulletproof_tpu_torch.ops import kernels, limb
    from mpc_bulletproof_tpu_torch.ops.limb import FP, FR, NW

    def pair(n, mp):
        a, b = scalars(n, mp), scalars(n, mp)
        b[:, :4] = b[:, :4].flip(-1).contiguous()         # edge lanes meet other edges
        return a, b

    at_paths, rows = {}, {}
    for path, n in (("none", VEC_N), ("ipp", 1 << IPP_FULL[-1]), ("mpc", MPC_VEC_N)):
        (a, b), (fa, fb) = pair(n, FR), pair(n, FP)
        b1 = b[:, 2:3].contiguous()                          # r - 1, broadcast
        rows = {}
        for op, fn, plain, per_lane in (("mul", kernels.vec_mul, limb.mod_mul, FR_MUL_NEEDS),
                                        ("add", kernels.vec_add, limb.mod_add, FE_ADD_NEEDS),
                                        ("sub", kernels.vec_sub, limb.mod_sub, FR_SUB_NEEDS)):
            errs, equal = [], True
            for x, y, mp in ((a, b, FR), (a, b1, FR), (fa, fb, FP)):
                got = fn(x, y, mp)
                torch.cuda.synchronize()
                want = plain(x, y, mp)
                equal &= bool(torch.equal(got, want))
                errs.append(max_abs_err(got, want, 0))
            bnd = bound(3 * NW * 8 * n, needs((n, per_lane)))
            rows[op] = {"phase": "kernel", "name": f"vec_{op}", "path": path,
                        "shape": [{"n": n, "field": "FR"}, {"n": n, "b": 1, "field": "FR"},
                                  {"n": n, "field": "FP"}],
                        "tolerance": 0, "equal": equal, "max_abs_err": max(errs),
                        "kernel_ms": cuda_ms(lambda: fn(a, b, FR), 20),
                        "device_ms": device_ms(lambda: fn(a, b, FR), 20),
                        "plain_ms": timed_ms(lambda: plain(a, b, FR))[1], **bnd, "gpu": gpu}
            rows[op]["bound_share"] = share(bnd["bound_ms"], rows[op]["device_ms"])
            if op == "mul":     # one product a lane: b R made once a block
                pb = bound(NW * 8 * (2 * n + 1), needs((n + 1, FR_MUL_NEEDS)))
                rows[op]["public_b"] = {"shape": {"n": n, "b": 1, "field": "FR"},
                                        "kernel_ms": cuda_ms(lambda: fn(a, b1, FR), 20),
                                        "device_ms": device_ms(lambda: fn(a, b1, FR), 20),
                                        "plain_ms": timed_ms(lambda: plain(a, b1, FR))[1], **pb}
            emit(rows[op])
        at_paths[path] = {f"vec_{op}": {k: r[k] for k in ("shape", "max_abs_err", "kernel_ms", "device_ms",
                                                           "plain_ms", "bound_ms", "bound_by", "pipe",
                                                           "pipe_bound_ms", "bytes_bound_ms", "bound_share",
                                                           "public_b")
                                        if k in r}
                          for op, r in rows.items()}
        at_paths[path]["equal"] = all(r["equal"] for r in rows.values())
    vec = {**rows["mul"], "equal": all(p["equal"] for p in at_paths.values()),
           "max_abs_err": max(r["max_abs_err"] for p in at_paths.values() for k, r in p.items() if k != "equal"),
           "ops": {k: v for k, v in at_paths["mpc"].items() if k != "equal"}, "at_paths": at_paths}
    return {"vec2": vec, **check_share_plane(gpu, scalars)}


def composed_beaver_round(x, y, triple, theirs, alpha_w, party):
    """A Beaver round's local algebra as the share plane ran it before, one
    elementwise launch an operation (``vec_mul/add/sub``): 4 subs and two
    concatenations, the opening's add, d and e copied out, 4 products and
    4 adds for ``c + d b + e a``, ``d e``, its MAC term and 1 or 2 adds
    (16 or 17 launches).  ``theirs`` stands for the peer's shares."""
    import torch

    from mpc_bulletproof_tpu_torch.ops import kernels
    from mpc_bulletproof_tpu_torch.ops.limb import FR

    k = x.shape[-1]
    (a, a_m), (b, b_m), (c, c_m) = triple
    xs = torch.cat([kernels.vec_sub(x, a, FR), kernels.vec_sub(y, b, FR)], dim=-1)
    torch.cat([kernels.vec_sub(x, a_m, FR), kernels.vec_sub(y, b_m, FR)], dim=-1)   # MACs of x - a, y - b
    opened = kernels.vec_add(xs, theirs, FR)
    d, e = opened[:, :k].contiguous(), opened[:, k:].contiguous()
    s = kernels.vec_add(kernels.vec_add(c, kernels.vec_mul(b, d, FR), FR), kernels.vec_mul(a, e, FR), FR)
    m = kernels.vec_add(kernels.vec_add(c_m, kernels.vec_mul(b_m, d, FR), FR), kernels.vec_mul(a_m, e, FR), FR)
    d_e = kernels.vec_mul(d, e, FR)
    if party == 0:
        s = kernels.vec_add(s, d_e, FR)
    return torch.stack([s, kernels.vec_add(m, kernels.vec_mul(d_e, alpha_w, FR), FR)])


def fused_beaver_round(x, y, triple, theirs, alpha, party):
    """The same round on this tree's share plane: three launches."""
    from mpc_bulletproof_tpu_torch.ops import kernels
    from mpc_bulletproof_tpu_torch.ops.limb import FR

    opened = kernels.vec_add(kernels.beaver_diff(x, y, triple), theirs, FR)
    return kernels.beaver_combine(opened, triple, alpha, party)


def composed_poly3(coeffs, x_w):
    """The former evaluation: Horner as 3 products by a width-1 x and 3 adds on
    each row (12 launches)."""
    import torch

    from mpc_bulletproof_tpu_torch.ops import kernels
    from mpc_bulletproof_tpu_torch.ops.limb import FR

    out = []
    for row in range(2):
        acc = coeffs[3, row]
        for j in (2, 1, 0):
            acc = kernels.vec_add(kernels.vec_mul(acc, x_w, FR), coeffs[j, row], FR)
        out.append(acc)
    return torch.stack(out)


def check_share_plane(gpu: str, scalars) -> dict:
    """The share plane's entries against their plain versions at the mpc
    path's shapes: ``beaver_diff`` at k = ``MPC_VEC_N`` (2k lanes out),
    ``beaver_combine`` at k = ``MPC_VEC_N`` for both parties and the MAC key
    share at 0, r - 1 and random, ``poly3_eval`` at the evaluations' width
    (``MPC_BITS * MPC_VALUES``) at x = 0, 1, r - 1 and random; edge lanes
    (0, 1, r - 1, r - 2) in every operand.  Then in turns (composed, fused,
    fused, composed) the device time of one Beaver round's local algebra
    and of one evaluation, fused against the former composition of
    ``vec_mul/add/sub`` calls (:func:`composed_beaver_round`,
    :func:`composed_poly3`) at the same shapes, each held equal to the
    other."""
    import random

    import torch

    from mpc_bulletproof_tpu_torch.ops import kernels, limb
    from mpc_bulletproof_tpu_torch.ops.limb import FR, NW

    r = FR.modulus
    rng = random.Random(7)
    k, ke = MPC_VEC_N, MPC_BITS * MPC_VALUES
    stack = lambda count, width: torch.stack([scalars(width, FR) for _ in range(2 * count)]) \
        .reshape(count, 2, NW, width).contiguous()
    x, y = scalars(k, FR), scalars(k, FR).flip(-1).contiguous()
    triple, de, coeffs = stack(3, k), scalars(2 * k, FR), stack(4, ke)
    alphas = (0, r - 1, rng.randrange(r))
    xs = (0, 1, r - 1, rng.randrange(r))
    cases = {
        "beaver_diff": ([(x, y, triple)], kernels.beaver_diff, kernels.beaver_diff_plain,
                        [{"k": k, "lanes_out": 2 * k}],
                        bound(6 * k * NW * 8, needs((2 * k, FR_SUB_NEEDS)))),
        "beaver_combine": ([(de, triple, al, p) for p in (0, 1) for al in alphas[::-1]], kernels.beaver_combine,
                           kernels.beaver_combine_plain,
                           [{"k": k, "party": p, "alpha": a} for p in (0, 1) for a in ("random", "r-1", "0")],
                           bound(10 * k * NW * 8, needs((8 * k, FR_MUL_NEEDS), (6 * k, FE_ADD_NEEDS)))),
        "poly3_eval": ([(coeffs, xv) for xv in xs], kernels.poly3_eval, kernels.poly3_eval_plain,
                       [{"k": ke, "x": v} for v in ("0", "1", "r-1", "random")],
                       bound(10 * ke * NW * 8, needs((6 * ke, FR_MUL_NEEDS), (6 * ke, FE_ADD_NEEDS)))),
    }
    out = {}
    for name, (argsets, fn, plain, shape, bnd) in cases.items():
        errs, equal = [], True
        for args in argsets:
            got = fn(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            equal &= bool(torch.equal(got, want))
            errs.append(max_abs_err(got, want, got.dim() - 2))
        args = argsets[-1] if name == "poly3_eval" else argsets[0]   # timed: party 0, random x
        row = {"phase": "kernel", "name": name, "path": "mpc", "shape": shape, "tolerance": 0,
               "equal": equal, "max_abs_err": max(errs),
               "kernel_ms": cuda_ms(lambda: fn(*args), 20), "device_ms": device_ms(lambda: fn(*args), 20),
               "plain_ms": timed_ms(lambda: plain(*args))[1], **bnd, "gpu": gpu}
        row["bound_share"] = share(bnd["bound_ms"], row["device_ms"])
        emit(row)
        out[name] = row

    # fused against composed, in turns
    theirs = scalars(2 * k, FR)
    alpha = alphas[-1]
    alpha_w = torch.as_tensor(limb.ints_to_words([alpha]), device=x.device)
    x_w = torch.as_tensor(limb.ints_to_words([xs[-1]]), device=x.device)
    pairs = {"beaver_round": (lambda: composed_beaver_round(x, y, triple, theirs, alpha_w, 0),
                              lambda: fused_beaver_round(x, y, triple, theirs, alpha, 0)),
             "evaluation": (lambda: composed_poly3(coeffs, x_w), lambda: kernels.poly3_eval(coeffs, xs[-1]))}
    turns = {}
    for what, (composed, fused) in pairs.items():
        if not torch.equal(composed(), fused()):
            raise RuntimeError(f"share plane: the fused {what} disagrees with the composed one")
        t = {"composed": [], "fused": []}
        launches = {}
        for who in ("composed", "fused", "fused", "composed"):
            fn = composed if who == "composed" else fused
            kernels.reset_launches()
            fn()
            torch.cuda.synchronize()
            launches[who] = sum(kernels.launches.values())
            t[who].append(device_ms(fn, 20, per_call=True) * 1e3)
        turns[what] = {"shape": {"k": k if what == "beaver_round" else ke}, "device_us": t,
                       "launches": launches}
    kernels.reset_launches()
    emit({"phase": "share_plane_turns", **turns, "gpu": gpu})
    out["beaver_combine"]["vs_composed"] = turns
    return out


def main_path(gpu: str, dev, n_bits: int = N_BITS, m_parties: int = M_PARTIES) -> dict:
    import torch

    from mpc_bulletproof_tpu_torch import (BulletproofGens, HashChainTranscript, PedersenGens,
                                           RangeProof)
    from mpc_bulletproof_tpu_torch import pinned
    from mpc_bulletproof_tpu_torch.ops import kernels

    want = pinned.DIGESTS[(n_bits, m_parties)]
    values, blindings = pinned.inputs(n_bits, m_parties)

    def prove():
        tr = HashChainTranscript(pinned.TRANSCRIPT_LABEL)
        proof, V = RangeProof.prove_multiple(bp_gens, pc_gens, tr, values, blindings, n_bits,
                                             device=dev, rng_bytes=pinned.det_stream())
        digest = pinned.proof_digest(proof, V, tr.state)
        if digest != want:
            raise RuntimeError(f"proof digest {digest} != pinned {want}")
        return proof, V

    t0 = time.perf_counter()
    bp_gens = BulletproofGens(n_bits, m_parties, device=dev)
    pc_gens = PedersenGens()
    torch.cuda.synchronize()
    gens_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, V = prove()                    # cold: builds the device tables
    cold_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    prove()
    counted_s = time.perf_counter() - t0
    launches = read_launches("prove")

    warm = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARM_PROOFS):
        t0 = time.perf_counter()
        prove()
        warm.append(time.perf_counter() - t0)
    res = {"phase": "main_path", "n": n_bits, "m": m_parties, "digest": want, "digest_equal": True,
           "proof_bytes": len(proof.to_bytes()), "gens_s": gens_s, "cold_prove_s": cold_s,
           "counted_prove_s": counted_s, "warm_prove_s": warm,
           "us_per_proof_median": statistics.median(warm) * 1e6,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": launches, "gpu": gpu}
    emit(res)
    emit(profile_run(prove, res["us_per_proof_median"], gpu, "prove"))
    res.update(proof=proof, V=V, values=values, bp_gens=bp_gens, pc_gens=pc_gens,
               proof_run=(lambda: None, lambda _: prove()))
    return res


def tampered(proof, case: str):
    """A copy of ``proof`` with t_x + 1, or with L_1 and R_1 swapped."""
    from mpc_bulletproof_tpu_torch import RangeProof

    data = proof.to_bytes()
    if case == "t_x+1":
        t_x = (int.from_bytes(data[128:160], "big") + 1) % proof.t_x.MODULUS
        data = data[:128] + t_x.to_bytes(32, "big") + data[160:]
    else:
        data = data[:224] + data[256:288] + data[224:256] + data[288:]
    return RangeProof.from_bytes(data)


def replay_check(proof, V, n_bits: int, tr, dev) -> dict:
    """A verification's transcript replay on the card against the host
    route: one ``keccak_transcript`` launch, the same challenges, and the
    caller's transcript left in the host route's final state.  Raises if
    any differs."""
    import torch

    from mpc_bulletproof_tpu_torch import transcript
    from mpc_bulletproof_tpu_torch.ops import kernels

    steps = proof._transcript_steps(V, n_bits)
    host, host_us = tr(), []
    for label, msg in steps:
        if msg is None:
            host_us.append(int(host.challenge_scalar(label)))
        else:
            host.append_message(label, msg)
    on_card = tr()
    torch.cuda.synchronize()
    kernels.reset_launches()
    card_us = transcript.replay([on_card], [steps], dev)[0]
    res = {"blocks": len(steps), "challenges": len(card_us), "launches_one_verify": kernels.launches["keccak_transcript"],
           "challenges_equal": card_us == host_us, "state_equal": on_card.state == host.state}
    if not (res["challenges_equal"] and res["state_equal"] and res["launches_one_verify"] == 1):
        raise RuntimeError(f"the replay on the card is not the host route's: {res}")
    return res


def verify_phase(gpu: str, dev, mp: dict, n_bits: int = N_BITS) -> dict:
    """Verify the main path's proof, reject two tampered copies, verify a
    batch of two; launches and times of one verification."""
    import torch

    from mpc_bulletproof_tpu_torch import (HashChainTranscript, RangeProof, Scalar,
                                           VerificationError, pinned)
    from mpc_bulletproof_tpu_torch.ops import backend, kernels

    proof, V = mp["proof"], mp["V"]
    bp_gens, pc_gens = mp["bp_gens"], mp["pc_gens"]
    m = len(V)
    tr = lambda: HashChainTranscript(pinned.TRANSCRIPT_LABEL)
    verify = lambda p=proof: p.verify_multiple(bp_gens, pc_gens, tr(), V, n_bits, device=dev)

    t0 = time.perf_counter()
    verify()                                                    # cold
    cold_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    kernels.reset_launches()
    verify()
    launches = read_launches("verify")

    rejected = {}
    for case in ("t_x+1", "swap_L1_R1"):
        try:
            verify(tampered(proof, case))
        except VerificationError:
            rejected[case] = True
        else:
            raise RuntimeError(f"verify accepted a tampered proof ({case})")

    # a second, independent proof (fresh blinding) and the batch of both
    values2 = [(v * 7919 + 13) % (1 << n_bits) for v in mp["values"]]
    proof2, V2 = RangeProof.prove_multiple(bp_gens, pc_gens, HashChainTranscript(b"batch-2"), values2,
                                           [Scalar.random() for _ in values2], n_bits, device=dev)
    batch = lambda second: RangeProof.verify_batch(
        [proof, second], bp_gens, pc_gens, [tr(), HashChainTranscript(b"batch-2")], [V, V2], n_bits,
        device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    batch(proof2)
    batch_replays = kernels.launches["keccak_transcript"]
    try:
        batch(tampered(proof2, "t_x+1"))
    except VerificationError:
        rejected["batch_t_x+1"] = True
    else:
        raise RuntimeError("verify_batch accepted a batch with a tampered proof")
    replay = replay_check(proof, V, n_bits, tr, dev)
    replay["launches_batch_of_2"] = batch_replays
    if replay["launches_batch_of_2"] != 1:
        raise RuntimeError(f"verify_batch replayed its transcripts in {batch_replays} launches, not 1")

    # interleaved, so the split and the whole see the same host
    (g, h), scalars, points = proof._verification_terms(bp_gens, pc_gens, tr(), V, n_bits, device=dev)
    warm, terms, msm = [], [], []
    for _ in range(WARM_VERIFIES):
        warm += host_ms(verify, 1)
        terms += host_ms(lambda: proof._verification_terms(bp_gens, pc_gens, tr(), V, n_bits, device=dev), 1)
        msm += host_ms(lambda: backend.gens_msm(bp_gens, scalars + g + h, points, n_bits, m, device=dev), 1)
    res = {"phase": "verify", "n": n_bits, "m": m, "verified": True, "rejected": rejected, "replay": replay,
           "batch_of_2_verified": True, "msm_points": len(scalars) + len(g) + len(h),
           "cold_verify_s": cold_s, "warm_verify_ms": warm, "host_terms_ms": terms, "msm_ms": msm,
           "us_per_verify_median": statistics.median(warm) * 1e3,
           "host_terms_us_median": statistics.median(terms) * 1e3,
           "msm_us_median": statistics.median(msm) * 1e3,
           "launches": launches, "gpu": gpu}
    emit(res)
    res["second"] = (proof2, V2)
    return res


def msm_phase(gpu: str, dev, log2n: int = MSM_LOG2N) -> dict:
    """``msm_device`` at n = 2^log2n on P_i = k_i G (fixed-base table on the
    card); the answer is (sum s_i k_i mod r) G, one host multiplication."""
    import torch

    from mpc_bulletproof_tpu_torch.constants import R
    from mpc_bulletproof_tpu_torch.generators import fixed_base_points
    from mpc_bulletproof_tpu_torch.ops import curve_t, kernels, limb
    from mpc_bulletproof_tpu_torch.ops import msm as msm_mod
    from mpc_bulletproof_tpu_torch.ops.curve import StarkPoint
    from mpc_bulletproof_tpu_torch.ops.limb import NW

    n = 1 << log2n
    c = msm_mod.select_window(n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)

    def rand_scalars():
        x = torch.randint(-(2**63), 2**63 - 1, (NW, n), generator=gen, device=dev)
        x[3] &= (1 << 59) - 1                                       # < 2^251 < r
        return x

    k, s = rand_scalars(), rand_scalars()
    k[:, 0] = 0                                                 # the identity point
    k[:, 2] = k[:, 1]                                           # one point twice
    edge = torch.as_tensor(limb.ints_to_words(
        [0, R - 1, (1 << (c * (-(-252 // c) - 1))) - (1 << (c * (-(-252 // c) - 2))), 1]), device=dev)
    s[:, 3:7] = edge                                            # 0, r - 1, top window on a borrow, 1
    G = StarkPoint.generator()
    pts = fixed_base_points(k, G)                               # MSM_SETUP_COMMITS points a call
    k_int, s_int = limb.words_to_ints(k), limb.words_to_ints(s)

    def want(count):
        return G.scalar_mul(sum(a * b for a, b in zip(s_int[:count], k_int[:count])) % R)

    def run(count):
        out = msm_mod.msm_device(s[:, :count].contiguous(), pts[..., :count].contiguous())
        return curve_t.points_to_host(out[..., None])[0]

    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = run(n)                                                # cold
    cold_s = time.perf_counter() - t0
    launches = read_launches("msm")
    peak = torch.cuda.max_memory_allocated()
    if got != want(n):
        raise RuntimeError("msm_device at 2^%d disagrees with (sum s_i k_i) G" % log2n)
    warm = host_ms(lambda: run(n), WARM_MSMS)
    med = statistics.median(warm)

    # the (64, 64) mega-check's width
    n2 = verify_width(N_BITS, M_PARTIES)
    kernels.reset_launches()
    got2 = run(n2)
    launches2 = dict(kernels.launches)
    if got2 != want(n2):
        raise RuntimeError(f"msm_device at {n2} disagrees with (sum s_i k_i) G")
    warm2 = host_ms(lambda: run(n2), WARM_MSMS)
    res = {"phase": "msm", "n": n, "c": c, "window_group": msm_mod._window_group(-(-252 // c), n), "equal": True,
           "cold_s": cold_s, "warm_ms": warm, "ms_median": med, "mpoints_per_s": n / med / 1e3,
           "peak_mem_bytes": peak, "mem_before_bytes": base_mem, "launches": launches,
           "verify_width": {"n": n2, "c": msm_mod.select_window(n2), "equal": True, "warm_ms": warm2,
                       "ms_median": statistics.median(warm2), "launches": launches2},
           "gpu": gpu}
    emit(res)
    emit(profile_run(lambda: run(n), med * 1e3, gpu, "msm"))
    res.update(inputs=(s, pts), result=got)
    return res


def mesh_run(gpu: str, dev, mesh, mp: dict, vf: dict, ms: dict, profile: bool) -> dict:
    """The mesh checks on one mesh: the sharded 2^MSM_LOG2N MSM on the msm
    phase's inputs against ``msm_device``'s result and (sum s_i k_i) G;
    the sharded (64, 64) prover against ``pinned.DIGESTS`` and the
    unsharded proof's bytes; with the mesh installed, ``verify_multiple``
    and ``verify_batch`` each counted once through ``sharded_msm`` and
    accepting, a t_x + 1 copy raising, and after ``set_mesh(None)`` no
    sharded call; the sharded inner product and point sum at
    ``MESH_VEC_N`` lanes against the unsharded ones.  Launches and peak
    memory around one MSM and one proof, and each side's times in turns
    with the unsharded one (host clock, ms)."""
    import torch

    from mpc_bulletproof_tpu_torch import HashChainTranscript, RangeProof, VerificationError, pinned
    from mpc_bulletproof_tpu_torch.models.range_proof.fused_device import prove_multiple_device
    from mpc_bulletproof_tpu_torch.ops import backend, curve_t, kernels, limb
    from mpc_bulletproof_tpu_torch.ops import msm as msm_mod
    from mpc_bulletproof_tpu_torch.ops.limb import FR, NW
    from mpc_bulletproof_tpu_torch.parallel import sharded

    t_start = time.perf_counter()
    out = {"devices": [str(d) for d in mesh.devices], "shards": mesh.size}
    host = lambda t: curve_t.points_to_host(t[..., None])[0]

    # the sharded MSM on the msm phase's 2^20 points
    s, pts = ms["inputs"]
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = host(sharded.sharded_msm(s, pts, mesh))
    cold_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    if got != ms["result"]:
        raise RuntimeError(f"sharded_msm on {mesh} disagrees with msm_device and (sum s_i k_i) G")
    turns = {"msm_device": [], "sharded_msm": []}
    for _ in range(WARM_MSMS):
        turns["msm_device"] += host_ms(lambda: host(msm_mod.msm_device(s, pts)), 1)
        turns["sharded_msm"] += host_ms(lambda: host(sharded.sharded_msm(s, pts, mesh)), 1)
    out["msm"] = {"n": s.shape[-1], "c": msm_mod.select_window(-(-s.shape[-1] // mesh.size)), "equal": True,
                  "cold_s": cold_s, "warm_ms": turns,
                  "ms_median": {k: statistics.median(v) for k, v in turns.items()},
                  "peak_mem_bytes": peak, "mem_before_bytes": mem_before,
                  "msm_device_peak_mem_bytes": ms["peak_mem_bytes"], "launches": launches}

    # the sharded (64, 64) prover on the pinned inputs
    want = pinned.DIGESTS[(N_BITS, M_PARTIES)]
    values, blindings = pinned.inputs(N_BITS, M_PARTIES)
    ref = mp["proof"].to_bytes()

    def prove(on=mesh):
        tr = HashChainTranscript(pinned.TRANSCRIPT_LABEL)
        proof, V = prove_multiple_device(mp["bp_gens"], mp["pc_gens"], tr, values, blindings, N_BITS, device=dev,
                                         rng_bytes=pinned.det_stream(), mesh=on)
        digest = pinned.proof_digest(proof, V, tr.state)
        if digest != want:
            raise RuntimeError(f"proof digest on {on}: {digest} != pinned {want}")
        return proof

    t0 = time.perf_counter()
    if prove().to_bytes() != ref:
        raise RuntimeError(f"the proof on {mesh} is not the unsharded proof's bytes")
    cold_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    kernels.reset_launches()
    sharded.reset_calls()
    torch.cuda.reset_peak_memory_stats()
    prove()
    launches, calls = dict(kernels.launches), dict(sharded.calls)
    peak = torch.cuda.max_memory_allocated()
    turns = {"unsharded": [], "sharded": []}
    for _ in range(WARM_MESH):
        turns["unsharded"] += host_ms(lambda: prove(None), 1)
        turns["sharded"] += host_ms(prove, 1)
    med = {k: statistics.median(v) * 1e3 for k, v in turns.items()}
    out["prove"] = {"digest": want, "digest_equal": True, "bytes_equal_unsharded": True, "cold_s": cold_s,
                    "warm_ms": turns, "us_median": med, "launches": launches, "sharded_calls": calls,
                    "peak_mem_bytes": peak, "main_path_peak_mem_bytes": mp["peak_mem_bytes"]}
    if profile:
        prof = profile_run(prove, med["sharded"], gpu, f"mesh_prove_{mesh.size}")
        emit(prof)
        out["prove"]["profile_counts_match"] = prof["counts_match"]

    # the verifiers' MSMs routed through the mesh
    proof, V = mp["proof"], mp["V"]
    proof2, V2 = vf["second"]
    bp_gens, pc_gens = mp["bp_gens"], mp["pc_gens"]
    tr = lambda: HashChainTranscript(pinned.TRANSCRIPT_LABEL)
    verify = lambda p=proof: p.verify_multiple(bp_gens, pc_gens, tr(), V, N_BITS, device=dev)
    routed = {}
    turns = {"unsharded": [], "sharded": []}
    backend.set_mesh(mesh)
    try:
        sharded.reset_calls()
        verify()
        routed["verify_multiple"] = sharded.calls["sharded_msm"]
        try:
            verify(tampered(proof, "t_x+1"))
        except VerificationError:
            routed["t_x+1_rejected"] = True
        else:
            raise RuntimeError(f"verify through {mesh} accepted a tampered proof")
        before = sharded.calls["sharded_msm"]
        RangeProof.verify_batch([proof, proof2], bp_gens, pc_gens, [tr(), HashChainTranscript(b"batch-2")],
                                [V, V2], N_BITS, device=dev)
        routed["verify_batch"] = sharded.calls["sharded_msm"] - before
        for _ in range(WARM_VERIFIES):
            backend.set_mesh(None)
            turns["unsharded"] += host_ms(verify, 1)
            backend.set_mesh(mesh)
            turns["sharded"] += host_ms(verify, 1)
    finally:
        backend.set_mesh(None)
    sharded.reset_calls()
    verify()
    routed["after_set_mesh_none"] = sharded.calls["sharded_msm"]
    if (routed["verify_multiple"], routed["verify_batch"], routed["after_set_mesh_none"]) != (1, 1, 0):
        raise RuntimeError(f"the verifiers' MSMs did not take the mesh route as set: {routed}")
    out["verify"] = {"msm_points": verify_width(N_BITS, M_PARTIES), "routed": routed, "warm_ms": turns,
                     "us_median": {k: statistics.median(v) * 1e3 for k, v in turns.items()}}

    # the sharded inner product and point sum
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    a, b = (torch.randint(-(2**63), 2**63 - 1, (NW, MESH_VEC_N), generator=gen, device=dev) for _ in range(2))
    a[3] &= (1 << 59) - 1
    b[3] &= (1 << 59) - 1
    ip = sharded.sharded_inner_product(a, b, mesh)
    few = pts[..., :MESH_VEC_N].contiguous()
    ps = sharded.sharded_point_sum(few, mesh)
    out["vectors"] = {"lanes": MESH_VEC_N,
                      "inner_product_equal": bool(torch.equal(ip, limb.inner_product_mod(a, b, FR))),
                      "point_sum_equal": affine_equal(ps[..., None], msm_mod._reduce_sum(few))}
    if not (out["vectors"]["inner_product_equal"] and out["vectors"]["point_sum_equal"]):
        raise RuntimeError(f"the sharded inner product or point sum on {mesh} disagrees: {out['vectors']}")
    out["seconds"] = time.perf_counter() - t_start
    return out


def mesh_phase(gpu: str, dev, mp: dict, vf: dict, ms: dict) -> dict:
    """:func:`mesh_run` on virtual meshes of ``MESH_SHARDS`` shards on this
    card (the ``MESH_PATH_SHARDS`` one profiled; its proof's launches are
    the mesh path's), and on every card when there are two or more."""
    import torch

    from mpc_bulletproof_tpu_torch.parallel.sharded import Mesh, make_mesh

    t0 = time.perf_counter()
    res = {"phase": "mesh", "note": "a virtual mesh shares one card: its times are the collective's and the "
                                    "extra launches' cost, not scaling"}
    for k in MESH_SHARDS:
        res[f"virtual_{k}"] = mesh_run(gpu, dev, Mesh([dev] * k), mp, vf, ms, profile=k == MESH_PATH_SHARDS)
    if torch.cuda.device_count() >= 2:
        res["real_mesh"] = mesh_run(gpu, dev, make_mesh(), mp, vf, ms, profile=False)
    else:
        res["real_mesh"] = "needs >= 2 cards"
    res["launches"] = require_launches("mesh", res[f"virtual_{MESH_PATH_SHARDS}"]["prove"]["launches"])
    res["phase_s"] = time.perf_counter() - t0
    res["gpu"] = gpu
    emit(res)
    return res


def r1cs_phase(gpu: str, dev, k: int = SHUFFLE_K) -> dict:
    """The k-shuffle proved and verified on the card, held to the JAX
    package's digest; launches of one proof and one verification; tampered
    proofs rejected."""
    import torch

    from mpc_bulletproof_tpu_torch import (BulletproofGens, PedersenGens, Prover, VerificationError,
                                           Verifier, pinned)
    from mpc_bulletproof_tpu_torch.models.inner_product import InnerProductProof
    from mpc_bulletproof_tpu_torch.models.r1cs.gadgets import shuffle_gadget
    from mpc_bulletproof_tpu_torch.ops import backend, kernels
    from mpc_bulletproof_tpu_torch.utils import profiling

    want = pinned.SHUFFLE_DIGESTS[k]
    inputs, outputs, blindings = pinned.shuffle_inputs(k)
    ipp_n, width = shuffle_widths(k)

    t0 = time.perf_counter()
    bp_gens = BulletproofGens(ipp_n, 1, device=dev)
    pc_gens = PedersenGens()
    torch.cuda.synchronize()
    gens_s = time.perf_counter() - t0

    # the 2k Pedersen commitments (host) once; every proof starts from a copy
    t0 = time.perf_counter()
    committed = Prover(pc_gens, pinned.shuffle_transcript(k))
    pairs = [committed.commit(v, b) for v, b in zip(inputs + outputs, blindings)]
    commit_s = time.perf_counter() - t0
    V = [c for c, _ in pairs]
    x_vars, y_vars = [var for _, var in pairs[:k]], [var for _, var in pairs[k:]]

    def prover():
        p = copy.deepcopy(committed)
        shuffle_gadget(p, x_vars, y_vars)
        return p

    def prove(p):
        proof = p.prove(bp_gens, device=dev, rng_bytes=pinned.det_stream())
        digest = pinned.proof_digest(proof, V, p.transcript().state)
        if digest != want:
            raise RuntimeError(f"shuffle proof digest {digest} != pinned {want}")
        return proof

    t0 = time.perf_counter()
    p = prover()
    gadget_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = prove(p)                                  # cold: uploads the generators
    cold_s = time.perf_counter() - t0

    p = prover()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    prove(p)
    counted_s = time.perf_counter() - t0
    prove_launches = read_launches("r1cs_prove")
    warm = []
    for _ in range(WARM_R1CS):
        p = prover()
        t0 = time.perf_counter()
        prove(p)
        warm.append(time.perf_counter() - t0)

    # verification: the verifier absorbs the 2k commitments once; copies then
    # run the gadget and verify
    t0 = time.perf_counter()
    committed_v = Verifier(pc_gens, pinned.shuffle_transcript(k))
    vx = [committed_v.commit(c) for c in V[:k]]
    vy = [committed_v.commit(c) for c in V[k:]]
    verifier_commit_s = time.perf_counter() - t0

    def verifier():
        v = copy.deepcopy(committed_v)
        shuffle_gadget(v, vx, vy)
        return v

    t0 = time.perf_counter()
    verifier().verify(proof, bp_gens, device=dev)     # cold
    cold_verify_s = time.perf_counter() - t0
    v = verifier()
    torch.cuda.synchronize()
    kernels.reset_launches()
    v.verify(proof, bp_gens, device=dev)
    verify_launches = read_launches("r1cs_verify")

    ipp = proof.ipp_proof
    swapped = InnerProductProof([ipp.R_vec[0]] + ipp.L_vec[1:], [ipp.L_vec[0]] + ipp.R_vec[1:],
                                ipp.a, ipp.b)
    rejected = {}
    for case, bad in (("t_x+1", dataclasses.replace(proof, t_x=proof.t_x + 1)),
                      ("swap_L1_R1", dataclasses.replace(proof, ipp_proof=swapped))):
        try:
            verifier().verify(bad, bp_gens, device=dev)
        except VerificationError:
            rejected[case] = True
        else:
            raise RuntimeError(f"R1CS verify accepted a tampered proof ({case})")

    # interleaved, so the split and the whole see the same host
    scalars, points, padded_n = verifier()._verification_terms(proof, bp_gens)
    if len(scalars) != width:
        raise RuntimeError(f"mega-check has {len(scalars)} points, expected {width}")
    w_all, w_terms, w_msm = [], [], []
    for _ in range(WARM_R1CS):
        v = verifier()
        w_all += host_ms(lambda: v.verify(proof, bp_gens, device=dev), 1)
        v = verifier()
        w_terms += host_ms(lambda: v._verification_terms(proof, bp_gens), 1)
        w_msm += host_ms(lambda: backend.gens_msm(bp_gens, scalars, points, padded_n, device=dev), 1)

    p = prover()
    split = prove_split(lambda: prove(p))

    # one more warm proof inside the profiling span of Prover.prove
    p = prover()
    profiling.reset()
    profiling.enable()
    try:
        prove(p)
    finally:
        profiling.disable()
    spans = profiling.snapshot()
    profiling.reset()
    if spans["counts"] != {"r1cs.prove": 1}:
        raise RuntimeError(f"profiling counted {spans['counts']} around one proof, not r1cs.prove once")

    res = {"phase": "r1cs", "gadget": "shuffle", "k": k, "multipliers": 2 * (k - 1), "n": ipp_n,
           "digest": want, "digest_equal": True, "proof_bytes": len(proof.to_bytes()),
           "gens_s": gens_s, "commit_s": commit_s, "commits": 2 * k, "gadget_s": gadget_s,
           "cold_prove_s": cold_s, "counted_prove_s": counted_s, "warm_prove_s": warm,
           "us_per_proof_median": statistics.median(warm) * 1e6, "prove_split_s": split,
           "verifier_commit_s": verifier_commit_s, "cold_verify_s": cold_verify_s,
           "verified": True, "rejected": rejected, "msm_points": width,
           "warm_verify_ms": w_all, "host_terms_ms": w_terms, "msm_ms": w_msm,
           "us_per_verify_median": statistics.median(w_all) * 1e3,
           "host_terms_us_median": statistics.median(w_terms) * 1e3,
           "msm_us_median": statistics.median(w_msm) * 1e3,
           "launches": {"r1cs_prove": prove_launches, "r1cs_verify": verify_launches}, "profiling": spans,
           "gpu": gpu}
    emit(res)
    p = prover()
    emit(profile_run(lambda: prove(p), res["us_per_proof_median"], gpu, "r1cs_prove"))
    res["proof_run"] = (prover, prove)
    return res


def keccak_walk_bound(perms: int, parallel: int, bytes_moved: float) -> dict:
    """The bound of ``parallel`` keccak chains of ``perms`` permutations
    each, moving ``bytes_moved`` bytes: the largest of the byte time, the
    per-pipe issue time of the function (``KECCAK_F_NEEDS`` a permutation)
    and its dependency bound (``KECCAK_F_DEPTH`` dependent instructions a
    permutation at ``DEP_LATENCY_CYCLES``)."""
    bnd = bound(bytes_moved, needs((parallel * perms, KECCAK_F_NEEDS)))
    dep_ms = perms * KECCAK_F_DEPTH * DEP_LATENCY_CYCLES / (SM_CLOCK_MHZ * 1e3)
    kind = "dependency" if dep_ms >= bnd["bound_ms"] else "issue"
    if dep_ms > bnd["bound_ms"]:
        bnd.update(bound_ms=dep_ms, bound_by="operations")
    return {**bnd, "dependency_bound_ms": dep_ms, "bound_kind": kind}


def keccak_warp_design(perms: int, dev_ms: float | None) -> dict:
    """The warp design's own floors for a chain of ``perms`` permutations
    (never the bound): its dependent path (``KECCAK_WARP_DEPTH``, a shuffle
    counted at ``DEP_LATENCY_CYCLES``), one warp's issue at one instruction
    a clock (``KECCAK_WARP_NEEDS`` over 32 lanes), and the shuffle latency
    in cycles that ``dev_ms`` implies if the path were all that ran."""
    per_clock = SM_CLOCK_MHZ * 1e3  # cycles a ms
    depth = sum(KECCAK_WARP_DEPTH.values())
    warp_instr = sum(KECCAK_WARP_NEEDS.values()) / 32
    out = {"depth_a_permutation": KECCAK_WARP_DEPTH, "instructions_a_permutation": KECCAK_WARP_NEEDS,
           "dependency_floor_ms": perms * depth * DEP_LATENCY_CYCLES / per_clock,
           "warp_issue_floor_ms": perms * warp_instr / per_clock}
    if dev_ms:
        cycles = dev_ms * per_clock / perms
        out["cycles_a_permutation"] = cycles
        out["implied_shfl_cycles"] = ((cycles - KECCAK_WARP_DEPTH["alu"] * DEP_LATENCY_CYCLES)
                                      / KECCAK_WARP_DEPTH["shfl"])
        out["dependency_floor_share"] = out["dependency_floor_ms"] / dev_ms
    return out


def gens_split(make) -> tuple:
    """``make()`` (a ``BulletproofGens`` construction) and its seconds split
    into the walk (``keccak_chain``), the second keccak (``keccak256_32``),
    the reduction mod r, the fixed-base products, the affine conversion and
    the host point lists, each part ended by a synchronize; the wrappers
    are removed again before returning."""
    import torch

    from mpc_bulletproof_tpu_torch import generators
    from mpc_bulletproof_tpu_torch.ops import curve_t, kernels, transcript_t

    parts = {"walk": (kernels, "keccak_chain"), "keccak": (kernels, "keccak256_32"),
             "reduce": (transcript_t, "bytes_to_scalar_mod_r"), "fixed_base": (generators, "fixed_base_points"),
             "affine": (curve_t, "affine_mont"), "host_lists": (generators, "host_points")}
    spent = dict.fromkeys(parts, 0.0)
    orig = {k: getattr(mod, name) for k, (mod, name) in parts.items()}

    def timed(part, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[part] += time.perf_counter() - t0
            return out
        return wrapper

    for k, (mod, name) in parts.items():
        setattr(mod, name, timed(k, orig[k]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = make()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for k, (mod, name) in parts.items():
            setattr(mod, name, orig[k])
    return out, {"total": total, **spent, "rest": total - sum(spent.values())}


def tensor_gens_digest(bp_gens, n: int, m: int, dev) -> str:
    """``pinned.gens_digest`` of the generator tensors the device routes
    read (``device_gens``), computed from their words."""
    import hashlib

    import numpy as np

    from mpc_bulletproof_tpu_torch.generators import device_gens
    from mpc_bulletproof_tpu_torch.ops import transcript_t

    h = hashlib.sha256()
    for pts in device_gens(bp_gens, n, m, dev):
        x, y, is_id = transcript_t.lazy_points_to_affine(pts)
        if bool(is_id.any()):
            raise RuntimeError("gens: an identity generator")
        be = lambda w: np.flip(np.ascontiguousarray(w.T.cpu().numpy()).astype("<i8").view(np.uint8), axis=1)
        h.update(np.ascontiguousarray(np.concatenate([be(x), be(y)], axis=1)).tobytes())
    return h.hexdigest()


def gens_phase(gpu: str, dev) -> dict:
    """The generator chains on the card: ``keccak_chain`` and
    ``keccak256_32`` against their plain versions; ``BulletproofGens`` at
    the reference's sizes, at ``GENS_WIDE`` and at ``GENS_AGGREGATED`` against
    ``pinned.GENS_DIGESTS`` (host lists and device tensors); each set-up's
    seconds by part; launches and a profile of the wide set-up."""
    import torch

    from mpc_bulletproof_tpu_torch import BulletproofGens, StarkPoint, generators, pinned
    from mpc_bulletproof_tpu_torch.ops import keccak_t, kernels

    gen = torch.Generator(device=dev)
    gen.manual_seed(1600)
    rows32 = lambda k: torch.randint(0, 256, (k, 32), generator=gen, device=dev, dtype=torch.uint8)
    err = lambda a, b: float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0.0
    checks = []
    for chains, skip, count in KECCAK_CHAIN_CHECKS:
        st = rows32(chains)
        got = kernels.keccak_chain(st, skip, count)
        want, plain_ms = timed_ms(lambda: keccak_t.keccak_chain_plain(st, skip, count))
        checks.append({"chains": chains, "skip": skip, "count": count, "equal": bool(torch.equal(got, want)),
                       "max_abs_err": err(got, want), "plain_ms": plain_ms})
    # the wide set-up's walk: 2 chains of GENS_WIDE steps, its last steps held to the plain walk
    wide_st = rows32(2)
    walk = lambda: kernels.keccak_chain(wide_st, 0, GENS_WIDE)
    got = walk()
    tail = min(256, GENS_WIDE - 1)
    want = keccak_t.keccak_chain_plain(got[:, -tail - 1].contiguous(), 0, tail)
    checks.append({"chains": 2, "skip": 0, "count": GENS_WIDE, "held": f"the last {tail} steps",
                   "equal": bool(torch.equal(got[:, -tail:], want)), "max_abs_err": err(got[:, -tail:], want)})
    chain_dev = device_ms(walk, 2)
    chain_bnd = keccak_walk_bound(GENS_WIDE, 2, 32 * 2 * (1 + GENS_WIDE))
    chain_row = {"phase": "kernel", "name": "keccak_chain", "path": "gens",
                 "shape": {"chains": 2, "skip": 0, "count": GENS_WIDE}, "tolerance": 0,
                 "equal": all(c["equal"] for c in checks), "max_abs_err": max(c["max_abs_err"] for c in checks),
                 "checks": checks, "kernel_ms": cuda_ms(walk, 2), "device_ms": chain_dev,
                 "plain_ms": checks[0]["plain_ms"], "plain_shape": list(KECCAK_CHAIN_CHECKS[0]), **chain_bnd,
                 "gpu": gpu}
    chain_row["bound_share"] = share(chain_row["bound_ms"], chain_dev)
    chain_row["serial"] = serial_depth("keccak_f", GENS_WIDE, chain_dev)
    chain_row["design"] = keccak_warp_design(GENS_WIDE, chain_dev)
    emit(chain_row)
    del got, want

    msgs = rows32(KECCAK_HASH_N)
    got = kernels.keccak256_32(msgs)
    want, plain_ms = timed_ms(lambda: keccak_t.keccak256_32_plain(msgs))
    hash_dev = device_ms(lambda: kernels.keccak256_32(msgs), 20)
    hash_row = {"phase": "kernel", "name": "keccak256_32", "path": "gens", "shape": {"n": KECCAK_HASH_N},
                "tolerance": 0, "equal": bool(torch.equal(got, want)), "max_abs_err": err(got, want),
                "kernel_ms": cuda_ms(lambda: kernels.keccak256_32(msgs), 20), "device_ms": hash_dev,
                "plain_ms": plain_ms, **bound(64 * KECCAK_HASH_N, needs((KECCAK_HASH_N, KECCAK_F_NEEDS))),
                "gpu": gpu}
    hash_row["bound_share"] = share(hash_row["bound_ms"], hash_dev)
    emit(hash_row)
    del msgs, got, want
    bad = [r["name"] for r in (chain_row, hash_row) if not r["equal"]]
    if bad:
        raise RuntimeError(f"keccak kernels disagree with their plain versions: {bad}")

    # the set-ups; the fixed-base table of the curve generator is built first (once a process)
    t0 = time.perf_counter()
    generators.device_point_table(StarkPoint.generator(), dev)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    setups, made = {}, {}
    for n, m in [(s, 1) for s in GENS_SIZES] + [(GENS_WIDE, 1), GENS_AGGREGATED]:
        if (n, m) == (GENS_WIDE, 1):
            torch.cuda.synchronize()
            kernels.reset_launches()
        g, split = gens_split(lambda: BulletproofGens(n, m, device=dev))
        if (n, m) == (GENS_WIDE, 1):
            launches = read_launches("gens")
        want = pinned.GENS_DIGESTS[(n, m)]
        host = pinned.gens_digest(g.G(n, m), g.H(n, m))
        tens = tensor_gens_digest(g, n, m, dev)
        if host != want or tens != want:
            raise RuntimeError(f"BulletproofGens({n}, {m}): digests {host} (host), {tens} (device) != pinned {want}")
        setups[f"{n}x{m}"] = {"chain_steps": n, "chains": 2 * m, "s": split}
        made[(n, m)] = g
    res = {"phase": "gens", "digests_equal": True, "table_s": table_s, "setups": setups,
           "wide_s": setups[f"{GENS_WIDE}x1"]["s"]["total"], "launches": launches, "gpu": gpu}
    emit(res)
    prof = profile_run(lambda: BulletproofGens(GENS_WIDE, 1, device=dev),
                       res["wide_s"] * 1e6, gpu, "gens")
    emit(prof)
    if not prof["counts_match"]:
        raise RuntimeError(f"gens: the profile's counts differ from the launch counters: {prof['by_source']}")
    res.update(checks={"keccak_chain": chain_row, "keccak256_32": hash_row}, gens=made)
    return res


def transcript_steps(lengths, challenges: str) -> list:
    """A run of absorbs of the given block lengths (bytes of state, label
    and message words: a 32-byte label from 64 on, none below) with
    ``challenges`` "end" (one after the run), "between" (one after every
    absorb) or "none"."""
    steps = []
    for i, total in enumerate(lengths):
        label = b"l%d" % i if total >= 64 else b""
        steps.append((label, (total - 32 - (32 if label else 0)) // 8))
        if challenges == "between":
            steps.append((b"c%d" % i, None))
    return steps + ([(b"end", None)] if challenges == "end" else [])


def verify_replay_steps(n: int, m: int) -> list:
    """A (n, m) range-proof verification's transcript as steps, every
    message a device word run: ``RangeProof._transcript_steps`` of a
    stand-in proof (every point the generator, every scalar 0, log2(n m)
    IPP rounds), each message mapped to its length in words, so the timed
    run is the one the verifier makes."""
    from mpc_bulletproof_tpu_torch import InnerProductProof, RangeProof, Scalar
    from mpc_bulletproof_tpu_torch.ops.curve import StarkPoint

    G, zero = StarkPoint.generator(), Scalar(0)
    rounds = (n * m - 1).bit_length()
    proof = RangeProof(G, G, G, G, zero, zero, zero, InnerProductProof([G] * rounds, [G] * rounds, zero, zero))
    return [(label, None if msg is None else len(msg) // 8) for label, msg in proof._transcript_steps([G] * m, n)]


def transcript_bound(steps: list, transcripts: int) -> dict:
    """The bound of ``transcripts`` runs of ``steps``: the larger of the
    bytes (each transcript's start state and message words read and its
    state and challenges written, the template and layout read once), the
    issue time of its permutations (one a block, one more a challenge,
    ``KECCAK_F_NEEDS`` each) and its dependency bound (the run's blocks in
    a row, and the last challenge's hash after them, at
    ``KECCAK_F_DEPTH`` dependent instructions a permutation)."""
    blocks = len(steps)
    chal = sum(1 for _, m in steps if m is None)
    words = sum(m for _, m in steps if m is not None)
    moved = 8 * (transcripts * (4 + words + 4 + 4 * chal) + blocks * (17 + 4))
    perms = blocks + int(steps[-1][1] is None)
    bnd = bound(moved, needs((transcripts * (blocks + chal), KECCAK_F_NEEDS)))
    dep_ms = perms * KECCAK_F_DEPTH * DEP_LATENCY_CYCLES / (SM_CLOCK_MHZ * 1e3)
    kind = "dependency" if dep_ms >= bnd["bound_ms"] else "issue"
    if dep_ms > bnd["bound_ms"]:
        bnd.update(bound_ms=dep_ms, bound_by="operations")
    return {**bnd, "dependency_bound_ms": dep_ms, "bound_kind": kind, "bytes_moved": moved,
            "chain_permutations": perms}


def start_epilogue_build():
    """Start ``nvcc`` on ``tools/keccak_epilogue_check.cu`` (the transcript
    kernel's ``fr_reduce_u512`` on chosen values; it includes the port's
    ``csrc/keccak.cu``) with the port's flags, beside the port's own
    builds.  Returns ``(process, library)``; ``main`` waits for it with
    the port's build."""
    from pathlib import Path

    from mpc_bulletproof_tpu_torch.ops import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = kernels.BUILD_DIR / "keccak_epilogue_check.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(lib),
           str(Path(__file__).resolve().parent / "tools" / "keccak_epilogue_check.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def epilogue_values() -> list:
    """512-bit values ``(lo, hi)`` for the epilogue: ``fr_reduce_u512``'s
    edges (all zeros, all 0xFF, multiples of r and their neighbours,
    2^251), halves whose top five bits q give ``v < q r`` (the borrow
    branch of ``fr_reduce_u256``, which a keccak output reaches with
    probability ~2^-54), and 64 random values from ``--seed``."""
    import random

    from mpc_bulletproof_tpu_torch.constants import R

    top = (1 << 256) - 1
    vals = [(0, 0), (top, top), (R, R), (R - 1, R - 1), (31 * R + 1, 31 * R + 1), (31 * R - 1, 1),
            (2 * R + 1, 0), (1 << 251, (1 << 251) - 1), ((17 << 251) + 5, 31 << 251)]
    vals += [((q << 251) + d, (q << 251) + q * d) for q in (1, 2, 16, 31) for d in (0, 1, 7)]
    rnd = random.Random(SEED)
    vals += [(rnd.getrandbits(256), rnd.getrandbits(256)) for _ in range(64)]
    return vals


def epilogue_check(dev, build) -> dict:
    """The transcript kernel's reduction mod r (compiled from
    ``csrc/keccak.cu`` into ``tools/keccak_epilogue_check.cu``) on
    :func:`epilogue_values`, held to Python's ``v mod r`` and to the plain
    version's ``limb.reduce_512`` on the card; fails unless the borrow
    branch was taken.  ``build``: the build's ``(exit code, log,
    library)``.  Its launches are not the port's."""
    import ctypes

    import torch

    from mpc_bulletproof_tpu_torch.constants import R
    from mpc_bulletproof_tpu_torch.ops import limb

    rc, log, lib = build
    if rc:
        raise RuntimeError(f"nvcc failed for tools/keccak_epilogue_check.cu:\n{log}")
    fn = ctypes.CDLL(str(lib)).check_fr_reduce_u512
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p], ctypes.c_int
    vals = epilogue_values()
    mask = (1 << 64) - 1
    to_i64 = lambda w: w - (1 << 64) if w >> 63 else w
    rows = [[to_i64((v >> (64 * j)) & mask) for v in (lo, hi) for j in range(4)] for lo, hi in vals]
    words = torch.tensor(rows, dtype=torch.int64, device=dev)
    got = torch.empty((len(vals), 4), dtype=torch.int64, device=dev)
    if fn(words.data_ptr(), got.data_ptr(), len(vals), torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("check_fr_reduce_u512: launch failed")
    plain = limb.reduce_512(torch.cat([limb.to_pieces(words[:, :4].T), limb.to_pieces(words[:, 4:].T)]), limb.FR)
    card = [sum((w & mask) << (64 * j) for j, w in enumerate(row)) for row in got.tolist()]
    want = [(lo + (hi << 256)) % R for lo, hi in vals]
    borrow = lambda v: v < (v >> 251) * R
    res = {"values": len(vals), "borrows": sum(borrow(lo) + borrow(hi) for lo, hi in vals),
           "equal_mod_r": card == want, "equal_plain": limb.words_to_ints(plain) == want}
    if not (res["equal_mod_r"] and res["equal_plain"] and res["borrows"]):
        bad = [i for i, (c, w) in enumerate(zip(card, want)) if c != w]
        raise RuntimeError(f"the transcript's reduction mod r disagrees on the card: {res}, values {bad[:8]}")
    return res


def transcript_phase(gpu: str, dev, epilogue_build) -> dict:
    """``keccak_transcript`` on the card against its plain version, states
    and challenges word for word: runs of ``TRANSCRIPT_RUNS`` absorbs at
    every block length of ``TRANSCRIPT_LENGTHS``, the challenges at the
    end, after every absorb or none, random and all-zero messages, 1 and
    ``TRANSCRIPT_MANY`` transcripts a launch, states and words from
    ``--seed``; then ``transcript_t.absorb_many`` at an IPP round's shape
    against the same run on the CPU, and its refusal above 135 bytes.
    Timed at the IPP round, the V run (64 absorbs, and the prover's V, A,
    S, y, z) and a whole (64, 64) verification's replay: device ms, the
    plain version's ms, the bound (:func:`transcript_bound`) and the warp
    design's floors.  Then the kernel's reduction mod r on chosen values
    (:func:`epilogue_check`, ``epilogue_build`` from
    :func:`start_epilogue_build`).  Returns ``{"keccak_transcript": row}``."""
    import torch

    from mpc_bulletproof_tpu_torch.ops import keccak_t, kernels
    from mpc_bulletproof_tpu_torch.ops import transcript_t as tj

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    words = lambda *shape: torch.randint(-(1 << 63), (1 << 63) - 1, shape, generator=gen, device=dev,
                                         dtype=torch.int64)
    cases, worst = [], 0.0
    for j in TRANSCRIPT_RUNS:
        runs = ([[n] for n in TRANSCRIPT_LENGTHS] if j == 1 else
                [[TRANSCRIPT_LENGTHS[i % len(TRANSCRIPT_LENGTHS)] for i in range(j)]])
        for lengths in runs:
            for challenges in ("end", "between", "none"):
                for many, zeros in ((1, False), (TRANSCRIPT_MANY, False), (1, True)):
                    plan = tj._plan(tuple(transcript_steps(lengths, challenges)), dev)
                    starts, msgs = words(many, 4), words(many, plan.words)
                    if zeros:
                        msgs.zero_()
                    got = kernels.keccak_transcript(starts, plan, msgs)
                    want = keccak_t.keccak_transcript_plain(starts, *plan[:2], msgs, plan.challenges)
                    err = max(max_abs_err(g, w, 1) if g.numel() else 0.0 for g, w in zip(got, want))
                    worst = max(worst, err)
                    cases.append({"absorbs": j, "lengths": lengths if j < 64 else "cycled",
                                  "challenges": challenges, "transcripts": many, "zero_messages": zeros,
                                  "equal": all(torch.equal(g, w) for g, w in zip(got, want)), "max_abs_err": err})
    # the transcript's own entry: plan, launch, challenge, against the CPU
    st, enc = words(4), words(16)
    steps = [(b"L", 8), (b"R", 8), (b"u", None)]
    s_card, u_card = tj.absorb_many(st, steps, enc)
    s_cpu, u_cpu = tj.absorb_many(st.cpu(), steps, enc.cpu())
    api = {"equal": bool(torch.equal(s_card.cpu(), s_cpu) and torch.equal(u_card.cpu(), u_cpu))}
    try:
        tj.absorb_many(st, [(b"x", 9)], enc[:9])     # 32 + 32 + 72 = 136 bytes
        api["refuses_136"] = False
    except ValueError:
        api["refuses_136"] = True

    shapes = {"ipp_round": (steps, 1),
              "v_run": ([(b"V", 8)] * 64, 1),
              "v_run_A_S_y_z": ([(b"V", 8)] * 64 + [(b"A", 8), (b"S", 8), (b"y", None), (b"z", None)], 1),
              "verify_64x64": (verify_replay_steps(*TRANSCRIPT_VERIFY), 1),
              "verify_batch_2": (verify_replay_steps(*TRANSCRIPT_VERIFY), 2)}
    timed = {}
    for what, (run_steps, many) in shapes.items():
        plan = tj._plan(tuple(run_steps), dev)
        n_chal = plan.challenges
        starts, msgs = words(many, 4), words(many, plan.words)
        run = lambda: kernels.keccak_transcript(starts, plan, msgs)
        _, plain_ms = timed_ms(lambda: keccak_t.keccak_transcript_plain(starts, *plan[:2], msgs, n_chal))
        dev_ms = device_ms(run, 20)
        bnd = transcript_bound(run_steps, many)
        timed[what] = {"blocks": len(run_steps), "challenges": n_chal, "transcripts": many,
                       "kernel_ms": cuda_ms(run, 20), "device_ms": dev_ms, "plain_ms": plain_ms, **bnd,
                       "bound_share": share(bnd["bound_ms"], dev_ms),
                       "serial": serial_depth("keccak_f", bnd["chain_permutations"], dev_ms),
                       "design": keccak_warp_design(bnd["chain_permutations"], dev_ms)}
    main = timed["ipp_round"]
    epilogue = epilogue_check(dev, epilogue_build)
    row = {"phase": "kernel", "name": "keccak_transcript", "path": "ipp", "shape": {"steps": "L, R, u"},
           "tolerance": 0, "equal": all(c["equal"] for c in cases) and api["equal"] and api["refuses_136"],
           "max_abs_err": worst, "checks": {"cases": cases, "absorb_many": api, "epilogue": epilogue},
           "seed": SEED,
           **{k: main[k] for k in ("kernel_ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "pipe",
                                   "pipe_bound_ms", "bytes_bound_ms", "dependency_bound_ms", "bound_kind",
                                   "bound_share", "serial", "design")},
           "at_paths": timed, "gpu": gpu}
    emit(row)
    if not row["equal"]:
        bad = [c for c in cases if not c["equal"]]
        raise RuntimeError(f"keccak_transcript disagrees with its plain version: {bad[:4]} {api}")
    return {"keccak_transcript": row}


def rp_sweep_phase(gpu: str, dev, mp: dict) -> dict:
    """The reference's range-proof sweep on the main path's (64, 64)
    generators: config 1 (``prove_single`` / ``verify_single`` on the
    README's 32-bit value) and config 2 at ``RP_SWEEP_M`` values, each a
    cold proof against ``pinned.DIGESTS``, a warm one and a verification;
    at m = 1 the median of ``VERIFY_MEDIAN_RUNS`` verifications with its
    host terms and MSM, and a tampered copy rejected."""
    import torch

    from mpc_bulletproof_tpu_torch import HashChainTranscript, RangeProof, VerificationError, pinned
    from mpc_bulletproof_tpu_torch.ops import backend, kernels

    bp_gens, pc_gens = mp["bp_gens"], mp["pc_gens"]
    tr = lambda: HashChainTranscript(pinned.TRANSCRIPT_LABEL)

    def prove(n, values, blindings):
        t = tr()
        proof, V = RangeProof.prove_multiple(bp_gens, pc_gens, t, values, blindings, n, device=dev,
                                             rng_bytes=pinned.det_stream())
        digest = pinned.proof_digest(proof, V, t.state)
        if digest != pinned.DIGESTS[(n, len(values))]:
            raise RuntimeError(f"range proof ({n}, {len(values)}): digest {digest} != pinned")
        return proof, V

    torch.cuda.synchronize()
    kernels.reset_launches()
    t_phase = time.perf_counter()
    (v1,), (b1,) = pinned.single_inputs()
    t0 = time.perf_counter()
    t = tr()
    proof1, V1 = RangeProof.prove_single(bp_gens, pc_gens, t, v1, b1, 32, device=dev, rng_bytes=pinned.det_stream())
    single_s = time.perf_counter() - t0
    if pinned.proof_digest(proof1, [V1], t.state) != pinned.DIGESTS[(32, 1)]:
        raise RuntimeError("config 1: prove_single's digest != pinned")
    t0 = time.perf_counter()
    proof1.verify_single(bp_gens, pc_gens, tr(), V1, 32, device=dev)
    single_verify_s = time.perf_counter() - t0

    rows = {}
    for m in RP_SWEEP_M:
        values, blindings = pinned.inputs(64, m)
        t0 = time.perf_counter()
        proof, V = prove(64, values, blindings)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        prove(64, values, blindings)
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        proof.verify_multiple(bp_gens, pc_gens, tr(), V, 64, device=dev)
        rows[m] = {"cold_prove_s": cold_s, "warm_prove_s": warm_s, "verify_s": time.perf_counter() - t0,
                   "proof_bytes": len(proof.to_bytes())}
        if m == 1:
            one = (proof, V)
    launches = read_launches("rp_sweep")

    proof, V = one
    verify = lambda p=proof: p.verify_multiple(bp_gens, pc_gens, tr(), V, 64, device=dev)
    try:
        verify(tampered(proof, "t_x+1"))
    except VerificationError:
        pass
    else:
        raise RuntimeError("rp_sweep: verify accepted a tampered m = 1 proof")
    replay = replay_check(proof, V, 64, tr, dev)
    # interleaved, so the split and the whole see the same host
    (g, h), scalars, points = proof._verification_terms(bp_gens, pc_gens, tr(), V, 64, device=dev)
    whole, terms, msm = [], [], []
    for _ in range(VERIFY_MEDIAN_RUNS):
        whole += host_ms(verify, 1)
        terms += host_ms(lambda: proof._verification_terms(bp_gens, pc_gens, tr(), V, 64, device=dev), 1)
        msm += host_ms(lambda: backend.gens_msm(bp_gens, scalars + g + h, points, 64, 1, device=dev), 1)
    res = {"phase": "rp_sweep", "digests_equal": True, "verified": True,
           "config1": {"n": 32, "m": 1, "value": v1, "prove_s": single_s, "verify_s": single_verify_s},
           "config2": {str(m): r for m, r in rows.items()},
           "m1_verify": {"runs": VERIFY_MEDIAN_RUNS, "msm_points": len(scalars) + len(g) + len(h),
                         "us_median": statistics.median(whole) * 1e3,
                         "host_terms_us_median": statistics.median(terms) * 1e3,
                         "msm_us_median": statistics.median(msm) * 1e3,
                         "ms": whole, "host_terms_ms": terms, "msm_ms": msm,
                         "tampered_t_x+1_rejected": True, "replay": replay},
           "launches": launches, "phase_s": time.perf_counter() - t_phase, "gpu": gpu}
    emit(res)
    return res


def r1cs_sweep_phase(gpu: str, dev, gens) -> dict:
    """The reference's R1CS sweeps on ``gens`` (``BulletproofGens(1024,
    1)``): the squaring chain at ``SQUARING_SWEEP`` multipliers
    (``pinned.squaring_chain``, benches/r1cs.rs) and the shuffle at
    ``SHUFFLE_SWEEP`` (benches/shuffle.rs), one proof each against its
    pinned digest, split into phase MSMs, IPP and host rest, each
    verified; the rest's seconds a multiplier size the shuffles above 2^10."""
    import torch

    from mpc_bulletproof_tpu_torch import PedersenGens, Prover, Scalar, Verifier, pinned
    from mpc_bulletproof_tpu_torch.models.r1cs.gadgets import shuffle_gadget
    from mpc_bulletproof_tpu_torch.ops import kernels

    pc_gens = PedersenGens()
    value = Scalar(pinned.squaring_value())

    def run(multipliers, want, prover, verifier):
        """``prover()`` -> (a prover with its circuit, its commitments, the
        seconds they took); ``verifier(V)`` -> a verifier with the circuit."""
        p, V, commit_s = prover()
        out = []
        split = prove_split(lambda: out.append(p.prove(gens, device=dev, rng_bytes=pinned.det_stream())))
        digest = pinned.proof_digest(out[0], V, p.transcript().state)
        if digest != want:
            raise RuntimeError(f"r1cs_sweep: digest {digest} != pinned {want} ({multipliers} multipliers)")
        t0 = time.perf_counter()
        verifier(V).verify(out[0], gens, device=dev)
        return {"multipliers": multipliers, "commit_s": commit_s, "prove_split_s": split,
                "rest_s_per_multiplier": split["rest"] / multipliers, "verify_s": time.perf_counter() - t0,
                "proof_bytes": len(out[0].to_bytes())}

    def squaring(cs, n):
        pinned.squaring_chain(cs, n, value)
        return cs

    def shuffle_prover(k):
        inputs, outputs, blindings = pinned.shuffle_inputs(k)
        t0 = time.perf_counter()
        p = Prover(pc_gens, pinned.shuffle_transcript(k))
        pairs = [p.commit(v, b) for v, b in zip(inputs + outputs, blindings)]
        commit_s = time.perf_counter() - t0
        shuffle_gadget(p, [var for _, var in pairs[:k]], [var for _, var in pairs[k:]])
        return p, [c for c, _ in pairs], commit_s

    def shuffle_verifier(k, V):
        v = Verifier(pc_gens, pinned.shuffle_transcript(k))
        vs = [v.commit(c) for c in V]
        shuffle_gadget(v, vs[:k], vs[k:])
        return v

    torch.cuda.synchronize()
    kernels.reset_launches()
    t_phase = time.perf_counter()
    sq = {n: run(n, pinned.SQUARING_DIGESTS[n],
                 lambda n=n: (squaring(Prover(pc_gens, pinned.squaring_transcript(n)), n), [], 0.0),
                 lambda V, n=n: squaring(Verifier(pc_gens, pinned.squaring_transcript(n)), n))
          for n in SQUARING_SWEEP}
    sh = {k: run(2 * (k - 1), pinned.SHUFFLE_DIGESTS[k], lambda k=k: shuffle_prover(k),
                 lambda V, k=k: shuffle_verifier(k, V))
          for k in SHUFFLE_SWEEP}
    launches = read_launches("r1cs_sweep")
    res = {"phase": "r1cs_sweep", "digests_equal": True, "verified": True,
           "squaring": {str(n): r for n, r in sq.items()}, "shuffle": {str(k): r for k, r in sh.items()},
           "launches": launches, "phase_s": time.perf_counter() - t_phase, "gpu": gpu}
    emit(res)
    return res


def ipp_inputs_on(n: int, dev) -> dict:
    """``pinned.ipp_inputs(n)`` for ``InnerProductProof.create`` on ``dev``:
    host lists below ``_DEVICE_MIN`` (the host route; the generators made
    on the card by ``fixed_base_mul``), tensors made on the card from
    there on; plus ``P``, the commitment the proof opens, by one
    ``msm_device`` over the 2n + 1 points ``[G | H | Q]``."""
    import torch

    from mpc_bulletproof_tpu_torch import StarkPoint, pinned
    from mpc_bulletproof_tpu_torch.generators import fixed_base_mul
    from mpc_bulletproof_tpu_torch.ops import backend, curve_t, limb
    from mpc_bulletproof_tpu_torch.ops import msm as msm_mod

    B = StarkPoint.generator()
    if n < backend._DEVICE_MIN:
        inp = pinned.ipp_host_inputs(n, lambda ints: fixed_base_mul(ints, B, dev))
        sc = lambda xs: torch.as_tensor(curve_t.scalars_from_host(xs), device=dev)
        pt = lambda xs: torch.as_tensor(curve_t.points_from_host(xs), device=dev)
        a, b, hf, G, H = sc(inp["a"]), sc(inp["b"]), sc(inp["H_factors"]), pt(inp["G"]), pt(inp["H"])
    else:
        inp = pinned.ipp_device_inputs(n, dev)
        a, b, hf, G, H = inp["a"], inp["b"], inp["H_factors"], inp["G"], inp["H"]
    scalars = torch.cat([a, limb.mod_mul(b, hf, limb.FR), limb.inner_product_mod(a, b, limb.FR)[:, None]], dim=-1)
    points = torch.cat([G, H, torch.as_tensor(curve_t.points_from_host([inp["Q"]]), device=dev)], dim=-1)
    inp["P"] = curve_t.points_to_host(msm_mod.msm_device(scalars, points)[..., None])[0]
    return inp


def ipp_prove(inp: dict, dev, create=None):
    """The IPP alone on ``inp`` (:func:`ipp_inputs_on`): ``(proof, final
    transcript state)``.  ``create``: ``_create_device`` (after the IPP
    domain is opened), else ``InnerProductProof.create``."""
    from mpc_bulletproof_tpu_torch import HashChainTranscript, InnerProductProof, pinned
    from mpc_bulletproof_tpu_torch.models.inner_product import _width

    t = HashChainTranscript(pinned.IPP_LABEL)
    args = (inp["Q"], inp["G_factors"], inp["H_factors"], inp["G"], inp["H"], inp["a"], inp["b"])
    if create is None:
        return InnerProductProof.create(t, *args, device=dev), t.state
    t.innerproduct_domain_sep(_width(inp["G"]))
    return create(t, *args, device=dev), t.state


def ipp_verify(proof, inp: dict, dev, factors: tuple) -> None:
    """``proof.verify`` on ``dev`` against ``inp["P"]``; ``factors``: the
    host ``(G_factors, H_factors)``."""
    from mpc_bulletproof_tpu_torch import HashChainTranscript, pinned

    n = 1 << len(proof.L_vec)
    proof.verify(n, HashChainTranscript(pinned.IPP_LABEL), *factors, inp["P"], inp["Q"], inp["G"], inp["H"],
                 device=dev)


def ipp_host_factors(inp: dict) -> tuple:
    """``(G_factors, H_factors)`` of ``inp`` as host ints."""
    import torch

    from mpc_bulletproof_tpu_torch.ops.limb import words_to_ints

    if isinstance(inp["H_factors"], torch.Tensor):
        return words_to_ints(inp["G_factors"]), words_to_ints(inp["H_factors"])
    return [int(x) for x in inp["G_factors"]], [int(x) for x in inp["H_factors"]]


def ipp_tampered(proof) -> dict:
    """The two tampered copies: a + 1, and L_1 swapped with R_1."""
    from mpc_bulletproof_tpu_torch import InnerProductProof

    return {"a+1": InnerProductProof(proof.L_vec, proof.R_vec, proof.a + 1, proof.b),
            "swap_L1_R1": InnerProductProof([proof.R_vec[0]] + proof.L_vec[1:],
                                            [proof.L_vec[0]] + proof.R_vec[1:], proof.a, proof.b)}


def fold_check(gpu: str, what: str, run, G_L, G_R, scalars, plain=None) -> dict:
    """A fold of points on the ``point_add`` kernel (``run()``, one of
    ``ops/fold.py``'s calls over ``G_L``, ``G_R``): 64 sampled lanes held
    to the host two-point MSM (``scalars(i)``: the host ``(s_l, s_r)`` of
    lane i), and with ``plain`` (the same fold composed on the plain add)
    every lane word for word; its launches, its time by events around one
    call and by the profiler (every launch of a call)."""
    import torch

    from mpc_bulletproof_tpu_torch.constants import FIELD_BITS
    from mpc_bulletproof_tpu_torch.ops import curve_t, kernels
    from mpc_bulletproof_tpu_torch.ops.curve import StarkPoint

    h = G_L.shape[-1]
    kernels.reset_launches()
    got, events_ms = timed_ms(run)
    launches = kernels.launches["point_add"]
    if launches != 2 * FIELD_BITS + 1:
        raise RuntimeError(f"fold_points ({what}) made {launches} point_add launches, not {2 * FIELD_BITS + 1}")
    lanes = torch.linspace(0, h - 1, FOLD_SAMPLES, device=G_L.device).long().unique()
    pick = lambda t: curve_t.points_to_host(t[..., lanes])
    want = [StarkPoint.msm(list(scalars(i)), [gl, gr]) for i, gl, gr in zip(lanes.tolist(), pick(G_L), pick(G_R))]
    if pick(got) != want:
        raise RuntimeError(f"fold_points ({what}) disagrees with the host two-point MSM")
    res = {"what": what, "lanes": h, "sampled_equal_host": len(want), "point_add_launches": launches,
           "design": kernels.point_add_design(h), "events_ms": events_ms, "device_ms": device_ms(run, 1, True)}
    if plain is not None:
        want_all, plain_ms = timed_ms(plain)
        res.update({"max_abs_err": max_abs_err(got, want_all, 1), "plain_ms": plain_ms})
        if res["max_abs_err"] != 0:
            raise RuntimeError(f"fold_points ({what}) disagrees with its composition on the plain add")
    return res


def ipp_phase(gpu: str, dev, sweep=IPP_SWEEP, full=IPP_FULL) -> dict:
    """The inner-product argument alone (BASELINE.json config 3):
    ``InnerProductProof.create`` on ``pinned.ipp_inputs(n)`` for n = 2^k,
    k in ``sweep``, held to ``pinned.IPP_DIGESTS`` and verified on the
    card; at the widths 2^k, k in ``full``, on inputs made on the card, the
    fused and the coefficient-tracking provers held to each other, the
    proof verified from the generator tensors and two tampered copies
    rejected; then ``fold_points`` (one round's fold of G, and a first
    round's per-lane factors), ``msm_device_pair`` and ``msm_device_split``
    against their oracles."""
    import hashlib

    import torch

    from mpc_bulletproof_tpu_torch import StarkPoint, VerificationError, pinned
    from mpc_bulletproof_tpu_torch.constants import R
    from mpc_bulletproof_tpu_torch.models.inner_product import _create_device
    from mpc_bulletproof_tpu_torch.ops import backend, curve_t, fold, kernels, limb
    from mpc_bulletproof_tpu_torch.ops import msm as msm_mod

    t_start = time.perf_counter()
    parts: dict = {}

    def part(name: str) -> None:
        """Close the part ``name``: the seconds since the last one closed."""
        parts[name] = time.perf_counter() - t_start - sum(parts.values())

    rows = []
    for k in sweep:
        n = 1 << k
        inp = ipp_inputs_on(n, dev)
        t0 = time.perf_counter()
        proof, state = ipp_prove(inp, dev)
        first_ms = (time.perf_counter() - t0) * 1e3
        digest = pinned.ipp_digest(proof, state)
        if digest != pinned.IPP_DIGESTS[n]:
            raise RuntimeError(f"IPP digest at n = {n}: {digest} != pinned {pinned.IPP_DIGESTS[n]}")
        ipp_verify(proof, inp, dev, ipp_host_factors(inp))
        msm_points = 1 + 2 * n + 2 * k                    # the verifier's one MSM
        row = {"n": n, "route": "host" if n < backend._DEVICE_MIN else "fused", "digest_equal": True,
               "verified": True, "verify_route": "host" if msm_points < backend._DEVICE_MIN else "card",
               "first_ms": first_ms}
        if n >= 64:
            reps = IPP_WARM if k >= IPP_WARM_FROM else 1
            row["warm_ms"] = host_ms(lambda: ipp_prove(inp, dev), reps)
            row["ms_median"] = statistics.median(row["warm_ms"])
        rows.append(row)
    part("sweep")

    wide = []
    launches = profile = None
    for k in full:
        n = 1 << k
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inp = ipp_inputs_on(n, dev)
        inputs_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        proof, state = ipp_prove(inp, dev)                       # cold
        cold_ms = (time.perf_counter() - t0) * 1e3
        counted = read_launches("ipp")
        peak = torch.cuda.max_memory_allocated()
        widest = k == full[-1]
        # at the widest the warm proof is the profiled one, below
        warm = [] if widest else host_ms(lambda: ipp_prove(inp, dev), IPP_FULL_WARM)
        t0 = time.perf_counter()
        d_proof, d_state = ipp_prove(inp, dev, _create_device)
        device_prover_ms = (time.perf_counter() - t0) * 1e3
        if d_proof.to_bytes() != proof.to_bytes() or d_state != state:
            raise RuntimeError(f"IPP at n = {n}: the fused and the coefficient-tracking provers differ")
        factors = ipp_host_factors(inp)
        verify_ms = host_ms(lambda: ipp_verify(proof, inp, dev, factors), 1)
        rejected = {}
        for case, bad in ipp_tampered(proof).items() if k == full[0] else ():
            try:
                ipp_verify(bad, inp, dev, factors)
            except VerificationError:
                rejected[case] = True
            else:
                raise RuntimeError(f"IPP verify at n = {n} accepted a tampered proof ({case})")
        row = {"n": n, "inputs_s": inputs_s, "cold_ms": cold_ms, "warm_ms": warm,
               "ms_median": statistics.median(warm) if warm else None, "create_device_ms": device_prover_ms,
               "fused_equals_create_device": True, "digest": pinned.ipp_digest(proof, state),
               "verify_ms": verify_ms, "verified": True, "rejected": rejected, "launches": counted,
               "peak_mem_bytes": peak, "mem_before_bytes": base_mem}
        wide.append(row)
        part(f"full_{n}")
        if widest:
            # eager PyTorch compiles nothing per shape, so the first proof at
            # a width is as fast as a warm one and stands for it unprofiled
            launches = counted
            profile = profile_run(lambda: ipp_prove(inp, dev), cold_ms * 1e3, gpu, f"ipp_{n}")
            last = inp
            part("profile")

    # fold_points: one round's fold of the widest G (one shared challenge
    # pair), and a first round's H fold with per-lane factors
    G, H = last["G"], last["H"]
    h = G.shape[-1] // 2
    u = int.from_bytes(hashlib.sha256(b"ipp-fold").digest(), "little") % R
    u_inv = pow(u, -1, R)
    w = lambda v: torch.as_tensor(limb.ints_to_words([v]), device=dev)
    G_L, G_R = G[..., :h].contiguous(), G[..., h:].contiguous()
    folds = [fold_check(gpu, "shared", lambda: fold.fold_points_shared(w(u_inv), w(u), G_L, G_R), G_L, G_R,
                        lambda i: (u_inv, u))]
    del G_L, G_R
    f = FOLD_FACTOR_LANES
    sl = limb.mod_mul(last["H_factors"][:, :f], w(u), limb.FR)
    sr = limb.mod_mul(last["H_factors"][:, f : 2 * f], w(u_inv), limb.FR)
    bits_l, bits_r = fold.scalar_bits(sl), fold.scalar_bits(sr)
    H_L, H_R = H[..., :f].contiguous(), H[..., f : 2 * f].contiguous()
    sl_int, sr_int = limb.words_to_ints(sl), limb.words_to_ints(sr)
    folds.append(fold_check(gpu, "per_lane", lambda: fold.fold_points(bits_l, bits_r, H_L, H_R), H_L, H_R,
                            lambda i: (sl_int[i], sr_int[i]),
                            plain=lambda: fold._fold(bits_l, bits_r, H_L, H_R, curve_t._point_add)))
    part("fold_points")

    # msm_device_pair at the widest round's shape, against two msm_device calls
    n = G.shape[-1]
    a, b = last["a"], last["b"]
    sA, sB = torch.cat([a, b[:, :1]], dim=-1), torch.cat([b, a[:, :1]], dim=-1)
    pA, pB = torch.cat([G, H[..., :1]], dim=-1), torch.cat([H, G[..., :1]], dim=-1)
    c = msm_mod.select_window(n + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pair = msm_mod.msm_device_pair(sA, pA, sB, pB, c)
    pair_peak = torch.cuda.max_memory_allocated()
    singles = torch.stack([msm_mod.msm_device(sA, pA), msm_mod.msm_device(sB, pB)], dim=-1)
    if curve_t.points_to_host(pair) != curve_t.points_to_host(singles):
        raise RuntimeError("msm_device_pair disagrees with two msm_device calls")
    times = {"pair": [], "two_singles": []}
    for who in ("pair", "two_singles", "two_singles", "pair"):
        fn = ((lambda: msm_mod.msm_device_pair(sA, pA, sB, pB, c)) if who == "pair"
              else (lambda: (msm_mod.msm_device(sA, pA), msm_mod.msm_device(sB, pB))))
        times[who] += host_ms(fn, 1)
    k = PAIR_HOST_POINTS
    small = [t[..., :k].contiguous() for t in (sA, pA, sB, pB)]
    got = curve_t.points_to_host(msm_mod.msm_device_pair(*small, msm_mod.select_window(k)))
    want = [StarkPoint.msm(limb.words_to_ints(s), curve_t.points_to_host(p))
            for s, p in ((small[0], small[1]), (small[2], small[3]))]
    if got != want:
        raise RuntimeError(f"msm_device_pair at {k} points disagrees with the host MSM")
    try:
        msm_mod.msm_device_pair(*small, 9)
    except ValueError:
        pass
    else:
        raise RuntimeError("msm_device_pair took c = 9 at 252 bits (a full top window)")
    pair_row = {"n": n + 1, "c": c, "equal_two_msm_device": True, "host_equal_at": small[0].shape[-1],
                "c9_raises": True, "ms": {who: statistics.median(v) for who, v in times.items()},
                "ms_turns": times, "peak_mem_bytes": pair_peak}
    part("msm_device_pair")

    # msm_device_split at SPLIT_POINTS points against msm_device of the same input
    m = SPLIT_POINTS
    s_m, p_m = a[:, :m].contiguous(), G[..., :m].contiguous()
    split = msm_mod.msm_device_split(s_m, msm_mod.split_points_device(p_m))
    if curve_t.points_to_host(split[..., None]) != curve_t.points_to_host(msm_mod.msm_device(s_m, p_m)[..., None]):
        raise RuntimeError(f"msm_device_split at {m} points disagrees with msm_device")
    split_row = {"n": m, "c": msm_mod.select_window(4 * m, msm_mod.SPLIT_CHUNK_BITS), "equal_msm_device": True}
    part("msm_device_split")

    res = {"phase": "ipp", "sweep": rows, "full": wide, "fold_points": folds, "msm_device_pair": pair_row,
           "msm_device_split": split_row, "launches": launches, "phase_s": time.perf_counter() - t_start,
           "parts_s": parts, "gpu": gpu}
    emit(res)
    emit(profile)
    return res


def run_parties(party, latency_s: float = 0.0, timeout_s: float = 900.0) -> tuple[list, list]:
    """``party(net)`` for both parties as threads over one in-process link
    (``make_local_pair``); returns the two results and the two ends (their
    message and byte counters).  A party's error is raised here; a party
    left blocked by its peer's error ends at the link's receive timeout."""
    import threading

    from mpc_bulletproof_tpu_torch import make_local_pair

    nets = make_local_pair(latency_s=latency_s)
    results, errors = [None, None], [None, None]

    def runner(i):
        try:
            results[i] = party(nets[i])
        except Exception as exc:  # noqa: BLE001 - raised below
            errors[i] = exc

    threads = [threading.Thread(target=runner, args=(i,), name=f"party{i}") for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout_s)
    if any(th.is_alive() for th in threads):
        raise RuntimeError("a party did not finish")
    for err in errors:
        if err is not None:
            raise err
    return results, list(nets)


def mpc_host_split(run) -> dict:
    """One more two-party proof by ``run()``, each party's host-clock time
    split into its sections: ``commitments`` (``batch_commit``: sharing,
    the two-point commitment MSMs, their opening), ``beaver_rounds``
    (``allocate_multiplier``: one Beaver round a multiplier), ``phase_msms``
    (``shared_gens_msm``), ``t_poly`` (``special_inner_product``: one
    Beaver round of 9n products on the device share plane), ``ipp``
    (``SharedInnerProductProof.create``), ``opening`` (the final
    MAC-checked opening) and the rest (constraints, l(x) and r(x), the T
    commitments, evaluations); no synchronize inside (the other party's
    work shares the card).  The wrappers are removed before returning."""
    import threading

    from mpc_bulletproof_tpu_torch.models.r1cs_mpc import (AuthenticatedVecPoly3, MpcProver,
                                                           PartiallySharedR1CSProof,
                                                           SharedInnerProductProof)
    from mpc_bulletproof_tpu_torch.parallel.fabric import MpcFabric

    sections = (("commitments", MpcProver, "batch_commit"),
                ("beaver_rounds", MpcProver, "allocate_multiplier"),
                ("phase_msms", MpcFabric, "shared_gens_msm"),
                ("t_poly", AuthenticatedVecPoly3, "special_inner_product"),
                ("ipp", SharedInnerProductProof, "create"),
                ("opening", PartiallySharedR1CSProof, "open"))
    spent = {f"party{i}": {name: 0.0 for name, _, _ in sections} for i in (0, 1)}

    def timed(part, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[threading.current_thread().name][part] += time.perf_counter() - t0
        return wrapper

    saved = [(cls, attr, cls.__dict__[attr]) for _, cls, attr in sections]
    for (part, cls, attr), (_, _, orig) in zip(sections, saved):
        if isinstance(orig, staticmethod):
            setattr(cls, attr, staticmethod(timed(part, orig.__func__)))
        else:
            setattr(cls, attr, timed(part, orig))
    try:
        t0 = time.perf_counter()
        totals = run()
        wall = time.perf_counter() - t0
    finally:
        for cls, attr, orig in saved:
            setattr(cls, attr, orig)
    out = {"wall_s": wall}
    for i, (name, parts) in enumerate(spent.items()):
        out[name] = {"total": totals[i], **parts, "rest": totals[i] - sum(parts.values())}
    return out


def mpc_phase(gpu: str, dev, n_bits: int = MPC_BITS, m_values: int = MPC_VALUES) -> dict:
    """The collaborative range proof over m committed n-bit values (n m
    multipliers), both parties as threads on one card: digest against the
    JAX package's host path, the port's verifier on the card, a tampered
    opening rejected by both parties, launches of one proof (both parties),
    warm medians, the host split, the link's rounds and bytes, a device
    profile; then the JAX package's ``bench.py`` MPC configuration (the
    example gadget) at each one-way latency of ``MPC_SMALL_LATENCIES``."""
    import random

    import torch

    from mpc_bulletproof_tpu_torch import (AuthenticationError, BulletproofGens, HashChainTranscript,
                                           LinearCombination, MpcFabric, MpcProver, PartyIdBeaverSource,
                                           PedersenGens, Scalar, SharedInnerProductProof, Variable,
                                           Verifier, pinned)
    from mpc_bulletproof_tpu_torch.models.r1cs.gadgets import example_gadget, range_check_gadget
    from mpc_bulletproof_tpu_torch.ops import kernels
    from mpc_bulletproof_tpu_torch.parallel.fabric import AuthenticatedScalarVector

    want = pinned.MPC_RANGE_DIGESTS[(n_bits, m_values)]
    values, blindings = pinned.mpc_range_inputs(n_bits, m_values)
    t0 = time.perf_counter()
    bp_gens = BulletproofGens(n_bits * m_values, 1, device=dev)
    pc_gens = PedersenGens()
    torch.cuda.synchronize()
    gens_s = time.perf_counter() - t0

    def party(net, tamper=False):
        t_start = time.perf_counter()
        fabric = MpcFabric(net, PartyIdBeaverSource(net.party_id), device=dev)
        tr = HashChainTranscript(pinned.MPC_LABEL)
        prover = MpcProver(fabric, pc_gens, tr)
        comms = pinned.mpc_range_party(prover, fabric, n_bits, values, blindings)
        shared = prover.prove(bp_gens)
        rejected = None
        if tamper:      # party 0 adds one to its share of the IPP's a
            ipp = shared.ipp_proof
            a = ipp.a
            if fabric.party_id == 0:
                a = AuthenticatedScalarVector(fabric, [a.shares[0] + Scalar(1)], list(a.macs))
            bad = dataclasses.replace(shared, ipp_proof=SharedInnerProductProof(
                ipp.L_vec, ipp.R_vec, a, ipp.b, fabric))
            try:
                bad.open()
            except AuthenticationError:
                rejected = True
            else:
                raise RuntimeError(f"party {fabric.party_id} accepted a tampered opening")
        proof = shared.open()
        return proof, comms, tr.state, rejected, time.perf_counter() - t_start

    def prove(tamper=False):
        (r0, r1), nets = run_parties(lambda net: party(net, tamper))
        proof, comms, state = r0[0], r0[1], r0[2]
        if r1[0] != proof or r1[1] != comms or r1[2] != state:
            raise RuntimeError("the parties opened different proofs")
        digest = pinned.proof_digest(proof, comms, state)
        if digest != want:
            raise RuntimeError(f"MPC range proof digest {digest} != pinned {want}")
        return (r0, r1), nets

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    (r0, r1), nets = prove(tamper=True)        # cold: uploads the generators
    cold_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_launches("mpc")
    if not (r0[3] and r1[3]):
        raise RuntimeError("the tampered opening was not rejected by both parties")
    proof, comms = r0[0], r0[1]

    t0 = time.perf_counter()
    verifier = Verifier(pc_gens, HashChainTranscript(pinned.MPC_LABEL))
    for V in comms:
        range_check_gadget(verifier, verifier.commit(V).to_lc(), None, n_bits)
    verifier.verify(proof, bp_gens, device=dev)
    verify_s = time.perf_counter() - t0

    warm, link = [], None
    for _ in range(WARM_MPC):
        t0 = time.perf_counter()
        _, nets = prove()
        warm.append(time.perf_counter() - t0)
        link = [{"messages": n.sent_messages, "bytes": n.sent_bytes} for n in nets]
    split = mpc_host_split(lambda: [r[4] for r in prove()[0]])

    res = {"phase": "mpc", "n_bits": n_bits, "values": m_values, "multipliers": n_bits * m_values,
           "ipp_rounds": (n_bits * m_values - 1).bit_length(), "parties": 2, "link": "local threads",
           "digest": want, "digest_equal": True, "verified_on_card": True,
           "tampered_opening_rejected": {"party0": r0[3], "party1": r1[3]},
           "proof_bytes": len(proof.to_bytes()), "gens_s": gens_s, "cold_prove_s": cold_s,
           "verify_s": verify_s, "warm_prove_s": warm,
           "us_per_proof_median": statistics.median(warm) * 1e6, "host_split_s": split,
           "link_per_party": link, "launches": launches,
           "vec2_family_launches": sum(launches[k] for k in VEC2_FAMILY), "gpu": gpu}
    emit(res)
    emit(profile_run(lambda: prove(), res["us_per_proof_median"], gpu, "mpc"))

    # the JAX package's bench.py MPC configuration (bench.py _mpc_prove_ms)
    gens16 = BulletproofGens(16, 1, device=dev)
    rng = random.Random(4242)
    blind = [Scalar(rng.getrandbits(260)) for _ in range(5)]
    c2 = LinearCombination({Variable.one(): Scalar(9)})

    def example(net):
        fabric = MpcFabric(net, PartyIdBeaverSource(net.party_id), device=dev)
        prover = MpcProver(fabric, pc_gens, HashChainTranscript(b"bench-mpc"))
        if fabric.party_id == 0:
            c0, v0 = prover.batch_commit(0, [Scalar(3), Scalar(6), Scalar(40)], blind[:3])
            c1, v1 = prover.batch_commit(1, None, None, count=2)
        else:
            c0, v0 = prover.batch_commit(0, None, None, count=3)
            c1, v1 = prover.batch_commit(1, [Scalar(4), Scalar(1)], blind[3:])
        example_gadget(prover, v0[0].to_lc(), v1[0].to_lc(), v0[1].to_lc(), v1[1].to_lc(), v0[2].to_lc(), c2)
        return prover.prove(gens16).open(), c0 + c1

    small = {}
    for latency in MPC_SMALL_LATENCIES:
        (e0, e1), _ = run_parties(example, latency)            # warm
        if e0 != e1:
            raise RuntimeError("example gadget: the parties opened different proofs")
        times = []
        for _ in range(WARM_MPC_SMALL):
            t0 = time.perf_counter()
            run_parties(example, latency)
            times.append(time.perf_counter() - t0)
        small[str(latency)] = {"prove_open_ms": [t * 1e3 for t in times],
                               "ms_median": statistics.median(times) * 1e3}
    ex_proof, ex_comms = e0
    v = Verifier(pc_gens, HashChainTranscript(b"bench-mpc"))
    vv = [v.commit(c) for c in ex_comms]
    example_gadget(v, vv[0].to_lc(), vv[3].to_lc(), vv[1].to_lc(), vv[4].to_lc(), vv[2].to_lc(), c2)
    v.verify(ex_proof, gens16, device=dev)
    emit({"phase": "mpc_small", "config": "bench.py _mpc_prove_ms: example_gadget, BulletproofGens(16, 1)",
          "one_way_latency_s": list(MPC_SMALL_LATENCIES), "verified_on_card": True, "runs": small, "gpu": gpu})
    return res


def party_dealer_phase(gpu: str, dev, mp: dict, n_bits: int = N_BITS, m_parties: int = M_PARTIES) -> dict:
    """The (n, m) range proof by the party/dealer protocol on the card:
    ``Party``/``Dealer`` on the main path's generators and pinned inputs,
    the m parties in order on one ``pinned.det_stream()``.  The digest of
    proof, commitments and transcript must be the fused prover's
    (``pinned.DIGESTS``); ``verify_multiple`` on the card accepts the
    proof; ``receive_shares`` audits the honest shares and assembles the
    same bytes; one party's share with t_x + 1 raises ``MPCError`` naming
    that party.  Launches of one proof, the median of warm proofs (host
    clock), the host split of one audited proof (the parties' three
    phases, the dealer's two challenge rounds, the share audits, the
    inner-product argument and the rest of the assembly, each part ended
    by a synchronize) and a device profile."""
    import torch

    from mpc_bulletproof_tpu_torch import HashChainTranscript, Scalar, pinned
    from mpc_bulletproof_tpu_torch.models.inner_product import InnerProductProof
    from mpc_bulletproof_tpu_torch.models.range_proof import Dealer, Party
    from mpc_bulletproof_tpu_torch.models.range_proof.dealer import DealerAwaitingProofShares
    from mpc_bulletproof_tpu_torch.ops import kernels
    from mpc_bulletproof_tpu_torch.utils.errors import MPCError

    bp_gens, pc_gens = mp["bp_gens"], mp["pc_gens"]
    values, blindings = pinned.inputs(n_bits, m_parties)
    want = pinned.DIGESTS[(n_bits, m_parties)]
    spent: dict = {}

    def timed(part, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        spent[part] = spent.get(part, 0.0) + time.perf_counter() - t0
        return out

    def prove(audit=False, corrupt=None):
        tr = HashChainTranscript(pinned.TRANSCRIPT_LABEL)
        rng_bytes = pinned.det_stream()
        dealer = Dealer.new(bp_gens, pc_gens, tr, n_bits, m_parties, device=dev)
        parties = [Party.new(bp_gens, pc_gens, v, b, n_bits, device=dev) for v, b in zip(values, blindings)]
        positioned, bit_comms = zip(*timed("parties_position", lambda: [
            p.assign_position(j, rng_bytes=rng_bytes) for j, p in enumerate(parties)]))
        dealer, bit_ch = timed("dealer_bit_round", lambda: dealer.receive_bit_commitments(list(bit_comms)))
        polied, poly_comms = zip(*timed("parties_bit_challenge", lambda: [
            p.apply_challenge(bit_ch) for p in positioned]))
        dealer, poly_ch = timed("dealer_poly_round", lambda: dealer.receive_poly_commitments(list(poly_comms)))
        shares = timed("parties_poly_challenge", lambda: [p.apply_challenge(poly_ch) for p in polied])
        named = None
        if corrupt is not None:     # a tampered copy first: its audit raises before the transcript moves
            bad = copy.deepcopy(shares)
            corrupt(bad)
            try:
                dealer.receive_shares(bad)
            except MPCError as exc:
                if f"[{bad_party}]" not in str(exc):
                    raise RuntimeError(f"the audit named other parties: {exc}") from exc
                named = str(exc)
            else:
                raise RuntimeError("the dealer accepted a tampered proof share")
        proof = timed("assembly", lambda: dealer.receive_shares(shares) if audit
                      else dealer.receive_trusted_shares(shares))
        V = [bc.V_j for bc in bit_comms]
        digest = pinned.proof_digest(proof, V, tr.state)
        if digest != want:
            raise RuntimeError(f"party/dealer proof digest {digest} != pinned {want}")
        return proof, V, named

    bad_party = min(5, m_parties - 1)

    def corrupt(shares):
        shares[bad_party].t_x = shares[bad_party].t_x + Scalar(1)

    t0 = time.perf_counter()
    proof, V, named = prove(corrupt=corrupt)
    first_s = time.perf_counter() - t0
    proof.verify_multiple(bp_gens, pc_gens, HashChainTranscript(pinned.TRANSCRIPT_LABEL), V, n_bits, device=dev)

    warm = []
    for _ in range(WARM_PROOFS):
        t0 = time.perf_counter()
        prove()
        warm.append(time.perf_counter() - t0)
    warm_us = statistics.median(warm) * 1e6
    prof = profile_run(prove, warm_us, gpu, "party_dealer")
    launches = read_launches("pd")              # the profiled proof's: profile_run resets the counters

    # one audited proof, split: the audits and the IPP timed inside the assembly
    orig_valid = DealerAwaitingProofShares.__dict__["_share_is_valid"]
    orig_create = InnerProductProof.__dict__["create"]
    DealerAwaitingProofShares._share_is_valid = lambda self, j, ps: timed(
        "share_audits", lambda: orig_valid(self, j, ps))
    InnerProductProof.create = staticmethod(lambda *a, **kw: timed("ipp", lambda: orig_create.__func__(*a, **kw)))
    try:
        spent.clear()
        t0 = time.perf_counter()
        audited, _, _ = prove(audit=True)
        total = time.perf_counter() - t0
    finally:
        DealerAwaitingProofShares._share_is_valid = orig_valid
        InnerProductProof.create = orig_create
    if audited.to_bytes() != proof.to_bytes():
        raise RuntimeError("the audited shares assembled other bytes")
    inner = ("share_audits", "ipp")                                # inside the assembly
    split = {"total": total, **spent, "assembly_rest": spent["assembly"] - sum(spent[k] for k in inner),
             "rest": total - sum(v for k, v in spent.items() if k not in inner)}
    del split["assembly"]

    res = {"phase": "party_dealer", "n": n_bits, "m": m_parties, "digest": want, "digest_equal": True,
           "verified_on_card": True, "audited_bytes_equal": True,
           "tampered_share": {"party": bad_party, "raised": named},
           "first_prove_s": first_s, "warm_prove_s": warm, "us_per_proof_median": warm_us,
           "fused_us_per_proof_median": mp["us_per_proof_median"], "host_split_s": split,
           "launches": launches, "gpu": gpu}
    emit(res)
    emit(prof)
    return res


def mpc_tcp_phase(gpu: str, dev, mc: dict, n_bits: int = MPC_BITS, m_values: int = MPC_VALUES) -> dict:
    """The collaborative prover's two-process deployment on the card: the
    integration harness (``mpc_bulletproof_tpu_torch/integration``), both
    parties as OS processes on this card over loopback TCP, started by its
    launcher after the kernels are built here (each process then loads
    them).  Every case of its registry must pass in both; the (n, m)
    collaborative range proof, proved ``TCP_PROOFS`` times (the first
    cold), must give ``pinned.MPC_RANGE_DIGESTS`` and the same opened bytes
    in both parties, and each party must send per proof the messages and
    bytes it sent with the parties as threads (``mc``, the mpc phase);
    the launches summed over both processes must include the point
    kernels and the vec2 family; ``mpc_prover_malleability`` passes only
    where the tampered opening raised ``AuthenticationError``.  Either
    process failing, or the deadline passing, fails the run."""
    from mpc_bulletproof_tpu_torch import pinned
    from mpc_bulletproof_tpu_torch.integration import launch
    from mpc_bulletproof_tpu_torch.integration.main import CASES
    from mpc_bulletproof_tpu_torch.ops import kernels

    kernels.build()
    args = ["--device", dev.type, "--bits", str(n_bits), "--values", str(m_values), "--proofs", str(TCP_PROOFS)]
    run = launch.run_pair(args, deadline_s=TCP_DEADLINE_S)
    tail = lambda i: run["stderr"][i][-3000:]
    if run["timed_out"]:
        raise RuntimeError(f"mpc_tcp: the deadline of {TCP_DEADLINE_S} s passed: {tail(0)} {tail(1)}")
    if run["rcs"] != [0, 0] or None in run["reports"]:
        raise RuntimeError(f"mpc_tcp: exit codes {run['rcs']}: {run['stdout'][0][-3000:]} {tail(0)} {tail(1)}")
    reports = run["reports"]
    for rep in reports:
        if [c["name"] for c in rep["cases"]] != sorted(CASES) or not all(c["ok"] for c in rep["cases"]):
            raise RuntimeError(f"mpc_tcp: party {rep['party']}: {[c for c in rep['cases'] if not c['ok']]}")
        if rep["jax_modules"]:
            raise RuntimeError(f"mpc_tcp: party {rep['party']} loaded {rep['jax_modules']}")
    opened = [{c["name"]: c["opened_sha256"] for c in rep["cases"]} for rep in reports]
    if opened[0] != opened[1]:
        raise RuntimeError("mpc_tcp: the parties opened different proofs")
    ranges = [next(c for c in rep["cases"] if c["name"] == "mpc_range_proof") for rep in reports]
    want = pinned.MPC_RANGE_DIGESTS[(n_bits, m_values)]
    threads_link = mc["link_per_party"]
    for party, row in enumerate(ranges):
        if row["detail"]["digest"] != want:
            raise RuntimeError(f"mpc_tcp: party {party}'s digest {row['detail']['digest']} != pinned {want}")
        for proof in row["detail"]["proofs"]:
            got = {"messages": proof["sent_messages"], "bytes": proof["sent_bytes"]}
            if got != threads_link[party]:
                raise RuntimeError(f"mpc_tcp: party {party} sent {got} a proof, the threads {threads_link[party]}")
    launches = {name: sum(c["launches"].get(name, 0) for rep in reports for c in rep["cases"])
                for name in kernels.KERNELS}
    require_launches("tcp", launches)
    per_proof = [[p["seconds"] for p in row["detail"]["proofs"]] for row in ranges]
    both = [max(a, b) for a, b in zip(*per_proof)]           # a proof ends when both parties have opened it
    res = {"phase": "mpc_tcp", "n_bits": n_bits, "values": m_values, "processes": 2, "link": "tcp loopback",
           "cases": {c["name"]: {"ok": True, "seconds": [r["cases"][i]["seconds"] for r in reports],
                                 "sent_messages": [r["cases"][i]["sent_messages"] for r in reports],
                                 "opened_sha256": c["opened_sha256"]}
                     for i, c in enumerate(reports[0]["cases"])},
           "digest": want, "digest_equal": True, "opened_equal": True, "link_per_party_per_proof":
               [{"messages": r["detail"]["proofs"][0]["sent_messages"], "bytes": r["detail"]["proofs"][0]["sent_bytes"]}
                for r in ranges],
           "link_equal_to_threads": True, "setup_s": [r["setup_s"] for r in reports],
           "proof_s_per_party": per_proof, "proof_s": both, "cold_proof_s": both[0],
           "warm_proof_s": both[1:], "us_per_warm_proof_median": statistics.median(both[1:]) * 1e6,
           "threads_us_per_proof_median": mc["us_per_proof_median"],
           "launches_per_proof_both_parties": {k: sum(r["detail"]["proofs"][-1]["launches"].get(k, 0)
                                                      for r in ranges) for k in kernels.KERNELS},
           "launches": launches, "vec2_family_launches": sum(launches[k] for k in VEC2_FAMILY),
           "harness_s": run["seconds"], "gpu": gpu}
    emit(res)
    return res


def prove_split(run) -> dict:
    """One more proof by ``run()``, its host-clock time split into the phase
    MSMs (``backend.gens_msm``), the inner-product argument
    (``InnerProductProof.create``) and the rest (RNG rekeying, constraints,
    t-polynomial, T commitments, transcript), each part ended by a
    synchronize.  The wrappers are removed again before returning."""
    import torch

    from mpc_bulletproof_tpu_torch.models.inner_product import InnerProductProof
    from mpc_bulletproof_tpu_torch.ops import backend

    spent = {"phase_msms": 0.0, "ipp": 0.0}

    def timed(part, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[part] += time.perf_counter() - t0
            return out
        return wrapper

    orig_msm, orig_create = backend.gens_msm, InnerProductProof.__dict__["create"]
    backend.gens_msm = timed("phase_msms", orig_msm)
    InnerProductProof.create = staticmethod(timed("ipp", orig_create.__func__))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        backend.gens_msm, InnerProductProof.create = orig_msm, orig_create
    return {"total": total, **spent, "rest": total - sum(spent.values())}


def probe_inputs(dev) -> dict:
    """The TPU benches' inputs per probe and dtype: int32 in [1, 2^12) for
    the chain (its float32 copy the same values), int32 in [1, 8191) and
    float32 in [0.5, 1.5) for the xor chain, int32 in [0, 2^13) for the
    accumulation (float32: the same values)."""
    import numpy as np
    import torch

    from mpc_bulletproof_tpu_torch.ops import probes

    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, device=dev).contiguous()
    ci = [t(rng.integers(1, 1 << 12, probes.CHAIN_SHAPE, dtype=np.int32)) for _ in range(2)]
    xi = t(rng.integers(1, 8191, probes.XOR_SHAPE, dtype=np.int32))
    xf = t(rng.uniform(0.5, 1.5, probes.XOR_SHAPE).astype(np.float32))
    ai = [t(rng.integers(0, 1 << 13, probes.ACCUM_SHAPE).astype(np.int32)) for _ in range(2)]
    return {"chain": {torch.int32: ci, torch.float32: [c.float() for c in ci]},
            "xor": {torch.int32: [xi], torch.float32: [xf]},
            "accum": {torch.int32: ai, torch.float32: [a.float() for a in ai]}}


def clock_under_load(fn, launches: int = 300, samples: int = 3) -> float:
    """The median SM clock (MHz) ``nvidia-smi`` reports while ``launches``
    runs of ``fn`` (one launch each, ~2 ms for the full xor chain) are
    queued on the card."""
    import torch

    torch.cuda.synchronize()
    for _ in range(launches):
        fn()
    got = []
    for _ in range(samples):
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True)
        got.append(float(out.stdout.strip().splitlines()[0]))
    torch.cuda.synchronize()
    return statistics.median(got)


def measure_clock(dev) -> float:
    """The SM clock under load that every per-pipe bound uses: the clock
    ``nvidia-smi`` reports while the full xor chain (``probe_xor_chain``,
    i32_mul) runs."""
    from mpc_bulletproof_tpu_torch.ops import probes

    xor_a = probe_inputs(dev)["xor"][probes.op_dtype("i32_mul")]
    return clock_under_load(lambda: probes.probe_xor_chain("i32_mul", *xor_a, probes.XOR_REPS[1]))


def probe_err(got, want) -> float:
    """Largest |got - want| of two probe outputs, NaN equal to NaN."""
    import torch

    if got.dtype == torch.int32:
        return float((got.long() - want.long()).abs().max())
    same = (got == want) | (got.isnan() & want.isnan())
    return 0.0 if bool(same.all()) else float((got - want)[~same].abs().nan_to_num(float("inf")).max())


def probe_edges(gpu: str, dev) -> dict:
    """The redesigned probes' edge cases (``probes.EDGE_*``), every op
    against its plain version: ``probe_chain`` at reps 0, 1, U - 1, U, U +
    1, 100 and 4,096 (U = CHAIN_STEPS: no unrolled iteration, the tail
    alone, both), and ``probe_accum`` at 2,048, 2,047 and 4,099 lanes (the
    16-byte path and its scalar tail) and on a view at a 4-byte offset
    (the scalar path), with int32 edge lanes, at rep 64, 0, 5 and 100."""
    import numpy as np
    import torch

    from mpc_bulletproof_tpu_torch.ops import probes

    rng = np.random.default_rng(6)
    chain_reps = probes.EDGE_CHAIN_REPS
    x, y = (torch.as_tensor(rng.integers(1, 1 << 12, probes.CHAIN_SHAPE, dtype=np.int32), device=dev)
            for _ in range(2))
    checked = 0
    for op in probes.CHAIN_OPS:
        xo, yo = (x, y) if probes.op_dtype(op) == torch.int32 else (x.float(), y.float())
        for reps in chain_reps:
            if probe_err(probes.probe_chain(op, xo, yo, reps), probes.chain_plain(op, xo, yo, reps)) != 0:
                raise RuntimeError(f"probe_chain {op} at {reps} reps disagrees with its plain version")
            checked += 1
    accum_lanes = probes.EDGE_ACCUM_LANES
    for n, off in accum_lanes:
        a, b = (torch.as_tensor(rng.integers(0, 1 << 13, n + off).astype(np.int32), device=dev) for _ in range(2))
        a[off:off + 3] = torch.tensor([2**31 - 1, -1, -(2**31)], dtype=torch.int32)
        for op in probes.ACCUM_OPS:
            ao, bo = ((a, b) if probes.op_dtype(op) == torch.int32 else (a.float(), b.float()))
            ao, bo = ao[off:], bo[off:]
            for rep in probes.EDGE_ACCUM_REPS:
                if probe_err(probes.probe_accum(op, ao, bo, rep), probes.accum_plain(op, ao, bo, rep)) != 0:
                    raise RuntimeError(f"probe_accum {op} at {n} lanes, offset {off}, rep {rep} disagrees")
                checked += 1
    torch.cuda.synchronize()
    row = {"phase": "probe_edges", "chain_reps": chain_reps, "accum_lanes_offset": accum_lanes,
           "cases": checked, "all_equal": True, "gpu": gpu}
    emit(row)
    return row


def probes_phase(gpu: str, dev) -> dict:
    """Every op of the three probes at its TPU shape: held to its plain
    version bit for bit (NaN equal to NaN) at ``check_reps``, then launched
    once at the full counts (the launches read), then timed; each row with
    its main loop's SASS (:func:`sass_rows`), its bounds and cycles a step."""
    import torch

    from mpc_bulletproof_tpu_torch.ops import kernels, probes

    xor_lo, xor_hi = probes.XOR_REPS
    specs = {  # kernel: (key, ops, ops per step, kernel call, plain call, full reps, check reps)
        "probe_chain": ("chain", probes.CHAIN_OPS, probes.CHAIN_OPS_PER_STEP, probes.probe_chain,
                        probes.chain_plain, probes.CHAIN_REPS, probes.CHAIN_REPS),
        "probe_xor_chain": ("xor", probes.XOR_OPS, probes.XOR_OPS_PER_STEP, probes.probe_xor_chain,
                            probes.xor_chain_plain, xor_hi, 64),
        "probe_accum": ("accum", probes.ACCUM_OPS, probes.ACCUM_OPS_PER_STEP, probes.probe_accum,
                        probes.accum_plain, probes.ACCUM_REP, probes.ACCUM_REP),
    }
    probe_edges(gpu, dev)
    inputs = probe_inputs(dev)
    args = lambda key, op: inputs[key][probes.op_dtype(op)]

    rows: dict = {}
    for name, (key, ops, per_step, fn, plain, full, check) in specs.items():
        for op in ops:
            got = fn(op, *args(key, op), check)
            torch.cuda.synchronize()
            want, plain_ms = timed_ms(lambda: plain(op, *args(key, op), check))
            e = probe_err(got, want)
            if e != 0:
                raise RuntimeError(f"{name} {op} disagrees with its plain version (max err {e})")
            rows.setdefault(name, {})[op] = {"check_reps": check, "max_abs_err": e,
                                             "plain_ms": plain_ms}
    torch.cuda.synchronize()
    kernels.reset_launches()
    for name, (key, ops, _, fn, _, full, _) in specs.items():    # the benches' runs
        for op in ops:
            fn(op, *args(key, op), full)
            if name == "probe_xor_chain":
                fn(op, *args(key, op), xor_lo)
    torch.cuda.synchronize()
    launches = read_launches("probes")

    sass = sass_rows(kernels.build()["probe_chain"][0])
    runs = [(f"{PROBE_KERNEL[name]}<{i}>(", lambda fn=fn, op=op, a=args(key, op), full=full: fn(op, *a, full))
            for name, (key, ops, _, fn, _, full, _) in specs.items() for i, op in enumerate(ops)]
    recorded: dict = {}
    dev_ms = device_ms_by_name(runs, 20, recorded)
    clock_mhz = SM_CLOCK_MHZ
    summary = {}
    for name, (key, ops, per_step, fn, plain, full, _) in specs.items():
        for i, op in enumerate(ops):
            a = args(key, op)
            lanes = a[0].numel()
            r = rows[name][op]
            r["ms"] = cuda_ms(lambda: fn(op, *a, full), 20)
            r["device_ms"] = d_ms = dev_ms[f"{PROBE_KERNEL[name]}<{i}>("]
            r["device_launches_recorded"] = recorded[f"{PROBE_KERNEL[name]}<{i}>("]
            r["cycles_per_step"] = None if d_ms is None else d_ms * clock_mhz * 1e3 / full
            r["bytes_bound_ms"] = lanes * 4 * (len(a) + 1) / HBM_BYTES_PER_S * 1e3
            r["pipe_bound_ms"], r["pipe"] = pipe_bound_ms(lanes * full, PROBE_NEEDS[name][op], clock_mhz)
            r.update(sass[name][op])
            r["sass_issue_ms"] = pipe_bound_ms(lanes * full, r["sass_per_lane_step"], clock_mhz)[0]
            r["bound_ms"] = max(r["bytes_bound_ms"], r["pipe_bound_ms"])
            r["bound_by"] = "bytes" if r["bytes_bound_ms"] >= r["pipe_bound_ms"] else "operations"
            r["gops_per_s"] = lanes * full * per_step[op] / r["ms"] / 1e6
            r["fill_share"] = min(1.0, lanes / RESIDENT_THREADS)
            dep = PROBE_DEP_STEPS[name][op]
            r["dependency_bound_ms"] = None if dep is None else \
                full * dep * DEP_LATENCY_CYCLES / (clock_mhz * 1e3)
            r["bound_share"] = None if d_ms is None else r["bound_ms"] / d_ms
            r["dependency_share"] = None if d_ms is None or dep is None else r["dependency_bound_ms"] / d_ms
            r["clock_mhz_under_load"] = clock_mhz
            if name == "probe_xor_chain":
                lo_ms = cuda_ms(lambda: fn(op, *a, xor_lo), 20)
                r["ms_at_%d" % xor_lo] = lo_ms
                r["gchain_iter_per_s_net"] = (full - xor_lo) * lanes / (r["ms"] - lo_ms) / 1e6
            emit({"phase": "probe", "kernel": name, "op": op, "lanes": lanes, "reps": full,
                  "ops_per_step": per_step[op], **r, "gpu": gpu})
        # the kernels line's numbers: the bench's int32 multiply, its plain version at the full counts
        a = args(key, "i32_mul")
        got = fn("i32_mul", *a, full)
        want, plain_full_ms = timed_ms(lambda: plain("i32_mul", *a, full))
        e = probe_err(got, want)
        if e != 0:
            raise RuntimeError(f"{name} i32_mul disagrees with its plain version at {full} reps")
        m = rows[name]["i32_mul"]
        summary[name] = {"kernel_ms": m["ms"], "device_ms": m["device_ms"], "plain_ms": plain_full_ms,
                         "op": "i32_mul", "clock_mhz_under_load": clock_mhz,
                         **{k: m[k] for k in ("bound_ms", "bound_by", "pipe", "pipe_bound_ms", "bound_share",
                                              "dependency_bound_ms", "dependency_share", "cycles_per_step")},
                         "sass_over_need": {op: v["sass_issue_ms"] / v["pipe_bound_ms"] for op, v in rows[name].items()
                                            if v["sass_issue_ms"] > v["pipe_bound_ms"]},
                         "max_abs_err": max(r["max_abs_err"] for r in rows[name].values()),
                         "equal": True, "fill_share": m["fill_share"],
                         "ops": {op: {k: v for k, v in r.items() if k not in ("sass_hist", "sass_per_lane_step")}
                                 for op, r in rows[name].items()}}
    emit({"phase": "probe_sass", "over_need": {name: c["sass_over_need"] for name, c in summary.items()},
          "rows": {name: {op: v["sass_hist"] for op, v in r.items()} for name, r in sass.items()}})
    return {"launches": launches, "checks": summary}


def profile_run(fn, warm_us: float, gpu: str, what: str, extra: dict | None = None) -> dict:
    """Device time by kernel over one warm run of ``fn`` (torch.profiler),
    with the port's launch counters around the same run.  ``by_source``
    sums the port's kernels by CUDA source (device µs, launches the
    profiler recorded, launches counted); ``counts_match`` says whether the
    two counts agree for every source, as per-run sums need (the profiler
    can drop launches).  ``extra``: ``{kernel function: (label, [launches
    counted])}`` for kernels outside this tree's sources (the A/B's
    baseline; the count is read after the run).  The profiler slows the host, so the idle share is also
    given against the unprofiled median time.  The session opens with
    :data:`PROFILER_PAD` sleeps, left out of every figure: a session
    records none of its first ~20 to 25 launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpc_bulletproof_tpu_torch.ops import kernels

    extra = extra or {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILER_PAD):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    counted = dict(kernels.launches)
    rows = [r for r in device_rows(prof) if "spin_kernel" not in r[1]]
    busy_us = sum(r[0] for r in rows)
    source_of = {**kernel_functions(), **{f: label for f, (label, _) in extra.items()}}
    by_source = {src: {"device_us": 0.0, "recorded": 0, "counted": 0} for src in set(source_of.values())}
    for name, (src, _, _) in kernels.KERNELS.items():
        by_source[src]["counted"] += counted[name]
    for label, n in extra.values():
        by_source[label]["counted"] += n[0]
    port: dict = {}
    for us, key, n in rows:
        fname = re.split(r"[<(]", key.removeprefix("void "), maxsplit=1)[0]
        if fname in source_of:
            agg = port.setdefault(fname, {"device_us": 0.0, "count": 0})
            agg["device_us"] += us
            agg["count"] += n
            by_source[source_of[fname]]["device_us"] += us
            by_source[source_of[fname]]["recorded"] += n
    by_source = {k: v for k, v in by_source.items() if v["recorded"] or v["counted"]}
    res = {"phase": "profile", "of": what, "wall_us": wall_us, "device_busy_us": busy_us if rows else None,
           "device_idle_share": (1 - busy_us / wall_us) if rows else None,
           "device_idle_share_unprofiled": (1 - busy_us / warm_us) if rows else None,
           "device_launches": sum(r[2] for r in rows) if rows else None,
           "top": [{"name": k[:80], "device_us": us, "count": n} for us, k, n in rows[:25]],
           "port_kernels": port, "by_source": by_source,
           "counts_match": all(v["recorded"] == v["counted"] for v in by_source.values()), "gpu": gpu}
    PROFILES.setdefault(what, {k: res[k] for k in ("device_launches", "device_idle_share",
                                                   "device_idle_share_unprofiled", "device_busy_us",
                                                   "wall_us", "counts_match")})
    return res


def prove_launch_drop() -> int:
    """How many fewer device launches the (64, 64) prove's profile counted
    than :data:`PARENT_PROFILES`; raises if under :data:`PROVE_LAUNCH_DROP`."""
    prove = PROFILES["prove"]["device_launches"]
    drop = PARENT_PROFILES["prove"]["device_launches"] - (prove or 0)
    if prove is None or drop < PROVE_LAUNCH_DROP:
        raise RuntimeError(f"prove: {prove} device launches, {drop} fewer than before, under {PROVE_LAUNCH_DROP}")
    return drop


def device_rows(prof) -> list:
    """``(device µs, name, launches)`` per name of a finished profiler
    session's device activity (kernels, copies, sets), largest first,
    summed from the raw trace (``kineto_results``): the profiler's own
    aggregation (``key_averages``) first builds an event tree of every CPU
    op, ~0.1 ms an event, over a minute for a proof of 10^5 launches."""
    from torch.autograd import DeviceType

    agg: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or ev.is_user_annotation():
            continue
        row = agg.setdefault(ev.name(), [0.0, 0])
        row[0] += ev.duration_ns() / 1e3
        row[1] += 1
    return sorted(((us, name, n) for name, (us, n) in agg.items() if us > 0), reverse=True)


def kernel_functions() -> dict:
    """``{__global__ function: source file}`` over the port's CUDA sources."""
    from mpc_bulletproof_tpu_torch.ops import kernels

    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)")
    return {m: f.name for f in kernels.CSRC.glob("*.cu") for m in pat.findall(f.read_text())}


# --- A/B against a baseline tree's point_reduce (``--ab DIR``)

def build_ab(src_dir: str):
    """The one-block ``point_reduce`` (256 threads, entry
    ``bp_point_reduce(x, out, n, stream)``), built from ``src_dir`` (that
    tree's ``csrc``, e.g. unpacked by ``git archive``) with this tree's nvcc
    flags."""
    import ctypes
    from pathlib import Path

    from mpc_bulletproof_tpu_torch.ops import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = kernels.BUILD_DIR / "ab-point_reduce.so"
    out = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                          str(Path(src_dir) / "point_reduce.cu")], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for the baseline's point_reduce.cu:\n{out.stdout}{out.stderr}")
    fn = ctypes.CDLL(str(lib)).bp_point_reduce
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p], ctypes.c_int
    return fn


def base_reduce_sum(old_fn, calls: list):
    """The former route in place of ``msm._reduce_sum``: a ``(3, NW, n)`` sum (the
    A bit sum) on its one-block kernel, every segmented sum (bucket tails,
    fixed-base commitments) on the halving tree.  ``calls[0]`` counts the
    kernel's launches."""
    import torch

    from mpc_bulletproof_tpu_torch.ops.limb import NW

    def reduce_sum(pts):
        pts = pts.contiguous()
        if pts.dim() != 3:
            return halving_tree(pts)
        out = torch.empty((3, NW, 1), dtype=torch.int64, device=pts.device)
        rc = old_fn(pts.data_ptr(), out.data_ptr(), pts.shape[-1], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the baseline's point_reduce failed to launch ({rc})")
        calls[0] += 1
        return out
    return reduce_sum


def ab_phase(gpu: str, dev, src_dir: str, proofs: dict) -> dict:
    """The one-block point_reduce, built from ``src_dir``, against this tree's, in one
    call: at the A bit sum's shape (1 x 2nm points) the sums equal as
    points, then device times in turns (base, this, this, base); then one
    warm proof of each path in ``proofs`` (``{path: (make, run)}``:
    ``run(make())`` proves once) profiled in the same turns, the base
    running the former route (:func:`base_reduce_sum`: the one-block kernel for
    the A sum, the halving tree for every other sum)."""
    import torch

    from mpc_bulletproof_tpu_torch.ops import curve_t, kernels
    from mpc_bulletproof_tpu_torch.ops import msm as msm_mod
    from mpc_bulletproof_tpu_torch.ops.curve import StarkPoint
    from mpc_bulletproof_tpu_torch.ops.limb import NW

    old = build_ab(src_dir)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    G = StarkPoint.generator()
    host_pool = [G]
    for _ in range(63):
        host_pool.append(host_pool[-1] + host_pool[-1] + G)
    pool = torch.as_tensor(curve_t.points_from_host(host_pool), device=dev)
    order = ("base", "this", "this", "base")

    n = 2 * N_BITS * M_PARTIES
    x = random_points(pool, n, gen)
    calls = [0]
    base = base_reduce_sum(old, calls)
    if not affine_equal(base(x), kernels.point_reduce(x)):
        raise RuntimeError("the baseline's point_reduce and this tree's disagree")
    t = {"base": [], "this": []}
    rec = {"base": {}, "this": {}}
    for who in order:
        t[who].append(device_ms(lambda: base(x) if who == "base" else kernels.point_reduce(x), 20, True,
                                rec[who]))
    row = {"phase": "ab", "name": "point_reduce", "shape": {"S": 1, "n": n}, "device_ms": t,
           "launches_recorded": {k: v[""] / 20 for k, v in rec.items()}, "gpu": gpu}
    emit(row)

    profiles = {}
    for path, (make, run) in proofs.items():
        got = {"base": [], "this": []}
        for who in order:
            state = make()
            if who == "this":
                prof = profile_run(lambda: run(state), 1.0, gpu, path)
            else:
                calls[0] = 0
                saved, msm_mod._reduce_sum = msm_mod._reduce_sum, base
                try:
                    prof = profile_run(lambda: run(state), 1.0, gpu, path,
                                       extra={"point_reduce_kernel": ("point_reduce.cu (base)", calls)})
                finally:
                    msm_mod._reduce_sum = saved
            got[who].append({k: prof[k] for k in ("device_busy_us", "device_launches", "by_source",
                                                   "counts_match")})
        profiles[path] = got
        emit({"phase": "ab_profile", "of": path, **got, "gpu": gpu})
    return {"point_reduce": row, "profiles": profiles}


# kernel -> its entry function in the ptxas report, for the redesigned kernels
PTXAS_ENTRY = {"point_scan_steps_inner": "point_scan_kernel", "point_scan_steps": "point_scan_kernel",
               "point_horner_multi": "point_horner_kernel"}


def kernel_summary(checks: dict, paths: dict, ptxas: dict) -> list:
    """The ``kernels`` line: one row per kernel, its launches per path; for
    the kernels of :data:`PTXAS_ENTRY` their registers and spills, launch
    configurations and resident warps a scheduler at each path's shape."""
    from mpc_bulletproof_tpu_torch.ops import kernels

    summary = []
    for name, (source, _, _) in kernels.KERNELS.items():
        r = checks[name]
        per_path = {p: counts[name] for p, counts in paths.items()}
        row = {
            "name": name, "route": "cuda", "source": f"mpc_bulletproof_tpu_torch/csrc/{source}",
            "replaces": REPLACES[name], "launches": sum(per_path.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "equal": r["equal"], "launches_per_path": per_path,
            "on_paths": sorted(p for p, ks in PATH_KERNELS.items() if name in ks),
        }
        for extra in ("ops", "at_paths", "op", "fill_share", "launch", "design", "serial", "sweep",
                      "gcd_vs_ladder", "plan", "launches_per_call", "dependency_bound_ms", "plans_check",
                      "public_b", "vs_composed", "clock_mhz_under_load", "pipe", "pipe_bound_ms",
                      "bytes_bound_ms", "bound_share", "dependency_share", "cycles_per_step",
                      "sass_over_need", "checks", "bound_kind", "plain_shape"):
            if extra in r:
                row[extra] = r[extra]
        if name == "point_reduce":   # the fold and every tree depth
            row["ptxas"] = ptxas[name]
        if name in PTXAS_ENTRY:
            entry = next(v for k, v in ptxas[name].items() if PTXAS_ENTRY[name] in k)
            row["ptxas"] = entry
            row["warps_per_scheduler"] = {p: warps_per_scheduler(entry["registers"], a["launch"])
                                          for p, a in r["at_paths"].items()}
        summary.append(row)
    return summary


def main() -> int:
    global SEED, SM_CLOCK_MHZ
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of the transcript check's states and bytes (default %(default)s)")
    ap.add_argument("--ab", metavar="DIR",
                    help="also time the one-block point_reduce, built from the csrc directory DIR, against this "
                         "tree's, alone and on its route in one prove and one r1cs_prove proof (the ab lines)")
    args = ap.parse_args()
    SEED = args.seed
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mpc_bulletproof_tpu_torch.ops import kernels

    gpu = smi_line()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc",
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "gpu": gpu})

    t0 = time.perf_counter()
    proc, epilogue_lib = start_epilogue_build()
    try:
        report = kernels.build()
    finally:
        log = proc.communicate()[0]
    epilogue_build = (proc.returncode, log, epilogue_lib)
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for name, (_, log) in report.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {name: os.path.relpath(path) for name, (path, _) in report.items()},
          "ptxas": ptxas})
    entries = {name: ptxas_entries(log) for name, (_, log) in report.items()}

    dev = torch.device("cuda")
    SM_CLOCK_MHZ = measure_clock(dev)
    emit({"phase": "clock", "sm_clock_mhz_under_load": SM_CLOCK_MHZ, "gpu": gpu})
    checks = check_kernels(gpu, dev)
    gn = gens_phase(gpu, dev)
    checks.update(gn["checks"])
    checks.update(transcript_phase(gpu, dev, epilogue_build))
    mp = main_path(gpu, dev)
    prove_launch_drop()
    vf = verify_phase(gpu, dev, mp)
    rs = rp_sweep_phase(gpu, dev, mp)
    pd = party_dealer_phase(gpu, dev, mp)
    ms = msm_phase(gpu, dev)
    mh = mesh_phase(gpu, dev, mp, vf, ms)
    rc = r1cs_phase(gpu, dev)
    r1s = r1cs_sweep_phase(gpu, dev, gn["gens"][(1024, 1)])
    ip = ipp_phase(gpu, dev)
    mc = mpc_phase(gpu, dev)
    tcp = mpc_tcp_phase(gpu, dev, mc)
    pr = probes_phase(gpu, dev)
    checks.update(pr["checks"])
    if args.ab:
        ab_phase(gpu, dev, args.ab, {"prove": mp["proof_run"], "r1cs_prove": rc["proof_run"]})

    paths = {"prove": mp["launches"], "verify": vf["launches"], "msm": ms["launches"], "mesh": mh["launches"],
             **rc["launches"], "ipp": ip["launches"], "mpc": mc["launches"], "pd": pd["launches"],
             "tcp": tcp["launches"], "probes": pr["launches"], "gens": gn["launches"],
             "rp_sweep": rs["launches"], "r1cs_sweep": r1s["launches"]}
    summary = kernel_summary(checks, paths, entries)
    emit({"kernels": summary})
    emit({"phase": "profiles", "this": PROFILES, "parent": PARENT_PROFILES,
          "prove_launch_drop": prove_launch_drop(),
          "prove_launches": {"this": PROFILES["prove"]["device_launches"], "parent": PARENT_PROVE_LAUNCHES},
          "gpu": gpu})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
