"""Chip check of the PyTorch port (snarkos_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:
  1. environment: the card's name and power limit (nvidia-smi), torch, CUDA
     and nvcc versions; build every kernel from snarkos_tpu_torch/csrc, one
     nvcc per source, all at once (each kernel's registers and spills from
     ptxas, its local loads and stores counted in its SASS); the dev SRS of degree 2^20 built on the
     card (its first 2^20 points are the bases of phase 5).
  2. every kernel (B1 mont_mul and its Fr passes fr_poseidon_permute,
     fr_epoch_program and fr_epoch_program_global; B2 g1_add and its window-tail entry points
     g1_horner_chain and g1_bucket_fixup; B3 seg_prefix, B4 bucket_scan_serial, B5 bucket_scan,
     B6 bucket_scan_fast, B7 jadd_bucket_total; the generic engine's window
     g1_lane_buckets and g1_lane_bucket_carry) against its plain PyTorch
     version on the card, at the paths' shapes and on real windows of their
     MSMs, with edge lanes; the comparison is exact (tolerance 0: the
     arithmetic is integer). B4-B7 add in another order than their plain
     versions, so they are held to them projectively (g1.same_points;
     max_abs_err is then over the affine normal forms), at each setting of
     their sweeps: B4 and B5 at every position, B6 at every position of a
     live bucket in an unflagged chain (elsewhere its values are don't-care)
     and its exception flags exactly, B7 at the total and at every suffix,
     g1_lane_buckets at every bucket and its lane aggregates (their flags,
     first heads and carry keys exactly) on real windows of the generic
     engine at m = 1, 16 and 256 positions a lane, each plan of its sweep,
     with P == Q, P == -Q, identities, a run over lanes 60-63, a lane whose
     last position starts a run and lanes with no tail planted;
     g1_lane_bucket_carry limb for limb; both around B3 equal to the JAX
     order (the lane fold and the tails' gather) at every bucket. At m =
     4096 (msm_dist(2^24)'s window) the sweep is timed and the tails of
     sampled lanes are held to the host's serial sums. g1_horner_chain (one launch a MSM) at the
     paths' (W, 24, 8), (W, 24, 16) c = 6 and (19, 24, 1) c = 14, with lane
     0's acc an identity with arbitrary X, Y through the top windows and the
     last add meeting P == Q and P == -Q, and its width-1 latency sweep over
     c (ms = a + b c, beside the chain figure); g1_bucket_fixup on real
     windows of b8, b16 and the 2^20 MSM (keys, heads, scan and B3 prefix as
     the engine makes them), each also with P == Q, P == -Q and identity
     carries planted. B1's sponge (fr_poseidon_permute) as hash_fixed runs
     it at b8, b16 and 2^22 (there lanes [0, 2^16) and the last 2^16
     compared), one permutation of a given state at (3, 16, 32768), (3, 16,
     65536), (3, 16, 2^22) (lanes [0, 2^16) and the last 2^16 compared) and
     (5, 16, 4096), edge states 0, 1, p - 1 in lanes 0-2, and the rate-4
     sponge over 5 inputs squeezing 3; the widths of rates 1, 3 and 8: one
     permutation at (t, 16, 2^16) and the sponge over rate + 1 inputs
     squeezing rate + 1; the wide rates 9, 12 and 16 (the runtime-width
     kernel): one permutation and the sponge over rate + 1 inputs squeezing
     rate + 1, each at 2^16 lanes, compared with the plain version on the
     first and the last 2048 lanes and with the host permute / hash_many
     on three lanes; sponge_kernel refuses rate 0. B1's epoch program
     against 12 epoch_step_plain, both variants launched directly on the
     program's side tables at every (B, K) a path launches (b8 and b16 x
     4096, b2 and b4 x 4096, b1 x 4096, b8 x 1, 2, 4, 8, 24) and at b1 x
     58,112 (the cluster entry's largest K), the global variant
     (fr_epoch_program_global, on the program's side tables) also at (16,
     8, 2^16) and (16, 2, 2^20) (its plain version once); with edge leaves
     0, 1, p - 1 and every selector at every step (at K < 4 every selector
     at some step); then the two variants' device times side by side,
     beside what epoch_plan(B, K) picks (not gated).
     Times: median of 7 runs of 20 back-to-back launches for a kernel (7 runs
     of 3 for the sponge, the global epoch program, the Horner chain, B5, B6,
     g1_lane_buckets and g1_lane_bucket_carry), CUDA events
     around each run, which at small widths time the host's launch rate;
     beside it the device time a launch, the same run captured in one CUDA
     graph and replayed (median of 7 replays); of one call for its plain
     version: the call whose output is compared for the kernels timed in
     runs of 3, the next one for the others (the permutation and the sponge
     at 2^22 compared on 2 x 2^16 lanes).
  3. Puzzle(log_degree=12).prove_batch over 8 nonces on the card, checked
     byte for byte against tests/fixtures/torch_puzzle_k12_b8.json, against
     C = p(tau) G and W = q(tau) G computed on the host from the coefficients
     and the known dev tau, and against prove_batch of one nonce. Then
     solutions/s at batch 8 (median of 3 timed calls). A call must launch
     fr_poseidon_permute once, the epoch program's variant by
     epoch_plan(B, 4096) once, mont_mul at most 80 times, g1_horner_chain
     twice (once a multi-MSM) and g1_bucket_fixup 86 times (once a window;
     here and at batch 16).
  4. prove_batch over 16 nonces (the wide-chain engine, B5): nonces 0-7 equal
     to prove_batch(8), all 16 checked on the host as above plus solution_id
     = sha64(C || y); solutions/s at batch 16 (median of 3 after a warm-up).
  4b. the prover at log degree 0-3 and 16 over 8 nonces and at 20 over 2
     (Puzzle with phase 1's dev SRS): each prove_batch byte for byte equal
     to tests/fixtures/torch_puzzle_k{LOG}_b{N}.json, launching every
     kernel exactly as often as the path's structure gives (the epoch
     program's variant by epoch_plan, B4 or B5 by width, the window tail
     and three B3 prefixes a window, prove_mont_muls single multiplies);
     verify_batch accepts its solutions and rejects one eval_y + 1;
     solutions/s (median of 3 after a warm-up) and the peak device memory
     recorded, not gated. Then kzg.commit and kzg.open_at over the first
     2^20 dev SRS powers (msm.msm: the fast engine, B7) on the log-20
     prover's nonce 0: C and W equal to prove_batch's, y to the host
     poly_eval, launches exact; both timed (median of 3).
  5. one MSM of 2^20 points through msm.msm_affine (the fast engine B6, the
     bucket total B7): the result equals (sum k_i tau^i) G computed on the
     host; then with base 1 := base 0 and k_1 := k_0, where B6's flag fires
     and the complete engine (B5) reruns; points/s (median of 3 timed calls).
     A call launches B7, B3 and g1_bucket_fixup once a window, g1_horner_chain
     once and B2's g1_add never (twice each on the rerun).
  6. the generic engine: msm.msm over the first 2^16 dev SRS powers, each
     rescaled to a random z, every 64th the identity, every 97th scalar 0:
     the result equals (sum k_i tau^i) G over the non-identity lanes, and a
     call launches g1_lane_buckets, B3, g1_lane_bucket_carry and B7 W times
     each (W = 20 windows; m = 16 steps a lane), g1_horner_chain once and nothing
     else, no g1_add;
     points/s (median of 3).
  7. the verifier: check_binding's B1 launches; Puzzle.verify_batch over the
     first 4 solutions of phase 3 and verify of each accept, eval_y + 1 and
     swapped witnesses reject, check_structural refuses x >= q;
     kzg.batch_verify over their openings runs on the fused engine (B4, no
     g1_add), with a constant polynomial's opening (W the identity) on the
     generic one (the lane scan, no g1_add, no B4), both accept, and reject
     once that opening's y changes. Times: verify_batch(4), its
     check_bindings, batch_verify (without and with the identity witness)
     and the host pairing_check apart (medians of 3).
  8. the SRS artifact: the degree-2^12 dev SRS saved with save_srs and
     loaded by PuzzleSRS.from_artifact (the consistency check's MSMs on B4)
     gives the same device points and tau H; a copy with one power changed
     fails the consistency check.
  9. the NTT over Fr and the pipeline: B1's NTT entry fr_ntt_pass against
     its plain version, limb for limb, at every pass of the plans for 2^12,
     2^16, 2^20, 2^22, (16, 8, 2^16) and ntt_dist's batches at 2^22 ((16,
     2048, 2^11) at world 1, (16, 1024, 2^11) at world 2), forward and
     inverse (n^-1 in the first pass), with every pair of 0, 1, p - 1, p - 2 as the (u, v) of a
     butterfly at the first, middle and last stage of each pass (planted at
     that stage's input and undone in plain PyTorch back to the pass's
     input); the first pass at 2^22 timed beside index_select of the same
     permutation. ntt at 2^22: intt(ntt(a)) == a, ntt(a) == ntt_plain(a),
     ntt(a)[k] == poly_eval(a, omega^k) on the host at k = 0 and 4 random
     k; ntt and intt at 2^12 and 2^16 equal to the host crypto/ref/ntt.py;
     each row of ntt_batched over (16, 8, 2^16) equal to ntt of the row. A
     transform of 2^k launches fr_ntt_pass len(ntt._pass_plan(k)) times
     and nothing else. ntt elems/s at 2^12-2^22 and intt at 2^22 (median
     of 3 host-clock calls, and the device time of a CUDA graph replay);
     the device time of each pass at 2^22; the sweep of plans, tiles and
     block sizes at 2^22 and 2^20. The pipeline of entry.entry()
     (Poseidon, ntt, square) at 2^10 equal limb for limb to the host
     composition, then at 2^22 (one sponge launch, len(plan) passes, one
     mont_mul) against the host Poseidon at 8 lanes and the plain ntt and
     square; its wall time (median of 3); its hash_fixed alone is one
     fr_poseidon_permute launch and dispatches no torch op but its
     output's allocation.
 10. the multi-device layer (snarkos_tpu_torch/parallel/). World 1 over
     NCCL, in this process: ntt_dist and intt_dist at 2^22 (N1 = N2 =
     2^11) equal to ntt.ntt limb for limb and the round trip to the input
     (one B1 mont_mul and 2 x 2 fr_ntt_pass a call); msm_dist over phase 5's
     2^20 bases and scalars equal to (sum k_i tau^i) G and to msm.msm of
     the same bases (the fused engine); msm_dist at 2^24 over those powers
     tiled 16 times, scalars drawn on the card below 2^252, equal to
     (sum k_i tau^(i mod 2^20)) G (the 16 blocks' scalars folded by Fr adds
     on the card first), one call with its peak device memory. The generic
     engine's launches are exact (W each of g1_lane_buckets, B3,
     g1_lane_bucket_carry and B7, one g1_horner_chain, no g1_add; at world 2 one
     g1_add, the tree reduce). Host-clock times: ntt_dist beside ntt (medians of 3) with
     its steps apart, msm_dist(2^20) beside msm.msm (medians of 3),
     msm_dist(2^24) once. World 2 over gloo, two spawned ranks sharing the
     one card: all_gather_last of ntt_dist(2^22) equal to the world-1 output,
     msm_dist(2^20) equal to the oracle on both ranks, each rank's launches
     (sent back from its process) and times, which are two processes
     time-slicing one card, not a scaling figure. Then
     entry.dryrun_multichip(8) on the card, its eight ranks sharing it over
     gloo, each of its checks against the host.
 11. (retired: the node seam, which a node of the JAX package used to reach
     the card; the port's own node below reaches it.)
 12. the node's ledger on the card (snarkos_tpu_torch/node/ledger.py,
     ``ledger_phase``) against tests/fixtures/torch_ledger_dev4.json, the
     chain the JAX ledger made (dev committee of 4, puzzle log degree 12):
     the puzzle SRS and the execution SRSs of degree 512, 16,384 and
     32,768 built on the card, their powers' sha256 equal to the fixture's;
     make_genesis (the credits.aleo deploy, every commitment a device MSM)
     byte for byte the fixture's genesis, and the genesis state root; each
     tampered block 1 (a solution's eval_y + 1, forged exec_outs, a garbage
     execution proof) raising the JAX ledger's ValueError; check_next_block
     on blocks 1 (4 solutions, a transfer_public, a same-block deploy and
     execute) and 2 (a transfer_public_to_private): accepted, the batch's
     openings and the state roots equal to the fixture's, every kernel
     launched exactly as predicted (B1's sponge and epoch program once a
     solution, one g1_horner_chain a MSM, one g1_bucket_fixup a window,
     nothing of the generic engine) but mont_mul, B4 and B3, which must
     launch; create_transaction of block 1's transfer_public from its
     signed payload and key equal to the fixture's transaction byte for
     byte and accepted by verify_transaction; no jax in sys.modules. Host
     seconds: each SRS build, make_genesis, each block check split into
     solution openings, transaction openings, the batch's MSMs and its
     host pairing, create_transaction.
 13. the validator's consensus core (snarkos_tpu_torch/node/consensus.py,
     bft/, events.py; ``consensus_phase``): four validators of the dev
     committee of 4 (the fixture's committee bytes; the accounts derived as
     the node's CLI derives them, tests/torch_bft_support.py) in this process
     over the in-process transport, each with its own Ledger on the card
     under a CoreLedgerService (the full block check), its genesis the
     fixture's, the JAX package's timers. After a warm-up (the puzzle SRS and
     the genesis epoch's program, global_varuna, execution_srs(16384), each
     execution verified once) every validator is fed, through
     add_unconfirmed_solution / add_unconfirmed_transaction, the fixture's 4
     solutions of block 1, its transfer_public, block 2's
     transfer_public_to_private and one solution with eval_y + 1; intake
     (each check on the card) ends before the primaries start, since the
     solutions bind only in block 1. Then the network runs until all four
     have committed the six transmissions (deadline CONSENSUS_DEADLINE_S
     from the first feed), and stops: every task cancelled, the executor
     drained. Checks: the tampered solution refused at intake by all four
     and never committed; the chains equal block for block by hash, each
     block's round even and anchored by its leader; each chain accepted by
     a fresh Ledger on the card; the credits.aleo account entries of dev
     accounts 0-3 and the record ciphertexts equal those of
     convert.ledger's replay of the fixture's blocks 1-2; the launches of
     the path "consensus" exact: phase 7's check_binding launches a binding
     and check_launches' count a KZG batch, over the bindings and batches
     the run made. Logged: seconds of intake and from the first feed to the
     last commit, the blocks and rounds, each validator's host seconds at
     intake, at the proposal re-checks and in block checks.
 14. the node's block sync over localhost (snarkos_tpu_torch/node/
     block_sync.py, router.py, tcp.py, roles.py; ``sync_phase``): a server,
     the port's Router on 127.0.0.1 port 0 over a Ledger on the card that
     holds LEDGER_FIXTURE's blocks 1-2, serves BlockRequests and announces
     its block locators with a Ping; a client, the port's Client role on the
     card (its router, its block sync over a fresh Ledger, its sync loop
     every SYNC_STEP_S), completes the signed handshake and syncs to height
     2, each block through the full block check on the card in the loop's
     executor; a device fault would stop the role, and the phase raises it. Checks: the client's
     blocks 1-2 byte for byte the fixture's, its state root the fixture's;
     the launches exact (check_launches over the bindings and KZG batches
     the sync made: block 1's 4 bindings, batches of 14 and 4 openings) and
     equal to phase 12's block 1 and block 2 columns added. Then block 1
     with one byte changed (the low byte of its first solution's nonce):
     from a server that announces the fixture's chain it is refused against
     the announced hash, no kernel launched, the server's requests revoked,
     the height 0; from one that announces the tampered chain it reaches the
     block check, where the solution's binding on the card fails and the
     ledger refuses the block with the JAX ledger's error (one binding's
     launches, exact), the height 0 and the pool empty. Logged: the sync's
     host seconds, the handshake, and the checks split as in phase 12.
 15. the devnet through the CLI (``devnet_phase``): four validators of the
     dev committee, each a process started as a user starts one (``python
     -m snarkos_tpu_torch.node.cli start --validator --dev i
     --dev-num-validators 4 --storage <tmp>/dev-i/ledger.dat``: its genesis,
     every solution check and block check on the card, REST on 3030 + i),
     after phase 1 built every kernel; a Prover in this process, built as
     ``cli start --prover --dev 4`` builds it (nonce batch 8 at log degree
     12, the puzzle on the card), started once block 1 is committed (a
     solution for the genesis epoch goes stale then), dials the validators'
     node ports and proves, as that command runs it, until a block holds
     one of its solutions: through validator 0's REST within
     DEVNET_DEADLINE_S of its start, the same hash at that height on all
     four. The Prover's launches exact: its batches times the
     prove_batch(8) column. Then SIGTERM: each validator exits with status
     0, no fault or traceback in its log (chiprun_out/devnet/), no process
     left, and the launch counts it printed as it stopped are at least what
     the committed chain asks of it (each solution's binding, phase 7's
     check_binding column; two Horner chains a block with transmissions,
     phase 12's block 2 column). Logged, in host seconds: each validator's
     start-up, the time to the first passing solution and to the block that
     holds it, the Prover's batches and solutions/s.
 16. one JSON line with every kernel's numbers, then the result line.
Each phase's start is logged (seconds since the start, phase_s in the
report). Every path runs with the launch counters set to 0 just before it and read
just after; each must launch the kernels it is built from, and every kernel
must launch on some path, but those of NO_PATH_YET (none now), which must
not.

The script imports nothing of JAX or of the JAX package (snarkos_tpu).
Details go to chiprun_out/chip_smoke.json. Whether it passes or fails, it
stops every process it started before it exits: it adopts its descendants'
orphans, stops multiprocessing's resource tracker (which the spawned ranks
of phase 10 start and which would outlive the script), and terminates and
waits for any other child, naming each on stderr.
"""

import dataclasses
import json
import os
import random
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

BATCH = 8
BATCH_WIDE = 16
LOG_N = 20
TEAM_SWEEP = (16, 32, 64, 128)  # B4's threads per chain
WIDE_TEAM_SWEEP = (4, 8, 16, 32)  # B5's and B6's threads per chain
# B7's (threads a block, buckets a thread) at the 2^20 MSM's B = 2^13 + 1,
# and the few also run at the c = 16 MSM's B = 2^15 + 1
TOTAL_SWEEP = tuple((t, s) for t in (32, 64, 128, 256) for s in (1, 2, 4))
TOTAL_SWEEP_WIDE = ((64, 1), (128, 1), (256, 1), (256, 2))
# g1_lane_buckets' plans (M members a lane, MB members a block) at the
# generic engine's m = 1 (the verifier's padded MSMs), 16 (2^16), 256 (2^20)
# and 4096 (2^24) positions a lane
LANE_SWEEP = {1: ((1, 64), (1, 32)),
              16: ((2, 64), (1, 64), (4, 64), (2, 128)),
              256: ((8, 64), (4, 64), (16, 64), (8, 128)),
              4096: ((8, 64), (4, 64), (16, 64), (8, 128), (32, 128))}
# kernels that no path launches yet, with their next caller: held against
# their plain versions, exempt from the "launched on no path" check, and a
# failure if a path does launch them
NO_PATH_YET = {}
# the generic engine's MSM (phase 6): 2^16 Jacobian bases, c = 13, K = 4096
# lanes of m = 16 steps, W = 20 windows; the kernels it launches once a
# window
GENERIC_KERNELS = ["g1_lane_buckets", "seg_prefix", "g1_lane_bucket_carry", "jadd_bucket_total",
                   "g1_horner_chain"]
# the window tail's latency sweep (phase 2): the chain at width 1 over W =
# 8 windows for these c; the latency of one Fq product on a thread's chain
# in the one-step Horner entry the chain replaced (a doubling, 7 products,
# 0.02831 ms: scripts/time_window_tail.py, H100 80GB HBM3 at 700 W), for
# the chain figure
TAIL_SWEEP_C = (0, 1, 2, 4, 8, 14)
TAIL_SWEEP_W = 8
STEP0_PRODUCT_MS = 0.02831 / 7
LOG_GENERIC = 16
GENERIC_C = 13
GENERIC_K = 4096
# the verifier (phase 7): a block's solutions, MAX_SOLUTIONS_PER_BLOCK
VERIFY_BATCH = 4
# the NTT (phase 9): BASELINE config #2's single-card sizes, the batched
# transform's (rows, log2 n), and the pipeline's log2 n
NTT_LOGS = (12, 16, 20, 22)
NTT_BATCH = (8, 16)
# ntt_dist's column and row batches at 2^22 (phase 10): N2/D rows of N1 and
# N1/D rows of N2 (N1 = N2 = 2^11), at world 1 and world 2
NTT_DIST_BATCHES = ((2048, 11), (1024, 11))
PIPE_LOG = 22
# the NTT's sweep at 2^22 and 2^20: stages a pass at most (the plan), log2 of
# a tile's elements, threads a block
NTT_SWEEP_K_MAX = (6, 8)
NTT_SWEEP_LOG_ELEMS = (9, 10, 11)
NTT_SWEEP_THREADS = (128, 256, 512)
# B1's single multiplies a prove_batch call at 2^12, at most (KZG eval,
# conversions); beside them one sponge and one epoch program (b1_counts)
MONT_MUL_MAX = 80
# the prover at the other log degrees the node takes (phase 4b): (log
# degree, nonces), each with its fixture tests/fixtures/torch_puzzle_k{LOG}_b{N}.json
DEGREES = ((0, 8), (1, 8), (2, 8), (3, 8), (16, 8), (20, 2))
# the epoch program's small K (log degree 0-3) and an uneven one (phase 2),
# and the Poseidon widths held beside the prover's rates 2 and 4: the
# register template's (rates 1, 3, 8) and the runtime-width kernel's
EPOCH_SMALL_K = (1, 2, 4, 8, 24)
# the largest K of the cluster variant: 16 blocks of 3632 lanes, 227 KiB each
EPOCH_CLUSTER_MAX_K = 58112
POSEIDON_MORE_RATES = (1, 3, 8)
POSEIDON_WIDE_RATES = (9, 12, 16)
# the lanes of a wide rate's 2^16 compared with the plain version: the
# first and the last WIDE_PART
WIDE_PART = 2048
# what hash_fixed dispatches on the card: the output's allocation, nothing
# on the sponge's state (phase 9)
SPONGE_OPS = ["aten.empty.memory_format"]

# Published H100 SXM peaks (NVIDIA's H100 datasheet): 3.35 TB/s of HBM and
# 67 TFLOP/s of float32 outside the tensor cores, i.e. 33.5 T fused
# multiply-adds/s. Hopper issues 32-bit integer multiply-adds at half the
# float32 FMA rate (64 against 128 per SM and clock), so 16.75 T/s; a 32x32
# -> 64-bit word product costs two of them (low and high halves).
HBM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_S = 67e12 / 2 / 2
FQ_MUL_OPS = 2 * (2 * 12 * 12 + 12)  # CIOS word products x 2 per Fq multiply
FR_MUL_OPS = 2 * (2 * 8 * 8 + 8)
# the 32-bit multiplies of fr_passes.cu's pieces: a 512-bit product (64 word
# products), a 512-bit square (36), a reduction of 512 bits (64 word products
# and 8 word multipliers m)
FR_WIDE_MUL, FR_WIDE_SQR, FR_REDC = 2 * 64, 2 * 36, 2 * 64 + 8


def poseidon_ops(t: int) -> int:
    """The 32-bit multiplies of one permutation of width t as fr_passes.cu
    runs it: 8 full rounds of t s-boxes (4 squarings and a multiply) and t
    MDS rows (t wide products, one reduction a chunk of at most 13); 31
    partial rounds of one s-box, one row of t and t - 1 multiplies (the
    sparse matrix). The dense form before it ran 8 (t^2 + 5 t) + 31 (t^2 +
    5) multiplies of FR_MUL_OPS (626 at t = 3)."""
    sbox = 4 * (FR_WIDE_SQR + FR_REDC) + FR_MUL_OPS
    row = t * FR_WIDE_MUL + -(-t // 13) * FR_REDC
    return 8 * t * (sbox + row) + 31 * (sbox + row + (t - 1) * FR_MUL_OPS)


def geometric_muls(m: int) -> int:
    """mont_mul launches of ntt.geometric_powers(., m): bbits squarings and
    bbits masked multiplies for the first block of 2^bbits powers, one
    multiply a later block."""
    if m == 1:
        return 0
    bbits = min(12, (m - 1).bit_length())
    return 2 * bbits + -(-m // (1 << bbits)) - 1


def prove_mont_muls(k: int) -> int:
    """mont_mul launches of a prove_batch at K = k: to_mont of the counters,
    from_mont of the coefficients and of the quotients, and the eval and
    quotient's three multiplies and two power tables (54 at K = 4096)."""
    return 6 + 2 * geometric_muls(k)


def sponge_permutations(rate: int, n_in: int, num_outputs: int) -> int:
    """Permutations of the sponge: one between absorbed rate blocks, one
    before each squeezed block."""
    return max(0, -(-n_in // rate) - 1) + -(-num_outputs // rate)


def log(*a):
    print(*a, flush=True)


def _adopt_orphans() -> None:
    """Make this process the reaper of its descendants' orphans (Linux
    prctl PR_SET_CHILD_SUBREAPER), so that _stop_children finds every
    process the run started, grandchildren included."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def _children() -> dict:
    """This process's children, {pid: (state, command line)}, from /proc:
    a process's parent pid is the second field after the name in its stat
    line."""
    me, kids = os.getpid(), {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as fh:
                stat = fh.read()
            with open(f"/proc/{d}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        state, ppid = stat[stat.rfind(")") + 2:].split()[:2]
        if int(ppid) == me:
            kids[int(d)] = (state, cmd)
    return kids


def _stop_children(grace_s: float = 5.0) -> list:
    """Stop every child this process still has and wait for it: first
    multiprocessing's resource tracker, which ignores SIGTERM and ends when
    its pipe closes, then any other child by SIGTERM and, after ``grace_s``
    seconds, SIGKILL. Children that appear meanwhile (orphans adopted by
    _adopt_orphans) are stopped the same way. Returns the command lines of
    the children that were still running, each also named on stderr."""
    tracker = sys.modules.get("multiprocessing.resource_tracker")
    if tracker is not None:
        try:
            tracker._resource_tracker._stop()
        except (AttributeError, OSError, ChildProcessError):
            pass
    stopped = []
    for _ in range(10):
        kids = _children()
        if not kids:
            break
        for pid, (state, cmd) in kids.items():
            if state != "Z":
                stopped.append(cmd)
                print(f"chip_smoke: stopping child {pid}: {cmd[:200]}", file=sys.stderr,
                      flush=True)
                try:
                    os.kill(pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + grace_s
        for pid in kids:
            while True:
                try:
                    done, _ = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    break
                if done:
                    break
                if time.monotonic() > deadline:
                    try:
                        os.kill(pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                    try:
                        os.waitpid(pid, 0)
                    except ChildProcessError:
                        pass
                    break
                time.sleep(0.02)
    return stopped


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template argument from its mangled name: the
    first length-prefixed identifier that names a kernel (else the last
    one), then the first integral template argument."""
    names, i = [], 0
    while i < len(mangled):
        num = re.match(r"\d+", mangled[i:])
        if num:
            j = i + len(num.group())
            ident = mangled[j:j + int(num.group())]
            if len(ident) == int(num.group()) and re.fullmatch(r"[A-Za-z_]\w*", ident):
                names.append(ident)
                i = j + len(ident)
                continue
        i += 1
    name = next((nm for nm in names if "kernel" in nm), names[-1] if names else mangled)
    arg = re.search(r"IL[ib](\d+)E", mangled)
    return name + (f"<{arg.group(1)}>" if arg else "")


def sass_local(build) -> dict:
    """Each built kernel's local loads and stores (LDL, STL) in its SASS
    (cuobjdump -sass), out-of-line callees included: {source: {kernel
    (its name and template argument): (LDL, STL)}}."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    with ThreadPoolExecutor(len(build.SOURCES)) as pool:  # one cuobjdump a library, at once
        texts = pool.map(lambda name: subprocess.run(
            [cuobjdump, "-sass", build.lib_path(name)], capture_output=True, text=True,
            check=True).stdout, build.SOURCES)
    out = {}
    for name, text in zip(build.SOURCES, texts):
        kerns, fn = {}, None
        for ln in text.splitlines():
            head = re.search(r"Function : (\S+)", ln)
            if head:
                fn = _kernel_name(head.group(1))
                kerns[fn] = [0, 0]
            elif fn and re.search(r"\b(LDL|STL)\b", ln):
                kerns[fn][0 if "LDL" in ln else 1] += 1
        out[name] = {k: tuple(v) for k, v in kerns.items()}
    return out


def aten_ops(fn) -> list:
    """The ATen operators that ``fn()`` dispatches, in order (a
    TorchDispatchMode that records each and runs it)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return seen


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_MULS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps, inner=1):
    """Median over ``reps`` runs of the device time of ``inner`` back-to-back
    calls, divided by ``inner`` (CUDA events around the whole run). At small
    widths this is the rate at which the host launches them."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, reps, inner):
    """The card's own time a call: ``inner`` calls captured in one CUDA
    graph, then the median over ``reps`` replays (CUDA events around each)
    divided by ``inner``. A replay launches them back to back, so the card
    never waits for the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    del graph
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    import torch

    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    return err


# the multi-device phase (10): the NTT's and the large MSM's sizes at world
# 1 (BASELINE configs #2 and #3), and the world-2 run's
DIST_NTT_LOG = 22
DIST_MSM_LOG = 24
DIST_WORLD2 = 2
# the ranks of the dry run (entry.dryrun_multichip), as the JAX reference's
# is called
DRYRUN_WORLD = 8


def _dist_rank(mesh, tmp, counters, reps):
    """One rank of the world-2 run (gloo, both ranks on the one card): its
    shard of ntt_dist at 2^22, held against the world-1 output after
    all_gather_last, then its shard of msm_dist at 2^20; the inputs come from
    files in ``tmp``. Returns, for each path, its launches (the counters at
    0 just before its first call) and host-clock seconds a call (ntt_dist:
    1 + ``reps`` calls), whether the NTT matched, and the MSM's point."""
    import importlib

    import torch
    import torch.distributed as dist

    from snarkos_tpu_torch.ops import g1
    from snarkos_tpu_torch.parallel import mesh as pmesh, msm_dist, ntt_dist

    # a spawned rank has launch counters of its own: found by their
    # (module, function) names
    fns = {k: getattr(importlib.import_module(m), f) for k, (m, f) in counters.items()}

    def run(fn):
        """fn() with the counters at 0 just before it, both ranks starting
        together: (result, seconds, launches)."""
        torch.cuda.synchronize()
        dist.barrier()
        for f in fns.values():
            f.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, {k: f.launches for k, f in fns.items()}

    x = pmesh.shard_last(mesh, torch.load(os.path.join(tmp, "ntt_in.pt")))
    ntt_dist.ntt_dist(x, mesh)  # the twiddle matrix of the size
    ev, s, launches = run(lambda: ntt_dist.ntt_dist(x, mesh))
    out = {"ntt_dist": {"s": [s] + [run(lambda: ntt_dist.ntt_dist(x, mesh))[1]
                                    for _ in range(reps)], "launches": launches}}
    want = torch.load(os.path.join(tmp, "ntt_out.pt")).to(mesh.device)
    out["ntt_equal"] = bool(torch.equal(pmesh.all_gather_last(mesh, ev), want))
    del x, ev, want
    bx, by, bz, k = torch.load(os.path.join(tmp, "msm_in.pt"))
    pts = g1.JacobianPoints(*(pmesh.shard_last(mesh, t) for t in (bx, by, bz)))
    p, s, launches = run(lambda: msm_dist.msm_dist(pts, pmesh.shard_last(mesh, k), mesh))
    out["msm_dist"] = {"s": [s], "launches": launches}
    out["msm"] = tuple(t.cpu() for t in (p.x, p.y, p.z))
    dist.barrier()
    return out


T_START = time.perf_counter()
PHASE_S = {}
LEDGER_FIXTURE = os.path.join("tests", "fixtures", "torch_ledger_dev4.json")
# the consensus phase (13): its deadline from the first feed to the last
# commit (it took 112.4 and 151.6 s on two H100 hosts: its host pairings and
# Schnorr checks share one GIL); the kernels of a solution's binding (phase
# 7's check_binding)
CONSENSUS_DEADLINE_S = 240.0
BINDING_KERNELS = ("mont_mul", "fr_poseidon_permute", "fr_epoch_program",
                   "fr_epoch_program_global")


def ledger_phase(run_path, kernels, smi) -> dict:
    """Phase 12: the node's ledger (snarkos_tpu_torch/node/ledger.py) on the
    card against the golden chain the JAX ledger made (LEDGER_FIXTURE)."""
    import hashlib

    import torch

    from snarkos_tpu_torch import convert
    from snarkos_tpu_torch.crypto import params
    from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, pairing
    from snarkos_tpu_torch.node import ledger as ledger_mod, types as node_types
    from snarkos_tpu_torch.ops import kzg, msm
    from snarkos_tpu_torch.ops import puzzle as puzzle_mod

    dev = torch.device("cuda")
    r = params.FR_MODULUS
    with open(os.path.join(HERE, LEDGER_FIXTURE)) as fh:
        lfx = json.load(fh)
    out = {"card": smi}
    comm = convert.committee(bytes.fromhex(lfx["committee"]))
    blocks = [convert.block(bytes.fromhex(b)) for b in lfx["blocks"]]

    def timed(label, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[label] = time.perf_counter() - t0
        return res

    # the puzzle at log degree 12 and the execution SRSs, built on the card
    puzzle_mod._PUZZLE = None
    timed("puzzle_srs_s", lambda: puzzle_mod.global_puzzle(lfx["log_degree"], dev))
    for need, want in sorted(lfx["srs_digest"].items(), key=lambda kv: int(kv[0])):
        srs = timed(f"execution_srs_{need}_s", lambda: ledger_mod.execution_srs(int(need), dev))
        h = hashlib.sha256()
        for x, y, z in srs.srs_ref.powers_g1:
            if z != 1:
                raise AssertionError(f"execution_srs({need}): a power is not affine")
            h.update(x.to_bytes(48, "little") + y.to_bytes(48, "little"))
        if h.hexdigest() != want or srs.points.x.device.type != "cuda":
            raise AssertionError(f"execution_srs({need}) on the card differs from the fixture")
        log(f"execution_srs({need}) built on the card in {out[f'execution_srs_{need}_s']:.2f} s "
            f"(host s), its sha256 equal to the fixture's")

    # the genesis: the credits.aleo deploy proved with the genesis key, every
    # commitment on the card; byte for byte the JAX ledger's
    commits_only = ["g1_add", "bucket_scan", "bucket_scan_fast", "jadd_bucket_total",
                    "g1_lane_buckets", "g1_lane_bucket_carry", "fr_ntt_pass", *BINDING_KERNELS[1:]]
    genesis = timed("make_genesis_s", lambda: run_path(
        "make_genesis(dev4)", lambda: ledger_mod.make_genesis(comm, dev),
        ["bucket_scan_serial", "seg_prefix", "g1_bucket_fixup", "g1_horner_chain"],
        absent=commits_only))
    if genesis.to_bytes() != bytes.fromhex(lfx["genesis"]):
        raise AssertionError("make_genesis on the card differs from the fixture's genesis")
    log(f"make_genesis on the card in {out['make_genesis_s']:.2f} s (host s): byte for byte "
        "the fixture's genesis")
    led = ledger_mod.Ledger(comm, device=dev)
    if led.latest_state_root.hex() != lfx["state_roots"][0]:
        raise AssertionError("the genesis state root differs from the fixture's")

    # tampered variants of block 1: the JAX ledger's ValueError each
    for name, case in lfx["tampered"].items():
        try:
            led.check_next_block(convert.block(bytes.fromhex(case["block"])))
        except ValueError as exc:
            if str(exc) != case["error"]:
                raise AssertionError(f"tampered {name}: {exc!r}, the JAX ledger: "
                                     f"{case['error']!r}") from None
        else:
            raise AssertionError(f"the ledger accepted the tampered block {name}")
    log(f"the {len(lfx['tampered'])} tampered blocks raise the JAX ledger's errors: "
        + "; ".join(f"{k}: {v['error']}" for k, v in lfx["tampered"].items()))

    # blocks 1 and 2, each split into its solution openings, transaction
    # openings, the batch's two MSMs and its host pairing
    split = {}

    def clocked(key, fn, sync=False):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            split[key] = split.get(key, 0.0) + time.perf_counter() - t0
            return res
        return run

    def affine(p):
        a = ref_g1.affine(p)
        return None if a is None else [str(a[0]), str(a[1])]

    saved = (kzg.batch_verify, ledger_mod.transaction_opening, msm.msm, pairing.pairing_check)
    for b, blk in enumerate(blocks):
        n_sol = sum(1 for t in blk.transmissions if t.kind == node_types.TX_SOLUTION)
        n_ops = len(lfx["openings"][b])
        seen, split = [], {}

        def spy(srs, openings, gamma=None, device=None):
            seen.append(list(openings))
            return saved[0](srs, openings, gamma, device)

        kzg.batch_verify = spy
        ledger_mod.transaction_opening = clocked("transaction_openings_s", saved[1])
        msm.msm = clocked("batch_msms_s", saved[2], sync=True)
        pairing.pairing_check = clocked("batch_pairing_s", saved[3])
        led._solution_opening_for = clocked("solution_openings_s", led._solution_opening_for,
                                            sync=True)
        try:
            t0 = time.perf_counter()
            run_path(f"check_next_block(block {b + 1})", lambda: led.check_next_block(blk),
                     ["bucket_scan_serial", "seg_prefix", "g1_bucket_fixup", "g1_horner_chain"]
                     + (["fr_poseidon_permute", "fr_epoch_program", "mont_mul"] if n_sol else []))
            split["check_next_block_s"] = time.perf_counter() - t0
        finally:
            kzg.batch_verify, ledger_mod.transaction_opening, msm.msm, pairing.pairing_check = saved
            del led._solution_opening_for
        check_launches(kernels, msm, f"check_next_block(block {b + 1})", n_sol, seen)
        got = [{"C": affine(c), "z": str(z % r), "y": str(y % r), "W": affine(w)}
               for c, z, y, w in seen[0]] if len(seen) == 1 else None
        if got != lfx["openings"][b]:
            raise AssertionError(f"block {b + 1}: the batch's openings differ from the fixture")
        led.advance_to_next_block(blk)
        if led.latest_state_root.hex() != lfx["state_roots"][b + 1]:
            raise AssertionError(f"block {b + 1}: the state root differs from the fixture's")
        out[f"block{b + 1}"] = dict(split, openings=n_ops, solutions=n_sol)
        log(f"check_next_block(block {b + 1}) accepted: {n_sol} solutions, {n_ops} openings "
            f"equal to the fixture's, the state root after it too; host s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f"; on {smi}")

    # a transfer_public created on the card: the fixture's transaction byte
    # for byte (its signed payload and key), verified by the port
    tx = next(t.deserialize() for t in blocks[0].transmissions
              if t.kind == node_types.TX_TRANSACTION)
    key = int(lfx["keys"]["transfer"], 16)
    new = timed("create_transaction_s", lambda: run_path(
        "create_transaction(transfer_public)",
        lambda: ledger_mod.create_transaction(tx.payload, fee=tx.fee, key=key, device=dev),
        ["bucket_scan_serial", "seg_prefix", "g1_bucket_fixup", "g1_horner_chain"],
        absent=commits_only))
    if new.to_bytes() != tx.to_bytes():
        raise AssertionError("create_transaction on the card differs from the fixture's")
    if not timed("verify_transaction_s", lambda: ledger_mod.verify_transaction(
            new, led.parsed_programs, dev)):
        raise AssertionError("the port's ledger rejected the transaction it created")
    log(f"create_transaction(transfer_public) on the card in {out['create_transaction_s']:.2f} s "
        f"(host s): the fixture's transaction byte for byte; verify_transaction accepts it in "
        f"{out['verify_transaction_s']:.2f} s")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if loaded:
        raise AssertionError(f"JAX was imported: {loaded[:5]}")
    log("jax is not in sys.modules")
    puzzle_mod._PUZZLE = None
    return out


def check_launches(kernels, msm, label, bindings, batches) -> None:
    """Raise unless the path ``label`` launched each kernel exactly as often
    as ``bindings`` solution bindings (each what phase 7's check_binding
    launched) and one ops/kzg.batch_verify over each list of openings in
    ``batches`` (host Jacobian tuples (C, z, y, W)) do. A batch runs its left
    MSM over [C.., W.., G] and its W MSM, each padded to a power of two >= 8,
    on the fused engine (serial chains: a B4 scan, three B3 prefixes and a
    fixup a window) when every base is affine (z == 1), else on the generic
    one (a g1_lane_buckets, a B3 prefix, a g1_lane_bucket_carry and a B7
    total a window): msm.msm's rule; one Horner chain a MSM. A transaction's
    two C are combined on the host (varuna.verify_prepare) in Jacobian form,
    z != 1, so a batch with a transaction runs its left MSM on the generic
    engine; every W comes from bytes, affine."""
    from snarkos_tpu_torch.crypto.ref import g1 as ref_g1

    want = {k["name"]: bindings * k["launches_per_path"]["check_binding"]
            if k["name"] in BINDING_KERNELS else 0 for k in kernels}
    for openings in batches:
        cs, ws = [o[0] for o in openings], [o[3] for o in openings]
        for pts in (cs + ws + [ref_g1.GENERATOR], ws):
            m = 1 << max(3, (len(pts) - 1).bit_length())
            if all(p[2] == 1 for p in pts):
                nw = -(-(msm.SCALAR_BITS + 1) // msm.fused_window_bits(m))
                steps = dict(bucket_scan_serial=nw, seg_prefix=3 * nw, g1_bucket_fixup=nw)
            else:
                nw = -(-msm.SCALAR_BITS // msm.default_window_bits(m))
                steps = dict(g1_lane_buckets=nw, seg_prefix=nw, g1_lane_bucket_carry=nw,
                             jadd_bucket_total=nw)
            for k, v in dict(steps, g1_horner_chain=1).items():
                want[k] += v
    got = {k["name"]: k["launches_per_path"][label] for k in kernels}
    if got != want:
        raise AssertionError(f"launches in {label}: {got}, want {want} ({bindings} bindings, "
                             f"KZG batches of {[len(b) for b in batches]} openings)")
    log(f"launches in {label} exact: {bindings} bindings, KZG batches of "
        f"{sorted(len(b) for b in batches)} openings")


class TimedService:
    """A ledger service as the consensus sees it, with the host seconds of
    its checks kept by stage ("intake" until the primaries start, then
    "proposal"; the block check apart) and every refusal: a validator's
    executor threads share the process (and the GIL) with the others."""

    def __init__(self, inner):
        self.inner = inner
        self.stage = "intake"
        self.seconds = {}
        self.refused = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _timed(self, key, fn, arg):
        t0 = time.perf_counter()
        try:
            return fn(arg)
        except Exception as exc:
            with self._lock:
                self.refused.append((self.stage, key, arg.id, str(exc)))
            raise
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[key] = self.seconds.get(key, 0.0) + dt

    def check_solution_basic(self, sol):
        return self._timed(f"{self.stage}_s", self.inner.check_solution_basic, sol)

    def check_transaction_basic(self, tx):
        return self._timed(f"{self.stage}_s", self.inner.check_transaction_basic, tx)

    def check_next_block(self, block):
        return self._timed("block_check_s", self.inner.check_next_block, block)


def consensus_phase(run_path, kernels, smi) -> dict:
    """Phase 13: four validators of the port's consensus core
    (snarkos_tpu_torch/node/consensus.py, bft/) in this process over the
    in-process transport of tests/torch_bft_support.py, each over its own
    ledger on the card (CoreLedgerService, the full block check), commit the
    transmissions of LEDGER_FIXTURE's chain that do not depend on block 1's
    deploy."""
    import asyncio

    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_bft_support as bft_sup

    from snarkos_tpu_torch import convert
    from snarkos_tpu_torch.crypto.ref import g1 as ref_g1
    from snarkos_tpu_torch.node import ledger as ledger_mod, types as node_types
    from snarkos_tpu_torch.node.bft import primary as primary_mod
    from snarkos_tpu_torch.ops import g1, kzg, msm, poseidon
    from snarkos_tpu_torch.ops import puzzle as puzzle_mod

    dev = torch.device("cuda")
    with open(os.path.join(HERE, LEDGER_FIXTURE)) as fh:
        lfx = json.load(fh)
    out = {"card": smi, "timers": {k: getattr(primary_mod, k) for k in (
        "MIN_BATCH_DELAY_S", "MAX_BATCH_DELAY_S", "MAX_LEADER_CERTIFICATE_DELAY_S",
        "MAX_TIMESTAMP_DELTA_S", "MAX_FETCH_TIMEOUT_S")}}
    comm = convert.committee(bytes.fromhex(lfx["committee"]))
    accounts = [bft_sup.dev_account(i) for i in range(lfx["num_validators"])]
    if sorted(a.address for a in accounts) != sorted(comm.addresses):
        raise AssertionError("the derived dev accounts are not the fixture committee's members")
    blocks = [convert.block(bytes.fromhex(b)) for b in lfx["blocks"]]
    sols = [t.deserialize() for t in blocks[0].transmissions
            if t.kind == node_types.TX_SOLUTION]
    # the executions that do not need block 1's deploy: its transfer_public
    # and block 2's transfer_public_to_private
    txs = [next(t.deserialize() for t in blk.transmissions
                if t.kind == node_types.TX_TRANSACTION) for blk in blocks]
    for tx, fn in zip(txs, ("transfer_public ", "transfer_public_to_private ")):
        if tx.is_deploy or not tx.payload.startswith(b"execute credits.aleo/" + fn.encode()):
            raise AssertionError(f"the fixture's {fn.strip()} is not where it was")
    tampered = dataclasses.replace(sols[0], eval_y=sols[0].eval_y + 1)
    want = {s.id for s in sols} | {t.id for t in txs}

    # warm-up before the network: the build, the puzzle SRS and the genesis
    # epoch's program, the authorization circuit, the execution SRS of
    # 16,384 and the executions' indexes (one verify_transaction each)
    t0 = time.perf_counter()
    pz = puzzle_mod.global_puzzle(lfx["log_degree"], dev)
    genesis = ledger_mod.make_genesis(comm, dev)
    if genesis.to_bytes() != bytes.fromhex(lfx["genesis"]):
        raise AssertionError("the genesis differs from the fixture's")
    pz.epoch_program(genesis.epoch_hash)
    ledger_mod.global_varuna(dev)
    ledger_mod.execution_srs(16384, dev)
    warm = ledger_mod.Ledger(comm, device=dev)
    for tx in txs:
        if not ledger_mod.verify_transaction(tx, warm.parsed_programs, dev):
            raise AssertionError("the port's ledger rejected a fixture transaction")
    torch.cuda.synchronize()
    out["warm_up_s"] = time.perf_counter() - t0
    log(f"consensus warm-up (the puzzle SRS, the genesis epoch program, global_varuna, "
        f"execution_srs(16384), both executions verified once) {out['warm_up_s']:.2f} s")

    def factory(c):
        svc = TimedService(ledger_mod.CoreLedgerService(ledger_mod.Ledger(c, device=dev)))
        if svc.ledger.blocks[0].to_bytes() != bytes.fromhex(lfx["genesis"]):
            raise AssertionError("a validator's genesis differs from the fixture's")
        return svc

    net = bft_sup.TestNetwork(accounts, factory, comm)
    services = net.services
    committed_at = {a: [] for a in net.nodes}
    t_feed = [None]

    def hook(addr, inner):
        async def on_block(block):
            committed_at[addr].append((block.height, block.round, time.perf_counter() - t_feed[0]))
            await inner(block)
        return on_block

    for addr, node in net.nodes.items():
        node.on_block = hook(addr, node.on_block)

    # spies on the solutions' bindings and the KZG batches, for the path's
    # exact launches (check_launches)
    bindings, batches, lock = [0], [], threading.Lock()
    saved = (puzzle_mod.Puzzle.check_binding, kzg.batch_verify)

    def binding(self, *args):
        with lock:
            bindings[0] += 1
        return saved[0](self, *args)

    def batch(srs, openings, gamma=None, device=None):
        with lock:
            batches.append(list(openings))
        return saved[1](srs, openings, gamma, device)

    def done(addr):
        """The validator's commit path ran to its end (its block hook) for
        blocks that hold every transmission."""
        return {t.id for b in net.blocks[addr] for t in b.transmissions} >= want

    async def drive():
        loop = asyncio.get_running_loop()
        loop.set_default_executor(ThreadPoolExecutor(max_workers=8,
                                                     thread_name_prefix="validator"))
        t_feed[0] = t = time.perf_counter()
        for node in net.nodes.values():
            await node.add_unconfirmed_solution(tampered)
            for sol in sols:
                await node.add_unconfirmed_solution(sol)
            for tx in txs:
                await node.add_unconfirmed_transaction(tx)
        # intake ends before the first proposal: the solutions target the
        # genesis epoch and bind only in block 1 (ledger._solution_opening_for)
        await net.start_intake()
        while not all(set(n.primary.worker.ready) == want for n in net.nodes.values()):
            if time.perf_counter() - t > CONSENSUS_DEADLINE_S:
                raise AssertionError("the validators' intake did not end before the deadline; "
                                     f"refused: {[s.refused for s in services.values()]}")
            await asyncio.sleep(0.05)
        intake_s = time.perf_counter() - t
        for svc in services.values():
            svc.stage = "proposal"
        net.connect_all()
        await net.start()
        try:
            while not all(done(a) for a in net.nodes):
                if time.perf_counter() - t > CONSENSUS_DEADLINE_S:
                    raise AssertionError(
                        f"not every validator committed the {len(want)} transmissions within "
                        f"{CONSENSUS_DEADLINE_S:.0f} s: heights "
                        f"{[s.inner.latest_height() for s in services.values()]}")
                await asyncio.sleep(0.05)
            commit_s = time.perf_counter() - t
        finally:
            await net.stop()
        return intake_s, commit_s

    puzzle_mod.Puzzle.check_binding, kzg.batch_verify = binding, batch
    try:
        intake_s, commit_s = run_path("consensus", lambda: asyncio.run(drive()),
                                      ["fr_poseidon_permute", "fr_epoch_program", "mont_mul",
                                       "bucket_scan_serial", "seg_prefix", "g1_bucket_fixup",
                                       "g1_horner_chain", "g1_lane_buckets",
                                       "g1_lane_bucket_carry", "jadd_bucket_total"])
    finally:
        puzzle_mod.Puzzle.check_binding, kzg.batch_verify = saved
    check_launches(kernels, msm, "consensus", bindings[0], batches)

    # the tampered solution: refused at intake by all four, never committed
    for addr, svc in services.items():
        if not any(r[:3] == ("intake", "intake_s", tampered.id) for r in svc.refused):
            raise AssertionError(f"validator {addr[:16]} did not refuse the tampered solution")
        if svc.inner.contains_transmission(tampered.id):
            raise AssertionError("the tampered solution was committed")
        wrong = [r for r in svc.refused if r[2] != tampered.id]
        if wrong:
            raise AssertionError(f"validator {addr[:16]} refused good transmissions: {wrong}")
    log("the tampered solution (eval_y + 1) was refused at intake by all four validators "
        "and never committed")

    # the chains: equal block for block, each block's round even and its
    # anchor that round's leader; the transmissions all committed once
    chains = {a: svc.inner.ledger.blocks for a, svc in services.items()}
    common = min(len(c) for c in chains.values())
    first = next(iter(chains.values()))
    if any([b.hash for b in c[:common]] != [b.hash for b in first[:common]]
           for c in chains.values()):
        raise AssertionError("the validators' chains differ")
    last = max(b.height for b in first[:common] for t in b.transmissions
               if t.id in want) if common > 1 else 0
    got_ids = [t.id for b in first[1:common] for t in b.transmissions]
    if set(got_ids) != want or len(got_ids) != len(want):
        raise AssertionError("the common chain does not hold the transmissions once each")
    for b in first[1:common]:
        if b.round % 2 or b.subdag.anchor_round != b.round or \
                b.subdag.leader_certificate.author != comm.get_leader(b.round):
            raise AssertionError(f"block {b.height}: round {b.round} is not an even round "
                                 "anchored by its leader")
    out.update(intake_s=intake_s, first_feed_to_last_commit_s=commit_s,
               heights=[len(c) - 1 for c in chains.values()], common_height=common - 1,
               transmissions_block=last,
               rounds=[svc.inner.latest_round() for svc in services.values()],
               blocks=[(b.height, b.round, len(b.transmissions)) for b in first[1:common]],
               committed_at={a[:16]: v for a, v in committed_at.items()},
               host_s={a[:16]: dict(svc.seconds) for a, svc in services.items()})
    log(f"consensus: {len(want)} transmissions committed by all four validators "
        f"{commit_s:.2f} s after the first feed (intake {intake_s:.2f} s); chains equal over "
        f"{common - 1} blocks (heights {out['heights']}), the transmissions in block {last}; "
        f"blocks (height, round, transmissions) {out['blocks']}; on {smi}")
    for a, svc in services.items():
        log(f"  validator {a[:16]}: host s " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(svc.seconds.items()))
            + f"; commits (height, round, s) {committed_at[a]}")

    # a fresh ledger on the card replays each validator's chain. During the
    # first replay the path's kernels are held against their plain versions
    # on the path's own inputs: each binding's coefficients against the
    # plain sponge and epoch program on the card (limb for limb) and its
    # evaluation against the plain multiplies on a host copy; each KZG
    # batch's MSMs against msm.msm on host copies, the plain versions
    # (after affine normalisation)
    real_binding, real_msm, real_hash = (puzzle_mod.Puzzle.check_binding, msm.msm,
                                         poseidon.hash_fixed)
    held = {"bindings": 0, "msms": 0}

    def binding_held(self, epoch_hash, address, nonce, commitment, eval_y):
        got = self.coefficients(epoch_hash, address, [nonce])
        poseidon.hash_fixed = poseidon.hash_plain
        try:
            leaves = self._leaves_device([self._seed_field(epoch_hash, address, nonce)])
        finally:
            poseidon.hash_fixed = real_hash
        if not torch.equal(got, self.epoch_program(epoch_hash).apply_plain(leaves)):
            raise AssertionError("a binding's coefficients differ from the plain versions'")
        z = self._challenge(commitment)
        if kzg.poly_eval(got[:, 0], z) != kzg.poly_eval(got[:, 0].cpu(), z):
            raise AssertionError("a binding's evaluation differs from the plain multiplies'")
        held["bindings"] += 1
        return real_binding(self, epoch_hash, address, nonce, commitment, eval_y)

    def msm_held(points, scalars):
        got = real_msm(points, scalars)
        want = real_msm(g1.JacobianPoints(*(t.cpu() for t in (points.x, points.y, points.z))),
                        scalars.cpu())
        if [ref_g1.affine(p) for p in g1.decode_points(got)] != \
                [ref_g1.affine(p) for p in g1.decode_points(want)]:
            raise AssertionError(f"a KZG batch's MSM of {points.x.shape[-1]} points differs "
                                 "from the plain versions'")
        held["msms"] += 1
        return got

    def replay():
        for i, (a, chain) in enumerate(chains.items()):
            fresh = ledger_mod.Ledger(comm, device=dev)
            if i == 0:
                puzzle_mod.Puzzle.check_binding, msm.msm = binding_held, msm_held
            try:
                for blk in chain[1:]:
                    fresh.check_next_block(blk)
                    fresh.advance_to_next_block(blk)
            finally:
                puzzle_mod.Puzzle.check_binding, msm.msm = real_binding, real_msm
            if fresh.latest_block.hash != chain[-1].hash:
                raise AssertionError(f"the replay of {a[:16]}'s chain ends elsewhere")

    t0 = time.perf_counter()
    run_path("consensus chains replayed", replay,
             ["fr_poseidon_permute", "fr_epoch_program", "bucket_scan_serial", "g1_horner_chain"])
    out["replay_s"] = time.perf_counter() - t0
    if held != {"bindings": len(sols), "msms": 2}:
        raise AssertionError(f"the first replay held {held}, want {len(sols)} bindings and "
                             "one KZG batch's two MSMs")
    log(f"held against their plain versions on the path's inputs: {held['bindings']} "
        f"bindings' coefficients (fr_poseidon_permute, the epoch program) limb for limb "
        f"and their evaluations (mont_mul), one KZG batch's two MSMs (B4, B3, "
        f"g1_bucket_fixup, g1_horner_chain, g1_lane_buckets, g1_lane_bucket_carry, B7) "
        f"after affine normalisation")
    ref = convert.ledger(bytes.fromhex(lfx["committee"]),
                         [bytes.fromhex(lfx["genesis"])] + [bytes.fromhex(b) for b in lfx["blocks"]],
                         device=dev)

    def records(led):
        return sorted(c for v in led.record_ciphertexts.values() for c in v)

    for a, svc in services.items():
        led = svc.inner.ledger
        for acct in accounts:
            mine = led.get_mapping_value("credits.aleo", "account", acct.address)
            theirs = ref.get_mapping_value("credits.aleo", "account", acct.address)
            if mine != theirs:
                raise AssertionError(f"validator {a[:16]}: credits account of "
                                     f"{acct.address[:16]} {mine} != {theirs}")
        if records(led) != records(ref) or not records(ref):
            raise AssertionError(f"validator {a[:16]}: the record ciphertexts differ")
    log(f"a fresh ledger on the card accepts each validator's chain ({out['replay_s']:.2f} s "
        f"for the four); the credits accounts of dev accounts 0-3 and the "
        f"{len(records(ref))} record ciphertext equal the fixture chain's")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if loaded:
        raise AssertionError(f"JAX was imported: {loaded[:5]}")
    puzzle_mod._PUZZLE = None
    return out


# the block sync phase (14): the limit from the first sync step to height 2,
# and the Client role's sync loop interval there (the role's is 5 s)
SYNC_DEADLINE_S = 120.0
SYNC_STEP_S = 0.01


def sync_phase(run_path, kernels, smi) -> dict:
    """Phase 14: the node's block sync (snarkos_tpu_torch/node/block_sync.py)
    over localhost between a server router (router.py, tcp.py) and the
    port's Client role (roles.py: its router, block sync and sync loop,
    its fresh ledger on the card): the client syncs LEDGER_FIXTURE's blocks
    1 and 2 from a server that holds them, each through the full block check
    on the card in the loop's executor; then two tampered servers. The
    role's sync loop runs every SYNC_STEP_S in place of its 5 s."""
    import asyncio

    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_bft_support as bft_sup
    import torch_net_support as net

    from snarkos_tpu_torch import convert
    from snarkos_tpu_torch.crypto.ref import pairing
    from snarkos_tpu_torch.node import ledger as ledger_mod, messages as msg, roles
    from snarkos_tpu_torch.node import types as node_types
    from snarkos_tpu_torch.node.cli import AccountView
    from snarkos_tpu_torch.node.router import Router
    from snarkos_tpu_torch.ops import kzg, msm
    from snarkos_tpu_torch.ops import puzzle as puzzle_mod

    dev = torch.device("cuda")
    with open(os.path.join(HERE, LEDGER_FIXTURE)) as fh:
        lfx = json.load(fh)
    out = {"card": smi}
    comm = convert.committee(bytes.fromhex(lfx["committee"]))
    blocks = [convert.block(bytes.fromhex(b)) for b in lfx["blocks"]]
    # block 1 with one byte changed: the low byte of its first solution's
    # nonce. The solution still decodes and meets its target on the host;
    # its binding on the card fails, which the JAX ledger refuses with its
    # invalid-solution error
    first = next(i for i, t in enumerate(blocks[0].transmissions)
                 if t.kind == node_types.TX_SOLUTION)
    sol = blocks[0].transmissions[first].deserialize()
    txs = list(blocks[0].transmissions)
    txs[first] = node_types.Transmission.from_solution(dataclasses.replace(sol, nonce=sol.nonce ^ 1))
    tampered = dataclasses.replace(blocks[0], transmissions=tuple(txs))
    raw, bad = blocks[0].to_bytes(), tampered.to_bytes()
    if len(raw) != len(bad) or sum(a != b for a, b in zip(raw, bad)) != 1:
        raise AssertionError("the tampered block 1 is not block 1 with one byte changed")
    refusal = lfx["tampered"]["solution_eval_y_plus_1"]["error"]
    accounts = [bft_sup.dev_account(i) for i in range(2)]

    # the puzzle at the fixture's log degree (phases 12-13 leave none) and the
    # genesis epoch's program; the genesis, the execution SRS and the Varuna
    # indexes are cached from phase 12
    t0 = time.perf_counter()
    pz = puzzle_mod.global_puzzle(lfx["log_degree"], dev)
    genesis = ledger_mod.make_genesis(comm, dev)
    if genesis.to_bytes() != bytes.fromhex(lfx["genesis"]):
        raise AssertionError("the genesis differs from the fixture's")
    pz.epoch_program(genesis.epoch_hash)
    server_led = ledger_mod.Ledger(comm, device=dev)
    for blk in blocks:
        server_led.advance_to_next_block(blk)
    torch.cuda.synchronize()
    out["warm_up_s"] = time.perf_counter() - t0

    def client_role(one_response):
        """The Client role on the card, a fresh ledger; its block checks'
        refusals kept in ``refused``, the BlockResponses it handled counted
        in ``responses``. With ``one_response`` its sync loop ends when the
        first response arrives (a refused block would be asked for again)."""
        client = roles.Client(AccountView(accounts[0]), comm, device=dev)
        svc, handle = client.ledger_service, client.router.handlers[msg.BlockResponse]
        client.refused, client.responses = [], 0
        real_check = svc.check_next_block

        def check_next_block(block):
            try:
                real_check(block)
            except Exception as exc:
                client.refused.append((block.height, type(exc).__name__, str(exc)))
                raise

        async def on_response(*args):
            if one_response:
                for task in client._tasks:
                    task.cancel()
            try:
                await handle(*args)
            finally:
                client.responses += 1

        svc.check_next_block = check_next_block
        client.router.handlers[msg.BlockResponse] = on_response
        return client

    def locators(chain):
        """Block locators of ``chain`` (heights 0..), as a ledger gives them."""
        return msg.BlockLocators(recents=tuple((b.height, b.hash) for b in chain),
                                 checkpoints=((0, chain[0].hash),))

    async def sync(chain, announced, target):
        """A server serves ``chain`` and announces ``announced``; the Client
        role connects and syncs until it reaches ``target`` or has handled
        one response. Returns the client and its seconds: the handshake, the
        sync. A fault the role stopped on is raised."""
        server = Router(accounts[1], msg.NodeType.VALIDATOR, genesis.hash)
        net.serve_blocks(server, lambda h: chain[h], lambda: len(chain) - 1)
        client = client_role(target is None)
        addr = await server.run()
        await client.start()
        try:
            t0 = time.perf_counter()
            if not await client.router.connect(addr):
                raise AssertionError("the client's handshake with the server failed")
            if not await net.until(lambda: server.number_of_connected_peers() == 1, 10.0):
                raise AssertionError("the server did not register the client")
            handshake_s = time.perf_counter() - t0
            (back,) = server.peers
            net.announce(server, back, announced)
            if not await net.until(lambda: client.router.peers[addr].block_locators
                                   is not None, 10.0):
                raise AssertionError("the server's locators did not reach the client")
            t0 = time.perf_counter()
            done = ((lambda: client.ledger.latest_height >= target) if target is not None
                    else (lambda: client.responses >= 1))
            if not await net.until(lambda: done() or client.halted.is_set(), SYNC_DEADLINE_S):
                raise AssertionError(f"the sync reached height {client.ledger.latest_height} "
                                     f"in {SYNC_DEADLINE_S} s")
            sync_s = time.perf_counter() - t0
        finally:
            await client.shut_down()
            await server.shut_down()
        if client.fault is not None:
            raise client.fault
        return client, handshake_s, sync_s

    # spies: the bindings and KZG batches the checks make (check_launches),
    # and the host seconds split as phase 12 splits a block check
    split, bindings, batches = {}, [0], []
    saved = (puzzle_mod.Puzzle.check_binding, kzg.batch_verify,
             ledger_mod.transaction_opening, msm.msm, pairing.pairing_check,
             ledger_mod.Ledger._solution_opening_for)

    def clocked(key, fn, sync=False):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            split[key] = split.get(key, 0.0) + time.perf_counter() - t0
            return res
        return timed

    def binding(self, *args):
        bindings[0] += 1
        return saved[0](self, *args)

    def batch(srs, openings, gamma=None, device=None):
        batches.append(list(openings))
        return saved[1](srs, openings, gamma, device)

    def spied(label, fn, required, absent=()):
        split.clear()
        bindings[0] = 0
        batches.clear()
        puzzle_mod.Puzzle.check_binding, kzg.batch_verify = binding, batch
        ledger_mod.transaction_opening = clocked("transaction_openings_s", saved[2])
        msm.msm = clocked("batch_msms_s", saved[3], sync=True)
        pairing.pairing_check = clocked("batch_pairing_s", saved[4])
        ledger_mod.Ledger._solution_opening_for = clocked("solution_openings_s", saved[5],
                                                          sync=True)
        step = roles.SYNC_INTERVAL_S
        roles.SYNC_INTERVAL_S = SYNC_STEP_S
        try:
            res = run_path(label, lambda: asyncio.run(fn()), required, absent=absent)
        finally:
            roles.SYNC_INTERVAL_S = step
            (puzzle_mod.Puzzle.check_binding, kzg.batch_verify, ledger_mod.transaction_opening,
             msm.msm, pairing.pairing_check, ledger_mod.Ledger._solution_opening_for) = saved
        check_launches(kernels, msm, label, bindings[0], batches)
        return res

    # the honest server: blocks 1-2 byte for byte, the path's launches exact
    # and equal to phase 12's two block checks
    chain = [genesis] + blocks
    client, handshake_s, sync_s = spied(
        "block sync", lambda: sync(chain, server_led.latest_block_locators(), 2),
        ["fr_poseidon_permute", "fr_epoch_program", "mont_mul", "bucket_scan_serial",
         "seg_prefix", "g1_bucket_fixup", "g1_horner_chain", "g1_lane_buckets",
         "g1_lane_bucket_carry", "jadd_bucket_total"])
    led = client.ledger
    if led.latest_height != 2 or [b.to_bytes() for b in led.blocks[1:]] != \
            [bytes.fromhex(b) for b in lfx["blocks"]]:
        raise AssertionError("the synced blocks 1-2 differ from the fixture's")
    if led.latest_state_root.hex() != lfx["state_roots"][2]:
        raise AssertionError("the synced ledger's state root differs from the fixture's")
    if bindings[0] != sum(1 for t in blocks[0].transmissions if t.kind == node_types.TX_SOLUTION) or \
            [len(b) for b in batches] != [len(o) for o in lfx["openings"]]:
        raise AssertionError(f"the sync made {bindings[0]} bindings and KZG batches of "
                             f"{[len(b) for b in batches]} openings, not block 1's and 2's")
    if client.refused:
        raise AssertionError(f"the client refused honest blocks: {client.refused}")
    phase12 = {k["name"]: sum(k["launches_per_path"].get(f"check_next_block(block {b})", 0)
                              for b in (1, 2)) for k in kernels}
    got = {k["name"]: k["launches_per_path"]["block sync"] for k in kernels}
    if got != phase12:
        raise AssertionError(f"the sync's launches {got} differ from phase 12's two block "
                             f"checks {phase12}")
    out.update(handshake_s=handshake_s, sync_s=sync_s, responses=client.responses,
               split=dict(split), bindings=bindings[0],
               batches=[len(b) for b in batches])
    log(f"block sync over localhost: blocks 1-2 byte for byte from the server in "
        f"{sync_s:.2f} s (host s; {client.responses} responses; handshake {handshake_s:.2f} s, "
        f"warm-up {out['warm_up_s']:.2f} s), the state root the fixture's; launches exact: "
        f"{bindings[0]} bindings, KZG batches of {out['batches']} openings, phase 12's block 1 "
        f"and block 2 columns added; host s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(split.items())) + f"; on {smi}")

    # a server that announces the fixture's chain and serves block 1 with one
    # byte changed: refused against the announced hash before any check,
    # its requests revoked, nothing launched
    names = [k["name"] for k in kernels]
    client, _, _ = spied("block sync, tampered, by hash",
                         lambda: sync([genesis, tampered] + blocks[1:],
                                      server_led.latest_block_locators(), None), [], names)
    if client.ledger.latest_height != 0 or client.block_sync.requests or \
            client.block_sync.responses or client.refused or bindings[0] or batches:
        raise AssertionError("the block served with one byte changed was not refused by hash")
    log("a server announcing the fixture's chain and serving block 1 with one byte changed: "
        "the block refused against the announced hash, the height 0, its requests revoked, "
        "no kernel launched")

    # a server that announces its own chain (the tampered block 1): the hash
    # matches, the block check refuses it when the solution's binding on the
    # card fails, with the JAX ledger's error; the height stays, the pool is
    # empty, the launches are exact (one binding, no KZG batch)
    t0 = time.perf_counter()
    client, _, _ = spied("block sync, tampered, checked",
                         lambda: sync([genesis, tampered], locators([genesis, tampered]), None),
                         BINDING_KERNELS[:2])
    out["tampered_check_s"] = time.perf_counter() - t0
    if client.refused != [(1, "ValueError", refusal)] or bindings[0] != 1 or batches or \
            client.ledger.latest_height != 0 or client.block_sync.requests or \
            client.block_sync.responses:
        raise AssertionError(f"the tampered block was not refused by the check: "
                             f"{client.refused}, height {client.ledger.latest_height}")
    out["tampered"] = dict(bindings=bindings[0], batches=[len(b) for b in batches],
                           error=refusal)
    log(f"a server announcing its chain with the tampered block 1: the solution's binding on "
        f"the card failed and the block check refused the block ({refusal!r}; {bindings[0]} "
        f"binding, no KZG batch, launches exact) in {out['tampered_check_s']:.2f} s, the "
        f"height 0, the pool empty")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if loaded:
        raise AssertionError(f"JAX was imported: {loaded[:5]}")
    puzzle_mod._PUZZLE = None
    return out


# the devnet phase (15): the limits on a validator's start-up (its genesis
# on the card) and from the Prover's start to the block that holds its
# solution, and on the validators' exit after SIGTERM
DEVNET_VALIDATORS = 4
DEVNET_STARTUP_S = 300.0
DEVNET_DEADLINE_S = 240.0
DEVNET_EXIT_S = 60.0


def devnet_phase(run_path, kernels, smi) -> dict:
    """Phase 15: four validators started as processes through the port's
    CLI (``python -m snarkos_tpu_torch.node.cli start --validator --dev i``,
    every check on the card) and a Prover in this process, built as ``cli
    start --prover --dev 4`` builds it, on the card; the devnet must commit
    a block that holds a solution the Prover found."""
    import asyncio
    import urllib.error
    import urllib.request

    import torch

    from snarkos_tpu_torch.node import cli, types as node_types
    from snarkos_tpu_torch.node.codec import Reader
    from snarkos_tpu_torch.ops import puzzle as puzzle_mod

    dev = torch.device("cuda")
    out = {"card": smi}
    logs = os.path.join(HERE, "chiprun_out", "devnet")
    os.makedirs(logs, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="devnet-")
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    procs, files = [], []

    def rest(i, path):
        """GET /testnet/{path} from validator i's REST, waiting out its rate
        limit (10 requests a second)."""
        for _ in range(20):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{3030 + i}/testnet/{path}",
                                            timeout=10) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as exc:
                if exc.code != 429:
                    raise
                time.sleep(1.0)
        raise AssertionError(f"validator {i}'s REST kept refusing {path}")

    def log_text(i):
        with open(os.path.join(logs, f"dev-{i}.log"), errors="replace") as fh:
            return fh.read()

    def tails():
        return "\n".join(f"--- dev-{i}.log\n" + "\n".join(log_text(i).splitlines()[-15:])
                         for i in range(len(procs)))

    try:
        # the validators: the kernels were built by phase 1, so each process
        # loads the libraries and builds nothing
        t_spawn = []
        for i in range(DEVNET_VALIDATORS):
            fh = open(os.path.join(logs, f"dev-{i}.log"), "w")
            files.append(fh)
            cmd = [sys.executable, "-m", "snarkos_tpu_torch.node.cli", "start", "--validator",
                   "--dev", str(i), "--dev-num-validators", str(DEVNET_VALIDATORS),
                   "--storage", os.path.join(tmp, f"dev-{i}", "ledger.dat")]
            t_spawn.append(time.perf_counter())
            procs.append(subprocess.Popen(cmd, cwd=HERE, env=env, stdout=fh,
                                          stderr=subprocess.STDOUT))
        log(f"started {DEVNET_VALIDATORS} validators: " + " ".join(cmd[:4]) + " --validator "
            "--dev i ...; logs in chiprun_out/devnet/")

        # the Prover's node, built before the validators are up: its genesis
        # (cached from phase 12), the puzzle at the dev log degree on the
        # card and this epoch's program are built outside the counted run
        args = cli.build_parser().parse_args(
            ["start", "--prover", "--dev", str(DEVNET_VALIDATORS),
             "--dev-num-validators", str(DEVNET_VALIDATORS)])
        prover = cli.make_node(args)
        pz = puzzle_mod.global_puzzle(None, dev)
        if pz.log_degree != 12 or prover.nonce_batch != BATCH:
            raise AssertionError(f"the Prover would prove at log degree {pz.log_degree}, "
                                 f"batch {prover.nonce_batch}")

        started = {}
        while len(started) < DEVNET_VALIDATORS:
            for i, p in enumerate(procs):
                if i not in started and "validator started:" in log_text(i):
                    started[i] = time.perf_counter() - t_spawn[i]
                if p.poll() is not None:
                    raise AssertionError(f"validator {i} exited with {p.returncode} at "
                                         f"start-up\n{tails()}")
            if time.perf_counter() - t_spawn[0] > DEVNET_STARTUP_S:
                raise AssertionError(f"the validators did not start within "
                                     f"{DEVNET_STARTUP_S:.0f} s\n{tails()}")
            time.sleep(0.2)
        out["validator_startup_s"] = [started[i] for i in range(DEVNET_VALIDATORS)]
        log("validators started (host s from spawn, the genesis on the card): "
            + ", ".join(f"{s:.2f}" for s in out["validator_startup_s"]))
        # the Prover starts in the epoch of heights 1-359: a solution for the
        # genesis epoch goes stale when block 1 commits, and the validators
        # refuse it at intake
        while rest(0, "block/height/latest") < 1:
            if time.perf_counter() - t_spawn[0] > DEVNET_STARTUP_S:
                raise AssertionError(f"the validators committed no block within "
                                     f"{DEVNET_STARTUP_S:.0f} s\n{tails()}")
            time.sleep(0.25)
        out["first_block_s"] = time.perf_counter() - t_spawn[0]
        log(f"block 1 committed {out['first_block_s']:.2f} s after the first spawn")
        # this epoch's program and one batch, as phase 3 warms its column
        epoch = bytes.fromhex(rest(0, "latest/epochHash"))
        pz.prove_batch(epoch, prover.account.address, list(range(BATCH)), None)
        torch.cuda.synchronize()

        # the Prover proves until the block that holds its solution is read,
        # as `cli start --prover` runs it; each batch is timed and nothing
        # else changes
        batch_s = []
        real_prove = prover._prove_batch_indexed

        def timed_prove(*a):
            t0 = time.perf_counter()
            res = real_prove(*a)
            batch_s.append(time.perf_counter() - t0)
            return res

        prover._prove_batch_indexed = timed_prove

        async def drive():
            loop = asyncio.get_running_loop()
            t0 = time.perf_counter()
            await prover.start()
            if prover.puzzle is not pz:
                raise AssertionError("the Prover built another puzzle than the process's")
            # the router's first heartbeat would dial its trusted peers, the
            # validators' node ports, after 25 s
            for addr in prover.router.trusted_peers:
                if not await prover.router.connect(addr):
                    raise AssertionError(f"the Prover could not connect to {addr}")
            found_at = held = None
            seen, height = {}, 0
            try:
                while held is None:
                    if time.perf_counter() - t0 > DEVNET_DEADLINE_S:
                        raise AssertionError(
                            f"no block held the Prover's solution within {DEVNET_DEADLINE_S:.0f}"
                            f" s: {prover.solutions_found} found in {len(batch_s)} batches, "
                            f"height {height}\n{tails()}")
                    if prover.fault is not None:
                        raise prover.fault
                    if found_at is None and prover.solutions_found:
                        found_at = time.perf_counter() - t0
                    height = await asyncio.to_thread(rest, 0, "block/height/latest")
                    for h in range(1, height + 1):
                        if h in seen or held is not None:
                            continue
                        blk = await asyncio.to_thread(rest, 0, f"block/{h}")
                        seen[h] = blk["transmissions"]
                        for t in blk["transmissions"]:
                            if t["kind"] == node_types.TX_SOLUTION and node_types.Solution.from_reader(
                                    Reader(bytes.fromhex(t["data"]))).address == \
                                    prover.account.address:
                                held = (h, blk["hash"], time.perf_counter() - t0)
                    await asyncio.sleep(0.25)
            finally:
                await prover.shut_down()
            return found_at, held, seen

        epoch_entry = ("fr_epoch_program_global" if puzzle_mod.epoch_plan(BATCH, pz.k)[0]
                       == "global" else "fr_epoch_program")
        # asyncio.run returns once the executor's batch in flight has ended:
        # every batch the Prover started is counted
        found_at, (height, block_hash, held_s), chain = run_path(
            "devnet prover", lambda: asyncio.run(drive()),
            ["mont_mul", "fr_poseidon_permute", epoch_entry, "g1_horner_chain",
             "g1_bucket_fixup", "seg_prefix", "bucket_scan_serial"])
        if prover.fault is not None:
            raise AssertionError(f"the Prover stopped on a fault: {prover.fault!r}")
        batches = prover.iterations // prover.nonce_batch
        # kernels first checked after phase 3 (fr_ntt_pass) launched 0 times there
        want = {k["name"]: batches * k["launches_per_path"].get(f"prove_batch({BATCH})", 0)
                for k in kernels}
        got = {k["name"]: k["launches_per_path"]["devnet prover"] for k in kernels}
        if got != want or len(batch_s) != batches:
            raise AssertionError(f"the Prover's launches {got}, want {batches} x the "
                                 f"prove_batch({BATCH}) column {want}")
        log(f"the Prover's launches exact: {batches} batches x the prove_batch({BATCH}) column")

        # every validator reports the same block at that height
        hashes = []
        t0 = time.perf_counter()
        for i in range(DEVNET_VALIDATORS):
            while rest(i, "block/height/latest") < height:
                if time.perf_counter() - t0 > 60:
                    raise AssertionError(f"validator {i} did not reach height {height}")
                time.sleep(0.25)
            hashes.append(rest(i, f"block/{height}")["hash"])
        if set(hashes) != {block_hash}:
            raise AssertionError(f"the validators disagree on block {height}: {hashes}")
        proved = sum(batch_s)
        out.update(height=height, block_hash=block_hash, first_solution_s=found_at,
                   block_s=held_s, batches=batches, solutions_found=prover.solutions_found,
                   batch_s=batch_s, solutions_per_s=batches * BATCH / proved)
        log(f"devnet: block {height} ({block_hash[:16]}) holds a solution the Prover found on "
            f"the card, the same hash on all four validators; from the Prover's start: first "
            f"passing solution {found_at:.2f} s, that block {held_s:.2f} s (host s); "
            f"{batches} batches of {BATCH}, {prover.solutions_found} passing, "
            f"{out['solutions_per_s']:.2f} solutions/s over {proved:.2f} s of proving; on {smi}")
    finally:
        t0 = time.perf_counter()
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(1.0, DEVNET_EXIT_S - (time.perf_counter() - t0))))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        for fh in files:
            fh.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out["exit_codes"], out["exit_s"] = codes, time.perf_counter() - t0
    faults = [i for i in range(len(procs)) if "device fault" in log_text(i)
              or "Traceback" in log_text(i)]
    if codes != [0] * DEVNET_VALIDATORS or faults:
        raise AssertionError(f"the validators exited with {codes} after SIGTERM; faults or "
                             f"tracebacks logged by {faults}\n{tails()}")
    left = [pid for pid in _children() if pid in {p.pid for p in procs}]
    if left:
        raise AssertionError(f"validator processes left: {left}")
    log(f"SIGTERM: the four validators exited with status 0 in {out['exit_s']:.2f} s, "
        "no fault logged, no process left")

    # each validator's own launches, printed by `cli start` when it stopped,
    # held against what the committed chain alone asks of it: every solution
    # in blocks 1..height has its binding checked (phase 7's check_binding
    # column) and every block that holds a transmission its KZG batch, whose
    # two MSMs end in one Horner chain each (phase 12's block 2 column);
    # intake and proposal checks add to both
    names = {k["counter"].__name__: k["name"] for k in kernels}
    n_sol = sum(t["kind"] == node_types.TX_SOLUTION for ts in chain.values() for t in ts)
    n_batches = sum(bool(ts) for ts in chain.values())
    floor = {k["name"]: n_sol * k["launches_per_path"]["check_binding"]
             for k in kernels if k["name"] in BINDING_KERNELS}
    floor["g1_horner_chain"] = n_batches * next(
        k["launches_per_path"]["check_next_block(block 2)"] for k in kernels
        if k["name"] == "g1_horner_chain")
    out["validator_launches"] = []
    for i in range(DEVNET_VALIDATORS):
        line = [ln for ln in log_text(i).splitlines() if ln.startswith("kernel launches: ")]
        if not line:
            raise AssertionError(f"validator {i} printed no launch counts\n{tails()}")
        got = {names.get(w, w): c for w, c in json.loads(line[-1][17:]).items()}
        out["validator_launches"].append(got)
        short = {k: got.get(k, 0) for k, v in floor.items() if got.get(k, 0) < v}
        if short or not n_sol:
            raise AssertionError(f"validator {i} launched {got}; blocks 1-{height} hold "
                                 f"{n_sol} solutions in {n_batches} blocks, which ask at "
                                 f"least {floor}")
    log(f"the validators' own launches (blocks 1-{height}: {n_sol} solutions, {n_batches} "
        f"blocks with transmissions; at least {floor}): "
        + "; ".join(", ".join(f"{k} {v}" for k, v in sorted(got.items()) if v)
                    for got in out["validator_launches"]))
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if loaded:
        raise AssertionError(f"JAX was imported: {loaded[:5]}")
    puzzle_mod._PUZZLE = None
    return out


def phase(label: str) -> None:
    """Log and keep the seconds since the start at which a phase begins."""
    PHASE_S[label] = time.perf_counter() - T_START
    log(f"[{PHASE_S[label]:.1f} s] phase {label}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch.distributed as dist

    from snarkos_tpu_torch import entry as entry_mod
    from snarkos_tpu_torch.crypto import params, srs_artifact
    from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, kzg as ref_kzg, ntt as ref_ntt, pairing
    from snarkos_tpu_torch.crypto.ref import poseidon as ref_poseidon
    from snarkos_tpu_torch.ops import _build, g1, g1_kernels, kzg, msm, msm_kernels, ntt, poseidon
    from snarkos_tpu_torch.ops import modarith as fa
    from snarkos_tpu_torch.ops import puzzle as puzzle_mod
    from snarkos_tpu_torch.ops.fieldspec import FQ, FR
    from snarkos_tpu_torch.ops.puzzle import DEV_TAU, Puzzle, PuzzleSRS, sha64
    from snarkos_tpu_torch.parallel import mesh as pmesh, msm_dist, ntt_dist

    with open(os.path.join(HERE, "tests", "fixtures", "torch_puzzle_k12_b8.json")) as fh:
        fixture = json.load(fh)
    dev = torch.device("cuda")
    report = {}

    # -- 1. environment and build ---------------------------------------------
    phase("1")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvcc: {nvcc}")
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    log(f"built {len(_build.SOURCES)} kernels in {build_s:.1f} s")
    regs = {}
    for name in _build.SOURCES:
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        regs[name] = lines
        for ln in lines:
            log(f"  {name}: {ln}")
    local = sass_local(_build)
    for name, kerns in local.items():
        log(f"  {name} SASS local loads / stores: "
            + "; ".join(f"{k} {ldl} / {stl}" for k, (ldl, stl) in kerns.items()))
    report.update(card=smi, torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
                  build_s=build_s, ptxas=regs, sass_local=local)
    t0 = time.perf_counter()
    srs = PuzzleSRS.dev(LOG_N)
    torch.cuda.synchronize()
    report["srs20_build_s"] = time.perf_counter() - t0
    log(f"dev SRS of degree 2^{LOG_N} built on the card in {report['srs20_build_s']:.1f} s")

    rng = np.random.default_rng(1234)
    prng = random.Random(1234)

    def field_operands(spec, n):
        a = spec.random(n, rng)
        b = spec.random(n, rng)
        edge = [0, 1, spec.p - 1, spec.p - 2]  # canonical values, as limbs
        ea = spec.encode_fast(edge + [spec.p - 1, 0])
        eb = spec.encode_fast([spec.p - 1, spec.p - 1, spec.p - 1, 1] + [spec.p - 1, 0])
        a[:, :ea.shape[1]] = ea
        b[:, :eb.shape[1]] = eb
        return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)

    # host points: multiples of a random point, then Jacobian rescaling
    H = ref_g1.scalar_mul(prng.randrange(1, params.FR_MODULUS), ref_g1.GENERATOR)
    multiples, acc = [], H
    for _ in range(4096):
        multiples.append(ref_g1.from_affine(ref_g1.affine(acc)))
        acc = ref_g1.add(acc, H)

    def rescale(p):
        """Another Jacobian representative of the same point."""
        if not p[2]:
            return p
        x, y = ref_g1.affine(p)
        lam = prng.randrange(1, FQ.p)
        return (x * lam * lam % FQ.p, y * lam ** 3 % FQ.p, lam)

    def point_pairs(n):
        P = [rescale(multiples[prng.randrange(4096)]) for _ in range(n)]
        Q = [rescale(multiples[prng.randrange(4096)]) for _ in range(n)]
        P[0] = rescale(Q[0])                                      # P == Q
        P[1] = rescale(ref_g1.neg(Q[1]))                          # P == -Q
        P[2] = ref_g1.INFINITY                                    # P = 0
        Q[3] = ref_g1.INFINITY                                    # Q = 0
        P[4], Q[4] = ref_g1.INFINITY, ref_g1.INFINITY             # both
        P[5] = (prng.randrange(FQ.p), prng.randrange(FQ.p), 0)    # odd identity
        return g1.encode_points(P, dev), g1.encode_points(Q, dev), add_ops(P, Q)

    def add_ops(P, Q):
        """Multiplies of the complete adds P + Q as g1.cuh runs them: none
        with an identity operand, 8 + 7 Fq products for P == Q, 16 else.
        Raises unless the lanes hold P == Q and P == -Q."""
        fin = [(p, q) for p, q in zip(P, Q) if p[2] and q[2]]
        n_dbl = sum(1 for p, q in fin if ref_g1.affine(p) == ref_g1.affine(q))
        n_neg = sum(1 for p, q in fin if ref_g1.affine(p) == ref_g1.affine(ref_g1.neg(q)))
        if n_dbl < 1 or n_neg < 1:
            raise AssertionError("edge lanes P == Q and P == -Q were not built")
        return (16 * (len(fin) - n_dbl) + 15 * n_dbl) * FQ_MUL_OPS

    kernels = []

    def affine_err(got, want, mask=None):
        """Projective check of two (x, y, z) outputs: every position (where
        ``mask``, if given) must be g1.same_points; returns the max abs error
        of their affine normal forms (x, y, is-identity)."""
        pg, pw = (g1.JacobianPoints(*(t.reshape(24, -1) if mask is None else
                                      t.reshape(24, -1)[:, mask] for t in o))
                  for o in (got, want))
        n, step, bad = pg.x.shape[-1], 1 << 16, 0
        for lo in range(0, n, step):  # the plain products of same_points take memory
            part = [g1.JacobianPoints(*(t[:, lo:lo + step] for t in (p.x, p.y, p.z)))
                    for p in (pg, pw)]
            bad += int((~g1.same_points(*part)).sum())
        if bad:
            raise AssertionError(f"{bad} positions are not the same point")
        return max_abs_err(g1.to_affine(pg), g1.to_affine(pw))

    def check(name, source, replaces, cases, counter, big=False, verify=None, exact=True,
              compare=None, library=None):
        """cases: [(label, kernel_fn, plain_fn, nbytes, nops[, timed_fn])],
        ``timed_fn`` timed in place of kernel_fn if given, a case with nbytes
        None compared and not timed, its plain version run once (the first
        case is timed); a timed case's plain version runs once for its output
        and once more, timed (CUDA events); ``big``: time 7 runs of 3 launches
        (else 7 runs of 20), and the device time over as many launches as a
        run, and run each plain version once, timed by that call; ``verify``
        checks the kernel's output beyond the comparison with the plain one;
        ``exact=False`` compares projectively (``affine_err``), ``compare``
        with a function (got, want) -> max abs error that raises on a
        mismatch; ``library``, one PyTorch call that computes the first case's
        function, is timed as its library_ms. Cases that share a plain_fn
        share its output and time."""
        shapes = []
        plain_runs = {}
        for label, kfn, pfn, nbytes, nops, *timed in cases:
            if pfn not in plain_runs and big:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                want = pfn()
                end.record()
                torch.cuda.synchronize()
                plain_runs[pfn] = (want, start.elapsed_time(end))
            elif pfn not in plain_runs:
                want = pfn()
                torch.cuda.synchronize()
                plain_runs[pfn] = (want, None)
            want, plain_ms = plain_runs[pfn]
            if plain_ms is None and nbytes is not None:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                pfn()
                end.record()
                torch.cuda.synchronize()
                plain_ms = start.elapsed_time(end)
                plain_runs[pfn] = (want, plain_ms)
            got = kfn()
            torch.cuda.synchronize()
            if compare is not None:
                err = compare(got, want)
            else:
                err = max_abs_err(got, want) if exact else affine_err(got, want)
            if err != 0:
                raise AssertionError(f"{name} {label}: kernel != plain (max abs err {err})")
            if verify is not None:
                verify(label, got)
            if nbytes is None:  # a case that is compared, not timed
                shapes.append({"shape": label, "max_abs_err": err})
                log(f"{name} {label}: exact")
                continue
            inner = 3 if big else 20
            tfn = timed[0] if timed else kfn
            ms = cuda_ms(tfn, 7, inner=inner)
            dev_ms = graph_ms(tfn, 7, inner)
            b_ms, b_by = bound(nbytes, nops)
            shapes.append({"shape": label, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
            how = "exact" if exact and compare is None else "same points"
            log(f"{name} {label}: {how}; kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
                f"plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by})")
        main_case = shapes[0]
        library_ms = None if library is None else cuda_ms(library, 7, inner=3 if big else 20)
        if library_ms is not None:
            log(f"{name} {main_case['shape']}: one PyTorch call computing it {library_ms:.4f} ms")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "counter": counter, "max_abs_err": max(s["max_abs_err"] for s in shapes),
                        "ms": main_case["ms"], "device_ms": main_case["device_ms"],
                        "plain_ms": main_case["plain_ms"],
                        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
                        "library_ms": library_ms, "shapes": shapes})

    # -- 2. kernels against their plain versions at the path's shapes ----------
    phase("2")
    n = BATCH * 4096
    b1 = []
    for spec, ops, width in ((FR, FR_MUL_OPS, n), (FQ, FQ_MUL_OPS, n), (FQ, FQ_MUL_OPS, 1 << 20)):
        a, b = field_operands(spec, width)
        b1.append((f"{spec.name} ({spec.nlimbs}, {width})",
                   lambda a=a, b=b, s=spec: fa.mont_mul_kernel(s, a, b),
                   lambda a=a, b=b, s=spec: fa.mont_mul_plain(s, a, b),
                   3 * spec.nlimbs * 4 * width, ops * width))
    check("mont_mul", "snarkos_tpu_torch/csrc/mont_mul.cu",
          "snarkos_tpu/ops/modarith.py:171", b1, fa.mont_mul_kernel)

    # B1's Fr passes (csrc/fr_passes.cu). The sponge kernel first as the
    # paths launch it (hash_fixed: prove_batch's leaves at B x 4096 lanes and
    # entry.forward's 2^22, rate 2, n = 2, one output), then one permutation
    # of a given state at the leaves' widths, at 2^22 and at rate 4, with the
    # edge states (0, 1, p - 1 in every slot) in lanes 0-2; and, compared
    # only, the sponge over 5 inputs squeezing 3 at rate 4 (two absorbs, two
    # squeezes). The widths of rates 1, 3 and 8 (t = 2, 4, 9): one
    # permutation at 2^16 lanes, and the sponge over rate + 1 inputs squeezing
    # rate + 1 (two absorbs, two squeezes), compared only. The bound counts
    # the 32-bit multiplies of the form the kernel runs (poseidon_ops).
    def fr_state(t, lanes):
        x = torch.from_numpy(np.ascontiguousarray(
            FR.random(t * lanes, rng).reshape(FR.nlimbs, t, lanes).transpose(1, 0, 2))).to(dev)
        for lane, v in enumerate((0, 1, FR.p - 1)):
            x[:, :, lane] = torch.from_numpy(FR.encode_fast([v], mont=True)[:, 0]).to(dev)
        return x

    def consts_bytes(rate):
        """The bytes of the constants the rate's kernel reads (limbs for the
        register template, words for the runtime-width kernel)."""
        return poseidon._device_kernel_consts(rate, torch.device("cpu")).numel() * 4

    def split(x, part):
        """The lanes [0, part) and [lanes - part, lanes) of (n, L, lanes)."""
        return torch.cat([x[..., :part], x[..., -part:]], dim=-1)

    host_cases = {}  # label: (rate, the case's input, its kernel, hash_many's args or None)

    def permute_case(rate, lanes, part=None):
        """``part``: compare the lanes [0, part) and [lanes - part, lanes)
        only (the plain permutation at 2^22 takes tens of seconds a call)."""
        t = rate + 1
        st = fr_state(t, lanes)
        label = f"permute ({t}, 16, {lanes})"

        def kernel():
            return poseidon.permute_kernel(st, rate)

        if part is None:
            kfn, xs = kernel, st
        else:
            label += f", lanes [0, {part}) and [{lanes - part}, {lanes}) compared"
            xs = split(st, part)

            def kfn():
                return split(kernel(), part)
        host_cases[label] = (rate, st, kernel, None)
        return (label, kfn, lambda: poseidon.permute_plain(xs, rate),
                2 * t * 16 * 4 * lanes + consts_bytes(rate), poseidon_ops(t) * lanes, kernel)

    def sponge_case(rate, n_in, lanes, num_outputs, domain, timed=True, part=None):
        """``part``: compare the lanes [0, part) and [lanes - part, lanes)
        only (the plain sponge at 2^22 takes tens of seconds a call)."""
        x = fr_state(n_in, lanes)
        perms = sponge_permutations(rate, n_in, num_outputs)
        label = f"hash_fixed ({n_in}, 16, {lanes}) rate {rate} -> {num_outputs}"

        def kernel():
            return poseidon.hash_fixed(x, rate, domain, num_outputs)

        if part is None:
            kfn, xs = kernel, x
        else:
            label += f", lanes [0, {part}) and [{lanes - part}, {lanes}) compared"
            xs = split(x, part)

            def kfn():
                return split(kernel(), part)
        host_cases[label] = (rate, x, kernel, (num_outputs, domain))
        return (label, kfn, lambda: poseidon.hash_plain(xs, rate, domain, num_outputs),
                (n_in + num_outputs) * 16 * 4 * lanes + consts_bytes(rate) if timed else None,
                perms * poseidon_ops(rate + 1) * lanes, kernel)

    wide_cases = []
    for r in POSEIDON_WIDE_RATES:
        wide_cases += [permute_case(r, 1 << 16, part=WIDE_PART),
                       sponge_case(r, r + 1, 1 << 16, r + 1, "snarkos_tpu.test", part=WIDE_PART)]
    wide_labels = [c[0] for c in wide_cases]
    check("fr_poseidon_permute", "snarkos_tpu_torch/csrc/fr_passes.cu",
          "snarkos_tpu/ops/modarith.py:171",
          [sponge_case(2, 2, BATCH * 4096, 1, puzzle_mod.COEFF_DOMAIN),
           sponge_case(2, 2, BATCH_WIDE * 4096, 1, puzzle_mod.COEFF_DOMAIN),
           sponge_case(2, 2, 1 << PIPE_LOG, 1, entry_mod.DOMAIN, part=1 << 16),
           permute_case(2, BATCH * 4096), permute_case(2, BATCH_WIDE * 4096),
           permute_case(2, 1 << PIPE_LOG, part=1 << 16), permute_case(4, 4096),
           sponge_case(4, 5, 4096, 3, "snarkos_tpu.test", timed=False),
           *(permute_case(r, 1 << 16) for r in POSEIDON_MORE_RATES),
           *(sponge_case(r, r + 1, 4096, r + 1, "snarkos_tpu.test", timed=False)
             for r in POSEIDON_MORE_RATES), *wide_cases],
          poseidon.sponge_kernel, big=True)

    # the wide rates against the host's permute and hash_many on three lanes:
    # 0 (every slot 0), 2 (every slot p - 1) and the last (random)
    def lane_ints(x, lane):
        return [FR.decode_fast(x[i, :, lane:lane + 1].cpu().numpy(), mont=True)[0]
                for i in range(x.shape[0])]

    for label in wide_labels:
        rate, x, kernel, sponge = host_cases[label]
        got = kernel()
        for lane in (0, 2, x.shape[-1] - 1):
            xs = lane_ints(x, lane)
            want = (ref_poseidon.permute(xs, rate) if sponge is None else
                    ref_poseidon.hash_many(xs, rate, sponge[0], sponge[1]))
            if lane_ints(got, lane) != want:
                raise AssertionError(f"fr_poseidon_permute {label}: lane {lane} differs from "
                                     "the host's")
        log(f"fr_poseidon_permute {label}: lanes 0, 2, {x.shape[-1] - 1} equal the host's")
    del host_cases, wide_cases, x, got, kernel
    for rate in (0, -1):
        try:
            poseidon.hash_fixed(fr_state(2, 32), rate)
        except ValueError:
            continue
        raise AssertionError(f"hash_fixed took rate {rate}")
    log("hash_fixed refuses rates 0 and -1 (no slot to absorb into); rates 1, 2, 3, 4, 8 "
        f"and {', '.join(map(str, POSEIDON_WIDE_RATES))} ran above")

    # the epoch program of the fixture's epoch, all 12 steps in one launch,
    # both variants launched directly at every (B, K) a path launches, the
    # global one also at log degree 16 over 8 nonces and 20 over 2, against
    # 12 epoch_step_plain: every selector present at every step (for K < 4
    # at some step), edge leaves 0, 1, p - 1. The bound counts one product a
    # lane a step, as the kernels run it, and the leaves, the coefficients
    # and the tables each variant reads once
    def epoch_case(k, batch, variant, label=None):
        """The program at K = k lanes over ``batch`` nonces: edge leaves 0, 1,
        p - 1 in lanes 0-2 of nonce 0 and in lane 0 of nonces 0-2; the
        selectors of lanes 0-3 set to 0-3 at every step (for K < 4: lane k's
        at step s to (s + k) mod 4). ``variant``: "cluster" (fr_epoch_program
        at epoch_cluster's size) or "global" (fr_epoch_program_global),
        both on the program's side tables, built before the call."""
        pk = puzzle_mod.EpochProgram(bytes.fromhex(fixture["epoch_hash"]), k)
        sels = pk.sels.reshape(puzzle_mod.EPOCH_STEPS, k).clone()
        if k >= 4:
            sels[:, :4] = torch.arange(4, dtype=torch.int32)
        else:
            sels = (torch.arange(puzzle_mod.EPOCH_STEPS).unsqueeze(1)
                    + torch.arange(k)).remainder(4).to(torch.int32)
        pk = puzzle_mod.EpochProgram.from_tensors(pk.epoch_hash, pk.perms,
                                                  sels.reshape(puzzle_mod.EPOCH_STEPS, 1, k),
                                                  pk.consts, dev)
        ps, cw = pk.side_tables()
        v = torch.from_numpy(FR.random(batch * k, rng).reshape(FR.nlimbs, batch, k)).to(dev)
        edges = torch.from_numpy(FR.encode_fast([0, 1, FR.p - 1], mont=True)).to(dev)
        v[:, 0, :min(3, k)] = edges[:, :min(3, k)]
        v[:, :min(3, batch), 0] = edges[:, :min(3, batch)]
        steps, n = puzzle_mod.EPOCH_STEPS, batch * k
        if variant == "cluster":
            cluster = puzzle_mod.epoch_cluster(k)[0]
            kfn = lambda: puzzle_mod.program_kernel_cluster(v, ps, cw, cluster)  # noqa: E731
        else:
            kfn = lambda: puzzle_mod.program_kernel_global(v, ps, cw)  # noqa: E731
        return (label or f"(16, {batch}, {k}) x {steps} steps", kfn, lambda: pk.apply_plain(v),
                2 * 16 * 4 * n + steps * k * (4 + 8 * 4), steps * n * FR_MUL_OPS)

    # (B, K): every shape a path launches the program at (the prover at b8
    # and b16, and at b2 and b4, the node's smaller nonce batches, which
    # bracket the rule's threshold; check_binding at b1, log degree 0-3 at
    # b8) and the cluster entry's largest K
    rule_shapes = [(BATCH, 4096), (BATCH_WIDE, 4096), (2, 4096), (4, 4096), (1, 4096),
                   *((BATCH, k) for k in EPOCH_SMALL_K), (1, EPOCH_CLUSTER_MAX_K)]
    label20 = f"(16, 2, {1 << 20}) x {puzzle_mod.EPOCH_STEPS} steps"
    check("fr_epoch_program", "snarkos_tpu_torch/csrc/fr_passes.cu",
          "snarkos_tpu/ops/modarith.py:171",
          [epoch_case(k, b, "cluster") for b, k in rule_shapes],
          puzzle_mod.program_kernel_cluster)
    check("fr_epoch_program_global", "snarkos_tpu_torch/csrc/fr_passes.cu",
          "snarkos_tpu/ops/modarith.py:171",
          [epoch_case(1 << 16, BATCH, "global"), epoch_case(1 << 20, 2, "global", label20),
           *(epoch_case(k, b, "global") for b, k in rule_shapes)],
          puzzle_mod.program_kernel_global, big=True)
    # the two variants side by side, and the code's own traffic of the
    # global one: 96 bytes a lane a step (x, its partner, the write) and 36
    # a lane's table entries a step (the constant's words, the wiring word)
    dev_ms = {k["name"]: {s["shape"]: s["device_ms"] for s in k["shapes"]}
              for k in kernels[-2:]}
    readings = []
    for b, k in rule_shapes:
        shape = f"(16, {b}, {k}) x {puzzle_mod.EPOCH_STEPS} steps"
        cl, gl = dev_ms["fr_epoch_program"][shape], dev_ms["fr_epoch_program_global"][shape]
        readings.append({"B": b, "K": k, "cluster_ms": cl, "global_ms": gl,
                         "faster": "cluster" if cl <= gl else "global",
                         "epoch_plan": puzzle_mod.epoch_plan(b, k)[0]})
        log(f"epoch program (B, K) = ({b}, {k}): cluster {cl:.4f} / global {gl:.4f} device ms; "
            f"faster {readings[-1]['faster']}, epoch_plan picks {readings[-1]['epoch_plan']}")
    report["epoch_variants"] = readings
    for b, k in ((BATCH, 1 << 16), (2, 1 << 20)):
        traffic = puzzle_mod.EPOCH_STEPS * (96 * b * k + 36 * k)
        log(f"fr_epoch_program_global (16, {b}, {k}): its own traffic {traffic} bytes, "
            f"{bound(traffic, 0)[0]:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s")

    def coords(p):
        return (p.x, p.y, p.z)

    # B2's add at the generic engine's widths: K = 4096 lanes (2^16 bases),
    # and 16 and 8 (batch_verify's padded MSMs with an identity base)
    b2 = []
    for width in (GENERIC_K, 16, 8):
        pa, pb, ops = point_pairs(width)
        b2.append((f"(24, {width})",
                   lambda pa=pa, pb=pb: coords(g1_kernels.add_kernel(pa, pb)),
                   lambda pa=pa, pb=pb: coords(g1.add(pa, pb)), 9 * 24 * 4 * width, ops))
    check("g1_add", "snarkos_tpu_torch/csrc/g1_add.cu", "snarkos_tpu/ops/g1_pallas.py:75",
          b2, g1_kernels.add_kernel)

    # B2's window tail: the Horner chain, one launch a MSM, at the paths'
    # shapes (b8, b16: W = 43 windows of c = 6 at widths 8 and 16; 2^20: 19
    # of c = 14 at width 1). Window points are rescaled multiples of H, so the
    # host follows each lane as k H. Lane 0's two top windows are identities
    # with arbitrary X, Y (its acc is such an identity for a window: skipped,
    # not doubled); window 0 of lanes 1 and 2 (width >= 3), or of lane 0
    # (width 1), is 2^c acc or -2^c acc: the last add meets P == Q or P == -Q.
    r_ord = params.FR_MODULUS

    def chain_case(W, width, c, sign=1):
        logs = [[prng.randrange(4096) + 1 for _ in range(width)] for _ in range(W)]
        for w in (W - 1, W - 2):
            logs[w][0] = 0
        edges = [(1, 1), (2, -1)] if width >= 3 else [(0, sign)]
        ops, finals = 0, []
        for e in range(width):
            k = 0
            for w in range(W - 1, -1, -1):
                if k:
                    ops += 7 * c * FQ_MUL_OPS
                k = k * (1 << c) % r_ord
                for lane, sgn in edges:
                    if lane == e and w == 0:
                        logs[0][e] = k if sgn > 0 else r_ord - k
                t = logs[w][e]
                if k and t:
                    ops += (23 if t == k else 16) * FQ_MUL_OPS
                k = (k + t) % r_ord
            finals.append(k)
        pts = [[rescale(ref_g1.scalar_mul(v, H)) if v else
                (prng.randrange(FQ.p), prng.randrange(FQ.p), 0) for v in row] for row in logs]
        enc = [g1.encode_points(row, dev) for row in pts]
        ts = tuple(torch.stack([getattr(p, k) for p in enc]).contiguous() for k in "xyz")
        want = [ref_g1.affine(ref_g1.scalar_mul(k, H)) if k else None for k in finals]
        label = f"({W}, 24, {width}) c={c}"
        if width < 3:
            label += f", last add P == {'+' if sign > 0 else '-'}Q"
        chain_want[label] = want
        return (label, lambda: coords(g1_kernels.horner_chain_kernel(ts, c)),
                lambda: coords(g1_kernels.horner_chain_plain(ts, c)),
                3 * 24 * 4 * width * (W + 1), ops)

    chain_want = {}

    def chain_host(label, got):
        """every lane's result is (its k) H on the host"""
        for e, (p, k) in enumerate(zip(g1.decode_points(g1.JacobianPoints(*got)),
                                       chain_want[label])):
            if ref_g1.affine(p) != k:
                raise AssertionError(f"g1_horner_chain {label}: lane {e} is not its k H")

    W6 = -(-(msm.SCALAR_BITS + 1) // 6)
    W14 = -(-(msm.SCALAR_BITS + 1) // 14)
    check("g1_horner_chain", "snarkos_tpu_torch/csrc/window_tail.cu",
          "snarkos_tpu/ops/g1_pallas.py:75",
          [chain_case(W6, BATCH, 6), chain_case(W6, BATCH_WIDE, 6), chain_case(W14, 1, 14),
           chain_case(W14, 1, 14, sign=-1)], g1_kernels.horner_chain_kernel, big=True,
          verify=chain_host)

    # its latency: width 1, W = TAIL_SWEEP_W windows, over c; ms = a + b c
    # (the top window's acc is the identity and is not doubled, so b / (W -
    # 1) is one doubling and a / W about one add); the chain figure of each
    # path shape: the products on a lane's longest dependent path (3 c + 5 a
    # window here, 7 c + 16 on one thread) times STEP0_PRODUCT_MS
    sweep_ms = []
    for cc in TAIL_SWEEP_C:
        enc = [g1.encode_points([rescale(multiples[prng.randrange(4096)])], dev)
               for _ in range(TAIL_SWEEP_W)]
        tsw = tuple(torch.stack([getattr(p, k) for p in enc]).contiguous() for k in "xyz")
        sweep_ms.append(graph_ms(lambda tsw=tsw, cc=cc: g1_kernels.horner_chain_kernel(tsw, cc),
                                 7, 20))
    n_c = len(TAIL_SWEEP_C)
    mc, mm = sum(TAIL_SWEEP_C) / n_c, sum(sweep_ms) / n_c
    fit_b = sum((x - mc) * (y - mm) for x, y in zip(TAIL_SWEEP_C, sweep_ms)) / \
        sum((x - mc) ** 2 for x in TAIL_SWEEP_C)
    fit_a = mm - fit_b * mc
    figures = {}
    for W_, c_ in ((W6, 6), (W14, 14)):
        figures[f"W={W_} c={c_}"] = {
            "team": ((W_ - 1) * 3 * c_ + 5 * W_) * STEP0_PRODUCT_MS,
            "one thread": ((W_ - 1) * 7 * c_ + 16 * W_) * STEP0_PRODUCT_MS}
    log(f"g1_horner_chain width 1, W = {TAIL_SWEEP_W}: device ms {[round(v, 4) for v in sweep_ms]} "
        f"at c = {list(TAIL_SWEEP_C)}; fit a = {fit_a:.4f} ms, b = {fit_b:.5f} ms: a doubling "
        f"{fit_b / (TAIL_SWEEP_W - 1):.5f} ms, an add about {fit_a / TAIL_SWEEP_W:.5f} ms; chain "
        "figures (path products x the one-step entry's product latency): "
        + ", ".join(f"{k} {v['team']:.3f} ms (one thread {v['one thread']:.3f})"
                    for k, v in figures.items()) + f"; on {smi}")
    report["tail_sweep"] = {"W": TAIL_SWEEP_W, "c": list(TAIL_SWEEP_C), "device_ms": sweep_ms,
                            "a_ms": fit_a, "b_ms": fit_b, "chain_figure_ms": figures}

    # a real window of the batch-8 multi-MSM: base = 4096 affine points tiled
    # 8 times, random scalars, c = 6, K = 256 chains of m = 128
    base = g1.encode_points(multiples, dev)
    c = msm.fused_window_bits(4096)
    B = (1 << (c - 1)) + 1

    def multi_window(batch, serial):
        """Chain layout of the middle window of a batch-``batch`` multi-MSM
        over ``base`` with random scalars, with edge steps P == Q and P == -Q
        inside chains 0-7 (each a head, then its copy or its negation); on
        serial chains also across the sub-run boundaries s-1 | s of B4's
        teams, s = 1, 2, 4, 8 (chains 8-23)."""
        nn = batch * 4096
        K = msm._default_lanes(nn)
        x = base.x.repeat(1, batch)
        ycat = torch.cat([base.y.repeat(1, batch), fa.neg(FQ, base.y).repeat(1, batch)], dim=-1)
        packed = msm.signed_window_digits(torch.from_numpy(FR.random(nn, rng)).to(dev), c)
        src = msm.chain_src(nn, K, msm_kernels.CHUNK, serial, dev)
        batch_off = (torch.arange(nn, device=dev) // 4096) * B
        _, xs, ys, heads = msm.chain_layout(x, ycat, packed[packed.shape[0] // 2], src, batch_off)
        rows = 1 if serial else msm_kernels.CHUNK
        j0, j1 = 4 * rows, 5 * rows  # steps 4 and 5 of the chains in layout row 0
        xs, ys, heads = xs.clone(), ys.clone(), heads.clone()
        edges = [(k, j0, j1) for k in range(8)]
        if serial:
            edges += [(8 + 4 * i + r, s - 1, s) for i, s in enumerate((1, 2, 4, 8)) for r in range(4)]
        for k, a, b in edges:
            xs[:, b, k], ys[:, b, k], heads[a, k], heads[b, k] = xs[:, a, k], ys[:, a, k], 1, 0
            if k % 2:
                ys[:, b, k] = fa.neg(FQ, ys[:, a, k:k + 1])[:, 0]
        return xs, ys, heads.unsqueeze(0).contiguous(), K

    def scan_cost(flags, n_dbl):
        """(bytes, multiplies) of a bucket scan: affine inputs and head flags
        read, Jacobian outputs written; 11 Fq products a non-head step, 6
        more for a doubling."""
        npos = flags.numel()
        return ((2 * 24 * 4 + 4 + 3 * 24 * 4) * npos,
                ((npos - int(flags.sum())) * 11 + 6 * n_dbl) * FQ_MUL_OPS)

    # B4 on windows of the batch-8 and batch-1 multi-MSMs, each of the team
    # sizes of the sweep at batch 8 (the path's team first); 12 doublings:
    # the even edge chains
    xs, ys, flags, K = multi_window(BATCH, serial=True)
    m = xs.shape[1]
    xs1, ys1, fl1, K1 = multi_window(1, serial=True)
    m1 = xs1.shape[1]
    team = msm_kernels.SERIAL_TEAM

    def plain8():
        return msm_kernels.bucket_scan_serial_plain(xs, ys, flags)

    b4 = [(f"(24, {m}, {K}) T={t}",
           lambda t=t: msm_kernels.bucket_scan_serial_kernel(xs, ys, flags, team=t),
           plain8, *scan_cost(flags, 12))
          for t in [team] + [t for t in TEAM_SWEEP if t != team]]
    b4.append((f"(24, {m1}, {K1}) T={min(team, m1)}",
               lambda: msm_kernels.bucket_scan_serial_kernel(xs1, ys1, fl1),
               lambda: msm_kernels.bucket_scan_serial_plain(xs1, ys1, fl1), *scan_cost(fl1, 12)))
    check("bucket_scan_serial", "snarkos_tpu_torch/csrc/bucket_scan_serial.cu",
          "snarkos_tpu/ops/msm_pallas.py:265", b4, msm_kernels.bucket_scan_serial_kernel,
          exact=False)

    # the 2^20 single MSM's bases (the dev SRS powers, tau^i known) and scalars
    N = 1 << LOG_N
    bx, by = srs.points.x[:, :N].contiguous(), srs.points.y[:, :N].contiguous()
    big_scalars = torch.from_numpy(FR.random(N, np.random.default_rng(20))).to(dev)
    c20 = msm.fused_window_bits(N)
    K20 = msm._default_lanes(N)
    src20 = msm.chain_src(N, K20, msm_kernels.CHUNK, False, dev)
    packed20 = msm.signed_window_digits(big_scalars, c20)
    keys20, xs20, ys20, heads20 = msm.chain_layout(
        bx, torch.cat([by, fa.neg(FQ, by)], dim=-1), packed20[packed20.shape[0] // 2], src20)
    fl20 = heads20.unsqueeze(0).contiguous()
    m20 = xs20.shape[1]

    # a window of the batch-16 multi-MSM (B3's widths, B5)
    xs16, ys16, fl16, K16 = multi_window(BATCH_WIDE, serial=False)

    # B2's bucket fixup on real windows of the three paths, as the engine
    # makes its inputs: the sorted keys and head flags of chain_layout, the
    # path's bucket scan (B4 on b8's serial chains, B5 on b16's and the 2^20
    # MSM's wide chains) and B3's prefix of the chain finals; each window
    # also with, at its buckets whose runs cross a chain start, in turn a
    # carry equal to the tail (P == Q), its negation (P == -Q), a carry that
    # is an identity and a tail that is one (arbitrary X, Y).
    def engine_window(batch):
        """(scan, keys, heads, summ), K, rows, nbatch, B of the middle
        window of prove_batch(batch)'s multi-MSMs, or of the 2^20 MSM for
        batch None."""
        if batch is None:
            keys, xs_, ys_, heads = keys20, xs20, ys20, heads20
            K, serial, nbatch, B_ = K20, False, 1, (1 << (c20 - 1)) + 1
        else:
            nn = batch * 4096
            K, serial, nbatch, B_ = msm._default_lanes(nn), nn <= msm_kernels.SERIAL_MAX_N, batch, B
            x = base.x.repeat(1, batch)
            ycat = torch.cat([base.y.repeat(1, batch), fa.neg(FQ, base.y).repeat(1, batch)], -1)
            packed = msm.signed_window_digits(torch.from_numpy(FR.random(nn, rng)).to(dev), c)
            src = msm.chain_src(nn, K, msm_kernels.CHUNK, serial, dev)
            batch_off = (torch.arange(nn, device=dev) // 4096) * B
            keys, xs_, ys_, heads = msm.chain_layout(x, ycat, packed[packed.shape[0] // 2], src,
                                                     batch_off)
        rows = 1 if serial else msm_kernels.CHUNK
        fl = heads.unsqueeze(0).contiguous()
        scan = (msm_kernels.bucket_scan_serial(xs_, ys_, fl, K) if serial
                else msm_kernels.bucket_scan(xs_, ys_, fl, K, msm_kernels.CHUNK))
        mv = heads.shape[0] // rows
        flag = heads.reshape(mv, rows, K).max(0).values.reshape(1, K * rows)
        finals = tuple(t[:, -rows:, :].reshape(24, K * rows) for t in scan)
        summ = g1_kernels.seg_prefix((flag,) + finals)[1:]
        return (tuple(t.contiguous() for t in scan), keys, heads, tuple(summ)), K, rows, nbatch, B_

    def fixup_case(batch, planted):
        args, K, rows, nbatch, B_ = engine_window(batch)
        flat, chain_of, needs, live = g1_kernels.bucket_indices(args[1], args[2], K, rows, nbatch,
                                                                B_)
        takers = (live & needs & (chain_of > 0)).nonzero().reshape(-1)
        n_dbl = n_inf = 0
        if planted:
            scan = [t.clone() for t in args[0]]
            summ = [t.clone() for t in args[3]]
            sflat = [t.reshape(24, -1) for t in scan]
            for i, b in enumerate(takers.tolist()):
                f, l = int(flat[b]), int(chain_of[b]) - 1
                if i % 4 < 2:  # P == Q, P == -Q
                    summ[0][:, l] = sflat[0][:, f]
                    summ[1][:, l] = (sflat[1][:, f] if i % 4 == 0
                                     else fa.neg(FQ, sflat[1][:, f:f + 1])[:, 0])
                    summ[2][:, l] = sflat[2][:, f]
                    n_dbl += i % 4 == 0
                elif i % 4 == 2:
                    summ[2][:, l] = 0
                    n_inf += 1
                else:
                    sflat[2][:, f] = 0
                    n_inf += 1
            args = (tuple(scan), args[1], args[2], tuple(summ))
        n_add = int(takers.numel()) - n_inf
        nb = nbatch * B_
        i_of = flat // (rows * K)
        nbytes = (3 * 24 * 4 * (int(live.sum()) + int(takers.numel()) + nb)
                  + 8 * nb * (args[1].shape[0].bit_length() + 1)
                  + 4 * int((i_of + 1)[live].sum()))
        label = (f"(24, {nb}) of ({args[1].shape[0]}, {K * rows}), "
                 + ("b%d" % batch if batch else "2^20") + (" planted" if planted else ""))
        return (label, lambda: coords(g1_kernels.bucket_fixup_kernel(*args, K, rows, nbatch, B_)),
                lambda: coords(g1_kernels.bucket_fixup_plain(*args, K, rows, nbatch, B_)), nbytes,
                (16 * n_add + 7 * n_dbl) * FQ_MUL_OPS)

    check("g1_bucket_fixup", "snarkos_tpu_torch/csrc/window_tail.cu",
          "snarkos_tpu/ops/g1_pallas.py:75",
          [fixup_case(b_, p_) for b_ in (BATCH, BATCH_WIDE, None) for p_ in (False, True)],
          g1_kernels.bucket_fixup_kernel)

    # B3 at the seven prefix widths of the paths, with their head flags: the
    # cross-chain carries (one flag per chain: any head in it) and the
    # bucket suffix scans (per-batch segments of B buckets, or none)
    def chain_heads(fl, rows):
        return fl.reshape(-1, rows, fl.shape[-1]).max(0).values.reshape(-1)

    def batch_heads(batch):
        return (torch.arange(batch * B, device=dev) % B == 0).to(torch.int32)

    def prefix_case(width, fl):
        """Random rescaled points, identities with arbitrary X, Y at every
        16th lane, and at lanes 2-15 (and again from width / 2) the edges
        where round 0 meets P == Q and P == -Q and round 1 (distance 2)
        meets (A + B) + (A + B) and (A + B) + (-A - B)."""
        pts = [rescale(multiples[prng.randrange(4096)]) for _ in range(width)]
        heads = [int(v) for v in fl.reshape(-1).tolist()]
        for e in range(7, width, 16):
            pts[e] = (prng.randrange(FQ.p), prng.randrange(FQ.p), 0)
        for base in sorted({0, width // 2 if width >= 64 else 0}):
            A, Bp = multiples[prng.randrange(4096)], multiples[prng.randrange(4096)]
            block = {3: A, 4: A, 5: Bp, 6: ref_g1.neg(Bp), 8: A, 9: Bp, 10: A, 11: Bp,
                     12: A, 13: Bp, 14: ref_g1.neg(A), 15: ref_g1.neg(Bp)}
            for off, pt in block.items():
                pts[base + off] = rescale(pt)
                heads[base + off] = int(off in (3, 5, 8, 12))
        enc = g1.encode_points(pts, dev)
        state = (torch.tensor([heads], dtype=torch.int32, device=dev), enc.x, enc.y, enc.z)
        n_add = sum(1 for h in heads[1:] if not h)  # a sequential scan's additions
        return (f"(24, {width})", lambda: g1_kernels.seg_prefix_kernel(*state),
                lambda: g1_kernels.seg_prefix_plain(state),
                2 * (1 + 3 * 24) * 4 * width, 16 * n_add * FQ_MUL_OPS)

    kv20 = msm_kernels.CHUNK * K20

    def zeros(w):
        return torch.zeros(w, dtype=torch.int32, device=dev)

    check("seg_prefix", "snarkos_tpu_torch/csrc/seg_prefix.cu",
          "snarkos_tpu/ops/g1_pallas.py:125",
          [prefix_case(K, chain_heads(flags, 1)), prefix_case(BATCH * B, batch_heads(BATCH)),
           prefix_case(msm_kernels.CHUNK * K16, chain_heads(fl16, msm_kernels.CHUNK)),
           prefix_case(BATCH_WIDE * B, batch_heads(BATCH_WIDE)),
           prefix_case(kv20, chain_heads(fl20, msm_kernels.CHUNK)),
           prefix_case(K1, chain_heads(fl1, 1)), prefix_case(B, zeros(B)),
           prefix_case(GENERIC_K, torch.from_numpy((rng.random(GENERIC_K) < 0.05)
                                                   .astype(np.int32)).to(dev)),
           prefix_case(16, zeros(16))],
          g1_kernels.seg_prefix_kernel)

    # Edge steps for the wide scans B5 and B6 (element i of chain (r, k) a
    # head, i + 1 its copy or its negation): mid-chain (10 | 11), on both
    # sides of every sub-run boundary of the team sweep (s - 2 | s - 1: the
    # last step of member 0; s - 1 | s: the first step of member 1, from its
    # carry) and at the chain start (element 0 no head, element 1 its copy or
    # negation), two chains each (P == Q, P == -Q).
    chunk = msm_kernels.CHUNK

    def edge_steps(mv):
        return [10, 0] + sorted({s + d for t in WIDE_TEAM_SWEEP for s in [-(-mv // t)]
                                 for d in (-2, -1)} & set(range(1, mv - 1)))

    def edge_chains(steps):
        return [((0, 3, 7)[i % 3], 100 + 3 * i) for i in range(2 * len(steps))]

    def plant_edges(xs, ys, fl, edges):
        """Copies of the chain layout with the edge steps (r, k, i) planted;
        odd entries of ``edges`` negate."""
        xs, ys, fl = xs.clone(), ys.clone(), fl.clone()
        for idx, (r, k, i) in enumerate(edges):
            j0, j1 = i * chunk + r, (i + 1) * chunk + r
            xs[:, j1, k], ys[:, j1, k], fl[0, j0, k], fl[0, j1, k] = xs[:, j0, k], ys[:, j0, k], 1, 0
            if i == 0:
                fl[0, j0, k] = 0  # the chain starts mid-segment
            if idx % 2:
                ys[:, j1, k] = fa.neg(FQ, ys[:, j0, k:k + 1])[:, 0]
        return xs, ys, fl

    # B6 on the 2^20 window with the edge steps in live buckets, where
    # exactly those chains must flag, and in bucket 0 (the first ~64 sorted
    # positions, all in chain 0), where the flag must stay clear.
    nz20 = (keys20 > 0).to(torch.int32)[src20.reshape(-1)].reshape(1, m20, K20).contiguous()
    mv20 = m20 // chunk
    steps = edge_steps(mv20)
    live_chains = edge_chains(steps)
    edges = [(r, k, steps[idx // 2]) for idx, (r, k) in enumerate(live_chains)]
    edges += [(0, 0, 10), (0, 0, 20), (0, 0, 15), (0, 0, 31)]
    xs6, ys6, fl6 = plant_edges(xs20, ys20, fl20, edges)
    for r, k, i in edges:
        j0, j1 = i * chunk + r, (i + 1) * chunk + r
        live = (r, k) in live_chains
        if int(nz20[0, j0, k]) != live or int(nz20[0, j1, k]) != live:
            raise AssertionError(f"B6 edge step at chain ({r}, {k}) is not where it was meant")
    want_exc = torch.zeros((1, chunk, K20), dtype=torch.int32, device=dev)
    for r, k in live_chains:
        want_exc[0, r, k] = 1
    log(f"B6 edge steps at elements {steps} (live, {len(live_chains)} chains) and "
        "10, 20, 15, 31 (bucket 0)")

    def exc_exact(label, got):
        if not torch.equal(got[3], want_exc):
            raise AssertionError(f"bucket_scan_fast {label}: exc set in chains "
                                 f"{got[3].nonzero().tolist()}, want {live_chains}")
        log(f"bucket_scan_fast {label}: exc set in exactly the {len(live_chains)} edge chains")

    def b6_compare(got, want):
        """exc exactly; the same points at every position of a live bucket
        in an unflagged chain (chain of flat position e: e % KV)."""
        if not torch.equal(got[3], want[3]):
            raise AssertionError("bucket_scan_fast: exc differs from the plain version's")
        flagged = want[3].reshape(-1)[torch.arange(m20 * K20, device=dev) % (chunk * K20)]
        mask = (nz20.reshape(-1) != 0) & (flagged == 0)
        return affine_err(got[:3], want[:3], mask)

    def plain6():
        return msm_kernels.bucket_scan_fast_plain(xs6, ys6, fl6, nz20, chunk)

    b6_bytes, b6_ops = scan_cost(fl6, 0)  # plus the nonzero flags read, exc written
    team6 = msm_kernels.FAST_TEAM
    check("bucket_scan_fast", "snarkos_tpu_torch/csrc/bucket_scan_fast.cu",
          "snarkos_tpu/ops/msm_pallas.py:138",
          [(f"(24, {m20}, {K20}) T={t}",
            lambda t=t: msm_kernels.bucket_scan_fast_kernel(xs6, ys6, fl6, nz20, chunk, team=t),
            plain6, b6_bytes + 4 * m20 * K20 + 4 * chunk * K20, b6_ops)
           for t in [team6] + [t for t in WIDE_TEAM_SWEEP if t != team6]],
          msm_kernels.bucket_scan_fast_kernel, big=True, verify=exc_exact, compare=b6_compare)

    # B5 on the batch-16 window with the edge steps planted, and on B6's 2^20
    # window (its edges in live buckets and in bucket 0), at each team size of
    # the sweep (the path's first): the same points at every position
    mv16 = xs16.shape[1] // chunk
    steps16 = edge_steps(mv16)
    xs5, ys5, fl5 = plant_edges(xs16, ys16, fl16, [
        (r, k, steps16[idx // 2]) for idx, (r, k) in enumerate(edge_chains(steps16))])
    n_dbl16 = 4 + len(steps16)  # the doublings: multi_window's 4 and one a step here
    team5 = msm_kernels.SCAN_TEAM
    sweep5 = [team5] + [t for t in WIDE_TEAM_SWEEP if t != team5]
    log(f"B5 edge steps at elements {steps16} (batch 16) and {steps} (2^20)")

    def plain5_16():
        return msm_kernels.bucket_scan_plain(xs5, ys5, fl5, chunk)

    def plain5_20():
        return msm_kernels.bucket_scan_plain(xs6, ys6, fl6, chunk)

    check("bucket_scan", "snarkos_tpu_torch/csrc/bucket_scan.cu",
          "snarkos_tpu/ops/msm_pallas.py:173",
          [(f"(24, {xs5.shape[1]}, {K16}) T={t}",
            lambda t=t: msm_kernels.bucket_scan_kernel(xs5, ys5, fl5, chunk, team=t),
            plain5_16, *scan_cost(fl5, n_dbl16)) for t in sweep5]
          + [(f"(24, {m20}, {K20}) T={t}",
              lambda t=t: msm_kernels.bucket_scan_kernel(xs6, ys6, fl6, chunk, team=t),
              plain5_20, *scan_cost(fl6, len(steps) + 2)) for t in sweep5],
          msm_kernels.bucket_scan_kernel, big=True, exact=False)

    # B7, the weighted bucket total of a window, at the 2^20 MSM's B = 2^13 +
    # 1 (the path's setting first, without the suffixes, as the path calls
    # it; then the sweep, each with every suffix) and at the c = 16 MSM's B =
    # 2^15 + 1. The kernel reads the live buckets in reverse, element r =
    # bucket B - 1 - r; at the thread and block boundaries of every setting
    # (r = k s, r = k T s) the planted pairs give P == Q and P == -Q across the
    # boundary, and identities (arbitrary X, Y) sit on both sides of another;
    # elements 0 and 1 cancel (a suffix is the identity). Then an
    # all-identity input (T_w is the identity).
    def total_case(B, sweep):
        pts = [rescale(multiples[prng.randrange(4096)]) for _ in range(B)]

        def at(r):
            return B - 1 - r

        def pair(r, neg):
            if 0 < r < B - 1:
                q = pts[at(r - 1)]
                pts[at(r)] = rescale(ref_g1.neg(q) if neg else q) if q[2] else q

        for T, s_ in sweep:
            for k, bound in enumerate((s_, 2 * s_, T * s_, 2 * T * s_)):
                pair(bound, k % 2 == 1)
            for bound in (3 * s_, 3 * T * s_):
                for r in (bound - 1, bound):
                    if r < B - 1:
                        pts[at(r)] = (prng.randrange(FQ.p), prng.randrange(FQ.p), 0)
        pts[at(1)] = rescale(ref_g1.neg(pts[at(0)]))
        p = g1.encode_points(pts, dev)
        n_fin = sum(1 for q in pts[1:] if q[2])
        return (p.x, p.y, p.z), n_fin

    def total_bound(B, n_fin, suffixes):
        """Buckets read once, T_w (and the suffixes) written once; the 2 n_fin
        complete adds of a serial scan and total (16 Fq products each)."""
        return 3 * 24 * 4 * (B + 1 + (B if suffixes else 0)), 2 * n_fin * 16 * FQ_MUL_OPS

    def b7_compare(got, want):
        """T_w the same point; with the suffixes (a kernel run with scan_out),
        every suffix the same point too."""
        if len(got) == 2:
            return max(affine_err(got[0], want[0]), affine_err(got[1], want[1]))
        return affine_err(got, want[0])

    b7 = []
    for B7, sweep in (((1 << 13) + 1, TOTAL_SWEEP), ((1 << 15) + 1, TOTAL_SWEEP_WIDE)):
        sums7, n_fin7 = total_case(B7, sweep)

        def plain7(sums7=sums7):
            return msm_kernels.bucket_total_plain(*sums7)

        if B7 == (1 << 13) + 1:
            b7.append((f"(24, {B7}) T={msm_kernels.BUCKET_THREADS} "
                       f"s={msm_kernels.BUCKET_PER_THREAD}, path",
                       lambda sums7=sums7: msm_kernels.bucket_total_kernel(*sums7), plain7,
                       *total_bound(B7, n_fin7, False)))
        b7 += [(f"(24, {B7}) T={t} s={s_}, suffixes",
                lambda sums7=sums7, t=t, s_=s_: msm_kernels.bucket_total_kernel(
                    *sums7, threads=t, per_thread=s_, scan_out=True),
                plain7, *total_bound(B7, n_fin7, True)) for t, s_ in sweep]
    # the generic engine's B = 2^c: bucket 0 holds a point the total ignores
    for B7 in (1 << GENERIC_C, 16):
        sums7, n_fin7 = total_case(B7, ((msm_kernels.BUCKET_THREADS, 1),))
        b7.append((f"(24, {B7}) generic",
                   lambda sums7=sums7: msm_kernels.bucket_total_kernel(*sums7),
                   lambda sums7=sums7: msm_kernels.bucket_total_plain(*sums7),
                   *total_bound(B7, n_fin7, False)))
    ids7 = g1.encode_points([(prng.randrange(FQ.p), prng.randrange(FQ.p), 0)
                             for _ in range((1 << 13) + 1)], dev)
    ids7 = (ids7.x, ids7.y, ids7.z)

    def no_total(label, got):
        if "identities" in label and int(got[0][2].abs().sum()) != 0:
            raise AssertionError(f"jadd_bucket_total {label}: T_w is not the identity")

    b7.append((f"(24, {(1 << 13) + 1}) all identities, suffixes",
               lambda: msm_kernels.bucket_total_kernel(*ids7, scan_out=True),
               lambda: msm_kernels.bucket_total_plain(*ids7), *total_bound((1 << 13) + 1, 0, True)))
    check("jadd_bucket_total", "snarkos_tpu_torch/csrc/jadd_scan.cu",
          "snarkos_tpu/ops/msm_pallas.py:303", b7, msm_kernels.bucket_total_kernel,
          compare=b7_compare, verify=no_total)

    # The generic engine's window: g1_lane_buckets and g1_lane_bucket_carry
    # on real windows (the keys sorted, the points gathered in that order) of
    # the verifier's padded MSMs with an identity witness (m = 1: 16 and 8
    # of phase 6's bases, c = 4, K = n), the generic msm(2^16) (phase 6's
    # bases: rescaled SRS powers, every 64th an identity; m = 16) and
    # msm_dist(2^20) (the dev SRS powers, identities planted at every 1000th
    # position; m = 256), K = 4096 lanes, with edges planted by changing the
    # keys (they stay sorted): at lane offsets 0, s - 1 for each member
    # length s of the sweep, and m - 2, a run start followed by its copy
    # (P == Q) or its negation (P == -Q), alternately; a run starting at the
    # last position of lane 5 and going on into lane 6; one run over lanes
    # 60-63 (lanes 61 and 62 have no tail; at m = 1 lanes K - 6 to K - 3).
    # g1_lane_buckets is held to its plain version at every bucket and
    # lane aggregate (the same points) and its aggregate flags, first heads
    # and carry keys exactly, at each plan of its sweep (the path's first);
    # g1_lane_bucket_carry limb for limb; the whole (the G1 group's
    # window_bucket_sums: both entries around one B3 prefix) against the
    # JAX order (the lane fold and the tails' gather) at every bucket.
    NG = 1 << LOG_GENERIC
    gen_pts = [rescale(p) for p in srs.srs_ref.powers_g1[:NG]]  # z != 1
    for i in range(0, NG, 64):  # every 64th an identity
        gen_pts[i] = ref_g1.INFINITY
    gen_scalars = FR.random(NG, np.random.default_rng(16))
    gen_scalars[:, ::97] = 0
    gen_base = g1.encode_points(gen_pts, dev)
    gen_k = torch.from_numpy(gen_scalars).to(dev)

    def lane_window(points, keys):
        """(keys (N,), x, y, z) of a window: the keys sorted, the points in
        their stable order."""
        keys, order = torch.sort(keys, stable=True)
        return (keys,) + tuple(t[..., order] for t in points)

    def plant_lane_edges(win, m, sweep, B):
        """A copy of the window with the edges above: lanes 8 i + 1 for the
        edge at offset i of the list (i < 7), lane 5's last position a run
        start whose run goes on, lanes 60-63 in one run (K >= 64; K - 6 to
        K - 3 for 16 <= K < 64)."""
        keys, x, y, z = (t.clone() for t in win)
        n = keys.shape[0]
        K = n // m

        def run_start(e):
            """position e starts a run: the rest of its run moves up a key
            (at most the next run's key: the keys stay sorted), and e + 1
            joins it"""
            if e > 0 and keys[e - 1] == keys[e]:
                end = int(torch.searchsorted(keys, keys[e], right=True))
                keys[e:end] += 1
            keys[e + 1] = keys[e]

        offs = [0] + sorted({-(-m // M) - 1 for M, _ in sweep} - {0}) + [m - 2]
        offs = [i for i in dict.fromkeys(offs) if 0 <= i and (i < m - 1 or m == 1)]
        for idx, i in enumerate(offs):
            e = (8 * idx + 1) * m + i
            run_start(e)
            x[:, e + 1], y[:, e + 1], z[:, e + 1] = x[:, e], y[:, e], z[:, e]
            if idx % 2:
                y[:, e + 1] = fa.neg(FQ, y[:, e:e + 1])[:, 0]
        run_start(6 * m - 1)
        if K >= 16:
            j0 = 60 if K >= 64 else K - 6
            keys[j0 * m + 1:(j0 + 4) * m] = keys[j0 * m]
        if not bool((keys[1:] >= keys[:-1]).all()) or int(keys[-1]) >= B:
            raise AssertionError("planting the lane edges unsorted the keys or passed B")
        return (keys.contiguous(), x.contiguous(), y.contiguous(), z.contiguous()), offs

    def lane_cost(keys, K, B):
        """g1_lane_buckets: keys and points read once, the buckets and lane
        outputs written once; the serial scan's complete add a non-head
        position (16 Fq products)."""
        n = keys.numel()
        heads = 1 + int((keys[1:] != keys[:-1]).sum())
        return ((8 + 72 * 4) * n + 72 * 4 * B + (4 + 72 * 4 + 8) * K,
                (n - heads) * 16 * FQ_MUL_OPS)

    def carry_cost(carry_key, K):
        """g1_lane_bucket_carry: the carry keys read; for each carried lane
        the prefix and the bucket read, the bucket written, one complete
        add."""
        n_c = int((carry_key[1:] > 0).sum())
        return (4 * K + 3 * 72 * 4 * n_c, 16 * n_c * FQ_MUL_OPS)

    def lane_compare(got, want):
        for i, what in ((3, "aggregate flags"), (7, "first heads"), (8, "carry keys")):
            if not torch.equal(got[i], want[i]):
                raise AssertionError(f"g1_lane_buckets: its {what} differ from the plain "
                                     "version's")
        return max(affine_err(got[:3], want[:3]), affine_err(got[4:7], want[4:7]))

    lane_windows = {}
    gen_keys = msm.window_digits(gen_k, GENERIC_C)[10].long()
    k20_keys = msm.window_digits(big_scalars, msm.default_window_bits(N))[10].long()
    ids20 = g1.JacobianPoints(bx.clone(), by.clone(),
                              fa.broadcast_const(FQ, 1, (N,), device=dev).contiguous())
    ids20.z[:, ::1000] = 0  # identities with the power's X, Y
    for label, pts, keys, m_l in (
            ("2^20", (ids20.x, ids20.y, ids20.z), k20_keys, 256),
            ("2^16", coords(gen_base), gen_keys, 16),
            ("verifier 16", tuple(t[:, :16] for t in coords(gen_base)),
             msm.window_digits(gen_k[:, :16], 4)[20].long(), 1),
            ("verifier 8", tuple(t[:, 64:72] for t in coords(gen_base)),
             msm.window_digits(gen_k[:, 64:72], 4)[30].long(), 1)):
        n_l = pts[0].shape[-1]
        B_l = 1 << msm.default_window_bits(n_l)
        win, offs = plant_lane_edges(lane_window(pts, keys), m_l, LANE_SWEEP[m_l], B_l)
        tp = msm_kernels.lane_plan(m_l)  # the path's plan first
        lane_windows[label] = (win, n_l // m_l, B_l, [tp] + [p for p in LANE_SWEEP[m_l]
                                                           if p != tp])
        log(f"lane window of {label}: m = {m_l}, B = {B_l}, edges at lane offsets {offs}")
    del ids20

    lane_plains = {label: (lambda win=win, K_l=K_l, B_l=B_l:
                           g1_kernels.lane_buckets_plain(*win, K_l, B_l))
                   for label, (win, K_l, B_l, _) in lane_windows.items()}
    check("g1_lane_buckets", "snarkos_tpu_torch/csrc/lane_scan.cu",
          "snarkos_tpu/ops/g1_pallas.py:125",
          [(f"(24, {win[1].shape[-1]}) K={K_l} m={win[1].shape[-1] // K_l} B={B_l} "
            f"plan={plan} ({label})",
            lambda win=win, K_l=K_l, B_l=B_l, plan=plan:
                g1_kernels.lane_buckets_kernel(*win, K_l, B_l, plan),
            lane_plains[label], *lane_cost(win[0], K_l, B_l))
           for label, (win, K_l, B_l, plans) in lane_windows.items() for plan in plans],
          g1_kernels.lane_buckets_kernel, big=True, compare=lane_compare)

    carry_cases = []
    for label, (win, K_l, B_l, plans) in lane_windows.items():
        bxl, byl, bzl, *agg, _, ck = g1_kernels.lane_buckets_kernel(*win, K_l, B_l, plans[0])
        summ = tuple(t.contiguous() for t in g1_kernels.seg_prefix(tuple(agg))[1:])
        scratch = (bxl.clone(), byl.clone(), bzl.clone())
        carry_cases.append((
            f"(24, {B_l}) K={K_l} m={win[1].shape[-1] // K_l}, {int((ck[1:] > 0).sum())} "
            f"carries ({label})",
            lambda o=(bxl, byl, bzl), summ=summ, ck=ck:
                g1_kernels.lane_bucket_carry_kernel(*(t.clone() for t in o), *summ, ck),
            lambda o=(bxl, byl, bzl), summ=summ, ck=ck:
                g1_kernels.lane_bucket_carry_plain(*o, *summ, ck),
            *carry_cost(ck, K_l),
            lambda scratch=scratch, summ=summ, ck=ck:
                g1_kernels.lane_bucket_carry_kernel(*scratch, *summ, ck)))
    check("g1_lane_bucket_carry", "snarkos_tpu_torch/csrc/lane_scan.cu",
          "snarkos_tpu/ops/g1_pallas.py:125", carry_cases,
          g1_kernels.lane_bucket_carry_kernel, big=True)
    g1_cuda = msm.g1_group(dev)
    jax_order = dataclasses.replace(g1_cuda, window_bucket_sums=None)
    for label, (win, K_l, B_l, _) in lane_windows.items():
        whole = g1_cuda.window_bucket_sums(win[0], win[1:], K_l, B_l)
        fold = msm._window_bucket_sums(msm._default_seg_combine(jax_order), jax_order, win[0],
                                       win[1:], K_l, B_l)
        log(f"the {label} window's bucket sums (g1_lane_buckets, B3, g1_lane_bucket_carry) == "
            f"the JAX order's at every bucket (max abs err of the affine forms "
            f"{affine_err(whole, fold)})")
    del lane_windows, lane_plains, carry_cases, whole, fold

    # msm_dist(2^24)'s window, m = 4096: the 2^20 dev SRS powers tiled 16
    # times in the order of 13 random key bits, identities (with the
    # power's X, Y) at every 1000th position, the edges planted as above.
    # Each plan of the sweep is timed; the plain fold would take minutes, so
    # sampled lanes (the first, the edge lanes, lane 5, the run over lanes
    # 60-63) are held to the host's serial scan (crypto/ref/g1): at every
    # tail in them the bucket, lane-local after g1_lane_buckets and whole
    # after B3 and g1_lane_bucket_carry, and each sampled lane's aggregate;
    # every lane's flag, first head and carry key to the keys.
    n24 = 1 << DIST_MSM_LOG
    B24 = 1 << GENERIC_C
    gen24 = torch.Generator(device=dev)
    gen24.manual_seed(DIST_MSM_LOG)
    keys24, order24 = torch.sort(torch.randint(0, B24, (n24,), generator=gen24, device=dev),
                                 stable=True)
    order24 = order24 % N
    win24 = (keys24, bx[:, order24], by[:, order24],
             fa.broadcast_const(FQ, 1, (n24,), device=dev))
    del keys24, order24
    m24 = n24 // GENERIC_K
    win24, offs24 = plant_lane_edges(win24, m24, LANE_SWEEP[m24], B24)
    win24[3][:, ::1000] = 0
    plan24 = msm_kernels.lane_plan(m24)
    by_name = {k["name"]: k for k in kernels}
    ms24 = {}
    b_ms, b_by = bound(*lane_cost(win24[0], GENERIC_K, B24))
    for plan in [plan24] + [p for p in LANE_SWEEP[m24] if p != plan24]:
        fn24 = (lambda plan=plan:
                g1_kernels.lane_buckets_kernel(*win24, GENERIC_K, B24, plan))
        ms24[plan] = (cuda_ms(fn24, 3, 2), graph_ms(fn24, 3, 2))
        by_name["g1_lane_buckets"]["shapes"].append({
            "shape": f"(24, {n24}) K={GENERIC_K} m={m24} B={B24} plan={plan} (2^24)",
            "ms": ms24[plan][0], "device_ms": ms24[plan][1], "plain_ms": None, "bound_ms": b_ms,
            "bound_by": b_by})
        log(f"g1_lane_buckets (24, {n24}) m={m24} plan={plan}: kernel {ms24[plan][0]:.4f} ms "
            f"(device {ms24[plan][1]:.4f} ms), bound {b_ms:.5f} ms ({b_by})")
        torch.cuda.empty_cache()
    bx24, by24, bz24, agg_f, ax, ay, az, first24, ck24 = g1_kernels.lane_buckets_kernel(
        *win24, GENERIC_K, B24, plan24)
    keys_l = win24[0].reshape(GENERIC_K, m24)
    heads_l = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         win24[0][1:] != win24[0][:-1]]).reshape(GENERIC_K, m24)
    tails_l = torch.cat([win24[0][1:] != win24[0][:-1],
                         torch.ones(1, dtype=torch.bool, device=dev)]).reshape(GENERIC_K, m24)
    want_first = torch.where(heads_l.any(1), heads_l.int().argmax(1), m24).to(torch.int32)
    want_ck = torch.where(~heads_l[:, 0] & tails_l.any(1),
                          keys_l[torch.arange(GENERIC_K, device=dev), tails_l.int().argmax(1)],
                          -1).to(torch.int32)
    if not (torch.equal(first24, want_first) and torch.equal(ck24, want_ck)
            and torch.equal(agg_f[0], heads_l.any(1).to(torch.int32))):
        raise AssertionError("g1_lane_buckets at 2^24: first heads, carry keys or aggregate "
                             "flags are wrong")
    sample = sorted({0, 5} | {8 * i + 1 for i in range(len(offs24))} | {60, 61, 62, 63})
    span = (max(sample) + 1) * m24
    local24 = tuple(t.cpu() for t in (bx24, by24, bz24))
    agg24 = tuple(t[:, sample].cpu() for t in (ax, ay, az))
    summ = tuple(t.contiguous() for t in g1_kernels.seg_prefix((agg_f, ax, ay, az))[1:])
    b_ms, b_by = bound(*carry_cost(ck24, GENERIC_K))
    fn24 = lambda: g1_kernels.lane_bucket_carry_kernel(bx24, by24, bz24, *summ, ck24)
    c_ms, c_dev = cuda_ms(fn24, 3, 2), graph_ms(fn24, 3, 2)
    by_name["g1_lane_bucket_carry"]["shapes"].append({
        "shape": f"(24, {B24}) K={GENERIC_K} m={m24}, {int((ck24[1:] > 0).sum())} carries "
                 "(2^24)", "ms": c_ms, "device_ms": c_dev, "plain_ms": None, "bound_ms": b_ms,
        "bound_by": b_by})
    log(f"g1_lane_bucket_carry (24, {B24}) m={m24}: kernel {c_ms:.4f} ms (device {c_dev:.4f} "
        f"ms), bound {b_ms:.5f} ms ({b_by})")
    # the timed launches added the carries again: one more clean pass
    bx24, by24, bz24, agg_f, ax, ay, az, first24, ck24 = g1_kernels.lane_buckets_kernel(
        *win24, GENERIC_K, B24, plan24)
    summ = tuple(t.contiguous() for t in g1_kernels.seg_prefix((agg_f, ax, ay, az))[1:])
    g1_kernels.lane_bucket_carry_kernel(bx24, by24, bz24, *summ, ck24)
    whole24 = tuple(t.cpu() for t in (bx24, by24, bz24))
    host_pts = g1.decode_points(g1.JacobianPoints(*(t[:, :span] for t in win24[1:])))
    keys_h = win24[0][:span + 1].cpu().tolist()
    del bx24, by24, bz24, agg_f, ax, ay, az, first24, ck24, summ, win24, keys_l, heads_l, tails_l
    torch.cuda.empty_cache()
    local_b = g1.decode_points(g1.JacobianPoints(*local24))
    whole_b = g1.decode_points(g1.JacobianPoints(*whole24))
    agg_h = g1.decode_points(g1.JacobianPoints(*agg24))

    def host_same(a, b):
        """Projective equality of two host Jacobian points (no inversion)."""
        q = FQ.p
        za, zb = a[2] % q, b[2] % q
        if za == 0 or zb == 0:
            return za == zb
        za2, zb2 = za * za % q, zb * zb % q
        return (a[0] * zb2 - b[0] * za2) % q == 0 and \
            (a[1] * zb2 * zb - b[1] * za2 * za) % q == 0

    acc, tails_seen = ref_g1.INFINITY, 0
    for k in range(max(sample) + 1):  # the serial scan over the lanes up to the last sampled
        lacc = ref_g1.INFINITY
        for e in range(k * m24, (k + 1) * m24):
            head = e == 0 or keys_h[e - 1] != keys_h[e]
            acc = host_pts[e] if head else ref_g1.add(acc, host_pts[e])
            lacc = host_pts[e] if head else ref_g1.add(lacc, host_pts[e])
            if k in sample and keys_h[e + 1] != keys_h[e] and keys_h[e] > 0:
                b = keys_h[e]
                if not (host_same(lacc, local_b[b]) and host_same(acc, whole_b[b])):
                    raise AssertionError(f"the window at 2^24, lane {k} tail {e} (bucket {b}): "
                                         "not the host's serial sum")
                tails_seen += 1
        if k in sample and not host_same(lacc, agg_h[sample.index(k)]):
            raise AssertionError(f"g1_lane_buckets at 2^24: lane {k}'s aggregate is not its "
                                 "lane-local sum")
    log(f"the window at 2^24 (m = {m24}, edges at lane offsets {offs24}): at the {tails_seen} "
        f"tails of lanes {sample} the buckets equal the host's serial sums, lane-local and "
        "whole; their aggregates likewise; every lane's flag, first head and carry key exact")
    del host_pts, local_b, whole_b, agg_h, local24, whole24, agg24

    def run_path(label, fn, required, absent=(), exact=None, at_most=None):
        """Drive one path with every launch counter at 0 just before it; the
        kernels in ``required`` must launch, those in ``absent`` must not,
        those in ``exact`` exactly as often as it says, those in ``at_most``
        no more often."""
        torch.cuda.synchronize()
        for kern in kernels:
            kern["counter"].launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {kern["name"]: kern["counter"].launches for kern in kernels}
        for kern in kernels:
            kern.setdefault("launches_per_path", {})[label] = counts[kern["name"]]
        log(f"launches in {label}: " + ", ".join(f"{k} {v}" for k, v in counts.items())
            + "; B2 in all "
            + str(sum(counts[k] for k in ('g1_add', 'g1_horner_chain', 'g1_bucket_fixup'))))
        missing = [k for k in required if counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched in {label}: {missing}")
        extra = [k for k in absent if counts[k] != 0]
        if extra:
            raise AssertionError(f"kernels launched in {label} that must not be: {extra}")
        off = {k: counts[k] for k, v in (exact or {}).items() if counts[k] != v}
        off.update({k: counts[k] for k, v in (at_most or {}).items() if counts[k] > v})
        if off:
            raise AssertionError(f"launches in {label}: {off}, want {exact} and at most {at_most}")
        return out

    def generic_counts(n, extra_adds=0):
        """The generic engine's launches on n points at c =
        default_window_bits(n), exactly and nothing else: a window's
        g1_lane_buckets, B3 prefix, g1_lane_bucket_carry and B7 total, the MSM's one
        Horner chain; plus the tree reduce's g1_add launches."""
        w = -(-msm.SCALAR_BITS // msm.default_window_bits(n))
        return {**{k["name"]: 0 for k in kernels},
                **{k: w for k in GENERIC_KERNELS}, "g1_horner_chain": 1, "g1_add": extra_adds}

    def tail_counts(msms, windows):
        """The fused engine's window tail: one Horner chain a MSM, one bucket
        fixup a window."""
        return {"g1_horner_chain": msms, "g1_bucket_fixup": msms * windows}

    def epoch_kernel(b, k):
        """The epoch program's kernel for b nonces of K = k lanes."""
        glob = puzzle_mod.epoch_plan(b, k)[0] == "global"
        return "fr_epoch_program_global" if glob else "fr_epoch_program"

    def b1_counts(b, k):
        """B1's Fr-pass launches of one prove_batch or check_binding over b
        nonces at K = k: one sponge (the leaves), one epoch program (all 12
        steps) of the variant epoch_plan(b, k) names, none of the other."""
        ek = epoch_kernel(b, k)
        return {"fr_poseidon_permute": 1, "fr_epoch_program": int(ek == "fr_epoch_program"),
                "fr_epoch_program_global": int(ek == "fr_epoch_program_global")}

    K12 = 1 << fixture["log_degree"]

    W4 = -(-(msm.SCALAR_BITS + 1) // msm.fused_window_bits(2 * VERIFY_BATCH + 1))

    # -- 3. the prover at batch 8 ---------------------------------------------------
    phase("3")
    t0 = time.perf_counter()
    puzzle = Puzzle(log_degree=fixture["log_degree"])
    torch.cuda.synchronize()
    srs_s = time.perf_counter() - t0
    log(f"Puzzle(log_degree={fixture['log_degree']}) with the dev SRS built on the card "
        f"in {srs_s:.2f} s")
    nonces = [row["nonce"] for row in fixture["solutions"]]
    epoch = bytes.fromhex(fixture["epoch_hash"])
    address = fixture["address"]
    puzzle.prove_batch(epoch, address, nonces)  # warm-up
    sols = run_path(f"prove_batch({BATCH})", lambda: puzzle.prove_batch(epoch, address, nonces),
                    ["mont_mul", "fr_poseidon_permute", epoch_kernel(BATCH, K12),
                     "g1_horner_chain", "g1_bucket_fixup", "seg_prefix", "bucket_scan_serial"],
                    absent=["g1_add", "jadd_bucket_total"],
                    exact={**b1_counts(BATCH, K12), **tail_counts(2, W6)},
                    at_most={"mont_mul": MONT_MUL_MAX})

    if len(sols) != len(nonces):
        raise AssertionError(f"{len(sols)} solutions for {len(nonces)} nonces")
    for row, sol in zip(fixture["solutions"], sols):
        got = (sol.commitment.hex(), str(sol.eval_y), sol.witness.hex(), str(sol.solution_id))
        want = (row["commitment"], row["eval_y"], row["witness"], row["solution_id"])
        if got != want:
            raise AssertionError(f"nonce {row['nonce']}: solution differs from the fixture")
    log("prove_batch(8) matches tests/fixtures/torch_puzzle_k12_b8.json byte for byte")

    def host_check(batch_nonces, batch_sols):
        """C = p(tau) G, W = q(tau) G, y = p(z) and solution_id = sha64(C || y),
        from the coefficients on the host."""
        coeffs = puzzle.coefficients(epoch, address, batch_nonces)
        r = params.FR_MODULUS
        for i, sol in enumerate(batch_sols):
            cs = FR.decode_fast(coeffs[:, i, :].cpu().numpy(), mont=True)
            p_tau = 0
            for coef in reversed(cs):
                p_tau = (p_tau * DEV_TAU + coef) % r
            z = puzzle._challenge(sol.commitment)
            y = 0
            for coef in reversed(cs):
                y = (y * z + coef) % r
            q_tau = (p_tau - y) * pow(DEV_TAU - z, -1, r) % r
            c_aff = ref_g1.affine(ref_g1.scalar_mul(p_tau, ref_g1.GENERATOR))
            w_aff = ref_g1.affine(ref_g1.scalar_mul(q_tau, ref_g1.GENERATOR))
            enc = lambda a: a[0].to_bytes(48, "little") + a[1].to_bytes(48, "little") + b"\x00"
            if y != sol.eval_y or enc(c_aff) != sol.commitment or enc(w_aff) != sol.witness:
                raise AssertionError(f"nonce {batch_nonces[i]}: C != p(tau) G or W != q(tau) G")
            if sha64(sol.commitment, y.to_bytes(32, "little")) != sol.solution_id:
                raise AssertionError(f"nonce {batch_nonces[i]}: solution_id != sha64(C || y)")
        log(f"C = p(tau) G, W = q(tau) G and solution_id = sha64(C || y) hold for all "
            f"{len(batch_sols)} nonces")

    host_check(nonces, sols)
    one = puzzle.prove_batch(epoch, address, [nonces[5]])
    if len(one) != 1 or one[0] != sols[5]:
        raise AssertionError("prove_batch of one nonce differs from the batch of eight")
    log("prove_batch(1) == prove_batch(8)[5]")

    def solutions_per_s(batch_nonces):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            puzzle.prove_batch(epoch, address, batch_nonces)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        log(f"prove_batch({len(batch_nonces)}): median {med:.3f} s of "
            f"{[round(t, 3) for t in times]} -> {len(batch_nonces) / med:.3f} solutions/s on {smi}")
        return times, len(batch_nonces) / med

    times8, sps8 = solutions_per_s(nonces)
    report.update(srs_build_s=srs_s, prove_batch8_s=times8, solutions_per_s=sps8)

    # -- 4. the prover at batch 16: the wide-chain engine (B5) ---------------------
    phase("4")
    nonces16 = list(range(BATCH_WIDE))
    if nonces16[:BATCH] != nonces:
        raise AssertionError("the fixture's nonces are not 0-7")
    puzzle.prove_batch(epoch, address, nonces16)  # warm-up
    sols16 = run_path(f"prove_batch({BATCH_WIDE})",
                      lambda: puzzle.prove_batch(epoch, address, nonces16),
                      ["mont_mul", "fr_poseidon_permute", epoch_kernel(BATCH_WIDE, K12),
                       "g1_horner_chain", "g1_bucket_fixup", "seg_prefix", "bucket_scan"],
                      absent=["bucket_scan_serial", "g1_add", "jadd_bucket_total"],
                      exact={**b1_counts(BATCH_WIDE, K12), **tail_counts(2, W6)},
                      at_most={"mont_mul": MONT_MUL_MAX})
    if len(sols16) != BATCH_WIDE or sols16[:BATCH] != sols:
        raise AssertionError("prove_batch(16)[:8] differs from prove_batch(8) (and the fixture)")
    log("prove_batch(16)[:8] == prove_batch(8), byte for byte equal to the fixture")
    host_check(nonces16, sols16)
    times16, sps16 = solutions_per_s(nonces16)
    report.update(prove_batch16_s=times16, solutions_per_s_b16=sps16)

    # -- 4b. the prover at the other log degrees the node takes, and KZG at 2^20 -----
    phase("4b")

    def prove_counts(ld, nb):
        """Every kernel's launches in a prove_batch over nb nonces at K =
        2^ld: one sponge, one epoch program of the variant epoch_plan(nb, K)
        names, prove_mont_muls(K) single multiplies; the two multi-MSMs at c
        = fused_window_bits(K), W windows: a chain scan a window (B4 on
        serial chains, nb K <= SERIAL_MAX_N, else B5), three B3 prefixes a
        window (the chain carries, the two suffix scans), the window tail;
        nothing else."""
        k = 1 << ld
        w = -(-(msm.SCALAR_BITS + 1) // msm.fused_window_bits(k))
        serial = nb * k <= msm_kernels.SERIAL_MAX_N
        return {**{kern["name"]: 0 for kern in kernels}, "mont_mul": prove_mont_muls(k),
                **b1_counts(nb, k),
                "bucket_scan_serial" if serial else "bucket_scan": 2 * w, "seg_prefix": 6 * w,
                **tail_counts(2, w)}

    def fixture_rows(sols):
        return [(s.commitment.hex(), str(s.eval_y), s.witness.hex(), str(s.solution_id))
                for s in sols]

    degree_report, prover20 = {}, None
    for ld, nb in DEGREES:
        name = f"torch_puzzle_k{ld}_b{nb}.json"
        with open(os.path.join(HERE, "tests", "fixtures", name)) as fh:
            fx = json.load(fh)
        pz = Puzzle(log_degree=ld, srs=srs)  # phase 1's dev SRS, its first 2^ld + 1 powers
        ep, addr = bytes.fromhex(fx["epoch_hash"]), fx["address"]
        ns = [row["nonce"] for row in fx["solutions"]]
        if len(ns) != nb:
            raise AssertionError(f"{name}: {len(ns)} nonces, not {nb}")
        t0 = time.perf_counter()
        pz.prove_batch(ep, addr, ns)  # warm-up: the epoch's program, the kernels' first calls
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = prove_counts(ld, nb)
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        label = f"prove_batch({nb}) at 2^{ld}"
        got = run_path(label, lambda: pz.prove_batch(ep, addr, ns),
                       [k for k, v in counts.items() if v], exact=counts)
        peak = torch.cuda.max_memory_allocated()
        want = [(r["commitment"], r["eval_y"], r["witness"], r["solution_id"])
                for r in fx["solutions"]]
        if fixture_rows(got) != want:
            raise AssertionError(f"{label}: the solutions differ from tests/fixtures/{name}")
        items = [(ep, addr, n, sol.commitment, sol.eval_y, sol.witness, 1)
                 for n, sol in zip(ns, got)]
        t0 = time.perf_counter()
        ok = pz.verify_batch(items)
        verify_s = time.perf_counter() - t0
        tampered = list(items)
        tampered[0] = items[0][:4] + ((items[0][4] + 1) % params.FR_MODULUS,) + items[0][5:]
        if not ok or pz.verify_batch(tampered):
            raise AssertionError(f"verify_batch at 2^{ld}: accepts {ok}, or eval_y + 1 passed")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            pz.prove_batch(ep, addr, ns)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        degree_report[ld] = {"nonces": nb, "first_s": first_s, "prove_s": times,
                             "solutions_per_s": nb / med, "peak_bytes": peak,
                             "allocated_before_bytes": base_mem, "verify_batch_s": verify_s,
                             "epoch_variant": puzzle_mod.epoch_plan(nb, 1 << ld)[0]}
        log(f"{label} == tests/fixtures/{name} byte for byte ({degree_report[ld]['epoch_variant']} "
            f"epoch program); verify_batch accepts ({verify_s:.2f} s), rejects eval_y + 1; "
            f"median {med:.3f} s of {[round(t, 3) for t in times]} -> {nb / med:.3f} "
            f"solutions/s, first call {first_s:.2f} s; peak {peak / 2**30:.3f} GiB "
            f"({base_mem / 2**30:.3f} GiB allocated before) on {smi}")
        if ld == 20:
            prover20 = (pz, got, ep, addr)
        del pz

    # KZG commit and open at degree 2^20 (msm.msm over the first 2^20 dev SRS
    # powers: affine bases, the fast engine B6 with B7's bucket totals) on
    # the log-20 prover's nonce 0: its commitment and witness are
    # prove_batch's (the fused multi-MSM over the same points), y the host
    # poly_eval
    pz20, sols20, ep20, addr20 = prover20
    k20 = 1 << 20
    coeffs20 = pz20.coefficients(ep20, addr20, [0])[:, 0].contiguous()
    w20 = -(-(msm.SCALAR_BITS + 1) // msm.fused_window_bits(k20))
    single = {"bucket_scan_fast": w20, "jadd_bucket_total": w20, "seg_prefix": w20,
              **tail_counts(1, w20)}
    zero = {kern["name"]: 0 for kern in kernels}
    commit_pt = run_path("kzg.commit(2^20)", lambda: kzg.commit(srs.points, coeffs20),
                         list(single), exact={**zero, **single, "mont_mul": 1})
    c_bytes = puzzle_mod._g1_to_bytes(g1.decode_points(commit_pt)[0])
    z20 = pz20._challenge(c_bytes)
    y20, wit_pt = run_path("kzg.open_at(2^20)", lambda: kzg.open_at(srs.points, coeffs20, z20),
                           list(single),
                           exact={**zero, **single, "mont_mul": 4 + 2 * geometric_muls(k20)})
    host_y = ref_ntt.poly_eval(FR.decode_fast(coeffs20.cpu().numpy(), mont=True), z20)
    if c_bytes != sols20[0].commitment or \
            puzzle_mod._g1_to_bytes(g1.decode_points(wit_pt)[0]) != sols20[0].witness:
        raise AssertionError("kzg.commit / open_at at 2^20 differ from prove_batch's C and W")
    if not y20 == host_y == sols20[0].eval_y:
        raise AssertionError("kzg.open_at's y at 2^20 is not the host poly_eval")
    kzg_s = {}
    for what, fn in (("commit", lambda: kzg.commit(srs.points, coeffs20)),
                     ("open_at", lambda: kzg.open_at(srs.points, coeffs20, z20))):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        kzg_s[what] = times
    log(f"kzg.commit / open_at at 2^20 == prove_batch(2) at 2^20's C and W for nonce 0, y == "
        f"the host poly_eval; median commit {statistics.median(kzg_s['commit']):.3f} s, "
        f"open_at {statistics.median(kzg_s['open_at']):.3f} s on {smi}")
    report.update(degrees=degree_report, kzg20_s=kzg_s)
    del pz20, prover20, coeffs20

    # -- 5. the 2^20 single MSM: fast engine (B6), bucket total (B7), rerun (B5) ------
    phase("5")
    r = params.FR_MODULUS
    ks = FR.decode_fast(big_scalars.cpu().numpy())

    s_tau, tau_i = 0, 1  # sum k_i tau^i, the discrete log of the MSM
    for k in ks:
        s_tau = (s_tau + k * tau_i) % r
        tau_i = tau_i * DEV_TAU % r

    def times_g(s):
        return ref_g1.affine(ref_g1.scalar_mul(s % r, ref_g1.GENERATOR))

    def affine_of(out):
        return ref_g1.affine(g1.decode_points(out)[0])

    W20 = packed20.shape[0]
    got = run_path(f"msm_affine(2^{LOG_N})", lambda: msm.msm_affine(bx, by, big_scalars),
                   ["bucket_scan_fast", "jadd_bucket_total", "g1_horner_chain",
                    "g1_bucket_fixup", "seg_prefix"],
                   absent=["bucket_scan", "bucket_scan_serial"],
                   exact={"jadd_bucket_total": W20, "seg_prefix": W20, "g1_add": 0,
                          **tail_counts(1, W20)})
    if affine_of(got) != times_g(s_tau):
        raise AssertionError(f"msm_affine(2^{LOG_N}) != (sum k_i tau^i) G")
    log(f"msm_affine(2^{LOG_N}) == (sum k_i tau^i) G on the fast engine")

    bx2, by2, sc2 = bx.clone(), by.clone(), big_scalars.clone()
    bx2[:, 1], by2[:, 1], sc2[:, 1] = bx[:, 0], by[:, 0], big_scalars[:, 0]
    got = run_path(f"msm_affine(2^{LOG_N}, base 1 = base 0)",
                   lambda: msm.msm_affine(bx2, by2, sc2),
                   ["bucket_scan_fast", "bucket_scan", "jadd_bucket_total", "g1_horner_chain",
                    "g1_bucket_fixup"],
                   exact={"jadd_bucket_total": 2 * W20, "seg_prefix": 2 * W20, "g1_add": 0,
                          **tail_counts(2, W20)})
    # base 1 (tau G) and k_1 gave way to base 0 (G) and k_0
    if affine_of(got) != times_g(s_tau - ks[1] * DEV_TAU + ks[0]):
        raise AssertionError(f"msm_affine(2^{LOG_N}) with base 1 = base 0 is wrong after the rerun")
    log(f"msm_affine(2^{LOG_N}) with base 1 = base 0: the flag fired, the complete engine "
        "reran, and the result == (sum k_i tau^i) G")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        msm.msm_affine(bx, by, big_scalars)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"msm_affine(2^{LOG_N}): median {med:.3f} s of {[round(t, 3) for t in times]} -> "
        f"{N / med:.0f} points/s on {smi}")
    report.update(msm_s=times, msm_points_per_s=N / med)

    # -- 6. the generic engine: 2^16 Jacobian bases (the lane scan, B3, B7, B2's chain) -
    phase("6")
    ks_g = FR.decode_fast(gen_scalars)
    s_gen, tau_i = 0, 1  # sum over the non-identity lanes of k_i tau^i
    for i, k in enumerate(ks_g):
        if gen_pts[i][2]:
            s_gen = (s_gen + k * tau_i) % r
        tau_i = tau_i * DEV_TAU % r
    if msm.default_window_bits(NG) != GENERIC_C:
        raise AssertionError(f"default_window_bits(2^{LOG_GENERIC}) != {GENERIC_C}")
    W_g = -(-msm.SCALAR_BITS // GENERIC_C)
    m_g = NG // GENERIC_K
    # a window: one g1_lane_buckets, one B3 prefix of the lane aggregates,
    # one g1_lane_bucket_carry, one B7 total of the 2^c buckets; one Horner
    # chain
    got = run_path(f"msm(2^{LOG_GENERIC}, Jacobian bases)", lambda: msm.msm(gen_base, gen_k),
                   GENERIC_KERNELS, exact=generic_counts(NG))
    if affine_of(got) != times_g(s_gen):
        raise AssertionError(f"msm(2^{LOG_GENERIC}) on Jacobian bases != "
                             "(sum k_i tau^i) G over the non-identity lanes")
    log(f"msm(2^{LOG_GENERIC}) on Jacobian bases (z != 1, every 64th an identity, every 97th "
        f"scalar 0) == (sum k_i tau^i) G: generic engine, W = {W_g}, m = {m_g}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        msm.msm(gen_base, gen_k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"msm(2^{LOG_GENERIC}) generic: median {med:.3f} s of {[round(t, 3) for t in times]} "
        f"-> {NG / med:.0f} points/s on {smi}")
    report.update(generic_msm_s=times, generic_points_per_s=NG / med)

    # -- 7. the verifier: a block's solutions ---------------------------------------
    phase("7")
    items = [(epoch, address, n, sol.commitment, sol.eval_y, sol.witness, 1)
             for n, sol in zip(nonces[:VERIFY_BATCH], sols[:VERIFY_BATCH])]
    b1_per_binding = b1_counts(1, K12)
    ok = run_path("check_binding", lambda: puzzle.check_binding(*items[0][:5]),
                  ["fr_poseidon_permute", epoch_kernel(1, K12), "mont_mul"],
                  absent=["g1_add", "bucket_scan_serial", "seg_prefix"],
                  exact=b1_per_binding, at_most={"mont_mul": MONT_MUL_MAX})
    if not ok:
        raise AssertionError("check_binding rejected a solution of prove_batch")
    ok = run_path(f"verify_batch({VERIFY_BATCH})", lambda: puzzle.verify_batch(items),
                  ["fr_poseidon_permute", epoch_kernel(1, K12), "bucket_scan_serial",
                   "seg_prefix", "g1_bucket_fixup", "g1_horner_chain"],
                  absent=["g1_add", "bucket_scan", "bucket_scan_fast", "jadd_bucket_total"],
                  exact={**{k: VERIFY_BATCH * v for k, v in b1_per_binding.items()},
                         **tail_counts(2, W4)})
    if not ok:
        raise AssertionError(f"verify_batch({VERIFY_BATCH}) rejected prove_batch's solutions")
    for item in items:
        if not puzzle.verify(*item):
            raise AssertionError(f"verify rejected the solution of nonce {item[2]}")
    log(f"verify_batch({VERIFY_BATCH}) and verify of each accept prove_batch's solutions")
    bumped = items[:2] + [items[2][:4] + ((items[2][4] + 1) % r,) + items[2][5:]] + items[3:]
    swapped = [items[0][:5] + (items[1][5], 1), items[1][:5] + (items[0][5], 1)] + items[2:]
    if puzzle.verify_batch(bumped) or puzzle.verify_batch(swapped):
        raise AssertionError("verify_batch accepted eval_y + 1 or swapped witnesses")
    q = params.FQ_MODULUS
    if puzzle.check_structural(q.to_bytes(48, "little") + items[0][3][48:], *items[0][4:7]) \
            is not None:
        raise AssertionError("check_structural accepted an x >= q encoding")
    log("verify_batch rejects eval_y + 1 and swapped witnesses; check_structural rejects x >= q")

    openings = [puzzle.check_structural(*it[3:7]) for it in items]
    k_const = prng.randrange(1, r)
    const = (ref_g1.scalar_mul(k_const, ref_g1.GENERATOR), prng.randrange(1, r), k_const,
             ref_g1.INFINITY)  # p(X) = k: C = k G, W = the identity
    srs_ref = puzzle.srs.srs_ref
    fused_ok = run_path(f"batch_verify({VERIFY_BATCH} affine)",
                        lambda: kzg.batch_verify(srs_ref, openings),
                        ["bucket_scan_serial", "seg_prefix", "g1_horner_chain"],
                        absent=["g1_add", "jadd_bucket_total"], exact=tail_counts(2, W4))
    # two generic MSMs (16 and 8 bases, c = 4): a window each of g1_lane_buckets,
    # B3, g1_lane_bucket_carry and B7, a Horner chain each
    W_v = -(-msm.SCALAR_BITS // msm.default_window_bits(2 * VERIFY_BATCH))
    gen_ok = run_path(f"batch_verify({VERIFY_BATCH} + identity witness)",
                      lambda: kzg.batch_verify(srs_ref, openings + [const]),
                      GENERIC_KERNELS, absent=["g1_add", "bucket_scan_serial", "g1_bucket_fixup"],
                      exact={**{k: 2 * W_v for k in GENERIC_KERNELS}, "g1_horner_chain": 2})
    const_bad = (const[0], const[1], (const[2] + 1) % r, const[3])
    if not (fused_ok and gen_ok) or kzg.batch_verify(srs_ref, openings + [const_bad]):
        raise AssertionError("batch_verify: the fused or generic engine gave a wrong verdict")
    log("batch_verify: the fused engine without the identity witness, the generic one with "
        "it; both accept, and reject once the constant opening's y changes")

    def med3(fn):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts), ts

    gamma = pow(5, 8, r)
    left, acc_w, g_i = ref_g1.INFINITY, ref_g1.INFINITY, 1
    for c_pt, z, y, w_pt in openings:  # the two points batch_verify pairs
        term = ref_g1.add(ref_g1.add(c_pt, ref_g1.neg(ref_g1.scalar_mul(y, ref_g1.GENERATOR))),
                          ref_g1.scalar_mul(z, w_pt))
        left = ref_g1.add(left, ref_g1.scalar_mul(g_i, term))
        acc_w = ref_g1.add(acc_w, ref_g1.scalar_mul(g_i, w_pt))
        g_i = g_i * gamma % r
    pairs = [(ref_g1.affine(left), srs_ref.h), (ref_g1.affine(ref_g1.neg(acc_w)), srs_ref.tau_h)]
    vb_s, vb_all = med3(lambda: puzzle.verify_batch(items))
    bind_s, _ = med3(lambda: [puzzle.check_binding(*it[:5]) for it in items])
    bv_s, _ = med3(lambda: kzg.batch_verify(srs_ref, openings))
    bvi_s, _ = med3(lambda: kzg.batch_verify(srs_ref, openings + [const]))
    pair_s, _ = med3(lambda: pairing.pairing_check(pairs))
    log(f"verify_batch({VERIFY_BATCH}): median {vb_s:.3f} s of {[round(t, 3) for t in vb_all]} "
        f"on {smi}; apart: {VERIFY_BATCH} check_binding {bind_s:.3f} s, batch_verify "
        f"{bv_s:.3f} s, of which the host pairing_check {pair_s:.3f} s; batch_verify with the "
        f"identity witness (the generic engine) {bvi_s:.3f} s")
    report.update(verify_batch4_s=vb_all, check_binding4_s=bind_s, batch_verify4_s=bv_s,
                  batch_verify4_identity_s=bvi_s, pairing_check_s=pair_s)

    # -- 8. the SRS artifact: save, load through the consistency check ---------------
    phase("8")
    art_dir = os.path.join(HERE, "build", "srs")
    os.makedirs(art_dir, exist_ok=True)
    art = os.path.join(art_dir, "dev12.srs")
    digest = srs_artifact.save_srs(art, srs_ref)
    t0 = time.perf_counter()
    loaded = run_path("PuzzleSRS.from_artifact(2^12)",
                      lambda: PuzzleSRS.from_artifact(art, digest, log_degree=12),
                      ["bucket_scan_serial", "seg_prefix", "g1_horner_chain", "g1_bucket_fixup"],
                      absent=["g1_add", "jadd_bucket_total"], exact=tail_counts(2, W6))
    art_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(
        (loaded.points.x, loaded.points.y, loaded.points.z),
        (puzzle.srs.points.x, puzzle.srs.points.y, puzzle.srs.points.z)))
    if not same or loaded.srs_ref.tau_h != srs_ref.tau_h or loaded.is_dev:
        raise AssertionError("from_artifact did not give the dev SRS's points and tau H")
    evil = ref_kzg.SRS(powers_g1=list(srs_ref.powers_g1), h=srs_ref.h, tau_h=srs_ref.tau_h)
    evil.powers_g1[5] = ref_g1.scalar_mul(prng.randrange(1, r), ref_g1.GENERATOR)
    evil_path = os.path.join(art_dir, "evil12.srs")
    srs_artifact.save_srs(evil_path, evil)
    try:
        PuzzleSRS.from_artifact(evil_path, log_degree=12)
    except srs_artifact.SRSArtifactError as exc:
        if "consistency" not in str(exc):
            raise
    else:
        raise AssertionError("from_artifact accepted an artifact with power 5 changed")
    for path in (art, evil_path):
        os.remove(path)
    log(f"PuzzleSRS.from_artifact(2^12) == the dev SRS (points, tau H), in {art_s:.3f} s; "
        "an artifact with one power changed fails the consistency check")
    report.update(from_artifact_s=art_s)

    # -- 9. the NTT over Fr (B1's fr_ntt_pass) and the pipeline -------------------------
    phase("9")
    P = FR.p
    edge_limbs = torch.from_numpy(FR.encode_fast([0, 1, P - 1, P - 2], mont=True)).to(dev)
    inv2 = torch.from_numpy(FR.encode_fast([pow(2, -1, P)], mont=True)).to(dev)

    def fr_rows(rows, n, seed):
        """(16, rows, n) uniform Montgomery limbs on the card."""
        arr = FR.random(rows * n, np.random.default_rng(seed)).reshape(FR.nlimbs, rows, n)
        return torch.from_numpy(arr).to(dev)

    def unstage(a, inv_twiddles, s):
        """The plain inverse of stage s: (A, B) -> ((A + B) / 2, (A - B) / 2w),
        with ``inv_twiddles`` the stage's w^-1."""
        L, B, n = a.shape
        m = 1 << s
        v = a.reshape(L, B, n // (2 * m), 2, m)
        half = inv2.view(L, 1, 1, 1)
        u = fa.mont_mul_plain(FR, fa.add(FR, v[:, :, :, 0], v[:, :, :, 1]), half)
        w = fa.mont_mul_plain(FR, fa.sub(FR, v[:, :, :, 0], v[:, :, :, 1]), half)
        w = fa.mont_mul_plain(FR, w, inv_twiddles.reshape(L, 1, 1, m))
        return torch.stack([u, w], dim=3).reshape(L, B, n)

    def plant_pass(x, s0, k, s, inverse):
        """A pass input made from x whose first 16 butterflies of stage s, in
        row 0, see every pair of the edge values (0, 1, p - 1, p - 2) as (u,
        v): the edges are written at stage s's input, the stages s - 1 .. s0
        undone in plain PyTorch (and, for the first pass, the gather and its
        n^-1), and the plain pass's first s - s0 stages must bring them back."""
        n = x.shape[-1]
        y = x.clone()
        m = 1 << s
        pos = []
        for e in range(16):
            i0 = (e // m) * 2 * m + e % m
            y[:, 0, i0] = edge_limbs[:, e // 4]
            y[:, 0, i0 + m] = edge_limbs[:, e % 4]
            pos += [i0, i0 + m]
        want = y[:, 0, pos].clone()
        inv_table = ntt._stage_table(n, not inverse, dev)
        for t in range(s - 1, s0 - 1, -1):
            y = unstage(y, ntt._stage_twiddles(inv_table, t), t)
        scale = ntt._n_inv_const(n, dev) if inverse and s0 == 0 else None
        if s0 == 0:
            n_mont = torch.from_numpy(FR.encode_fast([n], mont=True)).to(dev)
            y = ntt.bitrev_plain(y, n_mont if inverse else None)
        at_s = ntt.pass_plain(y, ntt._stage_table(n, inverse, dev), s0, s - s0, scale)
        if not torch.equal(at_s[:, 0, pos], want):
            raise AssertionError(f"planting at stage {s} of pass ({s0}, {k}) failed")
        return y

    ntt_inputs = {}
    for rows, log_n in ((1, 22), (1, 20), (1, 16), (1, 12), NTT_BATCH) + NTT_DIST_BATCHES:
        ntt_inputs[(rows, log_n)] = fr_rows(rows, 1 << log_n, 100 + log_n + rows)
    elem = FR.nlimbs * 4  # bytes an element

    def pass_work(rows, n, s0, k, inverse):
        """(bytes, 32-bit multiplies) of a pass: each element read and
        written once, the pass's twiddles read once (and n^-1), rows n / 2
        butterflies a stage (and rows n scalings)."""
        first = s0 == 0
        tw = (1 << k) - 1 if first else (1 << (s0 + k)) - (1 << s0)
        scaled = first and inverse
        nbytes = 2 * elem * rows * n + elem * (tw + scaled)
        return nbytes, FR_MUL_OPS * rows * n * (k / 2 + scaled)

    # every pass of every plan, both directions; at the first, middle and last
    # stage of each the edge butterflies (the first of the three also timed)
    pass_cases = []
    x22 = ntt_inputs[(1, 22)]
    for (rows, log_n), x in ntt_inputs.items():
        n = 1 << log_n
        for inverse in (False, True):
            table = ntt._stage_table(n, inverse, dev)
            for s0, k in ntt._pass_plan(log_n):
                scale = ntt._n_inv_const(n, dev) if inverse and s0 == 0 else None
                out = torch.empty_like(x)
                for s in sorted({s0, s0 + k // 2, s0 + k - 1}):
                    y = plant_pass(x, s0, k, s, inverse)
                    if s0 == 0:
                        kfn = (lambda y=y, out=out, table=table, k=k, scale=scale:
                               ntt.pass_kernel(y, out, table, 0, k, scale))
                        tfn = kfn
                    else:
                        def kfn(y=y, table=table, s0=s0, k=k):
                            z = y.clone()
                            return ntt.pass_kernel(z, z, table, s0, k)
                        work = y.clone()
                        tfn = (lambda work=work, table=table, s0=s0, k=k:
                               ntt.pass_kernel(work, work, table, s0, k))
                    nbytes, nops = pass_work(rows, n, s0, k, inverse) if s == s0 else (None, None)
                    pass_cases.append((
                        f"(16, {rows}, 2^{log_n}) pass ({s0}, {k})"
                        + (" inverse" if inverse else "") + f", edges at stage {s}", kfn,
                        lambda y=y, table=table, s0=s0, k=k, scale=scale:
                            ntt.pass_plain(y, table, s0, k, scale),
                        nbytes, nops, tfn))
    # the first pass at 2^22 beside one PyTorch call that moves the same
    # permutation (its stages have no such call)
    perm22 = torch.from_numpy(ntt._bitrev_perm(x22.shape[-1])).to(dev).long()
    check("fr_ntt_pass", "snarkos_tpu_torch/csrc/ntt.cu", "snarkos_tpu/ops/modarith.py:171",
          pass_cases, ntt.pass_kernel, library=lambda: x22.index_select(-1, perm22))
    del ntt_inputs, pass_cases, x22, perm22

    def only(counts):
        """Exactly these launches and none of any other kernel."""
        return {**{k["name"]: 0 for k in kernels}, **counts}

    def ntt_counts(log_n):
        return only({"fr_ntt_pass": len(ntt._pass_plan(log_n))})

    # ntt at 2^22: the round trip, the plain stage loop, and the host's
    # poly_eval at k = 0 and 4 random k (on the raw limbs, a R-multiple of
    # the values: the transform is linear)
    n22 = 1 << NTT_LOGS[-1]
    a22 = fr_rows(1, n22, 22).reshape(FR.nlimbs, n22)
    ntt.ntt(a22)  # the twiddle tables of the size
    ntt.intt(a22)
    ev22 = run_path(f"ntt(2^{NTT_LOGS[-1]})", lambda: ntt.ntt(a22),
                    ["fr_ntt_pass"], exact=ntt_counts(NTT_LOGS[-1]))
    back22 = run_path(f"intt(2^{NTT_LOGS[-1]})", lambda: ntt.intt(ev22),
                      ["fr_ntt_pass"], exact=ntt_counts(NTT_LOGS[-1]))
    if not torch.equal(back22, a22):
        raise AssertionError("intt(ntt(a)) != a at 2^22")
    if not torch.equal(ev22, ntt.ntt_plain(a22)):
        raise AssertionError("ntt(a) != ntt_plain(a) at 2^22")
    coeffs_raw = FR.decode_fast(a22.cpu().numpy())
    ev_raw = ev22.cpu().numpy()
    omega22 = ref_ntt.root_of_unity(n22)
    for k in [0] + [prng.randrange(1, n22) for _ in range(4)]:
        want = ref_ntt.poly_eval(coeffs_raw, pow(omega22, k, P))
        if FR.decode_fast(ev_raw[:, k:k + 1])[0] != want:
            raise AssertionError(f"ntt(a)[{k}] != poly_eval(a, omega^{k}) at 2^22")
    del coeffs_raw, ev_raw, back22
    log("ntt at 2^22: intt(ntt(a)) == a, ntt(a) == ntt_plain(a), and ntt(a)[k] == "
        "poly_eval(a, omega^k) on the host for k = 0 and 4 random k")
    for log_n in (12, 16):
        a = fr_rows(1, 1 << log_n, log_n).reshape(FR.nlimbs, -1)
        for inverse in (False, True):
            got = FR.decode_fast(ntt.ntt(a, inverse).cpu().numpy(), mont=True)
            if got != ref_ntt.ntt(FR.decode_fast(a.cpu().numpy(), mont=True), inverse):
                raise AssertionError(f"ntt(invert={inverse}) at 2^{log_n} != the host ntt")
    log("ntt and intt at 2^12 and 2^16 equal the host crypto/ref/ntt.py")
    rows_b, log_b = NTT_BATCH
    xb = fr_rows(rows_b, 1 << log_b, 7)
    ntt.ntt_batched(xb)
    evb = run_path(f"ntt_batched({rows_b} x 2^{log_b})", lambda: ntt.ntt_batched(xb),
                   ["fr_ntt_pass"], exact=ntt_counts(log_b))
    for r_ in range(rows_b):
        if not torch.equal(evb[:, r_], ntt.ntt(xb[:, r_].contiguous())):
            raise AssertionError(f"ntt_batched row {r_} != ntt of the row")
    log(f"each row of ntt_batched over (16, {rows_b}, 2^{log_b}) == ntt of the row")

    def host_ms3(fn):
        """med3 in ms."""
        med, ts = med3(fn)
        return med * 1e3, [t * 1e3 for t in ts]

    ntt_times = {}
    for log_n in NTT_LOGS:
        a = fr_rows(1, 1 << log_n, 200 + log_n).reshape(FR.nlimbs, -1)
        calls = [("ntt", lambda a=a: ntt.ntt(a))]
        if log_n == NTT_LOGS[-1]:
            calls.append(("intt", lambda a=a: ntt.intt(a)))
        for what, fn in calls:
            fn()
            med, ts = host_ms3(fn)
            dev_ms = graph_ms(fn, 3, 1)
            ntt_times[f"{what}_2^{log_n}"] = {"ms": ts, "median_ms": med, "device_ms": dev_ms,
                                              "elems_per_s": (1 << log_n) / med * 1e3}
            log(f"{what}(2^{log_n}): median {med:.4f} ms of {[round(t, 4) for t in ts]} "
                f"(device {dev_ms:.4f} ms) -> {(1 << log_n) / med * 1e3:.0f} elems/s on {smi}")

    def plan_run(x, out, table, log_n, k_max=None, log_elems=None, threads=None):
        """A forward transform of x into out by the plan for k_max, with the
        tile of log_elems and the block size given (the defaults else)."""
        for s0, k in ntt._pass_plan(log_n, k_max):
            ntt.pass_kernel(x if s0 == 0 else out, out, table, s0, k,
                            cols=ntt._pass_cols(log_n, s0, k, log_elems), threads=threads)
        return out

    # the device time of each pass at 2^22 (a CUDA graph of 20 launches,
    # median of 3 replays; the later passes in place)
    a = fr_rows(1, n22, 23)
    out = torch.empty_like(a)
    table = ntt._stage_table(n22, False, dev)
    per_pass = [graph_ms(lambda s0=s0, k=k: ntt.pass_kernel(a if s0 == 0 else out, out, table,
                                                            s0, k), 3, 20)
                for s0, k in ntt._pass_plan(NTT_LOGS[-1])]
    ntt_times["pass_device_ms_2^22"] = per_pass
    log(f"fr_ntt_pass at 2^22, device ms by pass {ntt._pass_plan(NTT_LOGS[-1])}: "
        f"{[round(t, 4) for t in per_pass]}; sum {sum(per_pass):.3f} ms")
    # the sweep: plans (k_max), tiles (2^log_elems elements) and block sizes
    # at 2^22 and 2^20, each transform checked against the default's output,
    # device ms a transform (a graph of 3, median of 3 replays)
    sweep = []
    for log_n in (NTT_LOGS[-1], NTT_LOGS[-2]):
        n = 1 << log_n
        x = fr_rows(1, n, 300 + log_n)
        table = ntt._stage_table(n, False, dev)
        want = ntt.ntt_batched(x)
        for k_max in NTT_SWEEP_K_MAX:
            plan = ntt._pass_plan(log_n, k_max)
            for log_elems in NTT_SWEEP_LOG_ELEMS:
                cols = [ntt._pass_cols(log_n, s0, k, log_elems) for s0, k in plan]
                if max(ntt._pass_smem(k, c, s0 == 0) for (s0, k), c in zip(plan, cols)) \
                        > ntt.PASS_SMEM_MAX:
                    continue
                for threads in NTT_SWEEP_THREADS:
                    out = torch.empty_like(x)

                    def fn(x=x, out=out, table=table, log_n=log_n, k_max=k_max,
                           log_elems=log_elems, threads=threads):
                        return plan_run(x, out, table, log_n, k_max, log_elems, threads)

                    if not torch.equal(fn(), want):
                        raise AssertionError(f"sweep 2^{log_n} k_max={k_max} "
                                             f"log_elems={log_elems} threads={threads}: wrong")
                    ms = graph_ms(fn, 3, 3)
                    sweep.append({"log_n": log_n, "plan": plan, "cols": cols,
                                  "threads": threads, "device_ms": ms})
                    log(f"sweep 2^{log_n}: plan {plan} cols {cols} threads {threads}: "
                        f"device {ms:.4f} ms")
        best = min((r for r in sweep if r["log_n"] == log_n), key=lambda r: r["device_ms"])
        plan = ntt._pass_plan(log_n)
        log(f"sweep 2^{log_n}: fastest plan {best['plan']} cols {best['cols']} threads "
            f"{best['threads']} ({best['device_ms']:.4f} ms); the default plan {plan} cols "
            f"{[ntt._pass_cols(log_n, s0, k) for s0, k in plan]} threads {ntt.PASS_THREADS}")
    ntt_times["sweep"] = sweep
    del a, out, table, x, want
    report["ntt"] = ntt_times

    # the pipeline of entry.entry(): at JAX's 2^10 byte for byte against the
    # host composition, then at 2^22 with its launches
    fwd, (seed10, ctr10) = entry_mod.entry(log_n=10)
    out10 = fwd(seed10, ctr10)
    coeffs10 = [ref_poseidon.hash_many([sv, cv], 2, domain=entry_mod.DOMAIN)[0]
                for sv, cv in zip(FR.decode_fast(seed10.cpu().numpy(), mont=True),
                                  FR.decode_fast(ctr10.cpu().numpy(), mont=True))]
    want10 = FR.encode_fast([v * v % P for v in ref_ntt.ntt(coeffs10)], mont=True)
    if not np.array_equal(out10.cpu().numpy(), want10):
        raise AssertionError("entry.forward at 2^10 != the host Poseidon -> ntt -> square")
    log("entry.forward at 2^10 == host Poseidon ('graft.entry') -> host ntt -> square, "
        "limb for limb")
    fwd, (seed22, ctr22) = entry_mod.entry(log_n=PIPE_LOG)
    fwd(seed22, ctr22)
    out22 = run_path(f"entry.forward(2^{PIPE_LOG})", lambda: fwd(seed22, ctr22),
                     ["fr_poseidon_permute", "fr_ntt_pass", "mont_mul"],
                     exact=only({"fr_poseidon_permute": 1, "mont_mul": 1,
                                 "fr_ntt_pass": len(ntt._pass_plan(PIPE_LOG))}))
    # its sponge alone: one launch, and no torch op on the sponge's state
    # (the output's allocation is the one operation dispatched)
    inputs22 = torch.stack([seed22, ctr22])
    coeffs22 = run_path(f"hash_fixed(2^{PIPE_LOG})",
                        lambda: poseidon.hash_fixed(inputs22, 2, domain=entry_mod.DOMAIN),
                        ["fr_poseidon_permute"], exact=only({"fr_poseidon_permute": 1}))[0]
    sponge_ops = aten_ops(lambda: poseidon.hash_fixed(inputs22, 2, domain=entry_mod.DOMAIN))
    if sponge_ops != SPONGE_OPS:
        raise AssertionError(f"hash_fixed(2^{PIPE_LOG}) dispatched {sponge_ops}, want {SPONGE_OPS}")
    log(f"hash_fixed(2^{PIPE_LOG}): one fr_poseidon_permute launch; torch ops {sponge_ops}")
    del inputs22
    lanes = [0, 1, (1 << PIPE_LOG) - 1] + [prng.randrange(1 << PIPE_LOG) for _ in range(5)]
    for lane in lanes:
        sv, cv = (FR.decode_fast(t[:, lane:lane + 1].cpu().numpy(), mont=True)[0]
                  for t in (seed22, ctr22))
        got = FR.decode_fast(coeffs22[:, lane:lane + 1].cpu().numpy(), mont=True)[0]
        if got != ref_poseidon.hash_many([sv, cv], 2, domain=entry_mod.DOMAIN)[0]:
            raise AssertionError(f"pipeline coefficient {lane} != the host Poseidon")
    evals22 = ntt.ntt_plain(coeffs22)
    for lo in range(0, 1 << PIPE_LOG, 1 << 20):  # the plain square in slices: its memory
        part = evals22[:, lo:lo + (1 << 20)]
        if not torch.equal(out22[:, lo:lo + (1 << 20)], fa.mont_mul_plain(FR, part, part)):
            raise AssertionError(f"entry.forward(2^{PIPE_LOG}) != square(ntt_plain(coeffs))")
    del evals22
    pipe_med, pipe_ts = host_ms3(lambda: fwd(seed22, ctr22))
    # its three steps apart, and the sponge's one permutation within the
    # first (medians of 3 host-clock calls)
    ev_c = ntt.ntt(coeffs22)
    state22 = torch.stack([coeffs22] * 3)
    steps = {"hash_fixed": host_ms3(lambda: poseidon.hash_fixed(
                 torch.stack([seed22, ctr22]), 2, domain=entry_mod.DOMAIN))[0],
             "of which permute": host_ms3(lambda: poseidon.permute(state22, 2))[0],
             "ntt": host_ms3(lambda: ntt.ntt(coeffs22))[0],
             "square": host_ms3(lambda: fa.mont_mul(FR, ev_c, ev_c))[0]}
    del coeffs22, ev_c, state22
    log(f"entry.forward(2^{PIPE_LOG}): coefficients == host Poseidon at {len(lanes)} lanes, "
        f"output == square(ntt_plain(coefficients)); median {pipe_med:.3f} ms of "
        f"{[round(t, 3) for t in pipe_ts]} on {smi}; apart: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in steps.items()))
    report["pipeline"] = {"log_n": PIPE_LOG, "ms": pipe_ts, "median_ms": pipe_med,
                          "steps_median_ms": steps}

    # -- 10. the multi-device layer: world 1 over NCCL, world 2 over gloo ---------------
    phase("10")
    dist_report = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-dist-")
    try:
        # world 1 over NCCL: the mesh of a torch.distributed program of one rank
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rdv')}",
                                world_size=1, rank=0)
        mesh = pmesh.make_mesh(1)
        n = 1 << DIST_NTT_LOG
        n1, n2 = ntt_dist._split(n)
        x = torch.from_numpy(FR.random(n, np.random.default_rng(2210))).to(mesh.device)
        ntt_dist.ntt_dist(x, mesh)  # the twiddle matrices of the size
        ntt_dist.intt_dist(x, mesh)
        ntt_counts = only({"mont_mul": 1,
                           "fr_ntt_pass": len(ntt._pass_plan(n1.bit_length() - 1))
                           + len(ntt._pass_plan(n2.bit_length() - 1))})
        ev = run_path(f"ntt_dist(2^{DIST_NTT_LOG}) w1", lambda: ntt_dist.ntt_dist(x, mesh),
                      ["mont_mul", "fr_ntt_pass"], exact=ntt_counts)
        back = run_path(f"intt_dist(2^{DIST_NTT_LOG}) w1", lambda: ntt_dist.intt_dist(ev, mesh),
                        ["mont_mul", "fr_ntt_pass"], exact=ntt_counts)
        if not torch.equal(ev, ntt.ntt(x)):
            raise AssertionError(f"ntt_dist(2^{DIST_NTT_LOG}) at world 1 != ntt.ntt, limb for limb")
        if not torch.equal(ev, ntt.ntt_plain(x)):
            raise AssertionError(f"ntt_dist(2^{DIST_NTT_LOG}) at world 1 != ntt.ntt_plain, "
                                 "limb for limb")
        if not torch.equal(back, x):
            raise AssertionError(f"intt_dist(ntt_dist(a)) != a at 2^{DIST_NTT_LOG}, world 1")
        log(f"ntt_dist / intt_dist(2^{DIST_NTT_LOG}) at world 1 over NCCL (N1 = {n1}, "
            f"N2 = {n2}): == ntt.ntt and ntt.ntt_plain limb for limb, and the round trip "
            "returns the input")
        dist_ms, dist_ts = host_ms3(lambda: ntt_dist.ntt_dist(x, mesh))
        one_ms, one_ts = host_ms3(lambda: ntt.ntt(x))
        # its steps apart, each on the previous step's output (host clock,
        # median of 3)
        step_ms, a = {}, x
        for name, step in ntt_dist.steps(mesh, n):
            step_ms[name] = host_ms3(lambda step=step, a=a: step(a))[0]
            a = step(a)
        if not torch.equal(a, ev):
            raise AssertionError("ntt_dist's steps apart do not compose to its output")
        del a, back
        log(f"ntt_dist(2^{DIST_NTT_LOG}) at world 1: median {dist_ms:.3f} ms of "
            f"{[round(t, 3) for t in dist_ts]}, ntt(2^{DIST_NTT_LOG}) in the same call "
            f"{one_ms:.3f} ms, on {smi}; apart: "
            + ", ".join(f"{k} {v:.3f}" for k, v in step_ms.items())
            + f" ms (sum {sum(step_ms.values()):.3f})")
        dist_report["ntt_dist_w1"] = {"ms": dist_ts, "median_ms": dist_ms, "ntt_ms": one_ts,
                                      "ntt_median_ms": one_ms, "steps_median_ms": step_ms}

        # msm_dist at world 1: 2^20 distinct dev SRS powers (phase 5's bases
        # and scalars), against the oracle and the fused engine's msm.msm
        N = big_scalars.shape[-1]
        log_n = N.bit_length() - 1
        bases = g1.JacobianPoints(*(t[:, :N].contiguous()
                                    for t in (srs.points.x, srs.points.y, srs.points.z)))
        want = times_g(s_tau)
        got = run_path(f"msm_dist(2^{log_n}) w1",
                       lambda: msm_dist.msm_dist(bases, big_scalars, mesh),
                       GENERIC_KERNELS, exact=generic_counts(N))
        if affine_of(got) != want:
            raise AssertionError(f"msm_dist(2^{log_n}) at world 1 != (sum k_i tau^i) G")
        if affine_of(msm.msm(bases, big_scalars)) != want:
            raise AssertionError(f"msm.msm(2^{log_n}) != (sum k_i tau^i) G")
        md_ms, md_ts = host_ms3(lambda: msm_dist.msm_dist(bases, big_scalars, mesh))
        mf_ms, mf_ts = host_ms3(lambda: msm.msm(bases, big_scalars))
        log(f"msm_dist(2^{log_n}) at world 1 == (sum k_i tau^i) G == msm.msm of the same bases "
            f"(fused engine); msm_dist median {md_ms:.1f} ms of {[round(t, 1) for t in md_ts]}, "
            f"msm.msm {mf_ms:.1f} ms of {[round(t, 1) for t in mf_ts]}, on {smi}")
        dist_report["msm_dist_w1_2^20"] = {"ms": md_ts, "median_ms": md_ms, "msm_ms": mf_ts,
                                           "msm_median_ms": mf_ms}

        # msm_dist at world 1 at 2^24: the 2^20 powers tiled, scalars below
        # 2^252 drawn on the card; the oracle folds the 16 blocks' scalars on
        # the card (Fr add), so that it stays (sum_i k'_i tau^i) G over 2^20
        n24 = 1 << DIST_MSM_LOG
        tile = n24 // N
        b24 = g1.JacobianPoints(*(t.repeat(1, tile) for t in (bases.x, bases.y, bases.z)))
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(DIST_MSM_LOG)
        k24 = torch.randint(0, 1 << 16, (FR.nlimbs, n24), generator=gen, device=mesh.device,
                            dtype=torch.int32)
        k24[-1] &= 0x0FFF
        folded = k24[:, :N]
        for i in range(1, tile):
            folded = fa.add(FR, folded, k24[:, i * N:(i + 1) * N])
        s24, tau_i = 0, 1
        for k in FR.decode_fast(folded.cpu().numpy()):
            s24 = (s24 + k * tau_i) % r
            tau_i = tau_i * DEV_TAU % r
        del folded
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        t0 = time.perf_counter()
        got = run_path(f"msm_dist(2^{DIST_MSM_LOG}) w1",
                       lambda: msm_dist.msm_dist(b24, k24, mesh),
                       GENERIC_KERNELS, exact=generic_counts(n24))
        s_24 = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(mesh.device)
        if affine_of(got) != times_g(s24):
            raise AssertionError(f"msm_dist(2^{DIST_MSM_LOG}) != "
                                 f"(sum k_i tau^(i mod 2^{log_n})) G")
        del b24, k24, got
        log(f"msm_dist(2^{DIST_MSM_LOG}) at world 1 == (sum k_i tau^(i mod 2^{log_n})) G: one "
            f"call {s_24:.2f} s ({n24 / s_24:.0f} points/s), peak device memory "
            f"{peak / 2 ** 30:.2f} GiB, on {smi}")
        dist_report["msm_dist_w1_2^24"] = {"s": s_24, "peak_bytes": peak}
        dist.destroy_process_group()

        # world 2 over gloo, both ranks on this card: the exchanges and the
        # reduce with real data split across ranks (two processes time-slice
        # the card: their times are no scaling figure)
        torch.save(x.cpu(), os.path.join(tmp, "ntt_in.pt"))
        torch.save(ev.cpu(), os.path.join(tmp, "ntt_out.pt"))
        torch.save(tuple(t.cpu() for t in (bases.x, bases.y, bases.z, big_scalars)),
                   os.path.join(tmp, "msm_in.pt"))
        del x, ev, bases
        torch.cuda.empty_cache()
        counters = {k["name"]: (k["counter"].__module__, k["counter"].__name__) for k in kernels}
        t0 = time.perf_counter()
        ranks = pmesh.spawn(_dist_rank, DIST_WORLD2, "gloo", str(mesh.device), tmp, counters, 2)
        spawn_s = time.perf_counter() - t0
        for rank, res in enumerate(ranks):
            if not res["ntt_equal"]:
                raise AssertionError(f"ntt_dist(2^{DIST_NTT_LOG}) at world 2, rank {rank}: "
                                     "all_gather_last != the world-1 output")
            if affine_of(g1.JacobianPoints(*res["msm"])) != want:
                raise AssertionError(f"msm_dist(2^{log_n}) at world 2, rank {rank} != "
                                     "(sum k_i tau^i) G")
            for path, size, required, exact in (
                    ("ntt_dist", DIST_NTT_LOG, ["mont_mul", "fr_ntt_pass"], ntt_counts),
                    ("msm_dist", log_n, GENERIC_KERNELS + ["g1_add"],
                     generic_counts(N // DIST_WORLD2, extra_adds=1))):
                label = f"{path}(2^{size}) w{DIST_WORLD2} rank {rank}"
                counts = res[path]["launches"]
                for kern in kernels:
                    kern.setdefault("launches_per_path", {})[label] = counts[kern["name"]]
                log(f"launches in {label}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
                if any(counts[k] == 0 for k in required) or counts != exact:
                    raise AssertionError(f"launches in {label}: {counts}, want {exact}")
        log(f"world {DIST_WORLD2} over gloo, both ranks on one card: all_gather_last(ntt_dist) == "
            f"the world-1 output limb for limb and msm_dist(2^{log_n}) == (sum k_i tau^i) G on "
            f"every rank; spawn and both paths {spawn_s:.1f} s")
        for rank, res in enumerate(ranks):
            log(f"  rank {rank} (sharing the card): ntt_dist(2^{DIST_NTT_LOG}) "
                f"{[round(t * 1e3, 1) for t in res['ntt_dist']['s']]} ms, msm_dist(2^{log_n}) "
                f"{res['msm_dist']['s'][0]:.2f} s, on {smi}")
        dist_report["world2"] = {"spawn_s": spawn_s,
                                 "ranks": [{p: res[p]["s"] for p in ("ntt_dist", "msm_dist")}
                                           for res in ranks]}

        # the port's dryrun_multichip on the card: its ranks share this card
        # over gloo, each of its four checks against the host inside the rank
        t0 = time.perf_counter()
        entry_mod.dryrun_multichip(DRYRUN_WORLD)
        dry_s = time.perf_counter() - t0
        log(f"entry.dryrun_multichip({DRYRUN_WORLD}) on the card ({DRYRUN_WORLD} ranks sharing "
            f"it over gloo): the field step, ntt_dist / intt_dist, the mock and the real-G1 "
            f"msm_dist all equal the host; spawn and the checks {dry_s:.1f} s on {smi}")
        dist_report["dryrun_multichip"] = {"world": DRYRUN_WORLD, "s": dry_s}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    report["dist"] = dist_report

    # -- 12. the ledger on the card ----------------------------------------------------
    phase("12")
    report["ledger"] = ledger_phase(run_path, kernels, smi)

    # -- 13. the consensus core on the card ------------------------------------------
    phase("13")
    report["consensus"] = consensus_phase(run_path, kernels, smi)

    # -- 14. the block sync over localhost on the card --------------------------------
    phase("14")
    report["sync"] = sync_phase(run_path, kernels, smi)

    # -- 15. the devnet through the CLI on the card -----------------------------------
    phase("15")
    report["devnet"] = devnet_phase(run_path, kernels, smi)

    # -- 16. output -----------------------------------------------------------------
    phase("16")
    launched = {k["name"]: any(k["launches_per_path"].values()) for k in kernels}
    unused = [k for k, v in launched.items() if not v and k not in NO_PATH_YET]
    if unused:
        raise AssertionError(f"kernels launched on no path: {unused}")
    found = [k for k in NO_PATH_YET if launched[k]]
    if found:
        raise AssertionError(f"kernels of NO_PATH_YET launched on a path: {found}")
    for k, caller in NO_PATH_YET.items():
        log(f"{k}: launched on no path yet (next caller: {caller})")
    for kern in kernels:
        del kern["counter"]
        kern["launches"] = sum(kern["launches_per_path"].values())
    line = {"kernels": [{k: v for k, v in kern.items() if k != "shapes"} for kern in kernels]}
    report["kernels"] = kernels
    report["wall_s"] = time.perf_counter() - T_START
    report["phase_s"] = PHASE_S
    log(f"chip_smoke: {report['wall_s']:.1f} s in all")
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    _adopt_orphans()
    try:
        rc = main()
    finally:
        _stop_children()
    sys.exit(rc)
