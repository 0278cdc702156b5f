#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (rnaelem_tpu_torch), one GPU.

Phases:
  1. the card's name and power limit; build the hand-written kernels
     (csrc/*.cu, nvcc for sm_90a) and time the build; K3's, K6's and
     K11's layouts as ops/kernels.ep_smem_bytes and the device plan
     (ep_plan) size them (the launch plans) against the kernels' own
     layouts and workspace stride, and the M chain's (K2's band_m, K5's
     m_adj) as band_smem_bytes sizes it for every group and ring (S to
     1,378: threads striding over the states, the device variant's
     workspace slice), and K8's and K9's as chain_smem_bytes and
     chain_plan size them (S to 4,096, K9's tiles and device variant);
  2. hold every kernel against its plain PyTorch version on the card:
     K1 score tables (ints/bools equal, floats within 1e-6 relative), the
     column stages of K2-K4 one by one (f64 at B=16 within 1e-9 relative,
     f32 at the main path's shapes within 1e-4 relative on the cells f32
     exp space resolves), the adjoint stages of K5-K7 one by one on one
     column (f64 within 1e-9, f32 within 1e-4, relative in the max norm),
     rows C and D, K14-K17 (the factors and their adjoint, the hoisted
     exponentials and lambda's cotangent) over (.....), ..*.. --no-rss,
     theta_softmax, no_theta, no_prf and fix_rss: f64 at B=16 within
     1e-12 and f32 at B=128 x 100 nt within 1e-6 relative (max norm), the
     constants identical, K15's contraction bitwise the plain sums, two
     runs and the first 8 of 16 reads bitwise equal; K15's and K17's
     cotangents per read bitwise equal in batches of 600, 1, 7 and 128
     reads at other places, in a repeat, and under every split of a read's
     sums that their host plans (factors_adj_plan, hoisted_adj_plan) can
     take, forced (f32 and f64), and K15 at 44 dots (S=1,081) under every
     split bitwise the plain contraction; K1 (one launch), K16 and K14 at
     B = 1, 7, 600 and 128 x 100 nt, f64 and f32, against their plain
     versions (K1's ints and bools equal, floats within 1e-6 relative; K16
     and K14 within 1e-12 / 1e-6 relative, a strided per-read lambda, K14's
     constants identical), K14 under every tile of factors_plan forced
     bitwise its own plan, with the share of float cells bit for bit the
     plain versions';
     and the full inside DP: f64 kernels vs the f64 plain version (parts
     within 1e-9 absolute), f32 kernels vs the f64 plain version (within
     2e-3 absolute);
  3. the full gradient on B=16 reads, per read (the weights enter as
     per-read copies): f64 kernels vs the f64 plain version, every
     gradient leaf and d alphaP of every read within 1e-9 relative (max
     norm); two kernel runs bitwise equal; batch_fn_grad_pr, the trainer's
     entry point, within 1e-9 of the same plain version, and its
     read-order sum within 1e-12 of batch_fn_grad;
  4. the min-BPP masks (the motif-free S=1 DP and its outside pass):
     posteriors of the f64 kernels within 1e-9 of the f64 plain version,
     masks equal but for cells within 1e-9 of the threshold; the f32
     kernels' mask cells that differ lie within 1e-3 (log) of it;
  5. per-call device times of K1-K7 (torch.profiler, the kernel's own
     functions over 200 calls) at the main path's shapes, K2's, K3's, K5's
     and K6's by CUDA function (K2's and K5's also under the pin and per
     masks batch), and the plain versions' times (CUDA events); K14-K17
     per call (200 calls) beside their bounds and plain versions; rows C
     and D as the main path runs them (K14-K17 and the glue left), device
     ms, kernel launches (at most 8 per fn+grad) and memcpy/memset events
     per call beside their bounds;
  6. the flagship evaluation path: B=128 reads x 100 nt, pattern
     (.....), max-span 50, max-iloop 30, min_bpp 1e-4, tau 0.1, f32: the
     masks (stack_reads; their S=1 pass must launch K3 and K6), then
     batch_fn_grad, one warm-up (the launch counts are read from it) and
     3 timed repetitions (CUDA events), the forward alone too, and 3
     more timed on the host clock to the call's return and to a
     synchronize (host-bound when the two agree); two profiled
     batch_fn_grad and two stack_reads (device busy share, device time
     per kernel); the glue gate: the census of torch's kernels in one
     fn+grad, one masks batch and one 64-read posterior chunk of the tRNA
     scan, each named by its aten op and the port's line (a torch
     function mode annotates every call), memcpy and memset apart, and
     the host syncs set_sync_debug_mode("warn") reports, by line; it
     fails on a cub sort or select kernel or on more than 60 / 50 / 150
     torch kernels;
  7. the no-rss chain K8/K9 against its plain version (..*.., f64 within
     1e-9 and f32 within 1e-4 relative, at B=16, 128 x 100 nt, 1, 7 and
     600; two runs bitwise equal), plain and under a pin with K9's class
     sums; per-call times of K8/K9;
  8. the training path, the production step as bench.py times it: the
     Trainer (Adam, k-let shuffled negatives) on 64 random reads x 100 nt
     plus 64 fresh negatives per step, f32, one warm-up step and 4 timed
     steps with a stage breakdown, for (.....) and for ..*.. with
     --no-rss; each run with the launch counts set to 0 before it; the
     last step's per-read f and gradients (its own batch and weights)
     against the f64 plain version, every read within 1e-2 of its max
     norm and their sum within 1e-3 relative;
  9. the C++ goldens on the card: eval of the reference's converged tRNA
     model over the 76 tRNAs (fn within 2e-3 of 0.13662, fn + L2 within
     2e-3 of 1.713098, f32) and `cli train --no-shuffle` on the first 8
     tRNAs (f64) within 0.05 of the reference binary's model;
 10. one JSON line per kernel (K1-K21) and per variant of a launch plan
     that phase 14's paths ran (K6's and K11's device variants, K3's,
     the M chain in groups of 4 reads at f32), the card line, and the
     result line;
 2b. (after phase 2) the scanner's row K: every forward stage and every
     adjoint stage, and the class sums of the column and of the whole
     outside pass, with a random pin per read and with aux = 0 (the class
     probe alone), against the plain versions (dense aux, autograd): f64
     at B=16 within 1e-9 (the whole pass too, pinned and aux = 0, two
     kernel runs bitwise equal),
     f32 at B=64 x 100 nt within 1e-4; likewise K8/K9 under a pin with
     K9's class sums (after phase 7); per-call device times of the pinned
     K2, K4, K5, K7, K8, K9 at the main path's shapes (phase 5);
 2d. (after phase 2c) K18-K21, the glue at the passes' ends, against
     their plain twins: K18 (the masks' candidates and threshold), K20
     (lambda's per-read sums) and K21 (the scanner's posteriors, on class
     sums rounded to ties too) bitwise and, the first 8 of 16 reads
     against those 8 alone, bitwise; K19 (the parts' gather bitwise, the
     objective in both forms, the scanner's lse, the masks' parts[:, 0],
     on parts with -inf entries too, its gbar and seeded O rows) within
     1e-12 at f64 and 1e-6 at f32 (relative, max norm); at the main
     path's shapes (f32, f64), on the no-rss chain's parts, the 64-read
     tRNA chunk and .....*..... -c 30 f64; per-unit times of K18-K21
     beside their bounds and twins in phase 5;
 2c. (after phase 2b) rows L and M, the CYK tables: K10-K12 under the
     scanner's pin set (Ys, Ye and the tail; a read with Ye == L, one with
     Ys == Ye) against the plain max DP on the card, every stage at column
     75 and the whole tables, -inf placement identical, f64 at B=16 within
     1e-12 and f32 at B=64 x 100 nt within 1e-4 (absolute), two kernel runs
     bitwise equal; K13 against the host traceback on the f64 tables, every
     read's psihat and pair set identical, under each plan of
     ops/kernels.traceback_plan (the walk's stack in shared memory and in
     the device scratch; so too on the 76 tRNAs and phase 14's CYK path);
 11. the scan path, this slice's: Scanner.scan of the 76 tRNAs with the
     reference's converged model in the driver's buckets and chunks
     (posteriors, then the CYK alignment), at f64 (the default) held
     against every line of the C++ trna_scan_ref.raw
     (test_scan_trained_golden's bars: posteriors, motif region, exist
     prob, mot on every read; the reads whose psihat/rss differ counted
     against test_scan_trained_golden's bar of at most 2 and reported
     with the port's best score and the best score of the golden's pairs
     and node path, which must be equal: each such read a tie),
     at f32 timed with its path differences and F4 count; each timed with
     a stage breakdown; one posterior chunk (row K) beside its bound; the
     launch counts of the f64 run; then K10-K12 per column and K13 per
     chunk timed beside their bounds, K13 checked against the host
     traceback on the 76 tRNAs; K11 and K12 also on the second chunk
     (12 reads: K11's ranges of x follow B);
 12. Scanner.scan of the --no-rss fixture model 2 on 0.fq against every
     line of the C++ scan_2.raw;
 13. row N, data parallelism (parallel/mesh.py) and the file array
     (parallel/arrayjob.py): N1, a one-rank NCCL group (TCP store on
     localhost) runs the sharded per-read step on the evaluation path's
     batch (B=128 x 100 nt, f32), bitwise equal to batch_fn_grad_pr, its
     sharded masks equal to stack_reads', the gather timed beside its
     bound; N2, two ranks on the one card (gloo, subprocesses of this
     script) split that batch 64/64, bitwise equal to one rank, then run
     the production step (Trainer, (.....), 1 warm-up + 4 steps) to a
     model byte-identical to the one-rank Trainer's, with a stage
     breakdown per rank (two ranks sharing one card: not a scaling
     figure); N3, the same over NCCL on cuda:0 and cuda:1 and a launch on
     cuda:1 from device 0, only with two cards (else reported as
     skipped); then ArrayEvaluator with 2 local array-eval slaves on the
     card (f64, the 76 tRNAs) within 1e-9 of eval_file; one JSON line for
     row N before the kernels line;
 14. the wide grammars, whose blocks outgrow shared memory or a block's
     threads (ops/kernels.ep_plan, band_plan): fn+grad per read of 12
     dots (S=105) at -c 30 f64, `.....*.....` at -c 40 f64, 16 dots
     (S=171) at -c 40 f64 (K3, K6 in their device variants) and 14 dots
     (S=136) at -c 30 f32 (K6 device, the M chain in groups of 4), each
     run with the launch counts set to 0 before it (every kernel of the
     path launched, in its plan's variant), two runs bitwise equal,
     against the f64 plain version (f64 within 1e-9 per read; f32 each
     read within 1e-2, the sums within 1e-3), every stage at one column
     against its plain version (1e-9 / 1e-4); the CYK tables of 12 dots
     (K11's device variant) bitwise equal to the plain max DP and K13's
     paths to the host traceback; at `.....*.....` -c 30 (both fit) K3,
     K6 and K11 in the device variant bitwise equal to the shared one,
     and the M chain (K2, K5 pinned with the class probe, K10) bitwise
     equal across every group of reads and the small ring; each
     variant's device ms per column beside the shared variant's, its
     bound and the plain version's ms.  Past 1,024 states, 44 dots
     (S=1,081, 3 reads) and 50 dots (S=1,378, 2 reads) of 40-50 nt, -w
     40, -c 10, each alone (the plain DP's dense split matrices take S^3
     values): fn+grad per read at f64 and f32 (the launch counts set to
     0 before each, every kernel of the path in its plan's variant,
     K14-K17 included) against the f64 plain version (f64 within 1e-9;
     f32 each read within 1e-2, the sums within 1e-3), two f64 runs
     bitwise equal, every stage at column 30 against its plain version
     (f64 1e-9), the no-rss path's K14/K15/K8/K9 launched and K8/K9
     against the plain chain (f64 1e-9, f32 1e-4), the M chain (K2, K5
     pinned with the class probe, K10) bitwise equal across every plan
     band_plan gives it (rings of 4 and 2, the device variant), each
     plan's ms per column.
 15. the elem pipeline (rnaelem_tpu_torch/pipeline/elem.py) in process on
     the card: 15a, test_pipeline_planted.py's set and bar (`(.....)`
     against `.....`, init, train -i 12 -b 8 -w 24, select -N 1: pattern 1
     first, its held-out AUC above 0.9 on both folds); 15b, `elem
     pipeline` over 256 reads of 100 nt with a planted hairpin (negatives
     from init's dinucleotide shuffle) and ELEM_PATTERNS (S = 29 to 91,
     the widest of tests/fixtures/pattern_list), -w 50 -c 30 -b 64 -k 2
     -i 20 -N 2, then `elem scan` with both refined models: every model,
     record file, cv, select.txt and SVG present and well formed, exist
     probs in [0, 1]; K1-K7 and K10-K17 launched (counts set to 0 before
     15b); the (.....) fold-0 task again in subprocesses byte for byte
     the in-process one; device memory within 1 MiB of its value before
     15b once the port's caches are cleared; one {"elem": ...} line with
     the walls, per-task times and launches and the AUCs.  --elem runs
     the build and this phase alone.

--rows-cd-times times K14-K17 and K1 alone through their common entry
points and prints the SHA-256 of every K1 and K16 output at the seeded
main-path batch (f32, f64) and of every K14 output in modes dp, eR and
null at B = 1, 7, 128 and 600 (f32, f64): a copy of this script beside
an older tree times that tree and prints its bits.  --tb-times does the
same for K13 on the two chunks of the 76-tRNA scan (f64, f32, each plan:
device ms, the SHA-256 of psihat, pairs and err, the walk's cells and
candidates per read, the latency of one dependent load from a pointer
chase, csrc/probe/pointer_chase.cu, and both bounds); with both flags
both run.  --k1-variants times K1 for other
launch plans and with a piece of its work taken out (K1_VARIANTS).
--chain-times does the same for K8 and K9 (B=128 x 100 nt of ..*..,
f32, plain and pinned with the class probe; the SHA-256 of every output
at f32 and f64, chain rows masked past each read's length).
--chain-variants times K8 and K9 per plan of ops/kernels.chain_plan
(the one-warp block, K9's device variant) and with
a piece of their work taken out (CHAIN_VARIANTS), in us per step.
--glue builds and runs phase 2d, K18-K21's times and the glue gate
alone.  --glue-times times the walls the glue moves (fn+grad with its
host ms and busy share, the masks batch, the production steps, a
posterior chunk, the 76-tRNA scan at f64 and f32), K18-K21 where the
tree has them, and prints the census: a copy of this script beside an
older tree times that tree in the same call.

Run from the repository root:  python3 chip_smoke.py
Exits non-zero and prints no result without CUDA or without the package.
"""
import argparse
import dataclasses
import gc
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import types
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# set by main() once the imports succeed (the script must fail cleanly,
# with no result, where torch, CUDA or the package is missing)
np = torch = ET = J = DP = DMB = K = LIN = MIO = OBJ = TRN = CLI = SC = \
    SCD = CYK = MESH = AJ = ELEM = None
seq_to_ints = ints_to_seq = FastqReader = compile_pattern = None

PATTERN = "(.....)"
LP = 100               # read length of the main path (and the padded Lp)
B_MAIN = 128           # reads per main-path batch
SMALL = (16, 80, 100)  # reads and length range of the f64 checks
MIN_BPP = 1e-4         # the main path's pruning threshold
REPS = 200             # calls per kernel timing
J0 = 75                # column of the per-stage checks and timings
DEVICE = "cuda"
MEM_BPS = 3.35e12      # H100 SXM HBM3 bytes/s (data sheet)
PEAK_F32 = 67e12       # H100 SXM f32 FLOP/s outside the tensor cores
STAGE_KERNEL = {"band_front": "inside_band", "band_bif": "inside_band",
                "band_m": "inside_band", "band_e": "inside_band",
                "ep_stage": "inside_ep", "ext_stage": "inside_ext"}
STAGE_OUT = {"band_front": ("LL", "P", "T2"), "band_bif": ("Bt", "T1"),
             "band_m": ("M",), "ep_stage": ("ep",), "band_e": ("E",),
             "ext_stage": ("O",)}
ADJ_KERNEL = {"ext_adj": "outside_ext", "e_adj": "outside_band",
              "ep_adj": "outside_ep", "band_adj": "outside_band"}
GRAD_KEYS = ("eR", "eL", "bg2", "pv", "alphaP", "emisA", "emisB", "gM",
             "gep")
NORSS = "..*.."        # the no-rss configuration's pattern (S=28)
N_POS = 64             # reads per production step (plus as many negatives)
STEPS = 4              # timed production steps after one warm-up
DP_KERNELS = ("score_tables", "inside_band", "inside_ep", "inside_ext",
              "outside_band", "outside_ep", "outside_ext")
CHAIN_KERNELS = ("linear_fwd", "linear_adj")
BAND_KERNELS = ("inside_band", "outside_band")   # K2, K5
TRNA_FA = os.path.join(HERE, "tests", "fixtures", "material", "positive.fa")
GOLD_TRNA = os.path.join(HERE, "tests", "golden", "trna_noshuffle_ref.model")
GOLD_SMALL8 = os.path.join(HERE, "tests", "golden", "trna_small8_ref.model")
FIXDIR = os.path.join(HERE, "tests", "fixtures")
GOLDDIR = os.path.join(HERE, "tests", "golden")
GOLD_TRNA_SCAN = os.path.join(GOLDDIR, "trna_scan_ref.raw")
B_SCAN = 64            # reads of the f32 pinned checks (a scan chunk)


def fail(msg):
    print("chip_smoke: FAIL: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = "nvidia-smi unavailable (%s)" % e
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


# kernels whose source holds another kernel's functions too: their own
KERNEL_OWN_FUNCTIONS = {"factors": {"factors_kernel"},
                        "factors_adj": {"factors_adj_kernel"},
                        "hoisted": {"hoisted_kernel"},
                        "hoisted_adj": {"hoisted_adj_kernel"}}


def kernel_functions():
    """{kernel: names of the __global__ functions of its source} (or its
    own, KERNEL_OWN_FUNCTIONS)."""
    out = dict(KERNEL_OWN_FUNCTIONS)
    for name, kern in K.KERNELS.items():
        if name in out:
            continue
        with open(os.path.join(HERE, kern.source)) as f:
            out[name] = set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|"
                r"\([^()]*\))*\)\s+)?(\w+)", f.read()))
    return out


def _function_name(key):
    """'void ep_v_kernel<float>(DPDims, ...)' -> 'ep_v_kernel'."""
    return key.split("(")[0].split("<")[0].replace("void ", "").strip()


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def device_profile(fn, reps):
    """torch.profiler over ``reps`` calls of ``fn`` after one warm-up:
    (device us per call by CUDA function name, the profile, the wall us
    and the device's busy us of the window, the union of kernel
    intervals over all streams)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    per = {}
    for e in prof.key_averages():
        name = _function_name(e.key)
        per[name] = per.get(name, 0.0) + _device_us(e) / reps
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return per, prof, wall_us, busy


def device_ms(fn, reps, functions):
    """Device ms per call of ``fn`` in the given CUDA functions (the
    profiler's per-kernel device time over ``reps`` calls)."""
    return device_ms_by_function(fn, reps, functions)[0]


def device_ms_by_function(fn, reps, functions):
    """(device ms per call of ``fn`` in the given CUDA functions, {function:
    its ms per call})."""
    per, _, _, _ = device_profile(fn, reps)
    by = {f: per.get(f, 0.0) / 1e3 for f in sorted(functions)}
    return sum(by.values()), by


def check_ep_smem():
    """K3's, K6's and K11's layout bytes as ops/kernels.ep_smem_bytes sizes
    them (the launch plans) against the size the kernels' own layout takes
    (csrc/ep_col.cuh), and the device variant's block bytes (ep_plan)
    against the kernels' workspace stride, over the grammars' range of S
    = n_ar (to 300), Cp (to 43) and Wp (which must not enter) and both
    types; the plan takes the shared variant exactly where the layout
    fits a block.  Returns the number of cases."""
    n = 0
    for S in (1, 15, 29, 47, 91, 105, 136, 171, 300):
        for Cp, Wp in ((30, 50), (30, 400), (12, 24), (4, 20), (40, 50),
                       (43, 60)):
            for dt, it in ((torch.float32, 4), (torch.float64, 8)):
                D = K.DPDims(100, Wp, Cp, S, 8, Wp + 1, 1, 1, S, 1, 1, 1,
                             0, 0, 0)
                for which, name in ((0, "inside_ep"), (1, "outside_ep"),
                                    (2, "inside_ep_max")):
                    c_ = int(K.lib().rnaelem_ep_smem_bytes(which, D, it))
                    ws = int(K.lib().rnaelem_ep_ws_bytes(which, D, it))
                    py = K.ep_smem_bytes(name, S, S, Cp, dt)
                    dev_ = K.ep_plan(name, S, S, Cp, dt, variant="device")
                    plan = K.ep_plan(name, S, S, Cp, dt)
                    if c_ != py or ws != dev_.block_bytes or \
                            (plan.variant == "shared") != (
                                c_ <= K.SMEM_LIMIT):
                        fail("%s layout: the kernel's takes %d bytes (a "
                             "workspace slice %d), ep_smem_bytes says %d, "
                             "the device plan %d, the plan %s (S=%d, Cp=%d, "
                             "Wp=%d, %s)" % (name, c_, ws, py,
                                             dev_.block_bytes, plan, S, Cp,
                                             Wp, dt))
                    n += 1
    return n


def check_band_smem():
    """The M chain's dynamic shared memory (K2's band_m, K5's m_adj) as
    ops/kernels.band_smem_bytes sizes it against csrc/mchain.cuh's own
    layout, over the grammars' range of S (to 1,378: 50 dots), both types
    and every (reads per block, ring) pair a plan may pick; the plan's
    block fits (its threads, ``cells`` states a thread, take the S x G
    cells; the device variant's workspace slice is the layout, 256-byte
    aligned).  Returns the number of cases."""
    n = 0
    for S in (1, 15, 29, 47, 78, 91, 136, 153, 171, 300, 691, 1024, 1081,
              1378):
        for dt, it in ((torch.float32, 4), (torch.float64, 8)):
            shapes = [(g, 4) for g in (8, 4, 2, 1) if g * it <= 32]
            for which, name in ((0, "inside_band"), (1, "outside_band")):
                for G, R in shapes + [(1, 2)]:
                    c_ = int(K.lib().rnaelem_band_smem_bytes(which, S, G, R,
                                                             it))
                    py = K.band_smem_bytes(name, S, dt, G, R)
                    if c_ != py:
                        fail("%s M-chain shared memory: the kernel's layout "
                             "takes %d bytes, band_smem_bytes says %d (S=%d, "
                             "G=%d, R=%d, %s)" % (name, c_, py, S, G, R, dt))
                    n += 1
                plan = K.band_plan(name, S, dt)
                layout = int(K.lib().rnaelem_band_smem_bytes(
                    which, S, plan.G, plan.R, it))
                if plan.threads > K.MAX_THREADS or \
                        plan.smem > K.SMEM_LIMIT or \
                        plan.threads * plan.cells < S * plan.G or \
                        (plan.variant == "device") != (plan.smem == 0) or \
                        (plan.variant == "device" and plan.block_bytes !=
                         -(-layout // K.EP_WS_ALIGN) * K.EP_WS_ALIGN):
                    fail("%s: the plan %s (%s, %d cells a thread, %d "
                         "workspace bytes a block) does not fit a block"
                         % (name, plan, plan.variant, plan.cells,
                            plan.block_bytes))
    return n


def check_chain_smem():
    """K8's and K9's layouts as ops/kernels.chain_smem_bytes sizes them
    against csrc/chain.cuh's own (rnaelem_chain_smem_bytes), over S to
    4,096, both types and tiles of 1 to 100 steps; each plan of
    chain_plan (the shape's, K9's device variant) fits a block and sizes
    its layout so.  Returns the number of cases."""
    n = 0
    for S in (1, 28, 29, 66, 91, 136, 300, 1024, 1081, 1378, 4096):
        nnz = 2 * S
        for dt, it in ((torch.float32, 4), (torch.float64, 8)):
            for which, name in ((0, "linear_fwd"), (1, "linear_adj"),
                                (2, "linear_adj")):
                for R in ((K.CHAIN_RING,) if which == 0 else
                          (1, 3, 8, 100)):
                    c_ = int(K.lib().rnaelem_chain_smem_bytes(
                        which, S, R, nnz, it))
                    py = K.chain_smem_bytes(name, S, dt, R, nnz, which == 2)
                    if c_ != py:
                        fail("%s layout: the kernel's takes %d bytes, "
                             "chain_smem_bytes says %d (S=%d, R=%d, %s)"
                             % (name, c_, py, S, R, dt))
                    n += 1
            for name in K.CHAIN_KERNELS:
                plans = [K.chain_plan(name, S, LP, B_MAIN, dt, True, nnz)]
                if name == "linear_adj":
                    plans.append(K.chain_plan(name, S, LP, B_MAIN, dt, True,
                                              nnz, variant="device"))
                for plan in plans:
                    layout = int(K.lib().rnaelem_chain_smem_bytes(
                        2 * int(name == "linear_adj"), S, plan.R, nnz, it))
                    if plan.threads > K.MAX_THREADS or \
                            plan.walkers * plan.cells < S or \
                            (plan.variant == "shared" and (
                                plan.smem != layout or
                                plan.smem > K.SMEM_LIMIT)) or \
                            (plan.variant == "device" and (
                                plan.smem or plan.block_bytes != -(
                                    -layout // K.EP_WS_ALIGN) *
                                K.EP_WS_ALIGN)):
                        fail("%s: the plan %s does not fit a block" % (
                            name, plan))
                    n += 1
    return n


def cuda_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up (events)."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def make_reads(rng, n, lmin, lmax):
    """n random reads of lmin..lmax nt with flat qualities."""
    reads = []
    for i in range(n):
        L = int(rng.randint(lmin, lmax + 1))
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
        q = np.full(L + 1, 10 + (i % 3))
        q[-1] = 0 if i % 2 == 0 else 20
        reads.append((seq_to_ints(s), q))
    return reads


def main_reads():
    """The main path's reads: B_MAIN x LP nt, as bench.py makes them."""
    rng = np.random.RandomState(0)
    reads = []
    for i in range(B_MAIN):
        s = "".join("ACGU"[x] for x in rng.randint(0, 4, LP))
        q = np.full(LP + 1, 10 + (i % 3))
        q[-1] = 0
        reads.append((seq_to_ints(s), q))
    return reads


def random_params(cfg, dev, seed=0):
    """Flat initial weights plus 0.3 N(0, 1) noise from a numpy seed."""
    p = J.init_params(J.kernels(cfg, "cpu").g, cfg, device="cpu",
                      dtype="float64")
    rng = np.random.RandomState(seed)
    dt = torch.float32 if cfg.dtype == "float32" else torch.float64
    f = lambda x: torch.as_tensor(x, dtype=dt, device=dev)
    return J.Params(
        singles=f(p.singles.numpy() + 0.3 * rng.randn(*p.singles.shape)),
        pairs=f(p.pairs.numpy() + 0.3 * rng.randn(*p.pairs.shape)),
        lam=f(np.array([1.0, 1.0])))


def cfg_for(dtype):
    return J.ModelConfig(pattern=PATTERN, Lp=LP, max_span=50, max_iloop=30,
                         min_bpp=MIN_BPP, tau=0.1, dtype=dtype)


def batch_factors_for(cfg, reads, dev, params):
    batch = OBJ.stack_reads(cfg, reads, device=dev)
    d, c = J.batch_factors(cfg, params, batch.sd, batch.bp_ok, device=dev)
    return batch, d, c


def ep_column_ms(cfg, reads, params, dev, funcs, j0):
    """Device ms of K3 (inside_ep) and K6 (outside_ep) at column j0 for
    ``reads`` (the kernel forward's tables; the outside pass run through
    the later columns first), by CUDA function."""
    _, d, c = batch_factors_for(cfg, reads, dev, params)
    dp = J.kernels(cfg, dev).dp
    st = dp.st
    h = DP.hoisted(d, c, st)
    fs = dp.run_inside(d, c, h)
    ks = DP.clone_state(fs)
    out = {"inside_ep": device_ms_by_function(
        lambda: DP.ep_stage(ks, j0, d, c, h, st), REPS // 4,
        funcs["inside_ep"])}
    gs = DP.init_grads(fs, d, c, h)
    gbar = torch.ones((len(reads), 3), dtype=st.dtype, device=dev)
    DP.seed_parts(gs, gbar, c, st)
    dp.outside_columns(fs, gs, d, c, h, cfg.Lp + 1, j0 + 1)
    kg = DP.clone_state(gs)
    out["outside_ep"] = device_ms_by_function(
        lambda: DP.ep_adj(fs, kg, j0, d, c, h, st), REPS // 4,
        funcs["outside_ep"])
    return out


def ext_inputs(cfg, reads, params, dev, null):
    """(DP, d, c, hoisted terms, the kernel forward's tables) of ``reads``
    for the grammar's DP, or with ``null`` the masks' S=1 DP."""
    sd = J.stack_seqdata([J.make_seqdata(cfg, s_, q_) for s_, q_ in reads],
                         dev)
    k = J.kernels(cfg, dev)
    if null:
        dp = k.dp_null
        d, c = J._null_batch_factors(cfg, k, sd,
                                     J._candidate_pairs(cfg, k, sd))
    else:
        dp = k.dp
        bp, _ = J.effective_bp_mask_batch(cfg, sd, device=dev)
        d, c = J.batch_factors(cfg, params, sd, bp, device=dev)
    h = DP.hoisted(d, c, dp.st)
    return dp, d, c, h, dp.run_inside(d, c, h)


def ext_column_ms(cfg, reads, params, dev, funcs, j0, null=False):
    """Device ms of K4 (inside_ext) at column j0 for ``reads`` on the
    kernel forward's tables of the grammar's DP, or with ``null`` of the
    masks' S=1 DP."""
    dp, d, c, h, fs = ext_inputs(cfg, reads, params, dev, null)
    st = dp.st
    ks = DP.clone_state(fs)
    return device_ms(lambda: DP.ext_stage(ks, j0, d, c, h, st), REPS // 4,
                     funcs["inside_ext"])


def ext_adj_column_ms(cfg, reads, params, dev, funcs, j0, null=False):
    """Device ms of K7 (outside_ext) at column j0, as ext_column_ms takes
    K4's, the outside pass run through the later columns first."""
    dp, d, c, h, fs = ext_inputs(cfg, reads, params, dev, null)
    st = dp.st
    gs = DP.init_grads(fs, d, c, h)
    DP.seed_parts(gs, torch.ones((len(reads), 3), dtype=st.dtype,
                                 device=dev), c, st)
    dp.outside_columns(fs, gs, d, c, h, cfg.Lp + 1, j0 + 1)
    kg = DP.clone_state(gs)
    return device_ms(lambda: DP.ext_adj(fs, kg, j0, d, c, h, st),
                     REPS // 4, funcs["outside_ext"])


def trna_reads(tmp):
    """The 76 tRNAs as (seq, qual) reads, through a FASTQ file in tmp."""
    fq = os.path.join(tmp, "trna.fq")
    write_fq(fq, trna_seqs())
    return [(r.seq, r.qual) for r in FastqReader(fq).reads()]


def cyk_column_ms(reads, dev, funcs, dtype, j0=J0):
    """Device ms of K11 (inside_ep_max) and K12 (inside_ext_max) at column
    j0 of the CYK tables of ``reads`` (a tRNA scan chunk, bucket 96, the
    reference's converged model, the CYK pin set)."""
    cfg, params = MIO.read_model(GOLD_TRNA, Lp=96, dtype=dtype, device=dev)
    scfg, d, c = cyk_factors(cfg, params, reads, dev, False)
    mdp = DMB.MaxDP(J.kernels(scfg, dev).dp)
    state = mdp.tables(d, c)
    out = {}
    for kname, f in (("inside_ep_max", DMB.max_ep_stage),
                     ("inside_ext_max", DMB.max_ext_stage)):
        ks = DP.clone_state(state)
        out[kname] = device_ms(lambda: f(ks, j0, d, c, mdp.mst), REPS // 4,
                               funcs[kname])
    return out


def band_column_ms(cfg, reads, params, dev, funcs, j0):
    """Device ms of K2 (inside_band: band_front, band_bif, band_m, band_e)
    and K5 (outside_band: e_adj, band_adj) at column j0 for ``reads`` (the
    kernel forward's tables; the outside pass run through the later
    columns first), by CUDA function."""
    _, d, c = batch_factors_for(cfg, reads, dev, params)
    dp = J.kernels(cfg, dev).dp
    st = dp.st
    h = DP.hoisted(d, c, st)
    fs = dp.run_inside(d, c, h)
    ks = DP.clone_state(fs)
    fwd = [getattr(DP, n) for n in ("band_front", "band_bif", "band_m",
                                    "band_e")]
    out = {"inside_band": device_ms_by_function(
        lambda: [f(ks, j0, d, c, h, st) for f in fwd], REPS // 4,
        funcs["inside_band"])}
    gs = DP.init_grads(fs, d, c, h)
    gbar = torch.ones((len(reads), 3), dtype=st.dtype, device=dev)
    DP.seed_parts(gs, gbar, c, st)
    dp.outside_columns(fs, gs, d, c, h, cfg.Lp + 1, j0 + 1)
    kg = DP.clone_state(gs)
    out["outside_band"] = device_ms_by_function(
        lambda: [DP.e_adj(fs, kg, j0, d, c, h, st),
                 DP.band_adj(fs, kg, j0, d, c, h, st)], REPS // 4,
        funcs["outside_band"])
    return out


def plain_parts(cfg, params, batch, dev):
    """[B, 3] parts with every column stage in its plain version, on the
    card: the reference the kernels are held against."""
    dp = J.kernels(cfg, dev).dp
    d, c = J.batch_factors(cfg, params, batch.sd, batch.bp_ok, device=dev)
    state = plain_forward(dp, d, c, DP.hoisted(d, c, dp.st))
    return dp.extract_parts(state["O"], c)


# ------------------------------------------------------------ phase 2

def check_score_tables(cfg, reads, dev):
    """K1 vs its plain version on ``reads``; returns the max abs float
    error."""
    batch = OBJ.stack_reads(cfg, reads, device=dev)
    return compare_score_tables(cfg, batch.sd, batch.bp_ok, dev)


def compare_score_tables(cfg, sd, bp_ok, dev, same=None):
    """K1 (one launch) vs its plain version on a batch's SeqData and pair
    masks; returns the max abs float error.  ``same`` (a dict) gathers,
    per float output, the cells bit for bit the plain version's and all
    cells."""
    k = J.kernels(cfg, dev)
    seq, L, bp_ok, dots_cum = J.score_inputs(cfg, k, sd, bp_ok)
    args = (k.tab, seq, L, bp_ok, dots_cum, cfg.Wp, cfg.max_span, cfg.turn,
            cfg.no_ene, cfg.fix_rss)
    K.reset_counts()
    got = ET.score_tables(*args)
    if K.KERNELS["score_tables"].launches != 1:
        fail("score_tables: %d launches for one call"
             % K.KERNELS["score_tables"].launches)
    want = ET.score_tables_plain(*args)
    if same is not None:
        for key in ET.SCORE_KEYS:
            if want[key].is_floating_point():
                eq = got[key] == want[key]
                eq |= torch.isneginf(got[key]) & torch.isneginf(want[key])
                n0, n1 = same.get(key, (0, 0))
                same[key] = (n0 + int(eq.sum()), n1 + eq.numel())
    worst = 0.0
    for key in ET.SCORE_KEYS:
        a, b = got[key], want[key]
        if a.shape != b.shape or a.dtype != b.dtype:
            fail("score_tables %s: %s %s vs %s %s" % (
                key, a.shape, a.dtype, b.shape, b.dtype))
        if not a.is_floating_point():
            if not torch.equal(a, b):
                fail("score_tables %s: %d cells differ"
                     % (key, int((a != b).sum())))
            continue
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or \
                not torch.equal(torch.isneginf(a), torch.isneginf(b)):
            fail("score_tables %s: -inf pattern differs" % key)
        fin = torch.isfinite(b)
        err = (a[fin] - b[fin]).abs()
        if err.numel():
            bad = err > 1e-6 * b[fin].abs() + 1e-12
            if bad.any():
                fail("score_tables %s: max rel err %.3g" % (
                    key, float((err / b[fin].abs().clamp(min=1e-12)).max())))
            worst = max(worst, float(err.max()))
    return worst


def stage_compare(name, k_out, p_out, rel, significant):
    """Max abs error of one stage output; fails beyond ``rel``.  With
    ``significant`` (f32), cells more than 50 below their read's maximum
    are not compared: exp space under per-read shifts flushes them."""
    fk, fp = torch.isfinite(k_out), torch.isfinite(p_out)
    B = p_out.shape[-1]
    if significant:
        flat = p_out.reshape(-1, B)
        rowmax = torch.where(torch.isfinite(flat), flat,
                             torch.full_like(flat, -1e30)).amax(dim=0)
        sig = fp & (p_out >= rowmax - 50.0)
        kflat = k_out.reshape(-1, B)
        extra = torch.isfinite(kflat) & ~torch.isfinite(flat) & \
            (kflat >= rowmax - 40.0)
        if extra.any():
            fail("%s: %d cells finite and significant in the kernel, -inf "
                 "in the plain version" % (name, int(extra.sum())))
    else:
        sig = fp
        if not torch.equal(fk, fp):
            fail("%s: -inf pattern differs (%d cells)"
                 % (name, int((fk != fp).sum())))
    if (sig & ~fk).any():
        fail("%s: %d cells -inf in the kernel, finite in the plain version"
             % (name, int((sig & ~fk).sum())))
    if not sig.any():
        return 0.0
    err = (k_out[sig] - p_out[sig]).abs()
    lim = rel * p_out[sig].abs().clamp(min=1.0)
    if (err > lim).any():
        fail("%s: max abs err %.3g beyond %.0e relative"
             % (name, float(err.max()), rel))
    return float(err.max())


def check_stages(dp, d, c, j0, rel, significant):
    """Each column stage at column j0 vs its plain version on identical
    inputs (the kernel DP's tables for columns < j0, the plain stages
    before it at j0).  Returns {kernel name: max abs err}."""
    h, state = dp.start(d, c)
    dp.run_columns(state, d, c, h, 1, j0)
    errs = {}
    PAD = dp.st.PAD
    for stage, plain in zip(DP.STAGES, DP.PLAIN_STAGES):
        ks = DP.clone_state(state)
        stage(ks, j0, d, c, h, dp.st)
        plain(state, j0, d, c, h, dp.st)
        for key in STAGE_OUT[stage.__name__]:
            a, b = ks[key][j0 + PAD], state[key][j0 + PAD]
            e = stage_compare("%s %s" % (stage.__name__, key), a, b, rel,
                              significant)
            kn = STAGE_KERNEL[stage.__name__]
            errs[kn] = max(errs.get(kn, 0.0), e)
    return errs


# ------------------------------------------------------------ bounds

def _band_cells(Wp, n):
    """Cells (row j - k, width v) with k = 0..n and k + v <= Wp: the
    triangle of a band window that a gap of at most n reaches."""
    n = np.minimum(n, Wp)
    return np.where(n >= 0, (n + 1) * (Wp + 1) - n * (n + 1) // 2, 0)


def _ms(by, ops):
    """(least ms, what bounds it) for bytes and operations."""
    tb, to = by / MEM_BPS * 1e3, ops / PEAK_F32 * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def score_work(cfg, c, tab, B, itemsize):
    """K1 (one batch): seq/L/bp_ok/dots_cum in; the energy tables, of
    which the loop key tables (tri/tetra/hexa) give at most one entry per
    (j, read); 19 float + 2 int32 + 4 bool planes out; ~40 operations per
    cell."""
    Lp, W1 = cfg.Lp, cfg.Wp + 1
    cells = (Lp + 1) * W1 * B
    tab_n = sum(min(tab[k].numel(), (Lp + 1) * B)
                if k in ("tri", "tetra", "hexa") else tab[k].numel()
                for k in ET.FLOAT_TABLES)
    by = B * Lp * 8 + B * 8 + cells + B * (Lp + 1) * 4 + tab_n * itemsize \
        + cells * (19 * itemsize + 2 * 4 + 4)
    return by, 40.0 * cells


def batch_counts(cfg, st, c, B):
    """The column-independent quantities of a batch the column counts
    use: state sets and list sizes of the grammar, the per-read loop cap
    C_b = min(C, Cp) and the internal-loop cells it admits."""
    Wp, Cp, S = cfg.Wp, cfg.Cp, st.dims.S
    g = st.g
    kk = {k: v.cpu().numpy() for k, v in st.k.items()}
    states = lambda *ks: set(np.concatenate([kk[k].ravel() for k in ks]))
    q = dict(Wp=Wp, S=S, W1=Wp + 1, C1=Cp + 1,
             B=B, CC=(Wp + 1) * S * B, WB=(Wp + 1) * B, SB=S * B,
             n_rt=len(states("rt_s")), n_b1=len(states("b12_a")),
             n_c=len(states("b12_c")), nb=len(g.b12_tuples),
             n_pt_src=int((kk["pt_code"] != -1).any(0).sum()),
             n_tab=len(set(kk["pt_code"][kk["pt_code"] >= 0].ravel())),
             pt_nnz=int((kk["pt_code"] != -1).sum()), rt_nnz=len(kk["rt_s"]),
             lt_nnz=len(kk["lt_s"]), n_op=len(g.op_tuples),
             n_opa=len(states("op_a")), n_opc=len(states("op_c")),
             n_opc_rt=len(states("op_c", "rt_s")),
             have_ep=st.have_ep)
    if st.have_ep:
        Cb = np.minimum(c.C.cpu().numpy().astype(np.int64), Cp)
        pc = _band_cells(Wp, Cb)                       # P cells per read
        x = np.arange(Wp + 1)[:, None, None]
        u1 = np.arange(Cp + 1)[None, :, None]
        dl = np.arange(Cp + 1)[None, None, :]
        geo = (x + u1 <= Wp) & (dl <= x)
        caps, n_caps = np.unique(Cb, return_counts=True)
        q.update(
            pc=int(pc.sum()), cb1=int((Cb + 1).clip(min=0).sum()),
            n_s1=len(states("p13_s1")), n_s2=len(states("k2_s2")),
            n_s3=len(states("p13_s3")),
            n_s3x=len(states("p13_s3") - states("k2_s2")),
            eszg=2 * 4 * (Cp + 1) * (Cp + 2) // 2,
            vterms=sum(int(n) * int((geo & (dl + u1 <= cb)).sum())
                       for cb, n in zip(caps, n_caps)),
            n_xu=int(_band_cells(Wp, Cp)),
            spec=(0 if cfg.no_ene else
                  6 * (Wp + 1) * st.n2 * (2 * st.n13 / st.n_ar + 3)))
    return q


def column_work(cfg, st, c, q, j, itemsize, need):
    """{kernel: (bytes, operations)} of K2-K7 at column j, each kernel
    counted as one function of what its stage needs: each input cell read
    once, in the states it reads, each output cell written once (a
    cotangent it adds to is read and written); where the extent depends
    on the data (the band masks, the per-read loop cap C, finite exterior
    energies) only what this batch needs is counted.  The scratch that
    the kernels' functions pass to one another (K3's and K6's partial
    sums of their blocks, K5's column cotangents of M and B and its
    eR/bg2 partials) is not counted: a fused kernel would not move it.
    Operations are the stage's arithmetic, summed over its functions.

    ``need`` names the groups of leaf cotangents the caller keeps besides
    the tables' own: "weights" (eR, eL, bg2, pv: the singles' and pairs'
    gradient), "lam" (lambda's per-cell partials DL, the size-weight
    partials GSZ and the hoisted exponentials emisA and emisB, which
    depend on lambda alone) and "alphaP" (the injected pair factor, whose
    cotangent is the pair posterior).  A group left out is not counted:
    its bytes, and the operations that only it needs (K5's eR/eL/pv, DL
    and alphaP adds, K6's emisA/emisB/GSZ spreads, K7's eR and DL
    sums)."""
    wts, lmb, alp = ("weights" in need, "lam" in need, "alphaP" in need)
    it = itemsize
    B, S, W1, Wp, C1 = q["B"], q["S"], q["W1"], q["Wp"], q["C1"]
    CC, WB, SB = q["CC"], q["WB"], q["SB"]
    okP = c.okP[j].cpu().numpy()                         # [W1, B]
    okB = c.okB[j].cpu().numpy()
    okE = c.okE[j].cpu().numpy()
    okM = c.okM[j].cpu().numpy()
    wv = np.arange(W1)[:, None]
    okP2 = int((okP & (wv >= 2)).sum())                 # cells reading E/P
    okB1 = int((okB & (wv >= 1)).sum())                 # cells reading T2
    tri1 = int((okB * wv).sum())                        # T1 (dk, w) cells
    nP, nE, nM, nB = (int(m.sum()) for m in (okP, okE, okM, okB))
    pvb = nP * q["n_tab"]                               # pair emissions
    out = {}

    # K2 (inside_band)
    by2 = it * (
        Wp * q["n_rt"] * B + okB1 * q["n_rt"] + 2 * okP2 * q["n_pt_src"]
        + tri1 * q["n_b1"] + pvb
        + 2 * W1 * S * B + S * B                        # eL rows, ep, eR
        + 8 * WB + B                                    # per-cell planes
        + 7 * CC) + 4 * WB                              # 7 rows out; masks
    ops2 = 2.0 * (tri1 * q["nb"] + okB1 * q["rt_nnz"] + WB * q["rt_nnz"]
                  + 2 * okP2 * q["pt_nnz"] + WB * q["lt_nnz"])
    out["inside_band"] = (by2, ops2)

    # K3 (inside_ep), per read with its cap C_b: P cells (j - dl, v) with
    # dl <= C_b, dl + v <= Wp; left-flank LL cells (j - x, u1) with
    # u1 <= C_b, x + u1 <= Wp (the right flank, LL row j up to width C_b,
    # lies in that set); emisB on the P cells; emisA, spec_il rows j; the
    # read-independent size weights eSZg; ep out
    if q["have_ep"]:
        by3 = it * (
            q["pc"] * (q["n_s1"] + q["n_s2"] + 2 * 4) + q["cb1"] * q["n_s3x"]
            + B * W1 * (2 * 4 + (0 if cfg.no_ene else 6)) + q["eszg"]
            + W1 * S * B) + 4 * B + (4 * (cfg.Lp + 1) * B if cfg.fix_rss
                                     else 0)
        ops3 = 2.0 * (q["vterms"] * (2 * st.n_ar + 12) + q["pc"] * (
            st.n13 + st.n2)) + 2.0 * B * q["spec"]
        out["inside_ep"] = (by3, ops3)
    else:
        out["inside_ep"] = (it * CC, 0.0)

    # K4 (inside_ext): for each w >= 1 with a finite exterior energy, P row
    # j at width w and O row j - w in the split tuples' states (row j - 1
    # also in the chain's sources); ext, eR rows; O row j out
    ext_ok = np.isfinite(c.ext[j].cpu().numpy()) & (wv >= 1)
    n_ext = int(ext_ok.sum())
    by4 = it * (n_ext * q["n_opa"] + int(ext_ok[2:].sum()) * q["n_opc"]
                + q["n_opc_rt"] * B + WB + SB + B + SB)
    ops4 = 2.0 * (n_ext * q["n_op"] + B * q["rt_nnz"])
    out["inside_ext"] = (by4, ops4)

    # K5 (outside_band): the adjoint of K2's E, M, B/T1 and L/P/T2 at
    # column j; liveX = the cells of table X its mask admits (E, M, B/T1/T2)
    # in all S states.  Forward cells: E, LL, M, ep at live E; M, Bt at
    # live M; T1, T2, Bt at live B; the T1 triangle and the T2 rows of the
    # splits; rows j of LL, P, T2 and j-1 of LL, E, P, T2; eL rows, eR row,
    # gates, per-cell planes, bg2, pv.  Cotangents: rows j of gE, gLL, gP,
    # gT1, gT2 read; rows j-1 of gLL, gE, gP, gT2, the triangle's and the
    # split rows' added to; gEP written (K6 reads it); DL row j, eL, eR row
    # j-1, bg2, pv and alphaP added to
    lE, lM, lB = nE * S, nM * S, nB * S
    split = tri1 * q["n_b1"] + Wp * q["n_c"] * B
    by5 = it * (
        4 * lE + 2 * nE + 2 * lM + W1 * S * B + WB + 3 * lB + split
        + 7 * CC + SB + B + 5 * WB + (W1 + 1) * B + pvb
        + 5 * CC + 2 * 4 * CC + 2 * split + CC
        + lmb * 2 * CC + alp * 2 * WB
        + wts * 2 * (W1 * S * B + SB + (W1 + 1) * B + pvb)) + WB
    ops5 = (6.0 * lE + 2.0 * nM * q["lt_nnz"] + 4.0 * lB
            + 4.0 * tri1 * q["nb"]
            + 2.0 * (WB * q["rt_nnz"] + okP2 * q["pt_nnz"])
            + 2.0 * (2 * WB * q["rt_nnz"] + 2 * okP2 * q["pt_nnz"])
            + wts * 2.0 * (CC + 2 * okP2 * st.n_pt)
            + float(lmb * CC + alp * WB))
    out["outside_band"] = (by5, ops5)

    # K6 (outside_ep): the adjoint of K3 at column j.  It reads what K3
    # reads (P cells, both LL flanks, emisB on the P cells, emisA and
    # spec_il rows j, eSZg), the ep row and its cotangent gEP; it adds to
    # the cotangents of the P and LL cells, emisB, emisA, the per-read
    # size-weight partials GSZ [2, 4, Cp+1, Cp+1, B] (its triangle) and DL
    # row j
    if q["have_ep"]:
        pc, n_xu, vt = q["pc"], q["n_xu"], q["vterms"]
        fwd_in = (pc * (q["n_s1"] + q["n_s2"] + 2 * 4) + q["cb1"] * q["n_s3x"]
                  + B * W1 * (2 * 4 + (0 if cfg.no_ene else 6)) + q["eszg"])
        by6 = it * (
            2 * CC + fwd_in
            + 2 * (pc * (q["n_s1"] + q["n_s2"]) + q["cb1"] * q["n_s3x"])
            + lmb * 2 * (pc * 2 * 4 + 2 * 4 * WB + q["eszg"] * B + CC)
        ) + 4 * B + (4 * (cfg.Lp + 1) * B if cfg.fix_rss else 0)
        ops6 = (2.0 * 6 * CC * st.n2 / S + 4.0 * n_xu * B * st.n2
                + vt * (8.0 * st.n_ar + 32) + lmb * 3 * 16.0 * vt
                + 2 * 2.0 * pc * st.n13)
        out["outside_ep"] = (by6, ops6)
    else:
        out["outside_ep"] = (0.0, 0.0)

    # K7 (outside_ext): O rows j-1 and j, eR, gate, gO row j, ext; at live
    # exterior widths the P column and O rows j-w (read, their cotangents
    # added to, and DL at those cells); eR's cotangent added to; gO row
    # j-1 added to
    by7 = it * (5 * SB + B + wts * 2 * SB + WB + (6 + lmb * 2) * n_ext * S
                + 2 * SB)
    ops7 = 2.0 * (wts * B * q["rt_nnz"] + (2 + lmb) * n_ext * q["n_op"]) \
        + 2.0 * B * q["rt_nnz"]
    out["outside_ext"] = (by7, ops7)
    return out


def bounds(cfg, st, c, tab, j0, B, itemsize):
    """Least time per unit (ms) for K1 (one batch) and K2-K7 (one column
    j0) of fn+grad, whose outside pass must give the weights' and
    lambda's cotangents: the larger of bytes / memory rate and operations
    / f32 rate."""
    q = batch_counts(cfg, st, c, B)
    work = column_work(cfg, st, c, q, j0, itemsize, ("weights", "lam"))
    work["score_tables"] = score_work(cfg, c, tab, B, itemsize)
    return {k: _ms(*v) for k, v in work.items()}


def mask_pass_bound(cfg, sd, dev, itemsize):
    """Row I: one S=1 forward and outside pass (K1-K7 over every column)
    of the batch ``sd``, as one function whose output is alphaP's
    cotangent (the pair posteriors): (ms, what bounds it)."""
    return _ms(*mask_pass_work(cfg, sd, dev, itemsize))


def mask_pass_work(cfg, sd, dev, itemsize):
    """(bytes, operations) of row I for the batch ``sd``."""
    k = J.kernels(cfg, dev)
    bp0 = J._candidate_pairs(cfg, k, sd)
    _, c = J._null_batch_factors(cfg, k, sd, bp0)
    st = k.dp_null.st
    B = bp0.shape[0]
    q = batch_counts(cfg, st, c, B)
    by, ops = score_work(cfg, c, k.tab, B, itemsize)
    for j in range(1, cfg.Lp + 1):
        for b_, o_ in column_work(cfg, st, c, q, j, itemsize,
                                  need=("alphaP",)).values():
            by, ops = by + b_, ops + o_
    return by, ops


def chain_bounds(lin, L, Lp, itemsize):
    """K8 and K9 for one batch of lengths L: K8 reads the rows p < L_b of
    eR and writes the chain rows 0..L_b and the parts; K9 reads eR and
    those rows, the parts' cotangent, and writes eR's cotangent [Lp, S,
    B].  Operations: per step and transition, K8 a max, an exp and an
    add; K9 an exp, a multiply and an add."""
    S, B = lin.dims.S, len(L)
    nnz = int(lin.k["rt_s"].numel())
    steps = int(np.sum(L))
    terms = steps * nnz
    by8 = itemsize * (steps * S + (steps + B) * S + 3 * B) + 8 * B
    by9 = itemsize * (steps * S + (steps + B) * S + 3 * B + Lp * S * B) \
        + 8 * B
    return {"linear_fwd": _ms(by8, 4.0 * terms + steps * S),
            "linear_adj": _ms(by9, 4.0 * terms)}


# ------------------------------------------------------------ outside pass

def plain_forward(dp, d, c, h):
    """The inside tables with every stage in its plain version."""
    state = DP.init_state(dp.st, c.wsp.shape[-1])
    for j in range(1, dp.dims.Lp + 1):
        for stage in DP.PLAIN_STAGES:
            stage(state, j, d, c, h, dp.st)
    return state


def outside_grads(dp, fs, d, c, h, gbar, stages, lam=True):
    """finish_grads of an outside pass through ``stages`` (the kernels'
    DP.ADJ_STAGES or DP.PLAIN_ADJ_STAGES), lambda's whole cotangent too
    when ``lam``: through K20 and K17 after the kernels' stages, through
    lam_sum_plain and autograd through hoisted_plain after the plain
    ones."""
    gs = DP.init_grads(fs, d, c, h)
    DP.seed_parts(gs, gbar, c, dp.st)
    for j in range(dp.dims.Lp, 0, -1):
        for stage in stages:
            stage(fs, gs, j, d, c, h, dp.st)
    if stages is DP.ADJ_STAGES:
        return DP.finish_grads(gs, d, c, dp.st, lam)
    g = DP.finish_grads(gs, d, c, dp.st, False)
    if not lam:
        return g
    leaf = d.lam.detach().requires_grad_(True)
    with torch.enable_grad():
        hp = DP.hoisted_plain(d._replace(lam=leaf), c, dp.st)
        (gh,) = torch.autograd.grad([hp[k_] for k_ in DP.HOISTED], [leaf],
                                    list(g[6:]), allow_unused=True)
    return g[:4] + (DP.lam_sum_plain(gs["DL"], gs["lam"], dp.st, gh),) + g[5:]


def full_grads(cfg, params, batch, dev, plain):
    """(f [B], per-read gradients of f w.r.t. singles, pairs and lam, and
    alphaP's cotangent): per-read copies of the weights, the factors, the
    hoisted tensors and the outside pass through the kernels (K14-K17,
    K1-K7) or the plain versions."""
    dp = J.kernels(cfg, dev).dp
    leaves = [x.detach().clone().requires_grad_(True)
              for x in J.per_read(params, batch.valid.shape[0])]
    with torch.enable_grad():
        d, c = J.batch_factors_pr(cfg, J.Params(*leaves), batch.sd,
                                  batch.bp_ok, device=dev, plain=plain)
        d = d._replace(alphaP=d.alphaP.requires_grad_(True))
        h = (DP.hoisted_plain if plain else DP.hoisted)(d, c, dp.st)
    with torch.no_grad():
        fs = plain_forward(dp, d, c, h) if plain else dp.run_inside(d, c, h)
        parts = dp.extract_parts(fs["O"], c)
    with torch.enable_grad():
        pl = parts.detach().requires_grad_(True)
        f, _ = OBJ._per_read_terms(cfg, pl, batch, False)
        (gbar,) = torch.autograd.grad(f.sum(), pl)
    g = outside_grads(dp, fs, d, c, h, gbar,
                      DP.PLAIN_ADJ_STAGES if plain else DP.ADJ_STAGES)
    with torch.enable_grad():
        outs = [d.eR, d.eL, d.bg2, d.pv, d.lam, d.alphaP]
        gr = torch.autograd.grad(outs, leaves + [d.alphaP], list(g[:6]),
                                 allow_unused=True)
    return f.detach(), [torch.zeros_like(x) if y is None else y
                        for x, y in zip(leaves + [d.alphaP], gr)]


def rel_err(a, b):
    """Max-norm error of a relative to b's max norm (0 for two zeros)."""
    a, b = a.double(), b.double()
    scale = float(b.abs().max()) if b.numel() else 0.0
    err = float((a - b).abs().max()) if b.numel() else 0.0
    return err / scale if scale > 0 else err


def worst_read(a, b, axis=0):
    """rel_err of a against b read by read (the read axis ``axis``), the
    worst read's."""
    a, b = a.movedim(axis, 0), b.movedim(axis, 0)
    return max(rel_err(a[r], b[r]) for r in range(b.shape[0]))


def grad_compare(name, a, b, rel):
    """Fails beyond ``rel`` (relative, max norm); returns the max abs
    error."""
    if torch.isnan(a).any():
        fail("%s: NaN in the kernel's cotangents" % name)
    e = rel_err(a, b)
    if not e <= rel:
        fail("%s: max-norm relative error %.3g beyond %.0e" % (name, e, rel))
    return float((a.double() - b.double()).abs().max()) if b.numel() else 0.0


def check_adj_stages(dp, d, c, j0, rel):
    """Each adjoint stage at column j0 vs its plain version on identical
    inputs: the kernel forward's tables, the cotangents of the kernel
    outside pass over the columns after j0 (seeded with gbar from a numpy
    seed), the plain adjoint stages before it at j0.  The tables compare
    at the rows below j0 (and at j0 but for band_adj, whose kernels keep
    the column's own intra-stage cotangents in row j0), every row
    cotangent and lambda's whole cotangent.  Returns {kernel: max abs
    err}."""
    st = dp.st
    h = DP.hoisted(d, c, st)
    fs = dp.run_inside(d, c, h)
    B = c.wsp.shape[-1]
    gbar = torch.as_tensor(np.random.RandomState(5).rand(B, 3),
                           dtype=st.dtype, device=fs["O"].device)
    gs = DP.init_grads(fs, d, c, h)
    DP.seed_parts(gs, gbar, c, st)
    dp.outside_columns(fs, gs, d, c, h, dp.dims.Lp + 1, j0 + 1)
    r = j0 + st.PAD
    errs = {}
    if d.cls is not None:
        # the class sums come out at the end of the column (K5's cls_red
        # sums what K7 and K5 left): the whole column's adjoint
        kg, pg = (DP.clone_state(gs) for _ in range(2))
        for stage, plain in zip(DP.ADJ_STAGES, DP.PLAIN_ADJ_STAGES):
            stage(fs, kg, j0, d, c, h, st)
            plain(fs, pg, j0, d, c, h, st)
        errs["outside_band"] = grad_compare("column %d class sums" % j0,
                                            kg["cls"], pg["cls"], rel)
        del kg, pg
    for stage, plain in zip(DP.ADJ_STAGES, DP.PLAIN_ADJ_STAGES):
        kg = {k: v.clone() for k, v in gs.items() if not k.startswith("_")}
        stage(fs, kg, j0, d, c, h, st)
        plain(fs, gs, j0, d, c, h, st)
        name = stage.__name__
        rows = r if name == "band_adj" else r + 1
        e = 0.0
        for key in DP.GRAD_TABLES:
            e = max(e, grad_compare("%s %s" % (name, key), kg[key][:rows],
                                    gs[key][:rows], rel))
        for key in GRAD_KEYS:
            e = max(e, grad_compare("%s %s" % (name, key), kg[key],
                                    gs[key], rel))
        lk = DP.finish_grads(kg, d, c, st)[4]
        lp = DP.finish_grads(gs, d, c, st)[4]
        el = float((lk - lp).abs().max())
        if not el <= rel * max(1.0, float(lp.abs().max())):
            fail("%s lambda: error %.3g beyond %.0e relative" % (name, el, rel))
        kn = ADJ_KERNEL[name]
        errs[kn] = max(errs.get(kn, 0.0), e, el)
    return errs


GRAD_NAMES = ("singles", "pairs", "lam", "alphaP")


def check_full_gradient(cfg64, cfg32, small, dev):
    """f64 kernels vs f64 plain on the small batch, every leaf per read;
    two kernel runs bitwise equal; batch_fn_grad_pr (the trainer's entry
    point) vs the same plain version, per read, and its read-order sum vs
    batch_fn_grad; f32 kernels vs f64 plain printed."""
    p64 = random_params(cfg64, dev)
    b = OBJ.stack_reads(cfg64, small, device=dev)
    _, gk = full_grads(cfg64, p64, b, dev, plain=False)
    _, gk2 = full_grads(cfg64, p64, b, dev, plain=False)
    fp, gp = full_grads(cfg64, p64, b, dev, plain=True)
    axes = (0, 0, 0, -1)                   # alphaP's read axis is last
    errs = {n: worst_read(a, c_, ax)
            for n, a, c_, ax in zip(GRAD_NAMES, gk, gp, axes)}
    for n, e in errs.items():
        if torch.isnan(gk[GRAD_NAMES.index(n)]).any() or not e <= 1e-9:
            fail("full gradient f64 %s: worst read's relative error %.3g "
                 "beyond 1e-9" % (n, e))
    for n, a, a2 in zip(GRAD_NAMES, gk, gk2):
        if not torch.equal(a, a2):
            fail("full gradient: two kernel runs differ in %s" % n)
    f, gpr, eff = OBJ.batch_fn_grad_pr(cfg64, p64, b, device=dev)
    e_pr = {"f": rel_err(f, fp)}
    e_pr.update({n: worst_read(a, c_) for n, a, c_ in
                 zip(GRAD_NAMES, gpr, gp)})
    if not max(e_pr.values()) <= 1e-9:
        fail("batch_fn_grad_pr vs plain: %s beyond 1e-9" % json.dumps(e_pr))
    fn, gsum, _ = OBJ.reduce_per_read(f, gpr, eff)
    fb, gb, _ = OBJ.batch_fn_grad(cfg64, p64, b, device=dev)
    e_sum = max([abs(fn - float(fb)) / max(1.0, abs(float(fb)))] + [
        rel_err(torch.as_tensor(a), c_.cpu()) for a, c_ in zip(gsum, gb)])
    if not e_sum <= 1e-12:
        fail("per-read gradients: read-order sum differs from batch_fn_grad "
             "by %.3g" % e_sum)
    p32 = random_params(cfg32, dev)
    b32 = b._replace(lik_sign=b.lik_sign.float(), eff=b.eff.float())
    _, g32 = full_grads(cfg32, p32, b32, dev, plain=False)
    e32 = {n: worst_read(a, c_, ax)
           for n, a, c_, ax in zip(GRAD_NAMES, g32, gp, axes)}
    print("check full gradient B=%d, per read (worst read, relative max "
          "norm): f64 kernels vs f64 plain %s (<= 1e-9); two kernel runs "
          "bitwise equal; batch_fn_grad_pr vs f64 plain %s (<= 1e-9); its "
          "read-order sum vs batch_fn_grad %.3g (<= 1e-12); f32 kernels vs "
          "f64 plain %s" % (len(small), json.dumps(errs), json.dumps(e_pr),
                            e_sum, json.dumps(e32)), flush=True)
    return max(errs.values())


def plain_posterior(cfg, sd, dev):
    """Pair posteriors [B, Lp+1, Wp+1] of the motif-free pass with the
    factors (not K14), the hoisted tensors (not K16) and every forward
    and adjoint stage in their plain versions."""
    k = J.kernels(cfg, dev)
    bp0 = J._candidate_pairs(cfg, k, sd)
    d, c = J._null_batch_factors(cfg, k, sd, bp0, plain=True)
    dp = k.dp_null
    h = DP.hoisted_plain(d, c, dp.st)
    fs = plain_forward(dp, d, c, h)
    gbar = torch.zeros((bp0.shape[0], 3), dtype=k.dtype, device=k.device)
    gbar[:, 0] = 1.0
    g = outside_grads(dp, fs, d, c, h, gbar, DP.PLAIN_ADJ_STAGES, False)
    return torch.movedim(g[5], -1, 0), bp0


def check_masks(cfg64, cfg32, small, dev):
    """The S=1 pass: posteriors and masks of K1-K7 vs the plain version."""
    thr = float(np.log(MIN_BPP))
    sd64 = J.stack_seqdata([J.make_seqdata(cfg64, s, q) for s, q in small],
                           dev)
    sd32 = J.stack_seqdata([J.make_seqdata(cfg32, s, q) for s, q in small],
                           dev)
    post_p, bp0 = plain_posterior(cfg64, sd64, dev)
    _, post_k, _ = J.bpp_posterior_batch(cfg64, sd64, dev)
    e_post = float((post_k - post_p).abs().max())
    if not e_post <= 1e-9:
        fail("masks: f64 posteriors differ by %.3g" % e_post)
    lp = torch.log(torch.clamp(post_p, min=1e-300))
    keep_p = bp0 & (lp >= thr)
    keep_k, _ = J.effective_bp_mask_batch(cfg64, sd64, dev)
    diff = keep_k != keep_p
    if (diff & ((post_p - MIN_BPP).abs() > 1e-9)).any():
        fail("masks: f64 masks differ away from the threshold")
    keep_32, _ = J.effective_bp_mask_batch(cfg32, sd32, dev)
    d32 = keep_32 != keep_p
    far = d32 & ((lp - thr).abs() > 1e-3)
    print("check masks S=1 B=%d: f64 posteriors max abs err %.3g (<= 1e-9), "
          "%d f64 mask cells differ (all within 1e-9 of the threshold); f32 "
          "masks: %d of %d cells differ from the f64 plain version, %d of "
          "them more than 1e-3 (log) from the threshold"
          % (len(small), e_post, int(diff.sum()), int(d32.sum()),
             int(bp0.sum()), int(far.sum())), flush=True)
    if far.any():
        fail("masks: f32 mask cells differ far from the threshold")
    return e_post


# ------------------------------------------------ no-rss chain, per read

def norss_cfg(dtype):
    return J.ModelConfig(pattern=NORSS, Lp=LP, max_span=50, max_iloop=30,
                         min_bpp=MIN_BPP, tau=0.1, no_rss=True, dtype=dtype)


def chain_inputs(cfg, reads, dev, seed=6):
    """(static, eR [Lp, S, B], L [B], a parts cotangent [B, 3]) of the
    reads under random weights."""
    k = J.kernels(cfg, dev)
    sd = J.stack_seqdata([J.make_seqdata(cfg, s_, q_) for s_, q_ in reads],
                         dev)
    eR = J.right_emissions(
        cfg, k, J.per_read(random_params(cfg, dev, seed), len(reads)), sd)
    L = torch.as_tensor(sd.L, device=dev).long()
    gp = torch.as_tensor(np.random.RandomState(seed).rand(len(reads), 3),
                         dtype=eR.dtype, device=dev)
    return k.dp.st, eR, L, gp


def plain_chain(lin, eR, L, gp):
    """(parts, eR's cotangent) of the plain chain and its autograd."""
    leaf = eR.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        parts = LIN.chain_plain(lin, leaf, L)
        (g,) = torch.autograd.grad(parts, leaf, gp)
    return parts.detach(), g


def chain_batches(small, reads):
    """The batches of the chain checks: the small one (B=16), the main
    path's (B=128 x 100 nt), one read, 7 reads and 600 reads (60-100
    nt): several blocks an SM."""
    return (("B=%d" % len(small), small),
            ("B=%d x %d nt" % (len(reads), LP), reads),
            ("B=1", reads[:1]), ("B=7", small[:7]),
            ("B=600", make_reads(np.random.RandomState(14), 600, 60, LP)))


def check_chain(small, reads, dev):
    """K8/K9 vs the plain chain, f64 and f32, at B = 16, 128, 1, 7 and
    600; two kernel runs bitwise equal.  Returns {kernel: max abs err} of
    the f32 main batch."""
    errs, msgs = {}, []
    for dtype, rel in (("float64", 1e-9), ("float32", 1e-4)):
        for name, rr in chain_batches(small, reads):
            lin, eR, L, gp = chain_inputs(norss_cfg(dtype), rr, dev)
            parts, rows = K.chain_fwd(lin, eR, L)
            g = K.chain_adj(lin, eR, L, rows, gp)
            parts2, rows2 = K.chain_fwd(lin, eR, L)
            if not (torch.equal(parts, parts2) and torch.equal(
                    g, K.chain_adj(lin, eR, L, rows2, gp))):
                fail("chain kernels: two runs differ (%s %s)"
                     % (dtype, name))
            pp, gpl = plain_chain(lin, eR, L, gp)
            fin = torch.isfinite(pp)
            if not torch.equal(fin, torch.isfinite(parts)):
                fail("linear_fwd %s %s: -inf pattern differs" % (dtype, name))
            ef = grad_compare("linear_fwd %s %s" % (dtype, name),
                              parts[fin], pp[fin], rel)
            ea = grad_compare("linear_adj %s %s" % (dtype, name), g, gpl,
                              rel)
            msgs.append("%s %s: parts %.3g, d eR %.3g"
                        % (dtype, name, ef, ea))
            if dtype == "float32" and rr is reads:
                errs = {"linear_fwd": ef, "linear_adj": ea}
    print("check chain %s (no-rss, S=%d) K8/K9 vs plain, max abs err (f64 "
          "within 1e-9, f32 within 1e-4 relative, max norm; two runs bitwise "
          "equal; plans %s): %s" % (NORSS, lin.dims.S, json.dumps(
              {k_: K.KERNELS[k_].variants for k_ in CHAIN_KERNELS}),
              "; ".join(msgs)), flush=True)
    return errs


# ------------------------------------------------------------ training

def write_fq(path, seqs, flagged=True):
    """FASTQ with flat '+' qualities and the has-motif sentinel."""
    with open(path, "w") as f:
        for i, s_ in enumerate(seqs):
            f.write("@r%d\n%s\n+\n%s%s\n" % (
                i, s_, "+" * len(s_), "!" if flagged else "+"))


def step_fq(no_rss, tmp):
    """The production step's FASTQ (64 random reads x 100 nt, numpy seed
    0) under ``tmp``."""
    rng = np.random.RandomState(0)
    fq = os.path.join(tmp, "step_%s.fq" % ("norss" if no_rss else "rss"))
    with open(fq, "w") as f:
        for i in range(N_POS):
            s_ = "".join("ACGU"[c] for c in rng.randint(0, 4, LP))
            f.write("@r%d\n%s\n+\n%s!\n" % (i, s_, chr(33 + 10) * LP))
    return fq


def step_trainer(pattern, no_rss, fq, dev, group=None):
    """The production step's Trainer (f32, Adam, flat start) on ``fq``."""
    cfg = J.ModelConfig(pattern=pattern, Lp=LP, max_span=50, max_iloop=30,
                        min_bpp=MIN_BPP, tau=0.1, rho_theta=0.1,
                        rho_lambda=0.1, no_rss=no_rss, dtype="float32")
    dev = dev if group is None else group.device
    params = J.init_params(J.kernels(cfg, dev).g, cfg, device=dev)
    tr = TRN.Trainer(cfg, params, max_iter=1 + STEPS, batch_size=N_POS,
                     kmer_shuf=2, device=dev, group=group)
    tr.set_fq(fq)
    return cfg, tr


def stage_timer(rec):
    """timed(key, fn): ``fn`` with the device synchronised around each
    call and its seconds appended to rec[key]."""
    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return run
    return timed


def production_step(pattern, no_rss, tmp, dev, check=True):
    """The Trainer's step as bench.py times it (64 random reads x 100 nt,
    numpy seed 0, 64 fresh negatives per step, f32, Adam): one warm-up
    step and STEPS timed steps, each stage timed with the device
    synchronised around it.  Returns a dict of the step's numbers (the
    trained model's text among them); the launch counts are those of this
    run alone."""
    fq = step_fq(no_rss, tmp)
    cfg, tr = step_trainer(pattern, no_rss, fq, dev)
    rec = {}
    timed = stage_timer(rec)

    starts, fns = [], []
    objective = tr._objective

    def step_objective(x, it):
        starts.append(time.perf_counter())
        fn, gr = timed("objective", objective)(x, it)
        fns.append(fn)
        return fn, gr

    tr._objective = step_objective
    tr._read_batch_host = timed("negatives", tr._read_batch_host)
    saved = {n: getattr(OBJ, n) for n in (
        "stack_reads", "batch_bp_masks", "batch_fn_grad_pr",
        "reduce_per_read")}
    last = {}

    def fn_grad(cfg_b, params_, batch, *a):
        out = saved["batch_fn_grad_pr"](cfg_b, params_, batch, *a)
        last.update(cfg=cfg_b, params=params_, batch=batch, out=out)
        return out

    for n, key, f in (("stack_reads", "stack", saved["stack_reads"]),
                      ("batch_bp_masks", "masks", saved["batch_bp_masks"]),
                      ("batch_fn_grad_pr", "fn_grad", fn_grad),
                      ("reduce_per_read", "reduce",
                       saved["reduce_per_read"])):
        setattr(OBJ, n, timed(key, f))
    try:
        K.reset_counts()
        tr.train()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = {n: kk.launches for n, kk in K.KERNELS.items()}
    finally:
        for n, f in saved.items():
            setattr(OBJ, n, f)
    if len(starts) != 1 + STEPS:
        fail("production step %s: %d evaluations, expected %d"
             % (pattern, len(starts), 1 + STEPS))
    if not all(np.isfinite(fns)):
        fail("production step %s: objective not finite: %s" % (pattern, fns))
    steps = np.diff(starts + [t_end])
    mean = lambda key: 1e3 * float(np.mean(rec[key][1:]))
    out = dict(pattern=pattern + (" --no-rss" if no_rss else ""),
               warmup_s=float(steps[0]),
               step_ms=1e3 * float(np.mean(steps[1:])),
               negatives_ms=mean("negatives"), masks_ms=mean("masks"),
               stack_ms=mean("stack") - mean("masks"),
               fn_grad_ms=mean("fn_grad"), reduce_ms=mean("reduce"),
               adam_ms=1e3 * float(np.mean(steps[1:] - np.asarray(
                   rec["objective"][1:]))),
               fn=[float(v) for v in fns], launches=launches, fq=fq,
               model="\n".join(MIO.model_lines(cfg, tr.params)) + "\n")
    out["seqs_per_s"] = 2 * N_POS * 1e3 / out["step_ms"]
    out["grad_err"] = check_step_gradient(last, dev) if check else None
    print("production step %s f32, %d reads + %d fresh negatives x %d nt: "
          "%.1f ms per step (%.1f seqs/s, mean of %d steps after a warm-up "
          "step of %.2f s); per step: negatives (host) %.2f ms, negatives' "
          "masks %.2f ms, stack_reads packing %.2f ms, fn+grad (per read) "
          "%.2f ms, host reduce %.2f ms, Adam update and log %.2f ms; fn per "
          "step %s; launches %s; the last step's f32 per-read f and "
          "gradients vs the f64 plain version (relative max norm: worst "
          "read <= 1e-2, sum over reads <= 1e-3) %s" % (
              out["pattern"], N_POS, N_POS, LP, out["step_ms"],
              out["seqs_per_s"], STEPS, out["warmup_s"],
              out["negatives_ms"], out["masks_ms"], out["stack_ms"],
              out["fn_grad_ms"], out["reduce_ms"], out["adam_ms"],
              json.dumps([round(v, 4) for v in out["fn"]]),
              json.dumps(launches), json.dumps(out["grad_err"])), flush=True)
    return out


def check_step_gradient(last, dev):
    """The last production step's per-read f and gradients (f32 kernels,
    the trainer's own batch of reads and negatives and its weights) vs the
    f64 plain version on the same inputs (every stage's plain version on
    the card for rss models, the plain chain on the CPU for no-rss ones):
    read by read within 1e-2 of the read's max norm, and summed over the
    reads within 1e-3.  A read whose gradient terms nearly cancel carries
    an f32 error near 1e-3 of its own max norm (..*.. read 9.1e-4 on an
    H100); a wrong leaf or a read mixed with another is off by O(1).
    Returns {leaf: worst read's relative error, leaf + " sum": ...}."""
    cfg = dataclasses.replace(last["cfg"], dtype="float64")
    f32, g32, _ = last["out"]
    b = last["batch"]
    b = b._replace(lik_sign=b.lik_sign.double(), eff=b.eff.double())
    p64 = J.Params(*[x.detach().double() for x in last["params"]])
    if cfg.no_rss:
        cpu = lambda x: (J.SeqData(*[torch.as_tensor(y).cpu() for y in x])
                         if isinstance(x, J.SeqData) else x.cpu())
        fp, gp, _ = OBJ.batch_fn_grad_pr(
            cfg, J.Params(*[x.cpu() for x in p64]),
            OBJ.BatchData(*[cpu(x) for x in b]), device="cpu")
    else:
        fp, gp = full_grads(cfg, p64, b, dev, plain=True)
    errs = {"f": rel_err(f32.cpu(), fp.cpu())}
    errs.update({n: worst_read(a.cpu(), c_.cpu())
                 for n, a, c_ in zip(GRAD_NAMES, g32, gp)})
    sums = {n + " sum": rel_err(a.cpu().double().sum(0), c_.cpu().sum(0))
            for n, a, c_ in zip(GRAD_NAMES, g32, gp)}
    if not (max(errs.values()) <= 1e-2 and max(sums.values()) <= 1e-3):
        fail("production step %s: gradients differ from the f64 plain "
             "version: %s %s" % (cfg.pattern, json.dumps(errs),
                                 json.dumps(sums)))
    errs.update(sums)
    return errs


def trna_seqs(n=None):
    seqs = [line.strip().replace("T", "U") for line in open(TRNA_FA)
            if line.strip() and not line.startswith(">")]
    return seqs if n is None else seqs[:n]


def golden_trna_eval(tmp, dev):
    """eval_file of the reference's converged model over the 76 tRNAs at
    f32 against its final objective (tests/test_lbfgsb_golden.py's bar)."""
    fq = os.path.join(tmp, "trna.fq")
    seqs = trna_seqs()
    write_fq(fq, seqs)
    if len(seqs) != 76:
        fail("tRNA fixture: %d reads, expected 76" % len(seqs))
    cfg, params = MIO.read_model(GOLD_TRNA, Lp=96, dtype="float32",
                                 device=dev)
    fn, gr, eff = OBJ.eval_file(cfg, params, fq, device=dev)
    x = J.pack_params(J.kernels(cfg, dev).g, params)
    rho = np.concatenate([np.full(len(gr) - 2, cfg.rho_theta),
                          [cfg.rho_lambda] * 2])
    total = fn + float((rho * x * x / 2.0).sum())
    print("golden tRNA eval (76 reads, Lp 96, f32): fn %.6f (reference "
          "0.13662, within 2e-3), fn + L2 %.6f (reference 1.713098, within "
          "2e-3), sum eff %.4f" % (fn, total, eff), flush=True)
    if not (abs(fn - 0.13662) <= 2e-3 and abs(total - 1.713098) <= 2e-3):
        fail("golden tRNA eval: fn %.6f, total %.6f" % (fn, total))
    return fn, total


def golden_small8_train(tmp, dev):
    """The port CLI's --no-shuffle L-BFGS-B on the first 8 tRNAs (W=28,
    C=12, 16 iterations, f64) against the reference binary's model."""
    fq = os.path.join(tmp, "small8.fq")
    write_fq(fq, trna_seqs(8))
    out1 = os.path.join(tmp, "small8.model")
    t0 = time.time()
    CLI.main(["train", "-f", fq, "-m", "(.....)", "--no-shuffle", "-i", "16",
              "-w", "28", "-c", "12", "--batch-size", "-1", "--dtype",
              "float64", "--out1", out1, "--out3", "~NULL~", "--device",
              "cuda"])
    t_train = time.time() - t0
    _, pr = MIO.read_model(GOLD_SMALL8, Lp=80, device="cpu")
    _, po = MIO.read_model(out1, Lp=80, device="cpu")
    err = {n: float((a - b).abs().max()) for n, a, b in zip(
        ("singles", "pairs", "lam"), po, pr)}
    print("golden small8 train --no-shuffle (8 tRNAs, W=28, C=12, -i 16, f64, "
          "on the card): %.1f s; max abs difference from the reference "
          "binary's model %s (within 0.05)" % (t_train, json.dumps(err)),
          flush=True)
    if not max(err.values()) <= 0.05:
        fail("golden small8: parameters differ by %.3g" % max(err.values()))
    return err


# ------------------------------------------------ the scanner (row K)

def random_pin(sd, dev, seed=7):
    """A pin per read at a random base of the read (the last read left
    unpinned), start class: the end pass's vetoes."""
    L = J._np(sd.L).astype(np.int64)
    pos = (np.random.RandomState(seed).rand(len(L)) * L).astype(np.int32)
    pos[-1] = -1
    return DP.Pin(torch.as_tensor(pos, device=dev), DP.CLS_START)


def scan_factors(cfg, batch, params, dev, pinned):
    """(d, c) of a batch with the class probe and, if ``pinned``, a pin
    per read."""
    B = batch.valid.shape[0]
    aux = {"cls": torch.zeros((4, cfg.Lp, B), dtype=params.lam.dtype,
                              device=dev)}
    if pinned:
        aux["pin"] = random_pin(batch.sd, dev)
    return J.batch_factors(cfg, params, batch.sd, batch.bp_ok, device=dev,
                           aux_b=aux)


def class_sums(dp, d, c, gbar, plain):
    """(parts, the class probe's cotangent [4, Lp, B]) of a forward and
    outside pass through the kernels or the plain versions."""
    h = DP.hoisted(d, c, dp.st)
    fs = plain_forward(dp, d, c, h) if plain else dp.run_inside(d, c, h)
    parts = dp.extract_parts(fs["O"], c)
    gs = DP.init_grads(fs, d, c, h)
    DP.seed_parts(gs, gbar, c, dp.st)
    for j in range(dp.dims.Lp, 0, -1):
        for stage in (DP.PLAIN_ADJ_STAGES if plain else DP.ADJ_STAGES):
            stage(fs, gs, j, d, c, h, dp.st)
    return parts, gs["cls"]


def check_pinned(cfg, batch, params, dev, rel, significant, full):
    """Row K's kernel work against the plain versions (dense aux built
    from the pin and the class probe, autograd): every forward stage at
    column J0, every adjoint stage and the column's class sums, with a
    random pin per read and with aux = 0 (the probe alone); with ``full``
    also, for both, the class sums of the whole outside pass, kernels
    (two runs, bitwise equal) vs plain.  Returns ({kernel: max abs err},
    message)."""
    dp = J.kernels(cfg, dev).dp
    errs, msgs = {}, []
    B = batch.valid.shape[0]
    for pinned in (True, False):
        d, c = scan_factors(cfg, batch, params, dev, pinned)
        st_e = check_stages(dp, d, c, J0, rel, significant)
        ad_e = check_adj_stages(dp, d, c, J0, rel)
        for e in (st_e, ad_e):
            for k_, v in e.items():
                errs[k_] = max(errs.get(k_, 0.0), v)
        msg = "%s: stages %s, adjoints %s" % (
            "pin" if pinned else "aux=0", json.dumps(st_e), json.dumps(ad_e))
        if full:
            fwd = dp.extract_parts(dp.run_inside(d, c, DP.hoisted(
                d, c, dp.st))["O"], c)
            gbar = torch.as_tensor(np.random.RandomState(8).rand(B, 3),
                                   dtype=fwd.dtype, device=dev)
            gbar = torch.where(torch.isfinite(fwd), gbar, 0.0)
            pk, ck = class_sums(dp, d, c, gbar, False)
            _, ck2 = class_sums(dp, d, c, gbar, False)
            pp, cp = class_sums(dp, d, c, gbar, True)
            if not torch.equal(ck, ck2):
                fail("class sums: two kernel runs differ (%s)" % msg)
            fin = torch.isfinite(pp)
            if not torch.equal(fin, torch.isfinite(pk)):
                fail("parts (%s): -inf pattern differs" % msg)
            ep = grad_compare("parts (%s)" % msg, pk[fin], pp[fin], rel)
            ec = grad_compare("class sums, whole pass", ck, cp, rel)
            msg += ", whole pass: parts %.3g, class sums %.3g (two kernel " \
                "runs bitwise equal)" % (ep, ec)
        msgs.append(msg)
    return errs, "; ".join(msgs)


def pinned_times(dp, d, c, j0, funcs):
    """Device ms per column j0 of the pinned K2 and K4 stages (a pin per
    read in ``c``) and of K5 and K7 with the class probe in ``d`` (the
    outside pass run through the later columns first), and K2's and K5's
    ms by CUDA function."""
    st = dp.st
    h = DP.hoisted(d, c, st)
    fs = dp.run_inside(d, c, h)
    out, per_fn = {}, {}
    for kname, names in (("inside_band", ("band_front", "band_bif", "band_m",
                                          "band_e")),
                         ("inside_ext", ("ext_stage",))):
        ks = DP.clone_state(fs)
        kf = [getattr(DP, n) for n in names]
        out[kname], per_fn[kname] = device_ms_by_function(
            lambda: [f(ks, j0, d, c, h, st) for f in kf], REPS, funcs[kname])
    gs = DP.init_grads(fs, d, c, h)
    B = c.wsp.shape[-1]
    DP.seed_parts(gs, torch.as_tensor(np.random.RandomState(5).rand(B, 3),
                                      dtype=st.dtype, device=fs["O"].device),
                  c, st)
    dp.outside_columns(fs, gs, d, c, h, dp.dims.Lp + 1, j0 + 1)
    for kname, names in (("outside_band", ("e_adj", "band_adj")),
                         ("outside_ext", ("ext_adj",))):
        kg = DP.clone_state(gs)
        kf = [getattr(DP, n) for n in names]
        per, _, _, _ = device_profile(
            lambda: [f(fs, kg, j0, d, c, h, st) for f in kf], REPS)
        per_fn[kname] = {f: per[f] / 1e3 for f in sorted(funcs[kname])
                         if f in per}
        out[kname] = sum(per_fn[kname].values())
    return out, {k: per_fn[k] for k in BAND_KERNELS}


def masks_by_function(cfg, sd, dev, funcs):
    """Device ms of K2's and K5's CUDA functions over one masks batch
    (the S=1 pass of effective_bp_mask_batch, every column)."""
    per, _, _, _ = device_profile(
        lambda: J.effective_bp_mask_batch(cfg, sd, dev), 3)
    return {k: {f: per.get(f, 0.0) / 1e3 for f in sorted(funcs[k])}
            for k in BAND_KERNELS}


def check_chain_pinned(small, reads, dev):
    """K8/K9 under a pin per read, with K9's class sums, against the
    plain chain (dense auxR from the pin and the probe, autograd): f64
    within 1e-9 and f32 within 1e-4 relative (max norm) at B = 16, 128,
    1, 7 and 600; two kernel runs bitwise equal.  Returns {kernel: max
    abs err} of the f32 main batch and the message."""
    errs, msgs = {}, []
    for dtype, rel in (("float64", 1e-9), ("float32", 1e-4)):
        for name, rr in chain_batches(small, reads):
            cfg = norss_cfg(dtype)
            lin, eR, L, gp = chain_inputs(cfg, rr, dev)
            sd = J.stack_seqdata([J.make_seqdata(cfg, s_, q_)
                                  for s_, q_ in rr], dev)
            pin = random_pin(sd, dev)
            B = eR.shape[-1]
            # a pinned read's no-motif part is -inf: no cotangent there
            gp = torch.where(torch.isfinite(K.chain_fwd(lin, eR, L, pin)[0]),
                             gp, 0.0)
            runs = []
            for _ in range(2):
                parts, rows = K.chain_fwd(lin, eR, L, pin)
                cls = torch.empty((4, LP, B), dtype=eR.dtype, device=dev)
                g = K.chain_adj(lin, eR, L, rows, gp, pin, cls)
                runs.append((parts, g, cls))
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                fail("chain kernels with a pin: two runs differ (%s %s)"
                     % (dtype, name))
            parts, g, cls = runs[0]
            leaf = eR.detach().clone().requires_grad_(True)
            probe = torch.zeros_like(cls, requires_grad=True)
            with torch.enable_grad():
                pp = LIN.chain_plain(lin, leaf, L, LIN.chain_aux(
                    lin, LP, B, pin=pin, cls=probe))
                gpl, cpl = torch.autograd.grad(pp, [leaf, probe], gp)
            pp = pp.detach()
            fin = torch.isfinite(pp)
            if not torch.equal(fin, torch.isfinite(parts)):
                fail("linear_fwd pinned %s %s: -inf pattern differs"
                     % (dtype, name))
            ef = grad_compare("linear_fwd pinned %s %s" % (dtype, name),
                              parts[fin], pp[fin], rel)
            ea = grad_compare("linear_adj pinned %s %s" % (dtype, name), g,
                              gpl, rel)
            ec = grad_compare("linear_adj class sums %s %s" % (dtype, name),
                              cls, cpl, rel)
            msgs.append("%s %s: parts %.3g, d eR %.3g, class sums %.3g"
                        % (dtype, name, ef, ea, ec))
            if dtype == "float32" and rr is reads:
                errs = {"linear_fwd": ef, "linear_adj": max(ea, ec)}
    return errs, "; ".join(msgs)


def parse_raw(text):
    """10-line scan records -> [{key: value}] (tests/test_scan_golden's
    reader)."""
    recs = []
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    for k0 in range(0, len(lines), 10):
        recs.append(dict(ln.split(": ", 1) if ": " in ln else (ln[:-1], "")
                         for ln in lines[k0:k0 + 10]))
    return recs


def vec(text):
    return np.array([float(v) for v in text.strip()[1:-1].split(",") if v])


def vecint(text):
    return [int(v) for v in text.strip()[1:-1].split(",") if v]


# ------------------------------------------------------------ CYK (rows L, M)

MAX_STAGE_OUT = {"max_band_front": ("LL", "P", "T2"),
                 "max_band_bif": ("Bt", "T1"), "max_band_m": ("M",),
                 "max_ep_stage": ("ep",), "max_band_e": ("E",),
                 "max_ext_stage": ("O",)}
MAX_KERNEL = {"max_band_front": "inside_band_max",
              "max_band_bif": "inside_band_max",
              "max_band_m": "inside_band_max",
              "max_band_e": "inside_band_max",
              "max_ep_stage": "inside_ep_max",
              "max_ext_stage": "inside_ext_max"}
MAX_TABLE_KERNEL = {"LL": "inside_band_max", "P": "inside_band_max",
                    "E": "inside_band_max", "M": "inside_band_max",
                    "Bt": "inside_band_max", "T1": "inside_band_max",
                    "T2": "inside_band_max", "ep": "inside_ep_max",
                    "O": "inside_ext_max"}
CYK_KERNELS = ("inside_band_max", "inside_ep_max", "inside_ext_max",
               "cyk_traceback")
SCAN_KERNELS = DP_KERNELS + CYK_KERNELS


def max_compare(name, a, b, tol):
    """Max abs error of kernel cells ``a`` against plain ``b``: the -inf
    placement must be identical and finite cells within ``tol``."""
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or \
            not torch.equal(torch.isneginf(a), torch.isneginf(b)):
        fail("%s: -inf placement differs (%d cells)" % (
            name, int((torch.isfinite(a) != torch.isfinite(b)).sum())))
    fin = torch.isfinite(b)
    if not fin.any():
        return 0.0
    err = float((a[fin] - b[fin]).abs().max())
    if not err <= tol:
        fail("%s: max abs err %.3g beyond %.0e" % (name, err, tol))
    return err


def cyk_factors(cfg, params, reads, dev, edges):
    """(scan config, d, c) of ``reads`` (seq, qual) under the CYK pin set:
    each read's Ys/Ye from the posterior pass, except, with ``edges``,
    read 0 (Ye == L) and read 1 (Ys == Ye)."""
    scfg, sp = SCD.scan_config(cfg, params, cfg.Lp)
    sd = J.stack_seqdata([J.make_seqdata(scfg, s_, q_) for s_, q_ in reads],
                         dev)
    res = SC.scan_posteriors_batch(scfg, sp, sd, device=dev)
    Ys, Ye = res["Ys"].clone(), res["Ye"].clone()
    L = torch.as_tensor(sd.L, device=dev).long()
    if edges:
        Ye[0], Ye[1] = L[0], Ys[1]
    d, c = J.batch_factors(scfg, sp, sd, res["bp_ok"], device=dev,
                           aux_b={"pin": CYK.cyk_pins(Ys, Ye, L)})
    return scfg, d, c


def check_max_tables(cfg, reads, params, dev, tol):
    """K10-K12 against the plain max DP on the card (same inputs): every
    stage at column J0 on the kernels' earlier columns, and the whole
    tables; two kernel runs bitwise equal.  Returns ({kernel: max abs
    err}, the scan config, d, c, the kernels' tables)."""
    scfg, d, c = cyk_factors(cfg, params, reads, dev, True)
    mdp = DMB.MaxDP(J.kernels(scfg, dev).dp)
    runs = [mdp.tables(d, c) for _ in range(2)]
    for key in MAX_TABLE_KERNEL:
        if not torch.equal(runs[0][key], runs[1][key]):
            fail("CYK tables: two kernel runs differ in %s" % key)
    plain = mdp.tables(d, c, plain=True)
    errs = {}
    for key, kn in MAX_TABLE_KERNEL.items():
        e = max_compare("CYK table %s" % key, runs[0][key], plain[key], tol)
        errs[kn] = max(errs.get(kn, 0.0), e)
    state = {k_: v.clone() for k_, v in runs[0].items()
             if not k_.startswith("_")}
    r = J0 + mdp.st.PAD
    for stage, pl in zip(DMB.STAGES, DMB.PLAIN_STAGES):
        ks = DP.clone_state(state)
        stage(ks, J0, d, c, mdp.mst)
        pl(state, J0, d, c, mdp.mst)
        for key in MAX_STAGE_OUT[stage.__name__]:
            e = max_compare("%s %s column %d" % (stage.__name__, key, J0),
                            ks[key][r], state[key][r], tol)
            kn = MAX_KERNEL[stage.__name__]
            errs[kn] = max(errs.get(kn, 0.0), e)
    return errs, scfg, d, c, runs[0]


def tb_plans(mst):
    """K13's launch plans to hold against the host traceback: the shape's
    (ops/kernels.traceback_plan) and the one with the stack in the other
    place, where that fits; [None] (the launch's own) where the package
    has no plans."""
    if not hasattr(K, "traceback_plan"):
        return [None]
    li = K.tb_lists(mst)[0]
    st = mst.st
    base = K.traceback_plan(st.dims.Lp, st.dtype, (li.ni, li.nt))
    plans = [base]
    try:
        plans.append(K.traceback_plan(
            st.dims.Lp, st.dtype, (li.ni, li.nt),
            variant="device" if base.stack == "shared" else "shared"))
    except ValueError:
        pass
    return plans


def same_as_host(out, host, L, what):
    """Fail unless K13's (psihat, pairs, err) has no error flag and every
    read's psihat and pair set equal the host traceback's."""
    psihat, pairs, err = (x.cpu().numpy() for x in out)
    if err.any():
        fail("K13 %s: error flags %s" % (what, err.tolist()))
    for t, (path, _, cells) in enumerate(host):
        if not np.array_equal(psihat[t, :L[t]], path):
            fail("K13 %s: read %d's psihat differs from the host "
                 "traceback" % (what, t))
        if sorted(map(tuple, np.argwhere(pairs[t]))) != sorted(cells):
            fail("K13 %s: read %d's pair set differs from the host "
                 "traceback" % (what, t))


def check_traceback(cfg, d, c, state, dev, what):
    """K13 against the host traceback on the same tables, under each plan
    of tb_plans (the stack in shared memory and in the device scratch):
    every read's psihat and pair set identical.  Returns (the reads
    compared, the plans' names)."""
    k = J.kernels(cfg, dev)
    mdp = DMB.MaxDP(k.dp)
    eps = CYK.EPS[k.dtype]
    host = CYK.host_tracebacks(cfg, k.g, state, d, c, k.dp.st, eps)
    L = c.L.cpu().numpy()
    names = []
    for plan in tb_plans(mdp.mst):
        name = "launch" if plan is None else plan.name
        kw = {} if plan is None else {"plan": plan}
        same_as_host(K.cyk_traceback(state, d, c, mdp.mst, eps, **kw),
                     host, L, "%s (%s)" % (what, name))
        names.append(name)
    return len(host), names


def cyk_times(fq, dev):
    """Per-column device ms of K10-K12 (column J0) and per-chunk ms of
    K13 on the first tRNA scan chunk (64 reads x bucket 96) at f64 (the
    scan's default) and f32, beside the plain versions' times (K13's, the
    host traceback's wall time, at f64) and the bounds; K13 checked
    against the host traceback on the 76 tRNAs (f64, both chunks)."""
    reads = [(r.seq, r.qual) for r in FastqReader(fq).reads()]
    funcs = kernel_functions()
    out = {}
    for dtype in ("float64", "float32"):
        cfg, params = MIO.read_model(GOLD_TRNA, Lp=96, dtype=dtype,
                                     device=dev)
        scfg, d, c = cyk_factors(cfg, params, reads[:SCD.SCAN_BATCH], dev,
                                 False)
        k = J.kernels(scfg, dev)
        mdp = DMB.MaxDP(k.dp)
        state = mdp.tables(d, c)
        ms, plain_ms, launches = {}, {}, {}
        for kname in ("inside_band_max", "inside_ep_max", "inside_ext_max"):
            names = [n for n, kn in MAX_KERNEL.items() if kn == kname]
            ks, ps = DP.clone_state(state), DP.clone_state(state)
            kf = [getattr(DMB, n) for n in names]
            pf = [DMB.PLAIN_STAGES[DMB.STAGES.index(f)] for f in kf]
            K.reset_counts()
            for f in kf:
                f(ks, J0, d, c, mdp.mst)
            launches[kname] = K.KERNELS[kname].launches
            ms[kname] = device_ms(
                lambda: [f(ks, J0, d, c, mdp.mst) for f in kf], REPS,
                funcs[kname])
            plain_ms[kname] = cuda_ms(
                lambda: [f(ps, J0, d, c, mdp.mst) for f in pf], 3)
            del ks, ps
        eps = CYK.EPS[k.dtype]
        ms["cyk_traceback"] = device_ms(
            lambda: K.cyk_traceback(state, d, c, mdp.mst, eps), 20,
            funcs["cyk_traceback"])
        launches["cyk_traceback"] = 1
        if dtype == "float64":
            # the host traceback (K13's plain version) at f64 only; the f32
            # bound counts the same walk
            stats = {}
            t0 = time.perf_counter()
            CYK.host_tracebacks(scfg, k.g, state, d, c, k.dp.st, eps,
                                stats=stats)
            plain_ms["cyk_traceback"] = 1e3 * (time.perf_counter() - t0)
        bnd = max_bounds(scfg, k.dp.st, c, J0, stats,
                         torch.finfo(k.dtype).bits // 8)
        out[dtype] = dict(ms=ms, plain_ms=plain_ms, bound=bnd,
                          launches=launches, stats=stats)
        if dtype == "float64":
            # K13's dependent-path bound: the longest read's walked cells
            # (the kernel's trace) x one dependent load from L2
            tr = torch.zeros((len(reads[:SCD.SCAN_BATCH]),
                              len(K.TB_TRACE)), dtype=torch.int64,
                             device=dev)
            K.cyk_traceback(state, d, c, mdp.mst, eps, trace=tr)
            cells = tr[:, :2].sum(1).max().item()
            lat = pointer_chase_ns(dev)
            out[dtype]["bound_dep"] = dict(
                cells_max=cells, latency_ns=lat,
                ms=cells * lat["l2_ns"] * 1e-6)
        # K11 and K12 on the second chunk (12 reads): K11's ranges of x
        # follow B
        out[dtype]["ms_chunk2"] = cyk_column_ms(reads[SCD.SCAN_BATCH:], dev,
                                                funcs, dtype)
        if dtype == "float64":
            n, plans = check_traceback(scfg, d, c, state, dev,
                                       "76 tRNAs, chunk 1")
            del state
            scfg2, d2, c2 = cyk_factors(cfg, params,
                                        reads[SCD.SCAN_BATCH:], dev, False)
            n2, _ = check_traceback(scfg2, d2, c2, DMB.MaxDP(J.kernels(
                scfg2, dev).dp).tables(d2, c2), dev, "76 tRNAs, chunk 2")
            out["tb_reads"], out["tb_plans"] = n + n2, plans
        torch.cuda.empty_cache()
    return out


def max_bounds(cfg, st, c, j, stats, itemsize):
    """Least ms of K10-K12 at column j (the cells and rows K2-K4 count,
    K11 reading the log mismatch tables misA/misB and the size classes'
    log energies per group instead of the exponentials per lambda bucket)
    and of K13 for the chunk: the walked cells' stored values and their
    chosen candidates' operands read (three values each) and the outputs
    written; operations, four per candidate scored up to each choice (the
    reference's first-strictly-greater order)."""
    B = c.wsp.shape[-1]
    q = batch_counts(cfg, st, c, B)
    work = column_work(cfg, st, c, q, j, itemsize, ())
    by3, ops3 = work["inside_ep"]
    if q["have_ep"]:
        C1 = cfg.Cp + 1
        by3 += itemsize * (-q["pc"] * 4 - B * (cfg.Wp + 1) * 4
                           - q["eszg"] + 4 * C1 * (C1 + 1) // 2 + 2)
    Lp, W1 = cfg.Lp, cfg.Wp + 1
    by13 = itemsize * 4 * stats["cells"] + B * (4 * Lp + (Lp + 1) * W1 + 4)
    return {"inside_band_max": _ms(*work["inside_band"]),
            "inside_ep_max": _ms(by3, ops3),
            "inside_ext_max": _ms(*work["inside_ext"]),
            "cyk_traceback": _ms(by13, 4.0 * stats["cands"])}


def rss_pairs(rss):
    """The pair cells (j, w) of a structure string's L/R letters."""
    stack, cells = [], []
    for p, ch in enumerate(rss):
        if ch == "L":
            stack.append(p)
        elif ch == "R":
            i = stack.pop()
            cells.append((p + 1, p + 1 - i))
    return cells


def path_scores(cfg, params, reads, recs, dev):
    """For reads whose psihat or rss differs from the golden's: (the
    port's optimal score, the best score of an alignment with the
    golden's pairs and node path) from the plain max DP on the card: the
    CYK tables under the port's Ys/Ye pins, then the same tables with
    bp_ok the golden's pairs alone and dense aux vetoes that keep, at
    each base, only emissions of the golden's node there, paired where
    the golden pairs it and unpaired elsewhere."""
    scfg, sp = SCD.scan_config(cfg, params, 96)
    g = J.kernels(scfg, dev).g
    sd = J.stack_seqdata([J.make_seqdata(scfg, r.seq, r.qual)
                          for r in reads], dev)
    L = torch.as_tensor(sd.L, device=dev).long()
    Ys = torch.tensor([int(m["motif region"].split(" - ")[0])
                       for m, _ in recs], device=dev)
    Ye = torch.tensor([int(m["motif region"].split(" - ")[1])
                       for m, _ in recs], device=dev)
    pins = CYK.cyk_pins(Ys, Ye, L)
    bp, _ = J.effective_bp_mask_batch(scfg, sd, dev)
    mdp = DMB.MaxDP(J.kernels(scfg, dev).dp)
    S, Lp, W1 = g.S, scfg.Lp, scfg.Wp + 1
    gbp = torch.zeros((len(reads), Lp + 1, W1), dtype=torch.bool)
    aux = np.zeros((4, len(reads), Lp, S, S))
    sr, sl = np.asarray(g.state_r), np.asarray(g.state_l)
    for t, (_, gold) in enumerate(recs):
        psi, rss = vecint(gold["psihat"]), gold["rss"]
        for j_, w_ in rss_pairs(rss):
            gbp[t, j_, w_] = True
        for p, node in enumerate(psi):
            paired = rss[p] in "LR"
            right = np.where(sr[:, None] == node, 0.0, -np.inf) * np.ones(S)
            left = np.where(sl[None, :] == node, 0.0, -np.inf) * np.ones((S,
                                                                         1))
            aux[0, t, p] = -np.inf if paired else right   # R (target)
            aux[1, t, p] = -np.inf if paired else left    # L (source)
            aux[2, t, p] = left if paired else -np.inf    # PL (source)
            aux[3, t, p] = right if paired else -np.inf   # PR (target)
    out = []
    ends = list(g.end_states[1:])
    for bp_t, extra in ((bp, {}), (gbp.to(dev), {
            k_: torch.as_tensor(aux[n], dtype=params.lam.dtype, device=dev)
            for n, k_ in enumerate(DP.AUX)})):
        d, c = J.batch_factors(scfg, sp, sd, bp_t, device=dev,
                               aux_b=dict(extra, pin=pins))
        O = mdp.tables(d, c, plain=True)["O"]
        out.append([float(O[int(L[t]) + mdp.st.PAD, ends, t].max())
                    for t in range(len(reads))])
    return list(zip(*out))


def golden_records(reads, text, gold, strict, what):
    """Every line of a scan against the C++ trna_scan_ref.raw: the
    posteriors, region, exist prob and mot at test_scan_trained_golden's
    bars when ``strict``, psihat/rss byte-equal counted.  Returns (ids of
    the reads whose psihat or rss differs, reads with an isfinite
    mismatch, largest log error on lines both print finite, [(record,
    golden)] of the differing reads)."""
    mine = parse_raw(text)
    if len(mine) != len(gold):
        fail("%s: %d records, the golden has %d" % (what, len(mine),
                                                    len(gold)))
    diff, n_fin, worst, pairs = [], 0, 0.0, []
    for r, m, g_ in zip(reads, mine, gold):
        if m["seq"] != g_["seq"]:
            fail("%s: read %s is not the golden's" % (what, m["id"]))
        fin_diff = False
        for key in ("start", "end", "inner"):
            a, b = vec(m[key]), vec(g_[key])
            if a.shape != b.shape:
                fail("%s %s %s: shape %s vs %s" % (what, m["id"], key,
                                                   a.shape, b.shape))
            fin_diff |= bool((np.isfinite(a) != np.isfinite(b)).any())
            both = np.isfinite(a) & np.isfinite(b)
            err = np.abs(a[both] - b[both])
            worst = max(worst, float(err.max()) if err.size else 0.0)
            if strict and (fin_diff or (err > 2e-4 + 1e-3 * np.abs(
                    b[both])).any()):
                fail("%s %s %s: differs from the golden" % (what, m["id"],
                                                            key))
        n_fin += fin_diff
        if strict and (m["motif region"] != g_["motif region"] or abs(
                float(m["exist prob"]) - float(g_["exist prob"])) > 1e-3
                or m["mot"] != g_["mot"]):
            fail("%s %s: motif region / exist prob / mot differ" % (
                what, m["id"]))
        if (m["psihat"], m["rss"]) != (g_["psihat"], g_["rss"]):
            diff.append(m["id"])
            pairs.append((m, g_))
    return diff, n_fin, worst, pairs


def scan_run(sc, fq, dev, marked):
    """One Scanner.scan of ``fq``: (records text, total ms, stage ms,
    chunks, launches); ``marked`` times the stages (the device
    synchronised around each) and counts the launches of this run."""
    stamps = []

    def mark(stage):
        torch.cuda.synchronize()
        stamps.append((stage, time.perf_counter()))

    buf = io.StringIO()
    K.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc.scan(fq, buf, log=io.StringIO(), mark=mark if marked else None)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {n: kk.launches for n, kk in K.KERNELS.items()}
    stages = {}
    for (_, a), (name, b) in zip(stamps, stamps[1:]):
        if name != "begin":
            stages[name] = stages.get(name, 0.0) + 1e3 * (b - a)
    stages["host"] = 1e3 * total - sum(stages.values())
    return (buf.getvalue(), 1e3 * total, stages,
            sum(1 for n, _ in stamps if n == "begin"), launches)


def scan_trna(tmp, dev):
    """Phase 11: Scanner.scan of the 76 tRNAs with the reference's
    converged model in the driver's buckets and chunks (posteriors, then
    the CYK alignment of each chunk): at f64, the scan's default, every
    line held against the C++ scan (test_scan_trained_golden's bars:
    posteriors, motif region, exist prob and mot on every read; the reads
    whose psihat/rss differ counted against its bar of at most 2, each
    reported with the port's best score and the best score of the
    golden's pairs and node path, which must be equal: a tie); at f32 its
    path differences and F4 count printed; each dtype run twice (records
    equal), the second timed with a stage breakdown and its launches
    counted; one posterior chunk (row K) timed beside its bound.  Returns
    the numbers."""
    fq = os.path.join(tmp, "trna.fq")
    write_fq(fq, trna_seqs())
    gold = parse_raw(open(GOLD_TRNA_SCAN).read())
    reads = list(FastqReader(fq).reads())
    out = {"fq": fq}
    for dtype in ("float64", "float32"):
        cfg, params = MIO.read_model(GOLD_TRNA, Lp=96, dtype=dtype,
                                     device=dev)
        sc = SCD.Scanner(cfg, params, dev)
        text, first_ms, _, _, _ = scan_run(sc, fq, dev, False)
        text2, total, stages, chunks, launches = scan_run(sc, fq, dev, True)
        if text2 != text:
            fail("scan %s: two runs wrote different records" % dtype)
        strict = dtype == "float64"
        diff, n_fin, worst, recs = golden_records(reads, text, gold, strict,
                                                  "scan %s" % dtype)
        o = dict(total_ms=total, first_ms=first_ms, stages=stages,
                 chunks=chunks, launches=launches, diff=diff, n_fin=n_fin,
                 worst=worst, seqs_per_s=len(reads) * 1e3 / total)
        if strict and diff:
            byid = {r.id: r for r in reads}
            o["scores"] = path_scores(cfg, params,
                                      [byid[m["id"]] for m, _ in recs],
                                      recs, dev)
        out[dtype] = o
        print("scan of the 76 tRNAs (trna_noshuffle_ref.model, Scanner.scan, "
              "%s%s): %.1f ms (%.1f seqs/s; first run %.1f ms) in %d chunks, "
              "stages (ms, the device synchronised around each) %s; reads "
              "whose psihat or rss differs from trna_scan_ref.raw: %d %s%s; "
              "reads with an isfinite mismatch %d, largest log error on "
              "lines both print finite %.3g" % (
                  dtype, ", the default" if strict else "", total,
                  o["seqs_per_s"], first_ms, chunks,
                  json.dumps({k_: round(v, 2) for k_, v in stages.items()}),
                  len(diff), json.dumps(diff),
                  "" if "scores" not in o else
                  " (port's best score, best score of the golden's pairs "
                  "and nodes: %s)" % json.dumps(
                      [[float("%.12g" % a), float("%.12g" % b)]
                       for a, b in o["scores"]]),
                  n_fin, worst), flush=True)
        if strict:
            # a differing read is a tie when the golden's alignment scores
            # the port's optimum: the reference chose among exactly equal
            # alignments by the rounding of its own sums
            off = [m["id"] for (m, _), (a, b) in zip(recs, o.get("scores", []))
                   if not abs(a - b) <= 1e-9 * (1.0 + abs(a))]
            print("scan f64: psihat/rss byte-equal to trna_scan_ref.raw on "
                  "%d of %d reads: test_scan_trained_golden's bar (all but "
                  "at most 2) %s; the golden's pairs and nodes score the "
                  "port's optimum within 1e-9 relative on %d of the %d "
                  "differing reads (ties)" % (
                      len(reads) - len(diff), len(reads),
                      "met" if len(diff) <= 2 else "NOT met",
                      len(diff) - len(off), len(diff)), flush=True)
            if off:
                fail("scan f64: reads %s differ from the golden and are no "
                     "ties: the golden's alignment scores other than the "
                     "port's optimum" % off)
        del sc
        torch.cuda.empty_cache()
    # row K's unit: one posterior chunk (the first 64 reads, bucket 96)
    cfg, params = MIO.read_model(GOLD_TRNA, Lp=96, dtype="float32",
                                 device=dev)
    scfg, sparams = SCD.scan_config(cfg, params, 96)
    sd = J.stack_seqdata([J.make_seqdata(scfg, r.seq, r.qual)
                          for r in reads[:SCD.SCAN_BATCH]], dev)
    call = lambda: SC.scan_posteriors_batch(scfg, sparams, sd, device=dev)
    K.reset_counts()
    call()
    out["chunk_launches"] = {n: kk.launches for n, kk in K.KERNELS.items()}
    out["chunk_ms"] = cuda_ms(call, 3)
    out["chunk_bound"] = scan_chunk_bound(scfg, sparams, sd, dev, 4)
    print("row K: one posterior chunk (64 reads x bucket 96, f32) %.2f ms, "
          "launches %s, bound %.4f ms by %s (its torch kernels: the glue "
          "census of phase 6)" % (
              out["chunk_ms"], json.dumps(out["chunk_launches"]),
              out["chunk_bound"][0], out["chunk_bound"][1]), flush=True)
    return out


def scan_norss(tmp, dev):
    """Phase 12: Scanner.scan of the --no-rss fixture model 2 on 0.fq
    (f32, the card) against the C++ scan on every line
    (tests/test_scan_golden's rules); the launch counts of this run."""
    cfg, params = MIO.read_model(os.path.join(FIXDIR, "2.model"), Lp=48,
                                 dtype="float32", device=dev)
    buf, log = io.StringIO(), io.StringIO()
    K.reset_counts()
    SCD.Scanner(cfg, params, dev).scan(os.path.join(FIXDIR, "0.fq"), buf,
                                       log=log)
    torch.cuda.synchronize()
    launches = {n: kk.launches for n, kk in K.KERNELS.items()}
    mine = parse_raw(buf.getvalue())
    gold = parse_raw(open(os.path.join(GOLDDIR, "scan_2.raw")).read())
    if len(mine) != len(gold) or "E[N]:" not in log.getvalue():
        fail("no-rss scan: %d records, golden %d" % (len(mine), len(gold)))
    worst = 0.0
    for m, g in zip(mine, gold):
        for key in ("start", "end", "inner"):
            a, b = vec(m[key]), vec(g[key])
            if a.shape != b.shape or not (np.isfinite(a) ==
                                          np.isfinite(b)).all():
                fail("no-rss scan %s %s: shape or isfinite pattern differs"
                     % (m["id"], key))
            fin = np.isfinite(a)
            err = np.abs(a[fin] - b[fin])
            worst = max(worst, float(err.max()) if err.size else 0.0)
            if (err > 2e-4 + 1e-3 * np.abs(b[fin])).any():
                fail("no-rss scan %s %s: max log error %.3g"
                     % (m["id"], key, float(err.max())))
        if abs(float(m["exist prob"]) - float(g["exist prob"])) > 1e-3:
            fail("no-rss scan %s: exist prob %s vs %s"
                 % (m["id"], m["exist prob"], g["exist prob"]))
        for key in ("id", "psihat", "motif region", "seq", "rss", "mot"):
            if m[key] != g[key]:
                fail("no-rss scan %s: %s differs" % (m["id"], key))
    print("no-rss scan (fixture model 2 on 0.fq, f32, Scanner.scan): every "
          "line of scan_2.raw held (largest log error %.3g); launches %s"
          % (worst, json.dumps(launches)), flush=True)
    return launches


def scan_chunk_bound(cfg, params, sd, dev, itemsize):
    """Row K for one chunk, as one function: the masks (row I), the score
    tables once, two forward and outside passes (K2-K7 over every
    column), the pins read and the class sums written: (ms, bound_by).
    Pass 1 must give the singles' and pairs' cotangents (E[N]; the scan
    keeps no lambda part), the end pass the class sums alone."""
    k = J.kernels(cfg, dev)
    bp, _ = J.effective_bp_mask_batch(cfg, sd, dev)
    _, c = J.batch_factors(cfg, params, sd, bp, device=dev)
    B = bp.shape[0]
    q = batch_counts(cfg, k.dp.st, c, B)
    by, ops = mask_pass_work(cfg, sd, dev, itemsize)
    b1, o1 = score_work(cfg, c, k.tab, B, itemsize)
    by, ops = by + b1, ops + o1
    for j in range(1, cfg.Lp + 1):
        for need in (("weights",), ()):
            for b_, o_ in column_work(cfg, k.dp.st, c, q, j, itemsize,
                                      need=need).values():
                by, ops = by + b_, ops + o_
    by += 4 * B + 2 * 4 * cfg.Lp * B * itemsize
    return _ms(by, ops)

# ------------------------------------------------------------ wide grammars

# The shapes whose blocks outgrow shared memory or a block's threads
# (ops/kernels.ep_plan, band_plan): (pattern, -c, type, reads, their
# length range, Lp, column of the per-stage checks and times)
WIDE = (("." * 12, 30, "float64", 6, 60, 80, 80, J0),
        (".....*.....", 40, "float64", 6, 60, 80, 80, J0),
        ("." * 14, 30, "float32", 6, 60, 80, 80, J0),
        ("." * 16, 40, "float64", 3, 40, 60, 60, 55))
EP_KERNELS = ("inside_ep", "outside_ep", "inside_ep_max")
WIDE_SAME = ".....*....."   # both variants fit at -c 30: bitwise and times


def wide_cfg(pattern, c_, dtype, Lp):
    return J.ModelConfig(pattern=pattern, Lp=Lp, max_span=50, max_iloop=c_,
                         min_bpp=MIN_BPP, tau=0.1, dtype=dtype)


def plans_of(st):
    """{kernel: its launch plan} of K3, K6, K11 and the M chains for the
    grammar, -c and type of ``st``."""
    S, n_ar, Cp, dt = st.dims.S, st.n_ar, st.dims.Cp, st.dtype
    out = {kn: K.ep_plan(kn, S, n_ar, Cp, dt) for kn in EP_KERNELS}
    out.update({kn: K.band_plan(kn, S, dt) for kn in BAND_KERNELS})
    out["inside_band_max"] = K.band_plan("inside_band", S, dt)
    return out


def wide_case(case, dev, funcs):
    """One shape of WIDE: fn+grad per read through the kernels (the launch
    counts set to 0 before it and read after: every kernel of the path
    launched, in the variants its plans name), a second run bitwise equal,
    against the plain versions at f64 (f64 within 1e-9 per read; f32
    each read's gradient within 1e-2 of its max norm, their sums and f
    within 1e-3 relative); every stage and adjoint stage at column j0
    against its plain version (1e-9 / 1e-4 relative); K3's, K6's, K2's
    and K5's device ms per column j0 in their plans' variants, their
    bounds and plain times."""
    pattern, c_, dtype, n, lmin, lmax, Lp, j0 = case
    cfg = wide_cfg(pattern, c_, dtype, Lp)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    reads = make_reads(np.random.RandomState(3), n, lmin, lmax)
    p, p64 = random_params(cfg, dev), random_params(cfg64, dev)
    b, b64 = (OBJ.stack_reads(x, reads, device=dev) for x in (cfg, cfg64))
    dp = J.kernels(cfg, dev).dp
    st = dp.st
    plans = plans_of(st)
    K.reset_counts()
    fk, gk = full_grads(cfg, p, b, dev, plain=False)
    torch.cuda.synchronize()
    launches = {kn: K.KERNELS[kn].launches for kn in DP_KERNELS}
    # the launch plans' layout variants (K1's plan only sizes its blocks)
    variants = {kn: dict(K.KERNELS[kn].variants) for kn in DP_KERNELS
                if kn != "score_tables" and K.KERNELS[kn].variants}
    for kn in DP_KERNELS:
        if launches[kn] <= 0:
            fail("wide %s -c %d %s: kernel %s was not launched"
                 % (pattern, c_, dtype, kn))
    for kn in EP_KERNELS[:2] + BAND_KERNELS:
        if variants.get(kn, {}).get(plans[kn].name, 0) <= 0:
            fail("wide %s: %s did not run its plan's variant %s (%s)"
                 % (pattern, kn, plans[kn].name, variants.get(kn)))
    fk2, gk2 = full_grads(cfg, p, b, dev, plain=False)
    if not torch.equal(fk, fk2) or not all(
            torch.equal(x, y) for x, y in zip(gk, gk2)):
        fail("wide %s: two kernel runs differ" % pattern)
    fp, gp = full_grads(cfg64, p64, b64, dev, plain=True)
    axes = (0, 0, 0, -1)
    errs = {nm: worst_read(a, c__, ax)
            for nm, a, c__, ax in zip(GRAD_NAMES, gk, gp, axes)}
    errs["f"] = rel_err(fk, fp)
    if dtype == "float64":
        bar = {k_: 1e-9 for k_ in errs}
    else:
        bar = {k_: 1e-2 for k_ in errs}
        bar["f"] = 1e-3
        sums = {nm: rel_err(a.sum(0), c__.sum(0))
                for nm, a, c__ in zip(GRAD_NAMES[:3], gk, gp)}
        errs.update({"sum " + k_: v for k_, v in sums.items()})
        bar.update({"sum " + k_: 1e-3 for k_ in sums})
    for k_, e in errs.items():
        if not e <= bar[k_]:
            fail("wide %s -c %d %s fn+grad: %s error %.3g beyond %.0e"
                 % (pattern, c_, dtype, k_, e, bar[k_]))
    rel = 1e-9 if dtype == "float64" else 1e-4
    _, d, c = batch_factors_for(cfg, reads, dev, p)
    stage_err = check_stages(dp, d, c, j0, rel, dtype == "float32")
    stage_err.update(check_adj_stages(dp, d, c, j0, rel))
    # device ms per column j0 in the plans' variants, beside bounds
    itemsize = torch.finfo(st.dtype).bits // 8
    bnd = bounds(cfg, st, c, J.kernels(cfg, dev).tab, j0, n, itemsize)
    ms = {kn: v[0] for kn, v in {
        **ep_column_ms(cfg, reads, p, dev, funcs, j0),
        **band_column_ms(cfg, reads, p, dev, funcs, j0)}.items()}
    plain_ms = wide_plain_ms(dp, d, c, j0)
    rec = dict(pattern=pattern, S=st.dims.S, n_ar=st.n_ar, c=c_,
               dtype=dtype, reads=n, Lp=Lp, column=j0,
               plans={kn: pl.name for kn, pl in plans.items()},
               launches=launches, variants=variants,
               err={k_: float(v) for k_, v in errs.items()},
               stage_err=stage_err, ms=ms, plain_ms=plain_ms,
               bound={kn: bnd[kn] for kn in ms})
    print("wide grammar %s (S=%d, n_ar=%d) -c %d %s, %d reads x %d-%d nt: "
          "plans %s; fn+grad per read vs the plain version (f64) %s; stages "
          "at column %d %s; launches %s, by variant %s; device ms per column "
          "%d %s, plain %s, bounds %s" % (
              pattern, st.dims.S, st.n_ar, c_, dtype, n, lmin, lmax,
              json.dumps(rec["plans"]), json.dumps(rec["err"]), j0,
              json.dumps(stage_err), json.dumps(launches),
              json.dumps(variants), j0, json.dumps(ms),
              json.dumps(plain_ms), json.dumps(rec["bound"])), flush=True)
    return rec, cfg, reads, p


def wide_plain_ms(dp, d, c, j0):
    """The plain versions' ms (CUDA events) of K2-K7's stages at column
    j0, per kernel, on the kernel forward's tables."""
    st = dp.st
    h = DP.hoisted(d, c, st)
    fs = dp.run_inside(d, c, h)
    out = {}
    for kn, names in (("inside_band", ("band_front", "band_bif", "band_m",
                                       "band_e")),
                      ("inside_ep", ("ep_stage",)),
                      ("inside_ext", ("ext_stage",))):
        ps = DP.clone_state(fs)
        pf = [getattr(DP, nm + "_plain") for nm in names]
        out[kn] = cuda_ms(lambda: [f(ps, j0, d, c, h, st) for f in pf], 3)
    gs = DP.init_grads(fs, d, c, h)
    DP.seed_parts(gs, torch.ones((c.wsp.shape[-1], 3), dtype=st.dtype,
                                 device=fs["O"].device), c, st)
    dp.outside_columns(fs, gs, d, c, h, dp.dims.Lp + 1, j0 + 1)
    for kn, names in (("outside_band", ("e_adj", "band_adj")),
                      ("outside_ep", ("ep_adj",)),
                      ("outside_ext", ("ext_adj",))):
        pg = DP.clone_state(gs)
        pf = [getattr(DP, nm + "_plain") for nm in names]
        out[kn] = cuda_ms(lambda: [f(fs, pg, j0, d, c, h, st) for f in pf],
                          3)
    return out


def wide_cyk(cfg, reads, p, dev, funcs):
    """The CYK tables of a wide grammar (f64: K11 in its device variant)
    under the scanner's pin set (the path: the launch counts set to 0
    before the tables and read after), two runs and the plain max DP
    bitwise equal, K13's paths identical to the host traceback; K11's
    device ms per column J0, its bound and the plain stage's ms."""
    scfg, d, c = cyk_factors(cfg, p, reads, dev, True)
    mdp = DMB.MaxDP(J.kernels(scfg, dev).dp)
    st = mdp.st
    plan = K.ep_plan("inside_ep_max", st.dims.S, st.n_ar, st.dims.Cp,
                     st.dtype)
    K.reset_counts()
    tabs = mdp.tables(d, c)
    torch.cuda.synchronize()
    launches = {kn: K.KERNELS[kn].launches for kn in CYK_KERNELS[:3]}
    n_var = K.KERNELS["inside_ep_max"].variants.get(plan.name, 0)
    if min(launches.values()) <= 0 or n_var <= 0:
        fail("wide CYK: launches %s, K11's %s variant %d" % (
            launches, plan.name, n_var))
    again = mdp.tables(d, c)
    plain = mdp.tables(d, c, plain=True)
    e = {}
    for key, kn in MAX_TABLE_KERNEL.items():
        if not torch.equal(tabs[key], again[key]):
            fail("wide CYK tables: two kernel runs differ in %s" % key)
        e[kn] = max(e.get(kn, 0.0), max_compare(
            "wide CYK table %s" % key, tabs[key], plain[key], 0.0))
    del again, plain
    n_tb, tb_names = check_traceback(scfg, d, c, tabs, dev,
                                     "wide %s" % cfg.pattern)
    ks = DP.clone_state(tabs)
    ms = device_ms(lambda: DMB.max_ep_stage(ks, J0, d, c, mdp.mst),
                   REPS // 4, funcs["inside_ep_max"])
    ps = DP.clone_state(tabs)
    plain = cuda_ms(lambda: DMB.PLAIN_STAGES[DMB.STAGES.index(
        DMB.max_ep_stage)](ps, J0, d, c, mdp.mst), 3)
    bnd = max_bounds(scfg, st, c, J0, {"cells": 0, "cands": 0},
                     torch.finfo(st.dtype).bits // 8)["inside_ep_max"]
    print("wide grammar %s CYK tables (f64, K11 %s variant) vs the plain "
          "max DP: max abs err %s (bitwise), K13 paths of %d reads "
          "identical to the host traceback under plans %s; K11 %.4f ms per "
          "column %d (plain %.3f, bound %.5f by %s)" % (
              cfg.pattern, plan.variant, json.dumps(e), n_tb,
              json.dumps(tb_names), ms, J0, plain, bnd[0], bnd[1]),
          flush=True)
    return dict(err=e["inside_ep_max"], ms=ms, plain_ms=plain, bound=bnd,
                variant=plan.variant, launches=n_var)


def same_shape_variants(dev, funcs):
    """Where both fit (`.....*.....`, -c 30, f64 and f32, 8 reads): K3,
    K6 and K11 in the shared and the device variant (ep_plan's keyword)
    bitwise equal, each variant's device ms per column J0; the M chain
    (K2's band_m, K5's band_adj pinned with the class probe, K10's
    band_m_max) bitwise equal across every group of reads the type takes
    and the small ring, K2's and K5's ms per column J0 for each."""
    out = {}
    reads = make_reads(np.random.RandomState(4), 8, 70, LP)
    for dtype in ("float64", "float32"):
        cfg = wide_cfg(WIDE_SAME, 30, dtype, LP)
        p = random_params(cfg, dev)
        dp = J.kernels(cfg, dev).dp
        st = dp.st
        S, r = st.dims.S, J0 + st.PAD
        _, d, c = batch_factors_for(cfg, reads, dev, p)
        h = DP.hoisted(d, c, st)
        fs = dp.run_inside(d, c, h)
        gs = DP.init_grads(fs, d, c, h)
        DP.seed_parts(gs, torch.ones((len(reads), 3), dtype=st.dtype,
                                     device=dev), c, st)
        dp.outside_columns(fs, gs, d, c, h, cfg.Lp + 1, J0 + 1)
        mdp = DMB.MaxDP(dp)
        tabs = mdp.tables(d, c)
        rec = {}
        got = {}
        for v in ("shared", "device"):
            pl = {kn: K.ep_plan(kn, S, st.n_ar, st.dims.Cp, st.dtype,
                                variant=v) for kn in EP_KERNELS}
            a, g_, m = (DP.clone_state(x) for x in (fs, gs, tabs))
            K.ep_stage(a, J0, d, c, h, st, plan=pl["inside_ep"])
            K.ep_adj(fs, g_, J0, d, c, h, st, plan=pl["outside_ep"])
            K.max_ep_stage(m, J0, d, c, mdp.mst, plan=pl["inside_ep_max"])
            got[v] = [x.clone() for x in [a["ep"][r], a["ep_shift"],
                                          m["ep"][r]] + [
                g_[k_] for k_ in sorted(g_) if not k_.startswith("_")]]
            rec[v] = {
                "inside_ep": device_ms(lambda: K.ep_stage(
                    a, J0, d, c, h, st, plan=pl["inside_ep"]), REPS // 4,
                    funcs["inside_ep"]),
                "outside_ep": device_ms(lambda: K.ep_adj(
                    fs, g_, J0, d, c, h, st, plan=pl["outside_ep"]),
                    REPS // 4, funcs["outside_ep"]),
                "inside_ep_max": device_ms(lambda: K.max_ep_stage(
                    m, J0, d, c, mdp.mst, plan=pl["inside_ep_max"]),
                    REPS // 4, funcs["inside_ep_max"])}
        for i, (x, y) in enumerate(zip(got["shared"], got["device"])):
            if not torch.equal(x, y):
                fail("%s %s: the device variant differs from the shared "
                     "one (output %d)" % (WIDE_SAME, dtype, i))
        # the M chain across groups of reads, pinned with the class probe
        dq, cq, hq, fq, gbq = scan_factors_pinned(cfg, reads, p, dev)
        gq = DP.init_grads(fq, dq, cq, hq)
        DP.seed_parts(gq, gbq, cq, st)
        dp.outside_columns(fq, gq, dq, cq, hq, cfg.Lp + 1, J0 + 1)
        K.e_adj(fq, gq, J0, dq, cq, hq, st)
        it = torch.finfo(st.dtype).bits // 8
        shapes = [(g, 4, 1) for g in (8, 4, 2, 1) if g * it <= 32] + [
            (1, 2, 1), (1, 4, 2), (1, 4, 4), (1, 2, 4)]
        ref, mrec = None, {}
        for G, R, nc in shapes:
            bp = {kn: K.band_plan(kn, S, st.dtype, G=G, R=R, cells=nc)
                  for kn in BAND_KERNELS}
            a, g_, m = (DP.clone_state(x) for x in (fq, gq, tabs))
            K.band_m(a, J0, dq, cq, hq, st, plan=bp["inside_band"])
            K.band_adj(fq, g_, J0, dq, cq, hq, st, plan=bp["outside_band"])
            K.max_band_m(m, J0, d, c, mdp.mst, plan=bp["inside_band"])
            cur = [x.clone() for x in [a["M"][r], m["M"][r]] + [
                g_[k_] for k_ in sorted(g_) if not k_.startswith("_")]]
            if ref is None:
                ref = cur
            elif not all(torch.equal(x, y) for x, y in zip(ref, cur)):
                fail("%s %s: the M chain in groups of %d reads (ring %d, "
                     "%d cells a thread) differs from groups of %d" % (
                         WIDE_SAME, dtype, G, R, nc, shapes[0][0]))
            mrec[bp["inside_band"].name] = {
                "band_m": device_ms(lambda: K.band_m(
                    a, J0, dq, cq, hq, st, plan=bp["inside_band"]),
                    REPS // 4, funcs["inside_band"]),
                "m_adj": device_ms(lambda: K.m_adj_stage(
                    fq, g_, J0, dq, cq, hq, st, plan=bp["outside_band"]),
                    REPS // 4, funcs["outside_band"])}
        rec["m_chain"] = mrec
        out[dtype] = rec
        print("%s -c 30 %s, 8 reads x 70-%d nt, column %d: K3, K6, K11 in "
              "the device variant bitwise equal to the shared one; device "
              "ms per column %s; the M chain (K2 band_m, K5 pinned with the "
              "class probe, K10) bitwise equal across (reads per block, "
              "ring, cells a thread) %s, ms %s" % (
                  WIDE_SAME, dtype, LP, J0,
                  json.dumps({v: rec[v] for v in ("shared", "device")}),
                  [list(x) for x in shapes], json.dumps(mrec)), flush=True)
        del fs, gs, tabs, fq, gq
        torch.cuda.empty_cache()
    return out


def scan_factors_pinned(cfg, reads, p, dev):
    """(d, c, h, the kernel forward's tables, a parts cotangent) of
    ``reads`` under a random pin per read with the class probe."""
    batch = OBJ.stack_reads(cfg, reads, device=dev)
    d, c = scan_factors(cfg, batch, p, dev, True)
    dp = J.kernels(cfg, dev).dp
    h = DP.hoisted(d, c, dp.st)
    fs = dp.run_inside(d, c, h)
    gbar = torch.ones((len(reads), 3), dtype=dp.st.dtype, device=dev)
    gbar = torch.where(torch.isfinite(dp.extract_parts(fs["O"], c)), gbar,
                       0.0)
    return d, c, h, fs, gbar


# Grammars past 1,024 states (the M chain's threads stride over the
# states, K8/K9's too): (pattern, -c, reads, their length range, Lp,
# max-span, column of the per-stage checks and times).  The plain DP's
# dense split matrices take S^3 values (21 GB at f64 for 50 dots), so each
# shape runs alone with the DPs of the others freed.
WIDE_BIG = (("." * 44, 10, 3, 40, 50, 50, 40, 30),
            ("." * 50, 10, 2, 40, 50, 50, 40, 30))


def free_dps():
    """Drop the cached DPs (their plain matrices) and the allocator's
    free blocks."""
    J._kernels_cached.cache_clear()
    torch.cuda.empty_cache()


def m_chain_variants(cfg, reads, p, dev, funcs, j0):
    """The M chain at column j0 in every plan band_plan gives the grammar
    at G = 1 (the rings of 4 and 2 where the block fits shared memory, and
    the device variant), each with the cells a thread the grammar needs
    and with 4 (forced: the build no grammar here takes on its own): K2's
    band_m with K10's band_m_max, and K5's band_adj pinned with the class
    probe, each bitwise equal across its plans; each plan's device ms per
    column (band_m, m_adj)."""
    dp = J.kernels(cfg, dev).dp
    st = dp.st
    S, r = st.dims.S, j0 + st.PAD
    _, d, c = batch_factors_for(cfg, reads, dev, p)
    mdp = DMB.MaxDP(dp)
    tabs = mdp.tables(d, c)
    dq, cq, hq, fq, gbq = scan_factors_pinned(cfg, reads, p, dev)
    gq = DP.init_grads(fq, dq, cq, hq)
    DP.seed_parts(gq, gbq, cq, st)
    dp.outside_columns(fq, gq, dq, cq, hq, cfg.Lp + 1, j0 + 1)
    K.e_adj(fq, gq, j0, dq, cq, hq, st)
    rec = {}
    for kn in BAND_KERNELS:
        plans = []
        for nc in (None, 4):
            for R in (K.BAND_RING, K.BAND_RING_SMALL):
                for v in ("shared", "device"):
                    try:
                        plans.append(K.band_plan(kn, S, st.dtype, G=1, R=R,
                                                 variant=v, cells=nc))
                    except ValueError:
                        continue
        ref = None
        for pl in plans:
            if kn == "inside_band":
                a, m = DP.clone_state(fq), DP.clone_state(tabs)
                K.band_m(a, j0, dq, cq, hq, st, plan=pl)
                K.max_band_m(m, j0, d, c, mdp.mst, plan=pl)
                cur = [a["M"][r].clone(), m["M"][r].clone()]
                ms = device_ms(lambda: K.band_m(a, j0, dq, cq, hq, st,
                                                plan=pl), REPS // 8,
                               funcs["inside_band"])
            else:
                g_ = DP.clone_state(gq)
                K.band_adj(fq, g_, j0, dq, cq, hq, st, plan=pl)
                cur = [g_[k_].clone() for k_ in sorted(g_)
                       if not k_.startswith("_")]
                ms = device_ms(lambda: K.m_adj_stage(fq, g_, j0, dq, cq, hq,
                                                     st, plan=pl),
                               REPS // 8, funcs["outside_band"])
            if ref is None:
                ref = (pl, cur)
            elif not all(torch.equal(x, y) for x, y in zip(ref[1], cur)):
                fail("%d dots %s: %s's M chain in plan %s differs from plan "
                     "%s" % (len(cfg.pattern), cfg.dtype, kn, pl.name,
                             ref[0].name))
            rec["%s %s" % ("band_m" if kn == "inside_band" else "m_adj",
                           pl.name)] = ms
    return rec


def wide_big_case(case, dev, funcs):
    """One shape of WIDE_BIG: fn+grad per read through the kernels at f64
    and f32 (the launch counts set to 0 before each: every kernel of the
    path launched, the M chain in its plan's variant), two f64 runs
    bitwise equal, against the f64 plain version (f64 within 1e-9 per
    read; f32 each read within 1e-2, the sums and f within 1e-3); every
    stage and adjoint stage at column j0 against its plain version (f64,
    1e-9 relative); the no-rss chain K8/K9 (with K14 for eR) launched and
    against its plain version (f64 within 1e-9, f32 within 1e-4); the M
    chain bitwise across its plans (m_chain_variants)."""
    pattern, c_, n, lmin, lmax, Lp, span, j0 = case
    cfg64 = J.ModelConfig(pattern=pattern, Lp=Lp, max_span=span,
                          max_iloop=c_, min_bpp=MIN_BPP, tau=0.1,
                          dtype="float64")
    cfg32 = dataclasses.replace(cfg64, dtype="float32")
    reads = make_reads(np.random.RandomState(3), n, lmin, lmax)
    t0 = time.time()
    rec = dict(pattern="%d dots" % len(pattern), c=c_, reads=n, Lp=Lp,
               column=j0, launches={}, variants={}, err={})
    res = {}
    for cfg in (cfg64, cfg32):
        p = random_params(cfg, dev)
        b = OBJ.stack_reads(cfg, reads, device=dev)
        st = J.kernels(cfg, dev).dp.st
        plans = plans_of(st)
        K.reset_counts()
        res[cfg.dtype] = full_grads(cfg, p, b, dev, plain=False)
        torch.cuda.synchronize()
        path = DP_KERNELS + ROWS_CD_KERNELS
        launches = {kn: K.KERNELS[kn].launches for kn in path}
        variants = {kn: dict(K.KERNELS[kn].variants) for kn in path
                    if K.KERNELS[kn].variants}
        for kn in path:
            if launches[kn] <= 0:
                fail("wide %d dots %s: kernel %s was not launched"
                     % (len(pattern), cfg.dtype, kn))
        for kn in EP_KERNELS[:2] + BAND_KERNELS:
            if variants.get(kn, {}).get(plans[kn].name, 0) <= 0:
                fail("wide %d dots %s: %s did not run its plan's variant %s "
                     "(%s)" % (len(pattern), cfg.dtype, kn, plans[kn].name,
                               variants.get(kn)))
        rec["launches"][cfg.dtype] = launches
        rec["variants"][cfg.dtype] = variants
        rec.setdefault("plans", {})[cfg.dtype] = {
            kn: pl.name for kn, pl in plans.items()}
        if cfg is cfg64:
            f2, g2 = full_grads(cfg, p, b, dev, plain=False)
            if not torch.equal(res[cfg.dtype][0], f2) or not all(
                    torch.equal(x, y) for x, y in zip(res[cfg.dtype][1], g2)):
                fail("wide %d dots: two kernel runs differ" % len(pattern))
            del f2, g2
            res["plain"] = full_grads(cfg, p, b, dev, plain=True)
            S = st.dims.S
    fp, gp = res["plain"]
    axes = (0, 0, 0, -1)
    for dtype, (fk, gk) in ((k_, res[k_]) for k_ in ("float64", "float32")):
        errs = {nm: worst_read(a, c__, ax)
                for nm, a, c__, ax in zip(GRAD_NAMES, gk, gp, axes)}
        errs["f"] = rel_err(fk, fp)
        bar = {k_: 1e-9 if dtype == "float64" else 1e-2 for k_ in errs}
        if dtype == "float32":
            bar["f"] = 1e-3
            sums = {"sum " + nm: rel_err(a.sum(0), c__.sum(0))
                    for nm, a, c__ in zip(GRAD_NAMES[:3], gk, gp)}
            errs.update(sums)
            bar.update({k_: 1e-3 for k_ in sums})
        for k_, e in errs.items():
            if not e <= bar[k_]:
                fail("wide %d dots %s fn+grad: %s error %.3g beyond %.0e"
                     % (len(pattern), dtype, k_, e, bar[k_]))
        rec["err"][dtype] = errs
    del res
    p64 = random_params(cfg64, dev)
    dp = J.kernels(cfg64, dev).dp
    _, d, c = batch_factors_for(cfg64, reads, dev, p64)
    rec["stage_err"] = check_stages(dp, d, c, j0, 1e-9, False)
    rec["stage_err"].update(check_adj_stages(dp, d, c, j0, 1e-9))
    rec["plain_ms"] = wide_plain_ms(dp, d, c, j0)
    itemsize = 8
    rec["bound"] = bounds(cfg64, dp.st, c, J.kernels(cfg64, dev).tab, j0, n,
                          itemsize)
    rec["ms"] = {kn: v[0] for kn, v in band_column_ms(
        cfg64, reads, p64, dev, funcs, j0).items()}
    del d, c, dp
    free_dps()
    chain = {}
    for cfg, rel in ((cfg64, 1e-9), (cfg32, 1e-4)):
        ncfg = dataclasses.replace(cfg, no_rss=True)
        lin, eR, L, gpc = chain_inputs(ncfg, reads, dev)
        sd = J.stack_seqdata([J.make_seqdata(ncfg, s_, q_)
                              for s_, q_ in reads], dev)
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in J.per_read(random_params(ncfg, dev), n)]
        K.reset_counts()
        with torch.enable_grad():
            parts = J.batch_logZ_parts_pr(ncfg, J.Params(*leaves), sd,
                                          device=dev)
            torch.autograd.grad(parts[torch.isfinite(parts)].sum(),
                                leaves[0])
        torch.cuda.synchronize()
        for kn in CHAIN_KERNELS + ("factors", "factors_adj"):
            if K.KERNELS[kn].launches <= 0:
                fail("wide %d dots no-rss %s: %s was not launched"
                     % (len(pattern), cfg.dtype, kn))
        pk, rows = K.chain_fwd(lin, eR, L)
        gk = K.chain_adj(lin, eR, L, rows, gpc)
        pp, gpl = plain_chain(lin, eR, L, gpc)
        fin = torch.isfinite(pp)
        chain[cfg.dtype] = dict(
            fwd=grad_compare("wide linear_fwd", pk[fin], pp[fin], rel),
            adj=grad_compare("wide linear_adj", gk, gpl, rel))
    rec["chain"] = chain
    rec["m_chain"] = {}
    for cfg in (cfg64, cfg32):
        rec["m_chain"][cfg.dtype] = m_chain_variants(
            cfg, reads, random_params(cfg, dev), dev, funcs, j0)
        free_dps()
    rec["S"], rec["seconds"] = S, time.time() - t0
    print("wide grammar %d dots (S=%d) -c %d, %d reads x %d-%d nt, -w %d: "
          "plans %s; fn+grad per read vs the f64 plain version %s; stages "
          "at column %d (f64) %s; launches %s, by variant %s; K8/K9 vs plain "
          "%s; the M chain bitwise across its plans, device ms per column "
          "%d %s; K2/K5 ms per column (f64) %s, plain %s, bounds %s; %.1f s"
          % (len(pattern), S, c_, n, lmin, lmax, span,
             json.dumps(rec["plans"]), json.dumps(rec["err"]), j0,
             json.dumps(rec["stage_err"]), json.dumps(rec["launches"]),
             json.dumps(rec["variants"]), json.dumps(chain), j0,
             json.dumps(rec["m_chain"]), json.dumps(rec["ms"]),
             json.dumps(rec["plain_ms"]),
             json.dumps({k_: rec["bound"][k_] for k_ in BAND_KERNELS}),
             rec["seconds"]), flush=True)
    return rec


def wide_phase(dev):
    """P4 on the card: WIDE's fn+grad paths, the CYK tables of the first
    (f64), the variants at a shape where both fit.  Returns the kernel
    rows of the variants the paths ran."""
    funcs = kernel_functions()
    recs, rows = [], []
    cyk = None
    for case in WIDE:
        rec, cfg, reads, p = wide_case(case, dev, funcs)
        recs.append(rec)
        if cyk is None:
            cyk = wide_cyk(cfg, reads, p, dev, funcs)
        torch.cuda.empty_cache()
    same = same_shape_variants(dev, funcs)
    big = []
    for case in WIDE_BIG:
        free_dps()
        big.append(wide_big_case(case, dev, funcs))
    free_dps()
    # one row per variant a path ran that the main path does not (the
    # device variants; the M chain in groups other than 32 bytes' worth of
    # reads), its times and bound at the first shape that ran it
    launched, first = {}, {}
    for rec in recs:
        main_g = "G=%d,R=4" % (32 // (8 if rec["dtype"] == "float64"
                                      else 4))
        for kn, per in rec["variants"].items():
            for v, n_ in per.items():
                if v in ("shared", main_g):
                    continue
                launched[(kn, v)] = launched.get((kn, v), 0) + n_
                first.setdefault((kn, v), rec)
    for (kn, v), n_ in sorted(launched.items()):
        rec, kern = first[(kn, v)], K.KERNELS[kn]
        rows.append({
            "name": "%s [%s]" % (kn, v), "route": "cuda",
            "source": kern.source, "replaces": kern.replaces,
            "launches": n_, "max_abs_err": rec["stage_err"].get(kn, 0.0),
            "ms": rec["ms"][kn], "plain_ms": rec["plain_ms"][kn],
            "bound_ms": rec["bound"][kn][0],
            "bound_by": rec["bound"][kn][1], "library_ms": None,
            "unit": "column %d, %s -c %d %s, %d reads" % (
                rec["column"], rec["pattern"], rec["c"], rec["dtype"],
                rec["reads"])})
    if cyk["variant"] == "device":
        kern = K.KERNELS["inside_ep_max"]
        rows.append({
            "name": "inside_ep_max [device]", "route": "cuda",
            "source": kern.source, "replaces": kern.replaces,
            "launches": cyk["launches"], "max_abs_err": cyk["err"],
            "ms": cyk["ms"],
            "plain_ms": cyk["plain_ms"], "bound_ms": cyk["bound"][0],
            "bound_by": cyk["bound"][1], "library_ms": None,
            "unit": "column %d of the CYK tables, %s f64" % (
                J0, WIDE[0][0])})
    for rec in big:       # the M chain past 1,024 states (f64 path's plan)
        for kn in BAND_KERNELS:
            v = rec["plans"]["float64"][kn]
            kern = K.KERNELS[kn]
            rows.append({
                "name": "%s [%s]" % (kn, v), "route": "cuda",
                "source": kern.source, "replaces": kern.replaces,
                "launches": rec["variants"]["float64"].get(kn, {}).get(v, 0),
                "max_abs_err": rec["stage_err"].get(kn, 0.0),
                "ms": rec["ms"][kn], "plain_ms": rec["plain_ms"][kn],
                "bound_ms": rec["bound"][kn][0],
                "bound_by": rec["bound"][kn][1], "library_ms": None,
                "unit": "column %d, %s (S=%d) -c %d f64, %d reads" % (
                    rec["column"], rec["pattern"], rec["S"], rec["c"],
                    rec["reads"])})
    return dict(cases=recs, cyk=cyk, same=same, big=big), rows


# ------------------------------------------------------------ rows C, D

# K14-K17 against their plain versions (phase 2): (pattern, config
# changes) of the cases, each at f64 B=16 and at f32 B=128 x 100 nt
ROWS_CD_CASES = (
    (PATTERN, {}), (PATTERN, {"theta_softmax": True}),
    (PATTERN, {"no_theta": True}), (PATTERN, {"no_prf": True}),
    (PATTERN, {"fix_rss": True}), (NORSS, {"no_rss": True}),
    (NORSS, {"no_rss": True, "theta_softmax": True}))
ROWS_CD_KERNELS = ("factors", "factors_adj", "hoisted", "hoisted_adj")


def random_rss(rng, L):
    """A dot-bracket structure of length L: a stem of up to 8 nested
    pairs around a random spot, dots elsewhere."""
    rss = ["."] * L
    m = int(rng.randint(1, 9))
    i0 = int(rng.randint(0, max(1, L - 2 * m - 4)))
    for k in range(m):
        if i0 + 2 * m + 3 - k < L:
            rss[i0 + k], rss[i0 + 2 * m + 3 - k] = "(", ")"
    return "".join(rss)


def rows_cd_batch(cfg, reads, dev, seed):
    """(SeqData, pair masks) of ``reads`` (with a random structure per
    read under fix_rss)."""
    rng = np.random.RandomState(seed)
    sds = [J.make_seqdata(cfg, s_, q_, random_rss(rng, len(s_))
                          if cfg.fix_rss else "") for s_, q_ in reads]
    sd = J.stack_seqdata(sds, dev)
    bp = None if cfg.no_rss else J.effective_bp_mask_batch(cfg, sd, dev)[0]
    return sd, bp


def rows_cd_weights(cfg, B, dev, seed):
    """Per-read weights, each read its own (numpy seed): singles [B, ns,
    4], pairs [B, Tp, 6], lam [B, 2]."""
    p = J.init_params(J.kernels(cfg, "cpu").g, cfg, device="cpu",
                      dtype="float64")
    rng = np.random.RandomState(seed)
    dt = torch.float32 if cfg.dtype == "float32" else torch.float64
    f = lambda x: torch.as_tensor(x, dtype=dt, device=dev)
    return [f(p.singles.numpy()[None] + 0.5 * rng.randn(
                B, *p.singles.shape)),
            f(p.pairs.numpy()[None] + 0.5 * rng.randn(B, *p.pairs.shape)),
            f(0.5 + rng.rand(B, 2))]


def factors_run(cfg, sd, bp, weights, cots, plain):
    """K14/K15 (or with ``plain`` the plain version and its autograd) on
    per-read weights: (the factors [eR, eL, bg2, pv] or [eR], the
    constants, the cotangents of singles and pairs (None: no dependence))."""
    k = J.kernels(cfg, DEVICE)
    leaves = [w.detach().clone().requires_grad_(True) for w in weights[:2]]
    pw = J.Params(leaves[0], leaves[1], weights[2])
    with torch.enable_grad():
        if cfg.no_rss:
            outs = [J.right_emissions(cfg, k, pw, sd, plain=plain)]
            consts = []
        else:
            d, c = J.batch_factors_pr(cfg, pw, sd, bp, DEVICE, plain=plain)
            outs = [d.eR, d.eL, d.bg2, d.pv]
            consts = [c.wsp, c.gate_O2, c.gate_M, c.seq, c.C, c.L,
                      c.dots_cum, d.alphaP, c.hp, c.ep["misA"], c.okP]
        need = [o.requires_grad for o in outs]
        grads = [None, None]
        if cots and any(need):
            gr = torch.autograd.grad(
                [o for o, n_ in zip(outs, need) if n_], leaves,
                [g for g, n_ in zip(cots, need) if n_], allow_unused=True)
            grads = list(gr)
    return [o.detach() for o in outs], consts, grads


def plain_contraction(cfg, sd, cots):
    """K15's contraction part as the plain version forms it (no
    log-softmax): per state, base and read the read_sum over positions of
    the one-hot products (model/joint._OneHot's adjoint), into the states'
    slots in ascending state order (singles[:, slot]'s index adjoint),
    bg2's + eL's + eR's; per table and pair type the read_sum over pair
    cells."""
    k = J.kernels(cfg, DEVICE)
    g = k.g
    dt = cots[0].dtype
    seq = sd.seq.long()
    Lp, B = seq.shape[1], seq.shape[0]
    ns = int((g.single_table_index >= 0).sum())
    valid = (seq > 0).T                                     # [Lp, B]
    oh4 = torch.nn.functional.one_hot(torch.clamp(seq - 1, 0, 3), 4).to(
        dt).permute(1, 0, 2)                                # [Lp, B, 4]
    zero = torch.zeros((), dtype=dt, device=seq.device)
    contr = lambda oh, gm: DP.read_sum(oh * gm[:, :, None], 1)
    paths = []
    for gi, tid in ((0, g.tid_r), (1, g.tid_l)):
        acc = torch.zeros((B, ns, 4), dtype=dt, device=seq.device)
        if gi < len(cots):
            slots = np.mod(g.single_table_index[tid], ns)
            for s_ in range(g.S):
                gm = torch.where(valid, cots[gi][:, s_], zero)
                acc[:, slots[s_]] = acc[:, slots[s_]] + contr(oh4, gm)
        paths.append(acc)
    bg = torch.zeros((B, ns, 4), dtype=dt, device=seq.device)
    if len(cots) > 2:
        bg[:, 0] = contr(oh4, torch.where(valid, cots[2], zero))
    singles = (bg + paths[1]) + paths[0]
    if len(cots) < 4:
        return singles, None
    bt = pair_types(cfg, seq)                                 # [n, B]
    oh6 = torch.nn.functional.one_hot(torch.clamp(bt - 1, 0, 5), 6).to(dt)
    gpv = cots[3].reshape(-1, cots[3].shape[2], B)            # [n, Tp, B]
    pairs = torch.stack([contr(oh6, torch.where(bt > 0, gpv[:, t], zero))
                         for t in range(gpv.shape[1])], 1)
    return singles, pairs


def pair_types(cfg, seq):
    """The pair type of every pair cell (j, w) of every read, [(Lp+1)
    (Wp+1), B] (0: the bases j-w and j-1 do not pair), as K15 forms it."""
    k = J.kernels(cfg, DEVICE)
    seq = seq.long()
    B, Lp = seq.shape
    j = torch.arange(Lp + 1, device=seq.device)[:, None]
    w = torch.arange(cfg.Wp + 1, device=seq.device)[None, :]
    i = torch.clamp(j - w, 0, Lp - 1).expand(-1, cfg.Wp + 1)
    jj = torch.clamp(j - 1, 0, Lp - 1).expand(-1, cfg.Wp + 1)
    return k.tab["bp"][seq[:, i], seq[:, jj]].reshape(B, -1).T


def factors_adj_bytes(cfg, seq, cots):
    """The bytes of K15's cotangents [eR, eL, bg2, pv] (any None) that
    this batch needs: it loads eR's, eL's and bg2's only at a read's bases
    (code > 0) and pv's only at the pair cells whose bases pair."""
    seq = torch.as_tensor(seq, device=DEVICE)
    n_pos = int((seq > 0).sum())
    n_pair = int((pair_types(cfg, seq) > 0).sum())
    per = (lambda t: t.shape[1]), (lambda t: t.shape[1]), (lambda t: 1), \
        (lambda t: t.shape[2])
    total = 0
    for i, (t, f) in enumerate(zip(cots, per)):
        if t is not None:
            total += (n_pair if i == 3 else n_pos) * f(t) * t.element_size()
    return total


def hoisted_adj_cots(cots, PAD):
    """K17's cotangents as it reads them: emisB's without its PAD front
    rows (K17 reads rows PAD..PAD+Lp only)."""
    return list(cots[:3]) + [None if cots[3] is None else cots[3][:, PAD:]]


def hoisted_run(cfg, d, c, lam, cots, plain, st=None):
    """K16 and K17 alone (or the plain version and its autograd) for
    per-read lambda [2, B]: (the four tensors, lambda's cotangent from
    theirs, ``cots``); ``st`` the
    grammar's DPStatic (default: the pattern's)."""
    st = J.kernels(cfg, DEVICE).dp.st if st is None else st
    if not plain:
        dd = d._replace(lam=lam)
        h = DP.hoisted(dd, c, st)
        return ([h[k_] for k_ in DP.HOISTED],
                DP.hoisted_lam_term(cots, dd, c, st))
    leaf = lam.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        h = DP.hoisted_plain(d._replace(lam=leaf), c, st)
        outs = [h[k_] for k_ in DP.HOISTED]
        (gl,) = torch.autograd.grad(outs, [leaf], cots)
    return [o.detach() for o in outs], gl


def check_rows_cd(dev):
    """K14-K17 against their plain versions on the card over
    ROWS_CD_CASES: f64 at B=16 within 1e-12 and f32 at B=128 x 100 nt
    within 1e-6 relative (max norm) for every factor, cotangent and
    hoisted tensor; the constants identical; K15's contraction part (the
    cases without the log-softmax) bitwise equal to the plain version's
    sums; two runs bitwise equal; the first 8 reads of a 16-read batch
    bitwise equal to those 8 alone.  Returns {kernel: max abs err} of the
    f32 runs."""
    small = make_reads(np.random.RandomState(0), *SMALL)
    reads = main_reads()
    errs, msgs = {k_: 0.0 for k_ in ROWS_CD_KERNELS}, []
    for pattern, change in ROWS_CD_CASES:
        for dtype, rr, rel in (("float64", small, 1e-12),
                               ("float32", reads, 1e-6)):
            cfg = dataclasses.replace(cfg_for(dtype), pattern=pattern,
                                      **change)
            name = "%s %s %s B=%d" % (pattern, json.dumps(change), dtype,
                                      len(rr))
            sd, bp = rows_cd_batch(cfg, rr, dev, 11)
            wts = rows_cd_weights(cfg, len(rr), dev, 12)
            rng = np.random.RandomState(13)
            outs_p, consts_p, gp = factors_run(cfg, sd, bp, wts, [], True)
            cots = [torch.as_tensor(rng.randn(*o.shape), dtype=o.dtype,
                                    device=dev) for o in outs_p]
            outs_p, consts_p, gp = factors_run(cfg, sd, bp, wts, cots, True)
            outs_k, consts_k, gk = factors_run(cfg, sd, bp, wts, cots, False)
            outs_k2, consts_k2, gk2 = factors_run(cfg, sd, bp, wts, cots,
                                                  False)
            ef = max(grad_compare("factors %s" % name, a, b_, rel)
                     for a, b_ in zip(outs_k, outs_p))
            for a, b_ in zip(consts_k, consts_p):
                if not torch.equal(a, b_):
                    fail("factors %s: a constant differs from the plain "
                         "version's" % name)
            ea = 0.0
            for a, b_ in zip(gk, gp):
                if (a is None) != (b_ is None):
                    fail("factors_adj %s: the weights' dependence differs"
                         % name)
                if a is not None:
                    ea = max(ea, grad_compare("factors_adj %s" % name, a, b_,
                                              rel))
            same = all(torch.equal(a, b_) for a, b_ in zip(
                outs_k + consts_k, outs_k2 + consts_k2)) and all(
                a is None or torch.equal(a, b_) for a, b_ in zip(gk, gk2))
            if not same:
                fail("factors %s: two kernel runs differ" % name)
            bitwise = "n/a"
            if not cfg.theta_softmax and gk[0] is not None:
                ref = plain_contraction(cfg, sd, cots)
                for a, b_ in zip(gk, ref):
                    if b_ is not None and not torch.equal(a, b_):
                        fail("factors_adj %s: the contraction differs from "
                             "the plain version's sums (max %.3g)" % (
                                 name, float((a - b_).abs().max())))
                bitwise = all(b_ is None or torch.equal(a, b_)
                              for a, b_ in zip(gk, gp))
            # the first 8 reads alone
            sd8 = J.SeqData(*[x[:8] for x in sd])
            bp8 = None if bp is None else bp[:8]
            o8, c8, g8 = factors_run(cfg, sd8, bp8, [w[:8] for w in wts],
                                     [cc[..., :8] for cc in cots], False)
            if not all(torch.equal(a, b_[..., :8]) for a, b_ in zip(
                    o8, outs_k)) or not all(
                    a is None or torch.equal(a, b_[:8])
                    for a, b_ in zip(g8, gk)):
                fail("factors %s: the first 8 reads differ from those 8 "
                     "alone" % name)
            msg = "%s: K14 %.3g, K15 %.3g (bitwise vs plain autograd: %s)" % (
                name, ef, ea, bitwise)
            if not cfg.no_rss:
                k = J.kernels(cfg, dev)
                d, c = J.batch_factors(cfg, J.Params(*[w[0] for w in wts]),
                                       sd, bp, dev)
                lam = wts[2].T          # per-read copies: a strided view
                with torch.no_grad():
                    outs_p = list(DP.hoisted_plain(d._replace(lam=lam), c,
                                                   k.dp.st).values())
                hc = [torch.as_tensor(rng.randn(*o.shape), dtype=o.dtype,
                                      device=dev) for o in outs_p]
                hp_, glp = hoisted_run(cfg, d, c, lam, hc, True)
                hk, glk = hoisted_run(cfg, d, c, lam, hc, False)
                hk2, glk2 = hoisted_run(cfg, d, c, lam, hc, False)
                eh = max(grad_compare("hoisted %s" % name, a, b_, rel)
                         for a, b_ in zip(hk, hp_))
                eg = grad_compare("hoisted_adj %s" % name, glk, glp, rel)
                direct = K.hoisted_adj(k.dp.st, lam, c, hc)
                st_ = k.dp.st
                gs = dict(zip(("eSZ", "GSZ", "emisA", "emisB"), hc),
                          lam=torch.zeros_like(glk), DL=torch.zeros(
                              (st_.dims.Lp + 1, st_.dims.Wp + 1, st_.dims.S,
                               glk.shape[1]), dtype=glk.dtype, device=dev),
                          **{k_: None for k_ in ("eR", "eL", "bg2", "pv",
                                                 "alphaP")})
                K.reset_counts()
                total = DP.finish_grads(gs, d._replace(lam=lam), c, st_)[4]
                got_n = tuple(K.KERNELS[k_].launches for k_ in (
                    "hoisted", "hoisted_adj", "lam_sum"))
                if got_n != (0, 1, 1):
                    fail("hoisted %s: finish_grads launched K16, K17 and "
                         "K20 %s times (want 0, 1 and 1)" % (name, got_n))
                if not (all(torch.equal(a, b_) for a, b_ in zip(hk, hk2))
                        and torch.equal(glk, glk2)
                        and torch.equal(glk, direct)
                        and torch.equal(glk, total)):
                    fail("hoisted %s: two kernel runs (or K17 alone, or "
                         "finish_grads) differ" % name)
                c8 = c._replace(C=c.C[:8].contiguous(), ep={
                    k_: v[..., :8].contiguous() for k_, v in c.ep.items()})
                hk8, glk8 = hoisted_run(cfg, d, c8, lam[:, :8].contiguous(),
                                        [x[..., :8] for x in hc], False)
                if not all(torch.equal(a, b_[..., :8]) for a, b_ in zip(
                        hk8, hk)) or not torch.equal(glk8, glk[:, :8]):
                    fail("hoisted %s: the first 8 reads differ from those 8 "
                         "alone" % name)
                msg += ", K16 %.3g, K17 %.3g" % (eh, eg)
                if dtype == "float32":
                    errs["hoisted"] = max(errs["hoisted"], eh)
                    errs["hoisted_adj"] = max(errs["hoisted_adj"], eg)
            if dtype == "float32":
                errs["factors"] = max(errs["factors"], ef)
                errs["factors_adj"] = max(errs["factors_adj"], ea)
            msgs.append(msg)
            torch.cuda.empty_cache()
    msgs.append(check_null_factors(dev, errs))
    print("check rows C, D (K14-K17) vs the plain versions, max abs err "
          "(f64 B=16 within 1e-12, f32 B=%d x %d nt within 1e-6 relative, "
          "max norm; constants identical; K15's contraction bitwise the "
          "plain sums; two runs and the first 8 of 16 reads bitwise "
          "equal): %s" % (B_MAIN, LP, "; ".join(msgs)), flush=True)
    return errs


EDGE_BATCHES = (1, 7, 600)  # K1's and K16's batches beside the main one


def check_factor_tiles(cfg, sd, bp, wts, B, dtype, rel):
    """K14 on per-read weights vs the plain version (every factor within
    ``rel`` relative in the max norm, the constants identical) and, with
    each tile of positions factors_plan can take forced, bitwise its own
    plan's outputs.  Returns (max abs err, the tiles' names)."""
    outs_p, consts_p, _ = factors_run(cfg, sd, bp, wts, [], True)
    outs_k, consts_k, _ = factors_run(cfg, sd, bp, wts, [], False)
    e = max(grad_compare("factors B=%d %s" % (B, dtype), a, b_, rel)
            for a, b_ in zip(outs_k, outs_p))
    for a, b_ in zip(consts_k, consts_p):
        if not torch.equal(a, b_):
            fail("factors B=%d %s: a constant differs from the plain "
                 "version's" % (B, dtype))
    k = J.kernels(cfg, DEVICE)
    st, reads = k.dp.st, J._card_reads(k, sd)
    base = K.factors(st, cfg, "dp", *reads, singles=wts[0], pairs=wts[1])
    names = []
    for P in K.FAC_TILES:
        plan = K.factors_plan(cfg.Lp, st.dims.Wp, st.dims.S,
                              wts[1].shape[1], wts[0].shape[1], B, st.dtype,
                              True, P)
        got = K.factors(st, cfg, "dp", *reads, singles=wts[0],
                        pairs=wts[1], plan=plan)
        if not all(torch.equal(got[n_], base[n_]) for n_ in base):
            fail("factors B=%d %s: plan %s differs from the shape's plan"
                 % (B, dtype, plan.name))
        names.append(plan.name)
    return e, names


def check_k1_k16_batches(dev):
    """K1, K16 and K14 at B = 1, 7 and 600 x 100 nt (one read of a group,
    a scalar tail, 16-byte rows and many groups) as at B=128: K1 vs its
    plain version (ints and bools equal, floats within 1e-6 relative),
    K16 for per-read lambdas (a strided view) vs hoisted_plain and K14
    for per-read weights vs the plain factors within 1e-12 (f64) and 1e-6
    (f32) relative in the max norm, K14 under every tile of factors_plan
    bitwise its own plan; prints the share of float cells bit for bit the
    plain versions'.  Returns the f32 max abs errors by kernel."""
    errs = {"score_tables": 0.0, "hoisted": 0.0, "factors": 0.0}
    msgs = []
    for B in EDGE_BATCHES + (B_MAIN,):
        rr = make_reads(np.random.RandomState(40 + B), B, LP - 20, LP)
        for dtype, rel in (("float64", 1e-12), ("float32", 1e-6)):
            cfg = cfg_for(dtype)
            same = {}
            sd, bp = rows_cd_batch(cfg, rr, dev, 41)
            e1 = compare_score_tables(cfg, sd, bp, dev, same)
            wts = rows_cd_weights(cfg, B, dev, 42)
            k = J.kernels(cfg, dev)
            d, c = J.batch_factors(cfg, J.Params(*[w[0] for w in wts]), sd,
                                   bp, dev)
            lam = wts[2].T
            K.reset_counts()
            hk = K.hoisted(k.dp.st, lam, c)
            variant = dict(K.KERNELS["hoisted"].variants)
            with torch.no_grad():
                hp = DP.hoisted_plain(d._replace(lam=lam), c, k.dp.st)
            e2 = 0.0
            for n_, a in zip(DP.HOISTED, hk):
                e2 = max(e2, grad_compare("hoisted %s B=%d %s" % (
                    n_, B, dtype), a, hp[n_], rel))
                same[n_] = (int((a == hp[n_]).sum()), a.numel())
            e3, tiles = check_factor_tiles(cfg, sd, bp, wts, B, dtype, rel)
            if dtype == "float32":
                errs["score_tables"] = max(errs["score_tables"], e1)
                errs["hoisted"] = max(errs["hoisted"], e2)
                errs["factors"] = max(errs["factors"], e3)
            share = {n_: round(a / b_, 6) for n_, (a, b_) in same.items()}
            msgs.append("B=%d %s: K1 %.3g, K16 %.3g (%s), K14 %.3g (tiles "
                        "bitwise %s), cells bitwise the plain version's %s"
                        % (B, dtype, e1, e2, json.dumps(variant), e3,
                           json.dumps(tiles), json.dumps(share)))
            del hk, hp, d, c
            torch.cuda.empty_cache()
    print("check K1, K16 and K14 at B = %s x %d nt vs their plain "
          "versions, max abs err (K1: ints/bools equal, floats within 1e-6 "
          "relative; K16 and K14: f64 1e-12, f32 1e-6 relative, max norm, "
          "K14's constants identical, its outputs bitwise equal under every "
          "tile of factors_plan): %s" % (
              ", ".join(str(b_) for b_ in EDGE_BATCHES + (B_MAIN,)), LP,
              "; ".join(msgs)), flush=True)
    return errs


def output_digests(dev):
    """SHA-256 of each K1 and K16 output at the seeded main-path batch (B
    = 128 x 100 nt, per-read lambdas a strided view), f32 and f64,
    through the common entry points (ET.score_tables, ops/kernels.hoisted)
    so that a copy of this script beside an older tree prints that
    tree's."""
    out = {}
    for dtype in ("float32", "float64"):
        cfg = cfg_for(dtype)
        k = J.kernels(cfg, dev)
        sd, bp = rows_cd_batch(cfg, main_reads(), dev, 11)
        wts = rows_cd_weights(cfg, B_MAIN, dev, 12)
        args = J.score_inputs(cfg, k, sd, bp) + (
            cfg.Wp, cfg.max_span, cfg.turn, cfg.no_ene, cfg.fix_rss)
        got = ET.score_tables(k.tab, *args)
        d, c = J.batch_factors(cfg, J.Params(*[w[0] for w in wts]), sd, bp,
                               dev)
        hk = K.hoisted(k.dp.st, wts[2].T, c)
        tens = [("K1 " + n_, got[n_]) for n_ in ET.SCORE_KEYS] + [
            ("K16 " + n_, t) for n_, t in zip(DP.HOISTED, hk)]
        out[dtype] = {n_: hashlib.sha256(
            t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
            for n_, t in tens}
    return out


def same_fields(name, ours, plain, rel):
    """Every field of two DiffFactors or ConstFactors (a dict field by
    key): of the same dtype and shape, the integer and bool ones and the
    ``rel`` None ones identical, the rest within ``rel`` (grad_compare);
    returns the max abs error."""
    e = 0.0
    for f_ in ours._fields:
        a, b_ = getattr(ours, f_), getattr(plain, f_)
        pairs = [(f_ + "." + k_, a[k_], b_[k_]) for k_ in sorted(b_)] \
            if isinstance(b_, dict) else [(f_, a, b_)]
        if isinstance(b_, dict) and sorted(a) != sorted(b_):
            fail("%s: %s holds %s, the plain version %s" % (
                name, f_, sorted(a), sorted(b_)))
        for fk, x, y in pairs:
            if (x is None) != (y is None):
                fail("%s: %s is None in one version only" % (name, fk))
            if y is None:
                continue
            if x.dtype != y.dtype or x.shape != y.shape:
                fail("%s: %s is %s %s, the plain version's %s %s" % (
                    name, fk, x.dtype, tuple(x.shape), y.dtype,
                    tuple(y.shape)))
            if rel is None or not y.is_floating_point():
                if not torch.equal(x, y):
                    fail("%s: %s differs from the plain version's" % (
                        name, fk))
            else:
                e = max(e, grad_compare("%s %s" % (name, fk), x, y, rel))
    return e


def check_null_factors(dev, errs):
    """The masks' motif-free factors at their shapes (the S = 1 grammar,
    B = 128 x 100 nt): K14 in mode "null" (one launch) against the plain
    _null_batch_factors, every ConstFactors field identical and every
    DiffFactors field within 1e-12 (f64) / 1e-6 (f32) relative; K16 there
    (lambda 1) against hoisted_plain and K17 against its autograd, within
    the same bars.  Returns the line's text; folds the f32 errors into
    ``errs``."""
    reads = main_reads()
    out = []
    for dtype, rel in (("float64", 1e-12), ("float32", 1e-6)):
        cfg = cfg_for(dtype)
        name = "null (masks) %s B=%d" % (dtype, len(reads))
        k = J.kernels(cfg, dev)
        sd = J.stack_seqdata([J.make_seqdata(cfg, s_, q_)
                              for s_, q_ in reads], dev)
        bp0 = J._candidate_pairs(cfg, k, sd)
        K.reset_counts()
        dk, ck = J._null_batch_factors(cfg, k, sd, bp0)
        if K.KERNELS["factors"].launches != 1:
            fail("factors %s: K14 launched %d times (want 1)"
                 % (name, K.KERNELS["factors"].launches))
        dp_, cp_ = J._null_batch_factors(cfg, k, sd, bp0, plain=True)
        same_fields("factors %s constants" % name, ck, cp_, None)
        ef = same_fields("factors %s" % name, dk, dp_, rel)
        st = k.dp_null.st
        rng = np.random.RandomState(14)
        with torch.no_grad():
            want = DP.hoisted_plain(dp_, cp_, st)
        hc = [torch.as_tensor(rng.randn(*want[n_].shape), dtype=k.dtype,
                              device=dev) for n_ in DP.HOISTED]
        hp_, glp = hoisted_run(cfg, dp_, cp_, dp_.lam, hc, True, st)
        K.reset_counts()
        hk, glk = hoisted_run(cfg, dk, ck, dk.lam, hc, False, st)
        if (K.KERNELS["hoisted"].launches,
                K.KERNELS["hoisted_adj"].launches) != (1, 1):
            fail("hoisted %s: K16 and K17 launched %d and %d times (want 1 "
                 "each)" % (name, K.KERNELS["hoisted"].launches,
                            K.KERNELS["hoisted_adj"].launches))
        eh = max(grad_compare("hoisted %s" % name, a, b_, rel)
                 for a, b_ in zip(hk, hp_))
        eg = grad_compare("hoisted_adj %s" % name, glk, glp, rel)
        out.append("%s: K14 %.3g (constants identical), K16 %.3g, K17 %.3g"
                   % (name, ef, eh, eg))
        if dtype == "float32":
            errs["factors"] = max(errs["factors"], ef)
            errs["hoisted"] = max(errs["hoisted"], eh)
            errs["hoisted_adj"] = max(errs["hoisted_adj"], eg)
        torch.cuda.empty_cache()
    return "; ".join(out)


# K15's and K17's bits across batches, places and splits (phase 2): (B,
# the place of its first read in the SPLIT_READS-read batch)
SPLIT_READS = 600
SPLIT_BATCHES = ((1, 3), (7, 11), (128, 200))


def adj_inputs(cfg, reads, dev, seed):
    """K15's and K17's inputs for ``reads``, made on the card from a
    seed (per-read weights, cotangents of K14's factors and of K16's
    tensors): a dict of tensors, each with the read last (or first for
    the weights and codes)."""
    k = J.kernels(cfg, dev)
    st = k.dp.st
    sd, bp = rows_cd_batch(cfg, reads, dev, seed)
    wts = rows_cd_weights(cfg, len(reads), dev, seed + 1)
    _, c = J.batch_factors_pr(cfg, J.Params(*wts), sd, bp, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt, B, Lp = wts[0].dtype, len(reads), cfg.Lp
    rn = lambda *shape: torch.randn(shape, generator=gen, dtype=dt,
                                    device=dev)
    C1, W1, Lp1 = st.dims.Cp + 1, st.dims.Wp + 1, Lp + 1
    Tp = wts[1].shape[1]
    return dict(
        seq=J._card_reads(k, sd)[0], singles=wts[0], pairs=wts[1],
        lam=wts[2].T.contiguous(), C=c.C, misA=c.ep["misA"],
        misB=c.ep["misB"], geR=rn(Lp, st.dims.S, B), geL=rn(Lp, st.dims.S, B),
        gbg2=rn(Lp, B), gpv=rn(Lp1, W1, Tp, B),
        eSZ=rn(2, st.n_cls, C1, C1, B), eSZg=rn(2, 4, C1, C1, B),
        emisA=rn(2, 4, Lp1, W1, B), emisB=rn(2, Lp1 + st.PAD, W1, 4, B))


def adj_slice(x, a, b_):
    """Reads a..b_ of adj_inputs' dict, contiguous (the weights and the
    codes read-first, the rest read-last)."""
    out = {}
    for n_, v in x.items():
        first = n_ in ("seq", "singles", "pairs")
        out[n_] = (v[a:b_] if first else v[..., a:b_]).contiguous()
    return out


def run_adj(cfg, x, hoisted=True, splits=(None, None)):
    """K15 (and with ``hoisted`` K17) on adj_inputs' dict, each on its
    plan or forced to the split in ``splits``: (g_singles, g_pairs[,
    g_lam])."""
    k = J.kernels(cfg, DEVICE)
    st = k.dp.st
    gs, gp = K.factors_adj(st, cfg, "dp", x["seq"], x["singles"],
                           x["pairs"], x["geR"], x["geL"], x["gbg2"],
                           x["gpv"], split=splits[0])
    if not hoisted:
        return [gs, gp]
    consts = types.SimpleNamespace(C=x["C"], ep={"misA": x["misA"],
                                                 "misB": x["misB"]})
    gl = K.hoisted_adj(st, x["lam"], consts, [x[n_] for n_ in DP.HOISTED],
                       split=splits[1])
    return [gs, gp, gl]


def check_adj_splits(dev):
    """K15 and K17 at the main path's shapes ((.....), 100 nt), f32 and
    f64: each read's cotangents bitwise equal in a batch of SPLIT_READS
    and in batches of 1, 7 and 128 reads taken at other places (the plan
    picks another split for each B), in a repeat, and under every split
    the host plan can take, forced (B=128); K15 at 44 dots (S=1,081, 8
    reads) under every split bitwise equal and bitwise the plain
    contraction.  Returns the line's text."""
    rng = np.random.RandomState(21)
    out = []
    for dtype in ("float32", "float64"):
        cfg = cfg_for(dtype)
        st = J.kernels(cfg, dev).dp.st
        x = adj_inputs(cfg, make_reads(rng, SPLIT_READS, 60, LP), dev, 22)
        ref = run_adj(cfg, x)
        again = run_adj(cfg, x)
        if not all(torch.equal(a, b_) for a, b_ in zip(ref, again)):
            fail("K15/K17 %s B=%d: a repeat differs" % (dtype, SPLIT_READS))
        for B, at in SPLIT_BATCHES:
            got = run_adj(cfg, adj_slice(x, at, at + B))
            want = [ref[0][at:at + B], ref[1][at:at + B],
                    ref[2][:, at:at + B]]
            for name, a, b_ in zip(("K15 singles", "K15 pairs", "K17"),
                                   got, want):
                if not torch.equal(a, b_):
                    fail("%s %s: reads %d..%d alone (B=%d) differ from the "
                         "same reads in a batch of %d" % (
                             name, dtype, at, at + B - 1, B, SPLIT_READS))
        x128 = adj_slice(x, 200, 328)
        base = run_adj(cfg, x128)
        fp = K.factors_adj_plan(st.dims.S, cfg.Lp, st.dims.Wp,
                                x["pairs"].shape[1], 128, st.dtype)
        hp = K.hoisted_adj_plan(st.dims.Lp, st.dims.Wp, st.dims.Cp,
                                st.n_cls, 128, st.dtype)
        for kk in fp.splits():
            got = run_adj(cfg, x128, False, (kk, None))
            if not all(torch.equal(a, b_) for a, b_ in zip(got, base)):
                fail("K15 %s: split K=%d differs from the plan's K=%d"
                     % (dtype, kk, fp.K))
        for kk in hp.splits():
            got = run_adj(cfg, x128, True, (None, kk))
            if not torch.equal(got[2], base[2]):
                fail("K17 %s: split K=%d differs from the plan's K=%d"
                     % (dtype, kk, hp.K))
        out.append("%s: K15 splits %s (plan K=%d at B=128), K17 splits %s "
                   "(plan K=%d)" % (dtype, fp.splits(), fp.K, hp.splits(),
                                    hp.K))
        del x, ref, again, x128, base
        torch.cuda.empty_cache()
    try:
        for dtype in ("float32", "float64"):
            cfg = J.ModelConfig(pattern="." * 44, Lp=50, max_span=40,
                                max_iloop=10, min_bpp=0.0, tau=0.1,
                                dtype=dtype)
            reads = make_reads(rng, 8, 40, 50)
            st = J.kernels(cfg, dev).dp.st
            x = adj_inputs(cfg, reads, dev, 23)
            sd, _ = rows_cd_batch(cfg, reads, dev, 23)
            want = plain_contraction(cfg, sd, [x[n_] for n_ in (
                "geR", "geL", "gbg2", "gpv")])
            fp = K.factors_adj_plan(st.dims.S, cfg.Lp, st.dims.Wp,
                                    x["pairs"].shape[1], 8, st.dtype)
            for kk in fp.splits():
                got = run_adj(cfg, x, False, (kk, None))
                if not all(torch.equal(a, b_) for a, b_ in zip(got, want)):
                    fail("K15 44 dots %s: split K=%d differs from the plain "
                         "contraction" % (dtype, kk))
            out.append("44 dots (S=%d) %s: K15 splits %s bitwise the plain "
                       "contraction" % (st.dims.S, dtype, fp.splits()))
            del x, want
    finally:
        J._kernels_cached.cache_clear()
        torch.cuda.empty_cache()
    text = ("check K15/K17 bits (each read's cotangents bitwise equal in "
            "batches of %d and of %s reads at other places, in a repeat and "
            "under every split the host plan takes): %s" % (
                SPLIT_READS, [b_ for b_, _ in SPLIT_BATCHES], "; ".join(out)))
    print(text, flush=True)
    return text


def is_copy_event(name):
    """A memcpy or memset of the profiler's device events (not a kernel)."""
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def glue_profile(fn, reps, exclude):
    """(device ms, kernel launches, memcpy and memset events) per call of
    ``fn``: every CUDA event the profiler sees over ``reps`` calls after a
    warm-up, those whose function is in ``exclude`` left out, the copies
    and fills counted apart from the kernels."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, n, cp = 0.0, 0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                _function_name(e.name) in exclude:
            continue
        if is_copy_event(e.name):
            cp += 1
            continue
        us += e.time_range.end - e.time_range.start
        n += 1
    return us / reps / 1e3, n / reps, cp / reps


GLUE_LIMITS = {"fn+grad": 60, "masks batch": 50, "posterior chunk": 150}
CUB_SORT_SELECT = ("RadixSort", "DeviceSelect", "DeviceCompact")


# tensor calls that read metadata and launch nothing (left unannotated)
NO_KERNEL_CALLS = frozenset((
    "data_ptr", "__get__", "size", "stride", "dim", "is_contiguous",
    "element_size", "numel", "storage_offset", "__len__", "__hash__"))


def _line_mode():
    """A torch function mode that runs every torch call from Python under
    a profiler annotation "@file:line" of the innermost frame of the port
    (or of this script) on the caller's stack: the profiler then names
    the line that launched each of torch's kernels."""
    class LineMode(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in NO_KERNEL_CALLS:
                return func(*args, **(kwargs or {}))
            f = sys._getframe(1)
            while f is not None and not (
                    ("rnaelem_tpu_torch" + os.sep) in f.f_code.co_filename
                    or f.f_code.co_filename.endswith("chip_smoke.py")):
                f = f.f_back
            label = "?" if f is None else "@%s:%d" % (
                os.path.relpath(f.f_code.co_filename, HERE), f.f_lineno)
            with torch.profiler.record_function(label):
                return func(*args, **(kwargs or {}))
    return LineMode()


def _port_line(evt):
    """The port's (or this script's) line that launched the CPU op
    ``evt``: the nearest "@file:line" annotation of _line_mode above it;
    else the innermost Python function of the port above it (its def
    line), else the name of the op at the top of its chain (an autograd
    node)."""
    top, func = evt, None
    while evt is not None:
        if evt.name.startswith("@"):
            return evt.name[1:]
        if func is None and "rnaelem_tpu_torch" + os.sep in evt.name:
            func = evt.name[evt.name.index("rnaelem_tpu_torch"):]
        top, evt = evt, evt.cpu_parent
    return func or top.name


def _aten_op(evt):
    """The outermost aten op of the CPU op chain that holds ``evt``."""
    op = evt.name
    while evt is not None:
        if evt.name.startswith("aten::"):
            op = evt.name
        evt = evt.cpu_parent
    return op


def glue_census(fn, reps, funcs, label):
    """Every kernel that torch (not the port's hand-written kernels)
    launches in a call of ``fn``, named by the aten op and the port's
    source line that launched it (the profiler's CPU parent of each CUDA
    event, with_stack=True, under _line_mode's annotations: the kernels the
    profiler files under each CPU op), over ``reps`` calls after a warm-up; the
    host syncs that torch.cuda.set_sync_debug_mode("warn") reports in one
    call, by line.  Prints both tables and returns (torch kernels per
    call, cub sort/select kernels per call, hand-written per call,
    memcpy/memset per call, {row: per call}, {sync line: count})."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof, _line_mode():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    own = set().union(*funcs.values())
    rows, n, cub, hand, cp = {}, 0, 0, 0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        for kern in e.kernels:
            if is_copy_event(kern.name):
                cp += 1
                continue
            name = _function_name(kern.name)
            if name in own:
                hand += 1
                continue
            n += 1
            if any(s in kern.name for s in CUB_SORT_SELECT):
                cub += 1
            key = (name.replace("at::native::", "")[:48] or kern.name[:48],
                   _aten_op(e), _port_line(e))
            rows[key] = rows.get(key, 0) + 1
    rows = {k_: v / reps for k_, v in sorted(rows.items(),
                                             key=lambda kv: -kv[1])}
    torch.cuda.synchronize()
    syncs = {}

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        # the innermost frame of the port or of this script that led there
        where = "%s:%d" % (os.path.relpath(filename, HERE), lineno)
        for fr in reversed(traceback.extract_stack()[:-1]):
            if ("rnaelem_tpu_torch" + os.sep) in fr.filename or \
                    fr.filename.endswith("chip_smoke.py") and \
                    fr.name not in ("seen", "glue_census"):
                where = "%s:%d" % (os.path.relpath(fr.filename, HERE),
                                   fr.lineno)
                break
        syncs[where] = syncs.get(where, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    print("glue census (torch %s), %s: %g torch kernels per call (%g cub "
          "sort/select), %g hand-written, %g memcpy/memset apart; by "
          "kernel, aten op and the port's line:\n%s\n  host syncs per call "
          "(set_sync_debug_mode warn): %s" % (
              torch.__version__, label, n / reps, cub / reps, hand / reps,
              cp / reps,
              "\n".join("  %6g  %-34s %-28s %s" % (v, *k_)
                        for k_, v in rows.items()),
              json.dumps(syncs)), flush=True)
    return n / reps, cub / reps, hand / reps, cp / reps, rows, syncs


def glue_gate(census):
    """Fail if a path launches a cub sort or select kernel, or more torch
    kernels than GLUE_LIMITS allows."""
    for label, got in census.items():
        if got[1] > 0:
            fail("%s launches %g cub sort/select kernels per call"
                 % (label, got[1]))
        if got[0] > GLUE_LIMITS[label]:
            fail("%s launches %g torch kernels per call (at most %d)"
                 % (label, got[0], GLUE_LIMITS[label]))


def census_paths(dev, funcs, reps=2):
    """glue_census of the three glue-gated paths: fn+grad and a masks
    batch (B_MAIN x LP nt, PATTERN, f32), and one 64-read posterior chunk
    of the 76-tRNA scan (f32).  Returns {label: glue_census's tuple}."""
    cfg32 = cfg_for("float32")
    reads = main_reads()
    p32 = random_params(cfg32, dev)
    batch = OBJ.stack_reads(cfg32, reads, device=dev)
    out = {"fn+grad": glue_census(
        lambda: OBJ.batch_fn_grad(cfg32, p32, batch, device=dev), reps,
        funcs, "fn+grad (B=%d x %d nt %s f32)" % (B_MAIN, LP, PATTERN))}
    out["masks batch"] = glue_census(
        lambda: OBJ.stack_reads(cfg32, reads, device=dev), reps, funcs,
        "masks batch (stack_reads, B=%d)" % B_MAIN)
    cfg, params = MIO.read_model(GOLD_TRNA, Lp=96, dtype="float32",
                                 device=dev)
    scfg, sparams = SCD.scan_config(cfg, params, 96)
    sd = J.stack_seqdata([J.make_seqdata(scfg, seq_to_ints(s), None)
                          for s in trna_seqs(SCD.SCAN_BATCH)], dev)
    out["posterior chunk"] = glue_census(
        lambda: SC.scan_posteriors_batch(scfg, sparams, sd, device=dev),
        reps, funcs, "one %d-read posterior chunk (tRNA, bucket 96, f32)"
        % SCD.SCAN_BATCH)
    return out


# ------------------------------------------------------------ phase 2d

# K18-K21: the passes' ends, the masks' threshold, the scanner's posteriors
GLUE_KERNELS = ("bpp_keep", "parts", "lam_sum", "posteriors")


def _bits(t):
    """A float tensor's bits as integers (NaN and -0.0 compared exactly)."""
    t = t.contiguous()
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def same_bits(name, a, b):
    """Fail unless the kernel's ``a`` is bit for bit the twin's ``b``."""
    if a.shape != b.shape or a.dtype != b.dtype:
        fail("%s: %s %s against the plain twin's %s %s" % (
            name, tuple(a.shape), a.dtype, tuple(b.shape), b.dtype))
    ne = _bits(a) != _bits(b)
    if bool(ne.any()):
        fail("%s: %d of %d values differ from the plain twin's bits" % (
            name, int(ne.sum()), ne.numel()))


def close_twin(name, a, b, rel):
    """Fail unless ``a`` has the twin ``b``'s non-finite values in the
    same places and its finite ones within ``rel`` relative (max norm);
    returns the max abs error."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(
            _bits(torch.where(fa, torch.zeros_like(a), a)),
            _bits(torch.where(fb, torch.zeros_like(b), b))):
        fail("%s: the non-finite values differ from the plain twin's" % name)
    e = rel_err(a[fa], b[fb])
    if not e <= rel:
        fail("%s: relative error %.3g beyond %.0e" % (name, e, rel))
    return float((a[fa].double() - b[fb].double()).abs().max()) \
        if fa.any() else 0.0


def ends_cases(B, dev, dt, seed=11):
    """An Ends of every mode over B reads: the objective in both forms
    with seeded restrict_ari, is_neg, valid (some reads not), lik_sign
    and eff."""
    rng = np.random.RandomState(seed)
    t = lambda x, dtype: torch.as_tensor(x, dtype=dtype, device=dev)
    obj = dict(restrict_ari=t(rng.rand(B) < 0.5, torch.bool),
               lik_sign=t(np.where(rng.rand(B) < 0.5, -1.0, 1.0), dt),
               is_neg=t(rng.rand(B) < 0.3, torch.bool),
               valid=t(rng.rand(B) < 0.9, torch.bool), eff=t(rng.rand(B), dt))
    return (DP.PARTS, DP.Ends("objective", False, **obj),
            DP.Ends("objective", True, **obj), DP.Ends("lse"),
            DP.Ends("null"))


def inf_parts(B, dev, dt, seed=12):
    """Parts [B, 3] with -inf in every pattern of the three (read r < 8:
    bit k of r), finite elsewhere."""
    rng = np.random.RandomState(seed)
    p = rng.randn(B, 3) * 20.0 - 100.0
    for r in range(min(8, B)):
        p[r, [k for k in range(3) if (r >> k) & 1]] = -np.inf
    return torch.as_tensor(p, dtype=dt, device=dev)


def check_parts(st, O, L, parts, rel, what):
    """K19 against its twin (ops/dp.ends_plain, ends_adj_plain,
    extract_parts_plain, seed_parts_plain) in every mode: the gather from
    the inside table O at rows L (bitwise: a copy) when O is given, else
    on the given parts; each mode's outputs and the adjoint (from the
    output's cotangent, the parts', both), its gbar and the seeded O
    rows, within ``rel``.  Returns the max abs error."""
    dev, dt = L.device, st.dtype
    B = L.shape[0]
    rng = np.random.RandomState(3)
    gy = torch.as_tensor(rng.randn(B), dtype=dt, device=dev)
    gp = torch.as_tensor(rng.randn(B, 3), dtype=dt, device=dev)
    R = st.dims.Lp + 1 + st.PAD
    err = 0.0
    for ends in ends_cases(B, dev, dt):
        name = "K19 %s %s" % (ends.mode + ("/lik-ratio" if ends.lik_ratio
                                           else ""), what)
        if O is not None:
            kp, ky, ky2 = K.ends_fwd(st, ends, O=O, L=L)
            pp = DP.extract_parts_plain(O, L, st)
            same_bits(name + " gather", kp, pp)
        else:
            kp, ky, ky2 = K.ends_fwd(st, ends, parts=parts)
            pp = parts
        py, py2 = DP.ends_plain(pp, ends)
        for tag, a, b in (("y", ky, py), ("y2", ky2, py2)):
            if (a is None) != (b is None):
                fail("%s: output %s missing" % (name, tag))
            if b is not None:
                err = max(err, close_twin("%s %s" % (name, tag), a, b, rel))
        cots = ((None, gp),) if ends.mode == "parts" else \
            ((gy, None), (None, gp), (gy, gp))
        for gy_, gp_ in cots:
            gO = torch.zeros((R, st.dims.S, B), dtype=dt, device=dev)
            gO_p = torch.zeros_like(gO)
            gk = K.ends_adj(st, ends, pp, gy_, gp_, gO=gO, L=L, gbar=True)
            gpl = DP.ends_adj_plain(pp, ends, gy_, gp_)
            DP.seed_parts_plain(gO_p, gpl, L, st)
            err = max(err, close_twin(name + " gbar", gk, gpl, rel),
                      close_twin(name + " seeded O", gO, gO_p, rel))
    return err


def check_lam_sum(st, DL, lam, what):
    """K20 bitwise its twin ops/dp.lam_sum_plain, with and without an
    extra term; the first 8 of 16 reads bitwise those 8 alone."""
    B, dev, dt = DL.shape[-1], DL.device, DL.dtype
    extra = torch.as_tensor(np.random.RandomState(4).randn(2, B), dtype=dt,
                            device=dev)
    for ex in (None, extra):
        same_bits("K20 %s%s" % (what, "" if ex is None else " + extra"),
                  K.lam_sum(st, DL, lam, ex),
                  DP.lam_sum_plain(DL, lam, st, ex))
    if B >= 16:
        cut = lambda n: (DL[..., :n].contiguous(), lam[:, :n].contiguous(),
                         extra[:, :n].contiguous())
        same_bits("K20 %s: 8 of 16 reads against the 8 alone" % what,
                  K.lam_sum(st, *cut(16))[:, :8], K.lam_sum(st, *cut(8)))


def check_bpp(cfg, sd, dev, what):
    """K18 bitwise its twins: the candidates against
    energy/tables.pair_mask_jw, the threshold (keep and eff) against
    model/joint.bpp_keep_plain on the motif-free posterior, and without a
    posterior (fix_rss's form, a seeded pair set); the first 8 of 16
    reads bitwise those 8 alone."""
    k = J.kernels(cfg, dev)
    bp0 = J._complementary_bp(cfg, k, sd)
    L = torch.as_tensor(sd.L, device=dev).long()
    same_bits("K18 candidates %s" % what, bp0, ET.pair_mask_jw(
        k.tab, torch.as_tensor(sd.seq, device=dev).long(), L,
        torch.clamp(L, max=cfg.max_span), cfg.Wp, cfg.turn))
    _, post = J._null_posterior(cfg, k, sd, bp0)
    rss = torch.as_tensor(np.random.RandomState(8).rand(*bp0.shape) < 0.1,
                          device=dev)
    for sel, post_, tag in ((bp0, post, ""), (rss, None, " fix_rss form")):
        got = K.bpp_keep(bp0, sel, post_, cfg.min_bpp, k.dtype)
        want = J.bpp_keep_plain(bp0, sel, post_, cfg.min_bpp, k.dtype)
        same_bits("K18 keep %s%s" % (what, tag), got[0], want[0])
        same_bits("K18 eff %s%s" % (what, tag), got[1], want[1])
    B = bp0.shape[0]
    if B >= 16:
        cut = lambda n: K.bpp_keep(bp0[:n].contiguous(), bp0[:n].contiguous(),
                                   post[..., :n].contiguous(), cfg.min_bpp,
                                   k.dtype)
        a, b = cut(16), cut(8)
        same_bits("K18 %s: 8 of 16 reads against the 8 alone" % what,
                  a[0][:8], b[0])
        same_bits("K18 eff %s: 8 of 16 reads" % what, a[1][:8], b[1])
    return bp0, post


def check_posteriors(g, L, what):
    """K21 bitwise its twins (scan/scanner.py pass1_posteriors_plain,
    end_posteriors_plain) on the class sums g [4, Lp, B], and on g on a
    coarse grid (ties for the last-maximum rule); the first 8 of 16 reads
    bitwise those 8 alone."""
    tied = torch.round(g * 4.0) / 4.0
    for gg, tag in ((g, ""), (tied, " tied")):
        for end in (False, True):
            got = K.posteriors(gg, L, end)
            want = SC.end_posteriors_plain(gg, L) if end else \
                SC.pass1_posteriors_plain(gg, L)
            for i, (a, b) in enumerate(zip(got, want)):
                same_bits("K21 %s%s %s output %d" % (
                    what, tag, "end" if end else "pass 1", i), a, b)
    if g.shape[-1] >= 16:
        for end in (False, True):
            a = K.posteriors(tied[..., :16].contiguous(), L[:16], end)
            b = K.posteriors(tied[..., :8].contiguous(), L[:8], end)
            for i, (x, y) in enumerate(zip(a, b)):
                same_bits("K21 %s: 8 of 16 reads, output %d" % (what, i),
                          x[:8], y)


def probe_class_sums(cfg, params, sd, bp_ok, dev):
    """The scanner's pass-1 class-probe cotangent [4, Lp, B] (K21's
    input)."""
    B = len(sd.L)
    cls = DP.zero_probe(cfg.Lp, B, J.kernels(cfg, dev).dtype, dev)
    with torch.enable_grad():
        _, z, _ = J.batch_ends(cfg, params, sd, bp_ok, dev,
                               aux_b={"cls": cls}, ends=DP.Ends("lse"))
        (g,) = torch.autograd.grad(z, cls, torch.ones_like(z))
    return g


def glue_case(cfg, reads, params, dev, what, rel):
    """K18-K21 on one batch of a grammar with rss: the masks (K18), the
    inside pass's O (K19 gather and every mode), the outside pass's
    lambda partials (K20), the scanner's class sums (K21).  Returns
    K19's max abs error."""
    sd = J.stack_seqdata([J.make_seqdata(cfg, s_, q_) for s_, q_ in reads],
                         dev)
    bp0, post = check_bpp(cfg, sd, dev, what)
    bp_ok, _ = J.effective_bp_mask_batch(cfg, sd, dev)
    dp = J.kernels(cfg, dev).dp
    d, c = J.batch_factors(cfg, params, sd, bp_ok, device=dev)
    h = DP.hoisted(d, c, dp.st)
    fs = dp.run_inside(d, c, h)
    B = len(reads)
    err = check_parts(dp.st, fs["O"], c.L, None, rel, what)
    err = max(err, check_parts(dp.st, None, c.L,
                               inf_parts(B, dev, dp.st.dtype), rel,
                               what + " -inf parts"))
    gbar = torch.as_tensor(np.random.RandomState(5).rand(B, 3),
                           dtype=dp.st.dtype, device=dev)
    gs = dp.outside_state(fs, gbar, d, c, h)
    check_lam_sum(dp.st, gs["DL"], gs["lam"], what)
    del fs, gs
    g = probe_class_sums(cfg, params, sd, bp_ok, dev)
    check_posteriors(g, torch.as_tensor(sd.L, device=dev).long(), what)
    return err


def check_glue_kernels(dev):
    """Phase 2d: K18-K21 against their plain twins on the card: K18's
    keep and eff, K20's lambda cotangent and K21's outputs bitwise, K19
    (f64 within 1e-12, f32 within 1e-6 relative, max norm: its gbar and
    seeded O rows likewise); at the main path's shapes (B=128 x 100 nt
    PATTERN, f32 and f64), on the no-rss path (K19 on K8's parts, ..*..),
    on the 64-read tRNA chunk and on the widest grammar of phase 14
    (.....*..... -c 30, f64); K18, K20 and K21 batch-invariant (the first
    8 of 16 reads bitwise those 8 alone).  Returns {kernel: max abs
    error} at the main path's f32."""
    t0 = time.time()
    reads = main_reads()
    rel = {"float32": 1e-6, "float64": 1e-12}
    err = {n: 0.0 for n in GLUE_KERNELS}
    msgs = []
    for dtype in ("float32", "float64"):
        cfg = cfg_for(dtype)
        e = glue_case(cfg, reads, random_params(cfg, dev), dev,
                      "main %s" % dtype, rel[dtype])
        if dtype == "float32":
            err["parts"] = e
        msgs.append("main %s K19 %.3g" % (dtype, e))
        lin, eR, L, _ = chain_inputs(norss_cfg(dtype), reads, dev)
        parts, _ = K.chain_fwd(lin, eR, L)
        e = check_parts(lin, None, L, parts, rel[dtype], "no-rss %s" % dtype)
        msgs.append("no-rss %s K19 %.3g" % (dtype, e))
        torch.cuda.empty_cache()
    cfg, params = MIO.read_model(GOLD_TRNA, Lp=96, dtype="float32",
                                 device=dev)
    scfg, sparams = SCD.scan_config(cfg, params, 96)
    chunk = [(seq_to_ints(s_), None) for s_ in trna_seqs(SCD.SCAN_BATCH)]
    e = glue_case(scfg, chunk, sparams, dev, "tRNA chunk f32", rel["float32"])
    msgs.append("tRNA chunk f32 K19 %.3g" % e)
    wcfg = wide_cfg(WIDE_SAME, 30, "float64", 80)
    wreads = make_reads(np.random.RandomState(9), 16, 60, 80)
    e = glue_case(wcfg, wreads, random_params(wcfg, dev), dev,
                  "%s -c 30 f64" % WIDE_SAME, rel["float64"])
    msgs.append("%s f64 K19 %.3g" % (WIDE_SAME, e))
    torch.cuda.empty_cache()
    print("check K18-K21 vs their plain twins (K18 keep/eff, K20, K21 "
          "bitwise, batch-invariant 8 of 16; K19 f64 1e-12, f32 1e-6 "
          "relative, gather bitwise, every mode, -inf parts, gbar and the "
          "seeded O rows): %s; %.1f s" % ("; ".join(msgs), time.time() - t0),
          flush=True)
    return err


def glue_kernel_times(batch, params, dev, funcs, reps=REPS):
    """K18-K21 at the main path's shapes (B=128 x 100 nt PATTERN f32; K21
    a 64-read chunk of 96 nt): device ms per unit (the profiler, ``reps``
    calls), the plain twins' ms (CUDA events), the bound (over HBM, the
    input values the unit's work reads, once each, as this run's data
    needs them, and its outputs written once; the operations are a few
    per value, far below the f32 peak) and the unit.  Returns
    (ms, plain_ms, {kernel: (bound ms, by)}, {kernel: (unit, launches)})."""
    cfg = cfg_for("float32")
    k = J.kernels(cfg, dev)
    st, dt, sd = k.dp.st, k.dtype, batch.sd
    B, n = len(sd.L), (cfg.Lp + 1) * (cfg.Wp + 1)
    ms, plain, bnd, unit = {}, {}, {}, {}

    def time_it(name, run, run_plain, by, what):
        K.reset_counts()
        run()
        unit[name] = (what, K.KERNELS[name].launches)
        ms[name] = device_ms(run, reps, funcs[name])
        plain[name] = cuda_ms(run_plain, 3)
        bnd[name] = _ms(by, 0)

    # K18: the candidates and the threshold of one masks batch
    bp0 = J._complementary_bp(cfg, k, sd)
    _, post = J._null_posterior(cfg, k, sd, bp0)
    L64 = torch.as_tensor(sd.L, device=dev).long()
    seq64 = torch.as_tensor(sd.seq, device=dev).long()
    W = torch.clamp(L64, max=cfg.max_span)
    time_it("bpp_keep", lambda: (J._complementary_bp(cfg, k, sd), K.bpp_keep(
        bp0, bp0, post, cfg.min_bpp, dt)), lambda: (ET.pair_mask_jw(
            k.tab, seq64, L64, W, cfg.Wp, cfg.turn), J.bpp_keep_plain(
            bp0, bp0, post, cfg.min_bpp, dt)),
        # the codes and lengths (int32: the read's bases), the pair table,
        # the posterior at the candidate cells only, bp0 written and read,
        # keep and eff written
        4 * int(L64.sum()) + 4 * B + _nbytes(k.tab["bp"])
        + int(bp0.sum()) * post.element_size() + 3 * B * n
        + B * post.element_size(),
        "one %d-read masks batch: candidates and threshold" % B)
    # K19: fn+grad's ends, the objective from O and its seeded adjoint
    d, c = J.batch_factors(cfg, params, sd, batch.bp_ok, device=dev)
    fs = k.dp.run_inside(d, c, DP.hoisted(d, c, st))
    ends = OBJ._ends(batch, False)
    O, L = fs["O"], c.L
    parts = K.ends_fwd(st, ends, O=O, L=L)[0]
    gy = torch.ones((B,), dtype=dt, device=dev)
    gO = torch.zeros_like(O)
    gO_p = torch.zeros_like(O)

    def k19_plain():
        pp = DP.extract_parts_plain(O, L, st)
        DP.ends_plain(pp, ends)
        DP.seed_parts_plain(gO_p, DP.ends_adj_plain(pp, ends, gy), L, st)

    time_it("parts", lambda: (K.ends_fwd(st, ends, O=O, L=L), K.ends_adj(
        st, ends, parts, gy, gO=gO, L=L)), k19_plain,
        4 * 3 * B * 4 + B * 8 + 3 * B + 6 * B * 4,
        "one %d-read fn+grad: the objective from O and its seeded adjoint"
        % B)
    del fs
    # K20: one fn+grad's lambda from K5's and K7's partials
    g = torch.Generator(device=dev)
    g.manual_seed(20)
    DL = torch.randn((cfg.Lp + 1, cfg.Wp + 1, st.dims.S, B), generator=g,
                     dtype=dt, device=dev)
    lam, extra = torch.randn((2, 2, B), generator=g, dtype=dt, device=dev)
    time_it("lam_sum", lambda: K.lam_sum(st, DL, lam, extra),
            lambda: DP.lam_sum_plain(DL, lam, st, extra),
            _nbytes(DL, lam, extra, lam), "one %d-read fn+grad's lambda" % B)
    del DL
    # K21: one 64-read chunk's two assemblies (Lp 96)
    Bc, Lc = SCD.SCAN_BATCH, 96
    gc = torch.rand((4, Lc, Bc), generator=g, dtype=dt, device=dev)
    Lb = torch.randint(40, Lc + 1, (Bc,), generator=g, device=dev)
    time_it("posteriors", lambda: (K.posteriors(gc, Lb, False),
                                   K.posteriors(gc, Lb, True)),
            lambda: (SC.pass1_posteriors_plain(gc, Lb),
                     SC.end_posteriors_plain(gc, Lb)),
            # read: rows 0-1 (pass 1) and row 2 (end pass) at p < L, one
            # tail value a read, L in each launch; written: Pys, Pyi, Ys,
            # the int32 pin, Pye, Ye
            gc.element_size() * (3 * int(Lb.sum()) + Bc) + 2 * 8 * Bc
            + gc.element_size() * Bc * (2 * Lc + Lc + 1) + Bc * (8 + 4 + 8),
            "one %d-read posterior chunk of %d nt: pass 1 and the end pass"
            % (Bc, Lc))
    return ms, plain, bnd, unit


def glue_times(dev):
    """--glue-times: the walls this slice's glue moves, one run each, on
    the tree beside this script (an older tree too: a copy of the script
    beside it): fn+grad (CUDA events, 5 calls; host ms to the call's
    return and wall ms to a synchronize, 3 calls; the device's busy share
    of 2 profiled calls), the masks batch, the production steps (.....)
    and ..*.. --no-rss, one 64-read posterior chunk, the 76-tRNA scan
    (f64, f32: the second of two runs); the device memory each of
    fn+grad, the masks batch and the posterior chunk allocates above what
    was allocated before it, at its peak (MiB); K18-K21's ms where the
    tree has them; the glue census.  One {"glue_times": ...} line."""
    funcs = kernel_functions()
    cfg32 = cfg_for("float32")
    reads = main_reads()
    p32 = random_params(cfg32, dev)
    batch = OBJ.stack_reads(cfg32, reads, device=dev)
    fg = lambda: OBJ.batch_fn_grad(cfg32, p32, batch, device=dev)
    out = {"fn_grad_ms": cuda_ms(fg, 5)}
    host, wall = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fg()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    _, _, wall_us, busy_us = device_profile(fg, 2)
    out.update(fn_grad_host_ms=host, fn_grad_wall_ms=wall,
               fn_grad_busy_share=busy_us / wall_us,
               masks_ms=cuda_ms(lambda: OBJ.stack_reads(cfg32, reads,
                                                        device=dev), 3))
    cfg, params = MIO.read_model(GOLD_TRNA, Lp=96, dtype="float32",
                                 device=dev)
    scfg, sparams = SCD.scan_config(cfg, params, 96)
    sd = J.stack_seqdata([J.make_seqdata(scfg, seq_to_ints(s_), None)
                          for s_ in trna_seqs(SCD.SCAN_BATCH)], dev)
    chunk = lambda: SC.scan_posteriors_batch(scfg, sparams, sd, device=dev)
    out["chunk_ms"] = cuda_ms(chunk, 3)

    def peak_mib(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20

    out["peak_mib"] = {
        "fn_grad": peak_mib(fg), "chunk": peak_mib(chunk),
        "masks": peak_mib(lambda: OBJ.stack_reads(cfg32, reads, device=dev))}
    with tempfile.TemporaryDirectory() as tmp:
        for pat, nr in ((PATTERN, False), (NORSS, True)):
            out["step_ms " + pat] = production_step(pat, nr, tmp, dev,
                                                    check=False)["step_ms"]
        fq = os.path.join(tmp, "trna.fq")
        write_fq(fq, trna_seqs())
        for dtype in ("float64", "float32"):
            cfg, params = MIO.read_model(GOLD_TRNA, Lp=96, dtype=dtype,
                                         device=dev)
            sc = SCD.Scanner(cfg, params, dev)
            scan_run(sc, fq, dev, False)
            out["scan_ms " + dtype] = scan_run(sc, fq, dev, False)[1]
    if "parts" in K.KERNELS:
        ms, plain, bnd, unit = glue_kernel_times(batch, p32, dev, funcs)
        out["kernels"] = {n: dict(ms=ms[n], plain_ms=plain[n],
                                  bound_ms=bnd[n][0], unit=unit[n][0],
                                  launches=unit[n][1]) for n in ms}
    out["census"] = {k_: v[0] for k_, v in census_paths(dev, funcs).items()}
    print(json.dumps({"glue_times": out}), flush=True)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts
               if torch.is_tensor(t))


def glue_rows(cfg, params, batch, dev, funcs):
    """Rows C and D at the main path's shapes, as the main path runs them:
    C the factors (model/joint.batch_factors_pr without K1's launch: K14
    and whatever torch glue remains) and their backward into the per-read
    weights (K15), D the hoisted exp-space tensors (ops/dp.hoisted: K16)
    and their backward into lambda (K17).  Each: device ms, kernel
    launches and memcpy/memset events per call (profiler, 20 calls),
    CUDA-event ms, and the bound, the bytes of its inputs and outputs once
    over HBM, of the inputs only what the kernels read (K15's cotangents at
    a read's bases and pairing cells, K17's emisB cotangent without its PAD
    rows)."""
    B = batch.valid.shape[0]
    leaves = J.Params(*[x.detach().clone().requires_grad_(True)
                        for x in J.per_read(params, B)])
    st = J.kernels(cfg, dev).dp.st
    with torch.enable_grad():
        d, c = J.batch_factors_pr(cfg, leaves, batch.sd, batch.bp_ok, dev)
        lam = d.lam.detach().requires_grad_(True)
        h = DP.hoisted(d._replace(lam=lam), c, st)
    outs_c = [d.eR, d.eL, d.bg2, d.pv]
    cot_c = [torch.randn_like(x) for x in outs_c]
    outs_d = [h[k] for k in ("eSZ", "eSZg", "emisA", "emisB")]
    cot_d = [torch.randn_like(x) for x in outs_d]
    weights = _nbytes(*leaves[:2])
    reads_in = _nbytes(batch.sd.seq, batch.sd.ws, batch.sd.L, batch.sd.dots)
    # K14's outputs: the factors, alphaP, the DP's constants and K1's
    # inputs (the codes and lengths int64, the dot counts batch-major)
    made = _nbytes(*outs_c, d.alphaP, c.wsp, c.gate_O2, c.seq, c.C, c.L,
                   c.dots_cum) + _nbytes(c.seq, c.L, c.dots_cum)
    bytes_ = {
        "C": reads_in + weights + made,
        "C backward": factors_adj_bytes(cfg, batch.sd.seq, cot_c)
        + _nbytes(batch.sd.seq) + 2 * weights,
        "D": _nbytes(lam, c.ep["misA"], c.ep["misB"], c.C, *outs_d),
        "D backward": _nbytes(*hoisted_adj_cots(cot_d, st.PAD), lam,
                              c.ep["misA"], c.ep["misB"], c.C)
        + _nbytes(lam)}

    def fwd_c():
        with torch.enable_grad():
            J.batch_factors_pr(cfg, leaves, batch.sd, batch.bp_ok, dev)

    def fwd_d():
        DP.hoisted(d._replace(lam=lam), c, st)

    calls = {
        "C": fwd_c,
        "C backward": lambda: torch.autograd.grad(
            outs_c, list(leaves[:2]), cot_c, retain_graph=True,
            allow_unused=True),
        "D": fwd_d,
        "D backward": lambda: DP.hoisted_lam_term(cot_d, d._replace(lam=lam),
                                                  c, st)}
    out = {}
    for name, fn in calls.items():
        ms, n, cp = glue_profile(fn, 20, funcs["score_tables"])
        out[name] = dict(ms=ms, launches=n, memcpy_memset=cp,
                         event_ms=cuda_ms(fn, 5), bytes=bytes_[name],
                         bound_ms=bytes_[name] / MEM_BPS * 1e3,
                         bound_by="bytes")
    total = sum(v["launches"] for v in out.values())
    print("rows C, D (K14-K17 and the torch glue left, B=%d x %d nt %s f32, "
          "per call: device ms, kernel launches, memcpy/memset events apart; "
          "K1 left out; CUDA-event ms; bound = its inputs and outputs once "
          "over HBM): %s; %g kernel launches per fn+grad for the two rows"
          % (B, LP, PATTERN, json.dumps(out), total), flush=True)
    if total > 8:
        fail("rows C and D launch %g kernels per fn+grad (more than 8)"
             % total)
    return out


def plain_factors(cfg, k, params_b, sd, bp):
    """K14's outputs as the plain version forms them: _diff_factors and
    the constants of _const_factors (without K1)."""
    d = J._diff_factors(cfg, k, params_b, sd)
    seq, L, _, dots_cum = J.score_inputs(cfg, k, sd, bp)
    W = torch.clamp(L, max=cfg.max_span)
    C = torch.clamp(W - 2 - (2 if cfg.turn == 0 else 5),
                    max=cfg.max_iloop).to(torch.int32)
    ws = torch.as_tensor(sd.ws, device=k.device).to(k.dtype)
    return d, (seq.T.contiguous(), C, ws.T.contiguous(),
               dots_cum.T.contiguous())


def rows_cd_times(cfg, params, batch, dev, funcs):
    """K14-K17 at the main path's shapes (B=128 x 100 nt, f32): device ms
    per call (the profiler, REPS calls) of the kernel alone, the plain
    versions' ms (CUDA events) and the bounds (bytes of inputs and outputs
    once over HBM, as glue_rows counts them, against the operations over
    the f32 peak).  Returns
    (ms, plain_ms, bounds, unit) by kernel."""
    k = J.kernels(cfg, dev)
    st = k.dp.st
    B = batch.valid.shape[0]
    reads = J._card_reads(k, batch.sd)
    wts = [x.detach().clone() for x in J.per_read(params, B)]
    out = K.factors(st, cfg, "dp", *reads, singles=wts[0], pairs=wts[1])
    cot = [torch.randn_like(out[n]) for n in ("eR", "eL", "bg2", "pv")]
    d, c = J.batch_factors_pr(cfg, J.Params(*wts), batch.sd, batch.bp_ok,
                              dev)
    lam = wts[2].T
    hk = K.hoisted(st, lam, c)
    hcot = [torch.randn_like(x) for x in hk]
    calls = {
        "factors": lambda: K.factors(st, cfg, "dp", *reads, singles=wts[0],
                                     pairs=wts[1]),
        "factors_adj": lambda: K.factors_adj(st, cfg, "dp", reads[0],
                                             wts[0], wts[1], *cot),
        "hoisted": lambda: K.hoisted(st, lam, c),
        "hoisted_adj": lambda: K.hoisted_adj(st, lam, c, hcot)}
    ms = {n: device_ms(fn, REPS, funcs[n]) for n, fn in calls.items()}
    leaves = [x.clone().requires_grad_(True) for x in wts[:2]]
    with torch.enable_grad():
        dp_, _ = plain_factors(cfg, k, J.Params(*leaves, wts[2]), batch.sd,
                               batch.bp_ok)
        lam_l = lam.detach().clone().requires_grad_(True)
        hp = DP.hoisted_plain(d._replace(lam=lam_l), c, st)
    outs_p = [dp_.eR, dp_.eL, dp_.bg2, dp_.pv]
    outs_h = [hp[n] for n in DP.HOISTED]
    plain = {
        "factors": cuda_ms(lambda: plain_factors(
            cfg, k, J.Params(*wts), batch.sd, batch.bp_ok), 5),
        "factors_adj": cuda_ms(lambda: torch.autograd.grad(
            outs_p, leaves, cot, retain_graph=True), 5),
        "hoisted": cuda_ms(lambda: DP.hoisted_plain(d._replace(lam=lam), c,
                                                    st), 5),
        "hoisted_adj": cuda_ms(lambda: torch.autograd.grad(
            outs_h, [lam_l], hcot, retain_graph=True), 5)}
    Lp, S, W1 = cfg.Lp, st.dims.S, cfg.Wp + 1
    consts = ("alphaP", "seq64", "seqT", "L64", "dcum", "dcumT", "gate", "C",
              "wsp")
    by = {"factors": _nbytes(*reads, *wts[:2], *out.values()),
          "factors_adj": factors_adj_bytes(cfg, reads[0], cot)
          + _nbytes(reads[0]) + 2 * _nbytes(*wts[:2]),
          "hoisted": _nbytes(c.ep["misA"], c.ep["misB"], c.C, lam, *hk),
          "hoisted_adj": _nbytes(*hoisted_adj_cots(hcot, st.PAD),
                                 c.ep["misA"], c.ep["misB"], c.C, lam)
          + _nbytes(lam)}
    # operations: K15 one product and one add per one-hot term (8 per
    # (position, state) of eR and eL, 4 per bg2 position, 6 per pair cell
    # and table); K17 three per term of its sums; K14/K16 one per output
    # value
    ops = {"factors": float(sum(out[n_].numel() for n_ in out
                                if n_ not in consts)),
           "factors_adj": 2.0 * B * (8 * Lp * S + 4 * Lp
                                     + 6 * (Lp + 1) * W1 * wts[1].shape[1]),
           "hoisted": float(sum(x.numel() for x in hk)),
           "hoisted_adj": 3.0 * sum(x.numel() for x in hoisted_adj_cots(
               hcot, st.PAD))}
    bnd = {n: max((by[n] / MEM_BPS * 1e3, "bytes"),
                  (ops[n] / PEAK_F32 * 1e3, "operations")) for n in calls}
    unit = {}
    for n, fn in calls.items():
        K.reset_counts()
        fn()
        unit[n] = ("batch", K.KERNELS[n].launches)
    del out, cot, hk, hcot, outs_p, outs_h
    return ms, plain, bnd, unit


def rows_cd_times_only(dev):
    """K14-K17 and K1 at the main path's shapes alone (--rows-cd-times,
    after phase 1): rows_cd_times' ms, plain ms and bounds, K1's through
    ET.score_tables, the SHA-256 of every K1 and K16 output at the
    seeded main-path batch (f32, f64: output_digests) and of every K14
    output in its three modes at four batches (factors_digests) and,
    where the package has the host plans, K15's and K17's device ms under
    every split the plan can take and K14's under every tile of positions
    (B=128 x 100 nt, f32), as one JSON line.
    Uses only the kernels' common entry points, so a copy of this script
    beside an older tree times that tree's kernels and prints its
    bits."""
    cfg = cfg_for("float32")
    params = random_params(cfg, dev)
    batch, _, _ = batch_factors_for(cfg, main_reads(), dev, params)
    funcs = kernel_functions()
    ms, plain, bnd, unit = rows_cd_times(cfg, params, batch, dev, funcs)
    k = J.kernels(cfg, dev)
    sargs = (k.tab,) + tuple(J.score_inputs(cfg, k, batch.sd,
                                            batch.bp_ok)) + (
        cfg.Wp, cfg.max_span, cfg.turn, cfg.no_ene, cfg.fix_rss)
    K.reset_counts()
    ET.score_tables(*sargs)
    unit["score_tables"] = ("batch", K.KERNELS["score_tables"].launches)
    ms["score_tables"] = device_ms(lambda: ET.score_tables(*sargs), REPS,
                                   funcs["score_tables"])
    plain["score_tables"] = cuda_ms(lambda: ET.score_tables_plain(*sargs), 3)
    by, ops = score_work(cfg, None, k.tab, B_MAIN, 4)
    bnd["score_tables"] = _ms(by, ops)
    out = {"ms": ms, "plain_ms": plain, "bound_ms": bnd, "unit": unit,
           "sha256": output_digests(dev),
           "sha256_factors": factors_digests(dev)}
    if hasattr(K, "hoisted_adj_plan"):
        st = J.kernels(cfg, dev).dp.st
        x = adj_inputs(cfg, main_reads(), dev, 22)
        fp = K.factors_adj_plan(st.dims.S, cfg.Lp, st.dims.Wp,
                                x["pairs"].shape[1], B_MAIN, st.dtype)
        hp = K.hoisted_adj_plan(st.dims.Lp, st.dims.Wp, st.dims.Cp,
                                st.n_cls, B_MAIN, st.dtype)
        split = {"factors_adj": {}, "hoisted_adj": {}}
        for kk in fp.splits():
            split["factors_adj"][kk] = device_ms(
                lambda: run_adj(cfg, x, False, (kk, None)), REPS,
                funcs["factors_adj"])
        for kk in hp.splits():
            consts = types.SimpleNamespace(C=x["C"], ep={
                "misA": x["misA"], "misB": x["misB"]})
            cots = [x[n_] for n_ in DP.HOISTED]
            split["hoisted_adj"][kk] = device_ms(
                lambda: K.hoisted_adj(st, x["lam"], consts, cots, split=kk),
                REPS, funcs["hoisted_adj"])
        out["by_split"] = split
        out["plan_split"] = {"factors_adj": fp.K, "hoisted_adj": hp.K}
    if hasattr(K, "factors_plan"):
        # K14 under each tile of positions factors_plan can take, forced
        k = J.kernels(cfg, dev)
        st, B = k.dp.st, batch.valid.shape[0]
        reads = J._card_reads(k, batch.sd)
        wts = [x.detach().clone() for x in J.per_read(params, B)]
        out["factors_by_tile"] = {}
        for P in K.FAC_TILES:
            plan = K.factors_plan(cfg.Lp, st.dims.Wp, st.dims.S,
                                  wts[1].shape[1], wts[0].shape[1], B,
                                  st.dtype, True, P)
            out["factors_by_tile"][plan.name] = device_ms(
                lambda: K.factors(st, cfg, "dp", *reads, singles=wts[0],
                                  pairs=wts[1], plan=plan), REPS,
                funcs["factors"])
    print(json.dumps({"rows_cd_times": out}), flush=True)


def factors_digests(dev):
    """SHA-256 of every K14 output in modes "dp" ((.....)), "eR" (..*..
    --no-rss) and "null" (the masks pass) at B = 1, 7, 128 and 600 x 100
    nt (seeded reads and per-read weights), f32 and f64, through
    K.factors, so that a copy of this script beside an older tree prints
    that tree's bits."""
    out = {}
    for dtype in ("float32", "float64"):
        for B in EDGE_BATCHES + (B_MAIN,):
            rr = make_reads(np.random.RandomState(60 + B), B, LP - 20, LP)
            for mode in ("dp", "eR", "null"):
                cfg = norss_cfg(dtype) if mode == "eR" else cfg_for(dtype)
                k = J.kernels(cfg, dev)
                sd, _ = rows_cd_batch(cfg, rr, dev, 61)
                reads = J._card_reads(k, sd)
                if mode == "null":
                    got = K.factors(k.dp_null.st, cfg, mode, *reads)
                else:
                    wts = rows_cd_weights(cfg, B, dev, 62)
                    got = K.factors(k.dp.st, cfg, mode, *reads,
                                    singles=wts[0],
                                    pairs=wts[1] if mode == "dp" else None)
                out["%s B=%d %s" % (dtype, B, mode)] = {
                    n_: _digest(t) for n_, t in sorted(got.items())}
    return out


def pointer_chase_ns(dev, steps=200000):
    """The latency of one dependent load on the card, ns: one thread
    following i = next[i] over a single random cycle of 256-byte slots
    (csrc/probe/pointer_chase.cu, built alone with the library's nvcc
    flags; CUDA events over ``steps`` loads after a warm pass) in a 4 MiB
    buffer that L2 holds ("l2_ns") and in a 1 GiB one ("hbm_ns").  None
    where the tree has no probe source (an older tree)."""
    import ctypes
    src = K.CSRC / "probe" / "pointer_chase.cu"
    if not src.exists():
        return None
    root = os.path.join(HERE, "build", "probe")
    os.makedirs(root, exist_ok=True)
    so = os.path.join(root, "pointer_chase.so")
    r = subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", so,
                        str(src)], stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True)
    if r.returncode:
        fail("pointer chase build:\n%s" % r.stdout)
    L = ctypes.CDLL(so)
    L.pointer_chase.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_void_p, ctypes.c_void_p]
    L.pointer_chase.restype = ctypes.c_int
    rng = np.random.RandomState(3)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, nbytes in (("l2_ns", 4 << 20), ("hbm_ns", 1 << 30)):
        stride = 32                       # int64s: 256 bytes a slot
        n = nbytes // (8 * stride)
        perm = rng.permutation(n)
        nxt = np.zeros(n * stride, np.int64)
        nxt[perm * stride] = np.roll(perm, -1) * stride
        t = torch.as_tensor(nxt, device=dev)
        res = torch.zeros(1, dtype=torch.int64, device=dev)
        run = lambda k_: L.pointer_chase(
            ctypes.c_void_p(t.data_ptr()), k_, ctypes.c_void_p(
                res.data_ptr()), ctypes.c_void_p(stream))
        if run(min(n, steps)):
            fail("pointer chase launch failed")
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run(steps)
        b.record()
        torch.cuda.synchronize()
        out[name] = a.elapsed_time(b) * 1e6 / steps
        del t
    torch.cuda.empty_cache()
    return out


def host_walks(cfg, g, state, d, c, st, eps):
    """The host traceback (K13's plain version) of every read of a chunk
    with one stats dict per read: ([(path, struct, cells)], [{"cells":
    walked cells, "cands": candidates up to each choice}])."""
    tabs, fac = CYK.host_inputs(state, d, c, st)
    pins = [(p_.pos.cpu().numpy(), int(p_.bit), int(p_.kinds))
            for p_ in DP.pin_set(c.pin)]
    codes = DP.class_codes(g)
    walks, stats = [], []
    for t in range(fac["L"].shape[0]):
        st_ = {}
        walks.append(CYK.traceback(cfg, g, CYK._Host(
            cfg, g, tabs, fac, t, pins, codes), eps, st_))
        stats.append(st_)
    return walks, stats


def tb_times_only(dev):
    """K13 alone (--tb-times, after phase 1) on the two chunks of the
    76-tRNA scan (64 and 12 reads, bucket 96, the reference's converged
    model, the CYK pin set from the posterior pass) at f64 and f32, under
    each plan of tb_plans: device ms per chunk (the profiler, 20 calls),
    launches, the SHA-256 of psihat, pairs and err, every read held
    against the host traceback; per chunk the host walk's cells and
    candidates per read (max and sum), the bytes/operations bound and the
    dependent-path bound (the longest read's walked cells x one dependent
    load, from pointer_chase_ns).  Uses only K.cyk_traceback's common
    entry (a plan where the tree has them), so a copy of this script
    beside an older tree times that tree's K13 and prints its bits.  One
    JSON line."""
    funcs = kernel_functions()
    lat = pointer_chase_ns(dev)
    out = {"latency_ns": lat, "chunks": []}
    with tempfile.TemporaryDirectory() as tmp:
        reads = trna_reads(tmp)
    chunks = (reads[:SCD.SCAN_BATCH], reads[SCD.SCAN_BATCH:])
    for dtype in ("float64", "float32"):
        cfg, params = MIO.read_model(GOLD_TRNA, Lp=96, dtype=dtype,
                                     device=dev)
        for ci, chunk in enumerate(chunks):
            scfg, d, c = cyk_factors(cfg, params, chunk, dev, False)
            k = J.kernels(scfg, dev)
            mdp = DMB.MaxDP(k.dp)
            state = mdp.tables(d, c)
            eps = CYK.EPS[k.dtype]
            host, stats = host_walks(scfg, k.g, state, d, c, k.dp.st, eps)
            cells = [x.get("cells", 0) for x in stats]
            cands = [x.get("cands", 0) for x in stats]
            L = c.L.cpu().numpy()
            it = torch.finfo(k.dtype).bits // 8
            Lp, W1, B = scfg.Lp, scfg.Wp + 1, len(chunk)
            by = it * 4 * sum(cells) + B * (4 * Lp + (Lp + 1) * W1 + 4)
            rec = {"dtype": dtype, "chunk": ci + 1, "reads": B,
                   "cells_max": max(cells), "cells_sum": sum(cells),
                   "cands_max": max(cands), "cands_sum": sum(cands),
                   "bound_ms": _ms(by, 4.0 * sum(cands)), "plans": {}}
            if lat:
                rec["bound_dep_ms"] = {n_: max(cells) * v * 1e-6
                                       for n_, v in lat.items()}
            for plan in tb_plans(mdp.mst):
                kw = {} if plan is None else {"plan": plan}
                call = lambda: K.cyk_traceback(state, d, c, mdp.mst, eps,
                                               **kw)
                K.reset_counts()
                res = call()
                torch.cuda.synchronize()
                name = "launch" if plan is None else plan.name
                same_as_host(res, host, L, "%s chunk %d (%s)" % (
                    dtype, ci + 1, name))
                rec["plans"][name] = {
                    "launches": K.KERNELS["cyk_traceback"].launches,
                    "sha256": {n_: _digest(x) for n_, x in zip(
                        ("psihat", "pairs", "err"), res)},
                    "ms": device_ms(call, 20, funcs["cyk_traceback"])}
            if hasattr(K, "TB_TRACE"):
                # the walk's counters per read (the shape's plan), and the
                # plan's warps forced to 1, 2 and 8
                tr = torch.zeros((B, len(K.TB_TRACE)), dtype=torch.int64,
                                 device=dev)
                K.cyk_traceback(state, d, c, mdp.mst, eps, trace=tr)
                tr = tr.cpu().numpy()
                rec["trace_sum"] = dict(zip(K.TB_TRACE, tr.sum(0).tolist()))
                rec["trace_max"] = dict(zip(K.TB_TRACE, tr.max(0).tolist()))
                li = K.tb_lists(mdp.mst)[0]
                rec["ms_by_warps"] = {}
                for w_ in (1, 2, 8):
                    plan = K.traceback_plan(scfg.Lp, k.dtype, (li.ni, li.nt),
                                            warps=w_)
                    rec["ms_by_warps"][w_] = device_ms(
                        lambda: K.cyk_traceback(state, d, c, mdp.mst, eps,
                                                plan=plan), 20,
                        funcs["cyk_traceback"])
            out["chunks"].append(rec)
            del state
            torch.cuda.empty_cache()
    print(json.dumps({"tb_times": out}), flush=True)


def _digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest(
    )[:16]


def chain_runs(lin, eR, L, gp, pin):
    """K8 and K9 once, plain and under ``pin`` with the class probe, through
    the kernels' entry points: {name: output} (the pinned read's -inf parts
    get no cotangent)."""
    parts, rows = K.chain_fwd(lin, eR, L)
    out = {"K8 parts": parts, "K8 rows": rows,
           "K9 g_eR": K.chain_adj(lin, eR, L, rows, gp)}
    parts_p, rows_p = K.chain_fwd(lin, eR, L, pin)
    gpp = torch.where(torch.isfinite(parts_p), gp, 0.0)
    cls = torch.empty((4,) + tuple(eR.shape[::2]), dtype=eR.dtype,
                      device=eR.device)
    out.update({"K8 parts pinned": parts_p, "K8 rows pinned": rows_p,
                "K9 g_eR pinned": K.chain_adj(lin, eR, L, rows_p, gpp, pin,
                                              cls),
                "K9 class sums pinned": cls})
    return out, gpp, rows_p


def chain_digests(outs, L):
    """SHA-256 of each output of chain_runs, the chain rows masked past
    each read's length (K8 leaves them unwritten)."""
    Lp1 = outs["K8 rows"].shape[0]
    beyond = (torch.arange(Lp1, device=L.device)[:, None] > L[None, :])
    d = {}
    for name, t in outs.items():
        if " rows" in name:
            t = t.masked_fill(beyond[:, None, :], 0.0)
        d[name] = _digest(t)
    return d


def chain_times_only(dev):
    """K8 and K9 at the main path's shape alone (--chain-times, after
    phase 1): B=128 x 100 nt of ..*.. (S=28) under random weights, f32,
    device ms per call (the profiler over REPS calls), plain and under a
    pin per read with the class probe, each beside its bound and its us
    per step (the reads' 100 steps); the launches per call; and the
    SHA-256 of every output at f32 and f64.  Uses only the kernels'
    entry points (K.chain_fwd, K.chain_adj), so a copy of this script
    beside an older tree times that tree's kernels and prints its bits.
    One JSON line."""
    funcs = kernel_functions()
    out = {"ms": {}, "us_per_step": {}, "bound_ms": {}, "share_of_bound": {},
           "launches_per_call": {}, "sha256": {}}
    reads = main_reads()
    for dtype in ("float32", "float64"):
        cfg = norss_cfg(dtype)
        lin, eR, L, gp = chain_inputs(cfg, reads, dev)
        sd = J.stack_seqdata([J.make_seqdata(cfg, s_, q_) for s_, q_ in reads],
                             dev)
        pin = random_pin(sd, dev)
        Lc = L.clamp(max=LP)
        outs, gpp, rows_p = chain_runs(lin, eR, L, gp, pin)
        out["sha256"][dtype] = chain_digests(outs, Lc)
        if dtype != "float32":
            continue
        rows = outs["K8 rows"]
        cls = torch.empty_like(outs["K9 class sums pinned"])
        calls = {
            "linear_fwd": lambda: K.chain_fwd(lin, eR, L),
            "linear_adj": lambda: K.chain_adj(lin, eR, L, rows, gp),
            "linear_fwd pinned": lambda: K.chain_fwd(lin, eR, L, pin),
            "linear_adj pinned": lambda: K.chain_adj(lin, eR, L, rows_p, gpp,
                                                     pin, cls)}
        steps = int(Lc.max())
        bnd = chain_bounds(lin, Lc.cpu().numpy(), LP, 4)
        for name, call in calls.items():
            kn = name.split()[0]
            K.reset_counts()
            call()
            out["launches_per_call"][name] = K.KERNELS[kn].launches
            ms = device_ms(call, REPS, funcs[kn])
            out["ms"][name] = ms
            out["us_per_step"][name] = ms * 1e3 / steps
            out["bound_ms"][name] = bnd[kn][0]
            out["share_of_bound"][name] = bnd[kn][0] / ms
    out["plain_ms"] = {
        "linear_fwd": cuda_ms(lambda: LIN.chain_plain(lin, eR, L), 3)}
    print(json.dumps({"chain_times": out}), flush=True)


# the build's pieces taken out, to see where a step's time goes (each
# variant a patched copy of csrc, csrc/linear_*.cu as shipped otherwise)
CHAIN_VARIANTS = {
    "shipped": (),
    "probe: K8 walk alone (constant eR, no ring copies)": (
        ("linear_fwd.cu",
         "      const T e = ring[(p & (kChainRing - 1)) * n + cid[k]];",
         "      const T e = (T)0.5;"),
        ("linear_fwd.cu", "        cp_async_t(ring + (next & (kChainRing - 1))"
         " * n + cid[k], src[k]);", "        ;")),
    "probe: K8 without its chain rows' stores": (
        ("linear_fwd.cu", "      *dst[k] = nxt;",
         "      if (nxt == (T)12345) *dst[k] = nxt;"),),
    "probe: K8 without exp and log": (
        ("linear_fwd.cu", "ev[q] = ex(x[q] - m0);", "ev[q] = x[q] - m0;"),
        ("linear_fwd.cu", "any ? m0 + lg(s) + e", "any ? m0 + s * (T)0.01 + e")),
    "probe: K8 without the ring's wait": (
        ("linear_fwd.cu", "    cp_async_wait<kChainRing - 1>();\n", "\n"),),
    "probe: K9 walk alone (constant weights, nothing staged, no class sums)":
        (("linear_adj.cu", "          const T v = ex(os + l.w[q] + ev[q] - "
          "on[q]);", "          const T v = (T)0.5;"),
         ("linear_adj.cu", "          const bool take = os > ninf<T>() && ",
          "          const bool take = true || os > ninf<T>() && "),
         ("linear_adj.cu", "      for (int r = h; r <= top - lo; r += H",
          "      for (int r = h; r < 0; r += H"),
         ("linear_adj.cu", "      for (int r = h; r < top - lo; r += H",
          "      for (int r = h; r < 0; r += H"),
         ("linear_adj.cu", "    if (cls) {\n      __syncthreads();",
          "    if (cls && false) {\n      __syncthreads();")),
    "probe: K9 without its walk": (
        ("linear_adj.cu", "    for (int p = hi - 1; p >= lo && h == 0; --p) {",
         "    for (int p = hi - 1; p >= hi && h == 0; --p) {"),),
    "probe: K9 without the walk's stores": (
        ("linear_adj.cu", "if (live[k]) *gek = gs;",
         "if (gs == (T)12345) *gek = gs;"),),
    "K9 without helpers (the walkers alone)": (
        ("chain.cuh", "static const int kChainAdjThreads = 128;",
         "static const int kChainAdjThreads = 32;"),),
}
# host constants of ops/kernels a variant sets beside its sources
CHAIN_VARIANT_CONSTS = {
    "K9 without helpers (the walkers alone)": {"CHAIN_ADJ_THREADS": 32}}


def chain_variants(dev, variants):
    """K8's and K9's device ms per call and us per step (f32, B=128 x 100
    nt of ..*.., plain and pinned with the class probe) for each plan the
    shape may take (the one-warp block; K9's device variant) and for
    ``variants`` (CHAIN_VARIANTS: source substitutions, each built from a
    patched copy of csrc under build/chain_variants/; the "probe" variants
    take a piece of the work out), with whether the outputs keep the
    shipped bits.  One JSON line per variant and plan."""
    cfg = norss_cfg("float32")
    reads = main_reads()
    lin, eR, L, gp = chain_inputs(cfg, reads, dev)
    sd = J.stack_seqdata([J.make_seqdata(cfg, s_, q_) for s_, q_ in reads],
                         dev)
    pin = random_pin(sd, dev)
    funcs = kernel_functions()
    S, B = lin.dims.S, len(reads)
    steps = int(L.clamp(max=LP).max())
    nnz = int(lin.k["rtr_t"].numel())
    dt = torch.float32
    ref = None
    for name in patched_builds({n_: v for n_, v in variants.items()},
                               os.path.join(HERE, "build", "chain_variants")):
        consts = CHAIN_VARIANT_CONSTS.get(name, {})
        saved = {a: getattr(K, a) for a in consts}
        for a, v in consts.items():
            setattr(K, a, v)
        K.chain_plan.cache_clear()
        t0 = time.time()
        K.lib()
        build_s = round(time.time() - t0, 1)
        for dev_var in (None, "device"):
            fp = {a: K.chain_plan("linear_fwd", S, LP, B, dt, a, 0)
                  for a in (False, True)}
            ap = {a: K.chain_plan("linear_adj", S, LP, B, dt, a, nnz,
                                  variant=dev_var) for a in (False, True)}
            parts, rows = K.chain_fwd(lin, eR, L, plan=fp[False])
            parts_p, rows_p = K.chain_fwd(lin, eR, L, pin, plan=fp[True])
            gpp = torch.where(torch.isfinite(parts_p), gp, 0.0)
            cls = torch.empty((4, LP, B), dtype=dt, device=dev)
            calls = {
                "linear_fwd": lambda: K.chain_fwd(lin, eR, L,
                                                  plan=fp[False]),
                "linear_adj": lambda: K.chain_adj(lin, eR, L, rows, gp,
                                                  plan=ap[False]),
                "linear_fwd pinned": lambda: K.chain_fwd(
                    lin, eR, L, pin, plan=fp[True]),
                "linear_adj pinned": lambda: K.chain_adj(
                    lin, eR, L, rows_p, gpp, pin, cls, plan=ap[True])}
            got = [parts, rows, calls["linear_adj"](), parts_p,
                   calls["linear_adj pinned"](), cls]
            beyond = (torch.arange(LP + 1, device=dev)[:, None]
                      > L.clamp(max=LP)[None, :])[:, None, :]
            got[1] = got[1].masked_fill(beyond, 0.0)
            if ref is None:
                ref = got
            rec = {"variant": name, "build_s": build_s,
                   "block": "one read a block (%d threads)" % fp[
                       False].threads,
                   "plans": [fp[True].name, ap[False].name,
                             ap[True].name],
                   "K9 threads": ap[False].threads,
                   "same_bits": all(torch.equal(a, b)
                                    for a, b in zip(got, ref))}
            rec["ms"] = {n_: device_ms(c_, REPS, funcs[n_.split()[0]])
                         for n_, c_ in calls.items()}
            rec["us_per_step"] = {n_: v * 1e3 / steps
                                  for n_, v in rec["ms"].items()}
            print(json.dumps(rec), flush=True)
        for a, v in saved.items():
            setattr(K, a, v)
        K.chain_plan.cache_clear()
    print("card: %s" % card_line(), flush=True)


# ------------------------------------------------------------ row N

def free_port():
    """A free TCP port on localhost (the one-rank NCCL group's store)."""
    import socket
    with socket.socket() as so:
        so.bind(("localhost", 0))
        return so.getsockname()[1]


def per_read_arrays(f, grads, eff):
    """{name: host array} of per-read outputs (f, the Params leaves,
    eff)."""
    out = dict(zip(J.Params._fields, grads), f=f, eff=eff)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def bit_diff(a, b):
    """Names of the arrays of ``b`` that ``a`` does not hold bit for bit,
    each with the largest difference and the first read that differs."""
    out = {}
    for k in b:
        if a[k].shape != b[k].shape or a[k].tobytes() != b[k].tobytes():
            d = np.abs(a[k].astype(np.float64) - b[k]).reshape(
                len(b[k]), -1).max(axis=1) if a[k].shape == b[k].shape \
                else np.array([np.inf])
            out[k] = (float(d.max()), int(np.flatnonzero(d)[0])
                      if d.any() else -1)
    return out


def run_ranks(cmds, log_dir, timeout):
    """Start one subprocess per command, wait for all; kill every rank and
    fail as soon as one exits non-zero (its peers would wait in a
    collective), or at the timeout."""
    logs = [open(os.path.join(log_dir, "rank%d.log" % r), "w+")
            for r in range(len(cmds))]
    procs = [subprocess.Popen(c, stdout=lg, stderr=subprocess.STDOUT)
             for c, lg in zip(cmds, logs)]
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.time() > deadline:
                r = bad[0] if bad else 0
                logs[r].seek(0)
                fail("rank %d of %s %s:\n%s" % (
                    r, os.path.basename(log_dir), "failed (exit %s)"
                    % procs[r].returncode if bad else "timed out",
                    logs[r].read()[-3000:]))
            time.sleep(0.5)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                logs[r].seek(0)
                fail("rank %d of %s failed (exit %d):\n%s" % (
                    r, os.path.basename(log_dir), p.returncode,
                    logs[r].read()[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lg in logs:
            lg.close()


def mesh_n1(cfg, reads, params, dev):
    """N1: a one-rank NCCL group (TCP on localhost) runs the sharded
    per-read step (make_sharded_per_read) on the flagship batch: bitwise
    equal to batch_fn_grad_pr on the same batch, its sharded masks equal
    to stack_reads', and the gather timed (CUDA events) beside its bound,
    the bytes it moves over HBM."""
    g = MESH.init_group("localhost:%d" % free_port(), 1, 0, device=dev)
    try:
        if g.backend != "nccl":
            fail("N1: backend %s, expected nccl" % g.backend)
        rows = OBJ.host_rows(cfg, reads)
        step = MESH.make_sharded_per_read(cfg, g)
        K.reset_counts()
        got = per_read_arrays(*step(params, rows))
        torch.cuda.synchronize()
        launches = {n: kk.launches for n, kk in K.KERNELS.items()
                    if kk.launches}
        batch = OBJ.stack_reads(cfg, reads, device=dev)
        out = OBJ.batch_fn_grad_pr(cfg, params, batch, device=dev)
        ref = per_read_arrays(*out)
        bad = bit_diff(got, ref)
        if bad:
            fail("N1: the one-rank group's per-read outputs differ from "
                 "batch_fn_grad_pr (max diff, first read): %s"
                 % json.dumps(bad))
        keep, me = MESH.make_sharded_bp_masks(cfg, g)(cfg, rows.sds)
        if not (torch.equal(keep, batch.bp_ok) and
                torch.equal(me, batch.eff)):
            fail("N1: make_sharded_bp_masks differs from stack_reads' masks")
        cols = [out[0], *out[1], out[2]]
        gather_ms = cuda_ms(lambda: MESH.gather_rows(g, cols), 20)
        nbytes = sum(c.numel() * c.element_size() for c in cols)
        bound = 2 * nbytes / MEM_BPS * 1e3   # read once, written once
        step_ms = cuda_ms(lambda: step(params, rows), 2)
        plain_ms = cuda_ms(lambda: OBJ.batch_fn_grad_pr(
            cfg, params, OBJ.stack_reads(cfg, reads, device=dev),
            device=dev), 2)
    finally:
        g.close()
    print("N1 (row N, one NCCL rank, TCP store on localhost, B=%d x %d nt %s "
          "f32): per-read f, gradients and eff bitwise equal to "
          "batch_fn_grad_pr; sharded masks equal to stack_reads'; the gather "
          "(one all_gather_into_tensor of %d bytes) %.4f ms (CUDA events, 20 "
          "calls; bound %.5f ms, its bytes over HBM); the group's step (host "
          "rows -> shard masks -> fn+grad -> gather) %.1f ms vs stack_reads + "
          "batch_fn_grad_pr %.1f ms; launches per step %s" % (
              B_MAIN, LP, PATTERN, nbytes, gather_ms, bound, step_ms,
              plain_ms, json.dumps(launches)), flush=True)
    return dict(ref=ref, gather_ms=gather_ms, gather_bytes=nbytes,
                bound_ms=bound, step_ms=step_ms, plain_step_ms=plain_ms,
                launches=launches)


def mesh_worker(args):
    """One rank of N2/N3 (a subprocess of this script): the sharded
    per-read step on the flagship batch (rank 0 saves the gathered
    outputs), then the production step on the group (Trainer, Adam, 64
    reads + 64 negatives, 1 warm-up + STEPS steps) with a stage breakdown;
    rank 0 writes the model's text."""
    devs = args.mesh_devices.split(",")
    rank = args.mesh_worker
    g = MESH.init_group("file://" + os.path.join(args.mesh_out, "store"),
                        len(devs), rank, device=devs[rank],
                        backend=args.mesh_backend)
    try:
        cfg32 = cfg_for("float32")
        p32 = random_params(cfg32, g.device)
        got = per_read_arrays(*MESH.make_sharded_per_read(cfg32, g)(
            p32, OBJ.host_rows(cfg32, main_reads())))
        if rank == 0:
            np.savez(os.path.join(args.mesh_out, "per_read.npz"), **got)
        cfg, tr = step_trainer(PATTERN, False, args.mesh_fq, None, group=g)
        rec, starts = {}, []
        timed = stage_timer(rec)
        saved = {n: getattr(OBJ, n) for n in (
            "device_batch", "batch_fn_grad_pr", "reduce_per_read")}
        gather = MESH.gather_rows
        objective = tr._objective

        def step_objective(x, it):
            starts.append(time.perf_counter())
            return objective(x, it)

        tr._objective = step_objective
        for n, key in (("device_batch", "shard_masks"),
                       ("batch_fn_grad_pr", "fn_grad"),
                       ("reduce_per_read", "reduce")):
            setattr(OBJ, n, timed(key, saved[n]))
        MESH.gather_rows = timed("gather", gather)
        try:
            K.reset_counts()
            tr.train()
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        finally:
            for n, f in saved.items():
                setattr(OBJ, n, f)
            MESH.gather_rows = gather
        mean = lambda k: 1e3 * float(np.mean(rec[k][1:]))
        res = dict(rank=rank, device=str(g.device), backend=g.backend,
                   step_ms=1e3 * float(np.mean(np.diff(starts + [t_end])[1:])),
                   shard_masks_ms=mean("shard_masks"),
                   fn_grad_ms=mean("fn_grad"), gather_ms=mean("gather"),
                   reduce_ms=mean("reduce"),
                   launches={n: kk.launches for n, kk in K.KERNELS.items()
                             if kk.launches})
        with open(os.path.join(args.mesh_out, "rank%d.json" % rank),
                  "w") as f:
            json.dump(res, f)
        if rank == 0:
            with open(os.path.join(args.mesh_out, "model.txt"), "w") as f:
                MIO.write_model(f, cfg, tr.params)
    finally:
        g.close()


def mesh_ranks(tmp, name, devices, backend, n1, step):
    """N2/N3: the ranks of ``devices`` as subprocesses of this script;
    their gathered per-read outputs bitwise equal to one rank's, their
    model byte-identical to the one-rank Trainer's after the same steps.
    Returns the ranks' stage breakdowns."""
    out_dir = os.path.join(tmp, name)
    os.makedirs(out_dir)
    t0 = time.time()
    run_ranks([[sys.executable, os.path.abspath(__file__),
                "--mesh-worker", str(r), "--mesh-devices", ",".join(devices),
                "--mesh-backend", backend, "--mesh-fq", step["fq"],
                "--mesh-out", out_dir] for r in range(len(devices))],
              out_dir, 600)
    wall = time.time() - t0
    got = dict(np.load(os.path.join(out_dir, "per_read.npz")))
    bad = bit_diff(got, n1["ref"])
    if bad:
        fail("%s: the ranks' per-read outputs differ from one rank's (max "
             "diff, first read): %s" % (name, json.dumps(bad)))
    with open(os.path.join(out_dir, "model.txt")) as f:
        model = f.read()
    if model != step["model"]:
        fail("%s: the %d-step model differs from the one-rank Trainer's"
             % (name, STEPS))
    ranks = []
    for r in range(len(devices)):
        with open(os.path.join(out_dir, "rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    print("%s (%d ranks, %s, devices %s; %.1f s with the ranks' start-up): "
          "per-read f, gradients and eff of B=%d x %d nt bitwise equal to one "
          "rank's; the production step's model after 1 + %d steps "
          "byte-identical to the one-rank Trainer's; per rank, ms per step "
          "(mean of %d after the warm-up): %s" % (
              name, len(devices), backend, ",".join(devices), wall, B_MAIN,
              LP, STEPS, STEPS, json.dumps([{k: (round(v, 3) if
                                                 isinstance(v, float) else v)
                                             for k, v in rk.items()}
                                            for rk in ranks])), flush=True)
    return dict(wall_s=wall, ranks=ranks)


def launch_on_second_card(cfg, reads, params):
    """N3's launch check: batch_fn_grad_pr on cuda:1 from a process whose
    current device is 0 gives cuda:0's bits and leaves device 0
    current."""
    torch.cuda.set_device(0)
    outs = []
    for d in ("cuda:0", "cuda:1"):
        p = J.Params(*[x.to(d) for x in params])
        outs.append(per_read_arrays(*OBJ.batch_fn_grad_pr(
            cfg, p, OBJ.stack_reads(cfg, reads, device=d), device=d)))
        if torch.cuda.current_device() != 0:
            fail("N3: a launch on %s changed the current device" % d)
    bad = bit_diff(outs[1], outs[0])
    if bad:
        fail("N3: batch_fn_grad_pr on cuda:1 differs from cuda:0: %s"
             % json.dumps(bad))


def array_eval_check(tmp, dev):
    """The file-array evaluation: ArrayEvaluator with 2 local array-eval
    slaves of the port's CLI on the card (f64, the 76 tRNAs, the
    reference's converged model) against eval_file of the snapshot the
    master wrote, within 1e-9 relative."""
    fq = os.path.join(tmp, "trna.fq")
    Lp = CLI._round_up(CLI._fq_maxlen(fq))
    cfg, params = MIO.read_model(GOLD_TRNA, Lp=Lp, dtype="float64",
                                 device=dev)
    env = dict(os.environ, PYTHONPATH=HERE)
    ev = AJ.ArrayEvaluator(cfg, 2, os.path.join(tmp, "arr"), fq,
                           submit=lambda argv, n: AJ.submit_local(
                               argv, n, env), device=dev)
    t0 = time.time()
    fn, gr, eff = ev(params)
    wall = time.time() - t0
    cfg_rt, p_rt = MIO.read_model(ev.tmp, Lp=Lp, dtype="float64", device=dev)
    fr, grr, er = OBJ.eval_file(cfg_rt, p_rt, fq, device=dev)
    errs = dict(fn=abs(fn - fr) / abs(fr), eff=abs(eff - er) / abs(er),
                gr=float(np.abs(gr - grr).max() / np.abs(grr).max()))
    print("array evaluation (2 local array-eval slaves on the card, 76 "
          "tRNAs, f64, the reference's converged model): fn %.12f, sum eff "
          "%.6f; relative error vs eval_file of the snapshot %s (<= 1e-9); "
          "%.1f s wall per evaluation (the slaves' start-up included)"
          % (fn, eff, json.dumps(errs), wall), flush=True)
    if not max(errs.values()) <= 1e-9:
        fail("array evaluation differs from eval_file: %s"
             % json.dumps(errs))
    return dict(wall_s=wall, errs=errs)


# One change each to the launch constants of the fused K3/K6 blocks
# (csrc/ep_col.cuh, csrc/outside_ep.cu): (file, shipped text, variant)
EP_VARIANTS = {
    "shipped": (),
    "K6 256 threads": (
        ("outside_ep.cu", "kEpAdjThreads = 512", "kEpAdjThreads = 256"),),
    "K6 1 block per SM": (
        ("outside_ep.cu", "__launch_bounds__(kEpAdjThreads, 2)",
         "__launch_bounds__(kEpAdjThreads, 1)"),),
    "K6 1024 threads": (
        ("outside_ep.cu", "kEpAdjThreads = 512", "kEpAdjThreads = 1024"),
        ("outside_ep.cu", "__launch_bounds__(kEpAdjThreads, 2)",
         "__launch_bounds__(kEpAdjThreads, 1)")),
    "K3 512 threads": (
        ("ep_col.cuh", "kEpThreads = 256", "kEpThreads = 512"),),
    "1 range of x": (("ep_col.cuh", "kEpXSplit = 4", "kEpXSplit = 1"),),
    "8 ranges of x": (("ep_col.cuh", "kEpXSplit = 4", "kEpXSplit = 8"),),
    "K11 512 threads": (
        ("inside_ep.cu", "kEpMaxThreads = 256", "kEpMaxThreads = 512"),),
    "K11 128 threads": (
        ("inside_ep.cu", "kEpMaxThreads = 256", "kEpMaxThreads = 128"),),
    "K11 at least 4 ranges of x": (
        ("inside_ep.cu", "kEpMaxMinSplit = 1", "kEpMaxMinSplit = 4"),),
    "K11 ranges for two waves": (
        ("inside_ep.cu", "per_sm * device_sms() / D.B",
         "2 * per_sm * device_sms() / D.B"),),
}


# K11 with one piece of its step taken out, or another block shape: times
# only (without a piece the tables are wrong), to find where a step's time
# goes
EP_PROBES = {
    "shipped": (),
    "K11 without T/W": (
        ("inside_ep.cu", "    ep_max_tw(k, x, ix, tl,",
         "    if (0) ep_max_tw(k, x, ix, tl,"),),
    "K11 without V": (
        ("inside_ep.cu", "    ep_max_v(k, x);", "    if (0) ep_max_v(k, x);"),),
    "K11 without out": (
        ("inside_ep.cu", "    ep_max_out(k, x, ix, ol,",
         "    if (0) ep_max_out(k, x, ix, ol,"),),
    "K11 without the merge": (
        ("inside_ep.cu",
         "  if (!last) return;\n  for (int i = threadIdx.x; i < W1 * S;",
         "  if (last || !last) return;\n  for (int i = threadIdx.x; "
         "i < W1 * S;"),),
    "K11 without the steps": (
        ("inside_ep.cu",
         "  for (int x = x0; x <= x1; ++x) {\n    const int q = (x - x0) & 1;",
         "  for (int x = x0; x < x0; ++x) {\n    const int q = (x - x0) & 1;"),),
    "K11 512 threads": (
        ("inside_ep.cu", "kEpMaxThreads = 256", "kEpMaxThreads = 512"),),
    "K11 512 threads, 2 blocks per SM by registers": (
        ("inside_ep.cu", "kEpMaxThreads = 256", "kEpMaxThreads = 512"),
        ("inside_ep.cu", "__launch_bounds__(kEpMaxThreads)",
         "__launch_bounds__(kEpMaxThreads, 2)")),
    "K11 4 blocks per SM by registers": (
        ("inside_ep.cu", "__launch_bounds__(kEpMaxThreads)",
         "__launch_bounds__(kEpMaxThreads, 4)"),),
}


def ep_probes(dev):
    """K11's device ms per column J0 on the tRNA scan's chunks (f64 B=64
    and B=12, f32 B=64) for EP_PROBES, each built from a patched copy of
    csrc under build/ep_probes/, and the shipped ep_max_kernel's ptxas
    lines.  One JSON line per probe."""
    with tempfile.TemporaryDirectory() as tmp:
        trna = trna_reads(tmp)
    funcs = kernel_functions()
    _, log = K.build(("-Xptxas", "-v"))
    sec = log.split("== inside_ep.cu")[-1].split("== ")[0].splitlines()
    keep = [i for i, ln in enumerate(sec)
            if "ep_max_kernel" in ln or "warning" in ln]
    print("ptxas, inside_ep.cu ep_max_kernel (shipped):\n" + "\n".join(
        sec[i] for j in keep for i in range(j, min(j + 3, len(sec)))),
        flush=True)
    for name in patched_builds(EP_PROBES,
                               os.path.join(HERE, "build", "ep_probes")):
        t0 = time.time()
        K.lib()
        rec = {"probe": name, "build_s": round(time.time() - t0, 1)}
        for key, dtype, rd in (("K11_f64_B64", "float64", trna[:64]),
                               ("K11_f64_B12", "float64", trna[64:]),
                               ("K11_f32_B64", "float32", trna[:64])):
            rec[key] = cyk_column_ms(rd, dev, funcs, dtype)["inside_ep_max"]
        print(json.dumps(rec), flush=True)
    print("card: %s" % card_line(), flush=True)


# K15's first form of its one-hot terms (the compare), patched into the
# shipped factors.cu by --onehot-repro
ONEHOT_COMPARE = {"K15 with the compare form": ((
    "factors.cu",
    """          const T* oh = oh4[clampi(code, 0, 4)];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            o[k] = oh[k] * vr;
            o[4 + k] = oh[k] * vl;
          }""",
    """          const int base = clampi(code - 1, 0, 3);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const T e = k == base ? (T)1 : (T)0;
            o[k] = e * vr;
            o[4 + k] = e * vl;
          }"""),)}


def _function_lines(text, marker, start, keep):
    """The lines of the function whose header holds ``marker`` (a PTX
    .entry or a SASS "Function :" line) that match the regex ``keep``."""
    out, on = [], False
    for ln in text.splitlines():
        if start in ln:
            on = marker in ln
            continue
        if on and re.search(keep, ln):
            out.append(" ".join(re.sub(r"/\* 0x[0-9a-f]+ \*/", "",
                                       ln).split()))
    return out


def onehot_repro(dev):
    """The one-hot select of K15's first form, (k == clampi(code - 1, 0,
    3) ? 1 : 0) x g, alone (csrc/repro/onehot_select.cu, built with the
    library's nvcc flags and again with ptxas's optimisation off): for
    codes 0..4 the terms of each base that differ from the exact ones
    (flat kernels, the compare and the table form, f64 and f32) and each
    base's reads whose sum differs from read_sum's (K15's state warp with
    the compare form); the PTX and SASS lines of the flat compare
    kernel's select (f64); then K15 itself with the compare form patched
    in, each base's largest error against the plain contraction; the
    shipped library's functions whose SASS takes a predicate out of a
    VIMNMX.  One JSON line each; it checks nothing."""
    import ctypes
    nvcc = K._nvcc()
    src = K.CSRC / "repro" / "onehot_select.cu"
    root = os.path.join(HERE, "build", "onehot_repro")
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(5)
    n, B, Lp = 4096, 64, 40
    code = torch.as_tensor(rng.randint(0, 5, n).astype(np.int32),
                           device=dev)
    lens = rng.randint(Lp // 2, Lp + 1, B)
    seq = rng.randint(1, 5, (B, Lp)).astype(np.int32)
    seq[np.arange(Lp)[None, :] >= lens[:, None]] = 0
    seq = torch.as_tensor(seq, device=dev)
    oh_seq = torch.nn.functional.one_hot(
        torch.clamp(seq.long() - 1, 0, 3), 4).permute(1, 0, 2)  # [Lp, B, 4]
    p_ = lambda t: ctypes.c_void_p(t.data_ptr())
    ver = subprocess.run([nvcc, "--version"], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True).stdout
    print("nvcc: %s" % " / ".join(ver.strip().splitlines()[-2:]), flush=True)
    for tag, extra in (("-O3", ()), ("-O3, ptxas -O0", ("-Xptxas", "-O0"))):
        so = os.path.join(root, "repro_%d.so" % len(extra))
        cmd = [nvcc, *K.NVCC_FLAGS, *extra, "-I", str(K.CSRC), "-shared",
               "-o", so, str(src)]
        r = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        if r.returncode:
            fail("onehot repro build %s:\n%s" % (tag, r.stdout))
        L = ctypes.CDLL(so)
        rec = {"build": tag, "codes": [int((code == v).sum())
                                       for v in range(5)]}
        for dt, suf in ((torch.float64, "f64"), (torch.float32, "f32")):
            g = torch.as_tensor(rng.randn(n), dtype=dt, device=dev)
            want = torch.nn.functional.one_hot(
                torch.clamp(code.long() - 1, 0, 3), 4).to(dt) * g[:, None]
            for kind in ("cmp", "tab"):
                out = torch.full((n, 4), float("nan"), dtype=dt, device=dev)
                rc = getattr(L, "repro_flat_%s_%s" % (kind, suf))(
                    p_(code), p_(g), p_(out), ctypes.c_int(n))
                torch.cuda.synchronize()
                rec["flat_%s_%s terms wrong by base" % (kind, suf)] = (
                    (out != want).sum(0).tolist() if rc == 0 else rc)
            gR = torch.as_tensor(rng.randn(Lp, B), dtype=dt, device=dev)
            gL = torch.as_tensor(rng.randn(Lp, B), dtype=dt, device=dev)
            out = torch.full((8, B), float("nan"), dtype=dt, device=dev)
            rc = getattr(L, "repro_walk_cmp_%s" % suf)(
                p_(seq), p_(gR), p_(gL), p_(out), ctypes.c_int(Lp),
                ctypes.c_int(B))
            torch.cuda.synchronize()
            valid = (seq > 0).T
            zero = torch.zeros((), dtype=dt, device=dev)
            want = torch.cat([DP.read_sum(oh_seq.to(dt) * torch.where(
                valid, x, zero)[:, :, None], 1).T for x in (gR, gL)])
            rec["walk_cmp_%s reads wrong by base (eR, eL)" % suf] = (
                (out != want).sum(1).tolist() if rc == 0 else rc)
            rec["walk_cmp_%s max abs err" % suf] = float(
                (out - want).abs().max())
        print(json.dumps(rec), flush=True)
        if extra:
            continue
        ptx = os.path.join(root, "repro.ptx")
        cubin = os.path.join(root, "repro.cubin")
        for flag, path in (("-ptx", ptx), ("-cubin", cubin)):
            r = subprocess.run([nvcc, *K.NVCC_FLAGS, "-I", str(K.CSRC), flag,
                                "-o", path, str(src)],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            if r.returncode:
                fail("onehot repro %s:\n%s" % (flag, r.stdout))
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
             cubin], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True).stdout
        with open(ptx) as f:
            ptx_text = f.read()
        print("PTX of onehot_flat_cmp<double> (compare, select, min/max, "
              "mul):\n  " + "\n  ".join(_function_lines(
                  ptx_text, "onehot_flat_cmpIdE", ".entry",
                  r"setp|selp|min|max|mul\.f64|add\.s32")), flush=True)
        print("SASS of onehot_flat_cmp<double> (-O3):\n  " + "\n  ".join(
            _function_lines(sass, "onehot_flat_cmpIdE", "Function :",
                            r"^\s*/\*[0-9a-f]{4}\*/")), flush=True)
    shipped_flags = K.NVCC_FLAGS
    for tag, extra in (("-O3", ()), ("-O3, ptxas -O0", ("-Xptxas", "-O0"))):
        K.NVCC_FLAGS = shipped_flags + extra
        try:
            for _ in patched_builds(ONEHOT_COMPARE, os.path.join(
                    root, "k15_%d" % len(extra))):
                rec = {"K15 with the compare form": tag}
                for dtype, nr in (("float64", 16), ("float32", 64)):
                    cfg = cfg_for(dtype)
                    reads = make_reads(np.random.RandomState(0), nr, 80,
                                       LP)
                    sd, bp = rows_cd_batch(cfg, reads, dev, 3)
                    w = rows_cd_weights(cfg, nr, dev, 4)
                    outs, _, _ = factors_run(cfg, sd, bp, w, None, True)
                    cots = [torch.randn_like(o) for o in outs]
                    _, _, g = factors_run(cfg, sd, bp, w, cots, False)
                    want, _ = plain_contraction(cfg, sd, cots)
                    rec[dtype + " g_singles max abs err by base"] = (
                        (g[0] - want).abs().amax((0, 1)).tolist())
                print(json.dumps(rec), flush=True)
        except Exception as e:  # a build refused at -O0: say so, go on
            print(json.dumps({"K15 with the compare form": tag,
                              "error": str(e)[-2000:]}), flush=True)
        finally:
            K.NVCC_FLAGS = shipped_flags
    # where else ptxas reads a predicate out of a VIMNMX in the shipped
    # library (the pattern of the wrong select above)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         str(K.build()[0])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True).stdout
    hits, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
        elif re.search(r"VIMNMX\S*\s+R\d+,\s*P[0-6]\b", ln):
            hits[fn] = hits.get(fn, 0) + 1
    print(json.dumps({"shipped library: VIMNMX with a predicate output, "
                      "by function": hits, "functions": sum(
                          "Function :" in ln for ln in sass.splitlines())}),
          flush=True)
    print("card: %s" % card_line(), flush=True)


EXT_VARIANTS = {
    "shipped": (),
    "16 width slices": (
        ("inside_ext.cu", "kExtSlices = 32", "kExtSlices = 16"),),
    "64 width slices": (
        ("inside_ext.cu", "kExtSlices = 32", "kExtSlices = 64"),),
    "16 bytes of reads per block at most": (
        ("inside_ext.cu", "kExtGroupBytes = 32", "kExtGroupBytes = 16"),),
    "64 bytes of reads per block at most": (
        ("inside_ext.cu", "kExtGroupBytes = 32", "kExtGroupBytes = 64"),),
    "1 width per load batch": (("inside_ext.cu", "kExtW = 2", "kExtW = 1"),),
    "4 splits per load batch": (
        ("inside_ext.cu", "kExtOps = 2", "kExtOps = 4"),),
}


# K7's launch constants (csrc/outside_ext.cu), one change each, and a
# probe: the state's lists read from device memory at each use (not
# staged in shared memory), the parent's dependent index loads
ADJ_VARIANTS = {
    "shipped": (),
    "2 list entries per load batch": (
        ("outside_ext.cu", "kAdjOps = 1", "kAdjOps = 2"),),
    "no register bound at f32": (
        ("outside_ext.cu", "kAdjMinBlocks = 4", "kAdjMinBlocks = 1"),),
    "16 bytes of reads per block at most": (
        ("outside_ext.cu", "kAdjGroupBytes = 32", "kAdjGroupBytes = 16"),),
    "64 width slices, 16 bytes of reads": (
        ("outside_ext.cu", "kAdjSlices = 32", "kAdjSlices = 64"),
        ("outside_ext.cu", "kAdjGroupBytes = 32", "kAdjGroupBytes = 16")),
    "lists not staged": (
        ("outside_ext.cu",
         "  for (int i = threadIdx.x; i < ro.stride; i += blockDim.x)\n"
         "    li[i] = lx.idx[(long long)s * ro.stride + i];",
         "  li = const_cast<int*>(lx.idx) + (long long)s * ro.stride;"),),
}


BAND_VARIANTS = {
    "shipped": (),
    "band_bif 1 thread per cell": (
        ("inside_band.cu", "kBifHalves = 2", "kBifHalves = 1"),),
    "band_bif 4 threads per cell": (
        ("inside_band.cu", "kBifHalves = 2", "kBifHalves = 4"),),
    "band_bif (sum DP) chunks of 16 dk": (
        ("inside_band.cu", "static const int n = 8;",
         "static const int n = 16;"),),
    "band_bif (sum DP) chunks of 32 dk": (
        ("inside_band.cu", "static const int n = 8;",
         "static const int n = 32;"),),
    "bif_adj chunks of 16": (
        ("outside_band.cu", "kBifChunk = 8", "kBifChunk = 16"),),
    "bif_adj 8 warps": (("outside_band.cu", "kBifWarps = 4", "kBifWarps = 8"),),
}


def patched_builds(variants, root):
    """For each variant (name, substitutions (file, old, new) in csrc),
    point ops/kernels at a patched copy of csrc under ``root`` (its own
    kernel build) and yield the name; the shipped sources are restored
    after each."""
    shipped_src, shipped_split = K.CSRC, K.EP_XSPLIT
    for i, (name, subs) in enumerate(variants.items()):
        src = os.path.join(root, "v%d" % i, "csrc")
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(shipped_src, src)
        split = shipped_split
        for fname, a, b in subs:
            path = os.path.join(src, fname)
            with open(path) as f:
                text = f.read()
            if a not in text:
                fail("variant %r: %r not in %s" % (name, a, fname))
            with open(path, "w") as f:
                f.write(text.replace(a, b))
            m = re.match(r"kEpXSplit = (\d+)", b)
            split = int(m.group(1)) if m else split
        K.CSRC, K.EP_XSPLIT, K._lib = Path(src), split, None
        try:
            yield name
        finally:
            K.CSRC, K.EP_XSPLIT, K._lib = shipped_src, shipped_split, None


K1_VARIANTS = {
    "shipped": ((), {}),
    "3 diagonals a block": ((), {"SCORE_DIAGONALS": (3, 1)}),
    "a sector of reads a block (8 f32, 4 f64)": ((), {"SCORE_ROW_BYTES": 32}),
    "half a line of reads a block": ((), {"SCORE_ROW_BYTES": 64}),
    "4 blocks an SM (64 registers)": ((
        ("score_tables.cu", "__launch_bounds__(kScoreThreads, 5) score_tables",
         "__launch_bounds__(kScoreThreads) score_tables"),), {}),
    "write-back stores": ((
        ("score_tables.cu", "  __stcs(p, v);", "  *p = v;"),
        ("score_tables.cu", "  __stcs(reinterpret_cast<unsigned char*>(p), "
         "static_cast<unsigned char>(v));", "  *p = v;")), {}),
    # probes: other bits, what a piece of the work costs
    "probe: staging only": ((
        ("score_tables.cu", "  if (b >= B) return;",
         "  if (b >= 0) return;"),), {}),
    "probe: no table gathers": ((
        ("score_tables.cu", "    return tab[off[id] + k];",
         "    return (T)(k & 7);"),), {}),
    "probe: hp and okP..okB stored, the rest computed": (tuple(
        ("score_tables.cu", "    put(%s_o + idx, %s);" % (o_, v_),
         "    if (%s == 12345) put(%s_o + idx, %s);" % (v_, o_, v_))
        for o_, v_ in (("stk", "stk"), ("ext", "ext"), ("ml2", "ml2"),
                       ("mlE", "mlE"), ("tout", "t_out"), ("tin", "t_in")))
        + (("score_tables.cu", "      put(misA_o + k * plane + idx, misA[k]);"
            "\n      put(misB_o + k * plane + idx, misB[k]);",
            "      if (misA[k] == misB[k] + 12345) {\n"
            "      put(misA_o + k * plane + idx, misA[k]);\n"
            "      put(misB_o + k * plane + idx, misB[k]); }"),
           ("score_tables.cu",
            "    for (int k = 0; k < 6; ++k) put(spec_o + k * plane + idx, "
            "spec[k]);",
            "    for (int k = 0; k < 6; ++k) if (spec[k] == 12345) "
            "put(spec_o + k * plane + idx, spec[k]);")), {}),
    "probe: stores of constant codes and tables": ((
        ("score_tables.cu", "    return tab[off[id] + k];",
         "    return (T)1;"),
        ("score_tables.cu", "    return seq[(idx - lo) * G];",
         "    return 1 + (idx & 1);"),
        ), {}),
}


def k1_variants(dev, variants):
    """K1's device ms per 128-read batch (f32, B=128 x 100 nt) and whether
    its outputs keep the shipped bits, for the shipped kernel and for
    ``variants`` (K1_VARIANTS: source substitutions, each built from a
    patched copy of csrc under build/k1_variants/, and host plan
    constants of ops/kernels); the "probe" variants take a piece of the
    work out.  One JSON line per variant."""
    cfg = cfg_for("float32")
    k = J.kernels(cfg, dev)
    sd, bp = rows_cd_batch(cfg, main_reads(), dev, 11)
    sargs = (k.tab,) + tuple(J.score_inputs(cfg, k, sd, bp)) + (
        cfg.Wp, cfg.max_span, cfg.turn, cfg.no_ene, cfg.fix_rss)
    funcs = kernel_functions()
    ref = None
    variants = {n_: v or ((), {}) for n_, v in variants.items()}
    subs = {n_: v[0] for n_, v in variants.items()}
    consts = {n_: v[1] for n_, v in variants.items()}
    for name in patched_builds(subs, os.path.join(HERE, "build",
                                                  "k1_variants")):
        saved = {a: getattr(K, a) for a in consts[name]}
        for a, v in consts[name].items():
            setattr(K, a, v)
        K.score_plan.cache_clear()
        try:
            t0 = time.time()
            K.lib()
            rec = {"variant": name, "build_s": round(time.time() - t0, 1),
                   "plan": K.score_plan(cfg.Lp, cfg.Wp, B_MAIN,
                                        torch.float32)._asdict()}
            out = ET.score_tables(*sargs)
            if ref is None:
                ref = out
            rec["same_bits"] = all(torch.equal(out[n_], ref[n_])
                                   for n_ in ET.SCORE_KEYS)
            rec["ms"] = [device_ms(lambda: ET.score_tables(*sargs), REPS,
                                   funcs["score_tables"]) for _ in range(2)]
            print(json.dumps(rec), flush=True)
        finally:
            for a, v in saved.items():
                setattr(K, a, v)
            K.score_plan.cache_clear()
    print("card: %s" % card_line(), flush=True)


def band_variants(dev, variants):
    """K2's and K5's device ms per column J0 (f32 at B=128 and B=33, f64
    at B=64: the main path, a batch that is no multiple of the reads per
    M-chain block, a scan chunk; S=29) and the masks' ms per 128-read
    batch (f32, CUDA events), for the shipped kernels and for
    BAND_VARIANTS, each built from a patched copy of csrc under
    build/band_variants/.  One JSON line per variant: the numbers behind
    the launch constants of csrc/mchain.cuh, band_bif and bif_adj."""
    cfg32, cfg64 = cfg_for("float32"), cfg_for("float64")
    reads = main_reads()
    p32, p64 = random_params(cfg32, dev), random_params(cfg64, dev)
    sd = J.stack_seqdata([J.make_seqdata(cfg32, s, q) for s, q in reads],
                         dev)
    funcs = kernel_functions()
    for name in patched_builds(variants,
                               os.path.join(HERE, "build", "band_variants")):
        t0 = time.time()
        K.lib()
        rec = {"variant": name, "build_s": round(time.time() - t0, 1)}
        for key, cfg, rd, p in (("f32_B128", cfg32, reads, p32),
                                ("f32_B33", cfg32, reads[:33], p32),
                                ("f64_B64", cfg64, reads[:64], p64)):
            out = band_column_ms(cfg, rd, p, dev, funcs, J0)
            rec[key] = {n: v[0] for n, v in out.items()}
        rec["masks_ms"] = cuda_ms(
            lambda: J.effective_bp_mask_batch(cfg32, sd, dev), 3)
        print(json.dumps(rec), flush=True)
    print("card: %s" % card_line(), flush=True)


def ep_variants(dev, variants):
    """K3's and K6's device ms per column J0 (f32 at B=128 and B=33, f64
    at B=64: the main path, one block per SM, a scan chunk; S=29), K11's
    (the CYK tables of the tRNA scan's chunks: f64 at B=64 and B=12, f32
    at B=64) and the masks' ms per 128-read batch (f32, CUDA events), for
    the shipped kernels and for ``variants`` (EP_VARIANTS), each built from
    a patched copy of csrc under build/ep_variants/ (its own kernel
    build).  One JSON line per variant: the numbers behind the launch
    constants of ep_col.cuh and of K11's blocks."""
    cfg32, cfg64 = cfg_for("float32"), cfg_for("float64")
    reads = main_reads()
    p32, p64 = random_params(cfg32, dev), random_params(cfg64, dev)
    sd = J.stack_seqdata([J.make_seqdata(cfg32, s, q) for s, q in reads],
                         dev)
    with tempfile.TemporaryDirectory() as tmp:
        trna = trna_reads(tmp)
    funcs = kernel_functions()
    for name in patched_builds(variants,
                               os.path.join(HERE, "build", "ep_variants")):
        t0 = time.time()
        K.lib()
        rec = {"variant": name, "build_s": round(time.time() - t0, 1)}
        for key, cfg, rd, p in (("f32_B128", cfg32, reads, p32),
                                ("f32_B33", cfg32, reads[:33], p32),
                                ("f64_B64", cfg64, reads[:64], p64)):
            out = ep_column_ms(cfg, rd, p, dev, funcs, J0)
            rec[key] = {n: v[0] for n, v in out.items()}
        for key, dtype, rd in (("K11_f64_B64", "float64", trna[:64]),
                               ("K11_f64_B12", "float64", trna[64:]),
                               ("K11_f32_B64", "float32", trna[:64])):
            rec[key] = cyk_column_ms(rd, dev, funcs, dtype)["inside_ep_max"]
        rec["masks_ms"] = cuda_ms(
            lambda: J.effective_bp_mask_batch(cfg32, sd, dev), 3)
        print(json.dumps(rec), flush=True)
    print("card: %s" % card_line(), flush=True)


def ext_variants(dev, variants):
    """K4's device ms per column J0 (f32 B=128: the main path's S=29 and
    the masks' S=1; f64 B=64, S=29) and K12's (the CYK tables of the tRNA
    scan's chunks, f64 B=64 and B=12, f32 B=64), and the masks' ms per
    128-read batch (f32, CUDA events), for the shipped kernels and for
    ``variants`` (EXT_VARIANTS), each built from a patched copy of csrc
    under build/ext_variants/; the shipped build's registers and spills
    of ext_col_kernel (nvcc -Xptxas -v).  One JSON line per variant: the
    numbers behind the launch constants of inside_ext.cu."""
    cfg32, cfg64 = cfg_for("float32"), cfg_for("float64")
    reads = main_reads()
    p32, p64 = random_params(cfg32, dev), random_params(cfg64, dev)
    sd = J.stack_seqdata([J.make_seqdata(cfg32, s, q) for s, q in reads],
                         dev)
    with tempfile.TemporaryDirectory() as tmp:
        trna = trna_reads(tmp)
    funcs = kernel_functions()
    _, log = K.build(("-Xptxas", "-v"))
    print_ptxas(log, "inside_ext.cu")
    for name in patched_builds(variants,
                               os.path.join(HERE, "build", "ext_variants")):
        t0 = time.time()
        K.lib()
        rec = {"variant": name, "build_s": round(time.time() - t0, 1)}
        rec["K4_f32_B128"] = ext_column_ms(cfg32, reads, p32, dev, funcs, J0)
        rec["K4_f32_B128_S1"] = ext_column_ms(cfg32, reads, p32, dev, funcs,
                                              J0, null=True)
        rec["K4_f64_B64"] = ext_column_ms(cfg64, reads[:64], p64, dev, funcs,
                                          J0)
        for key, dtype, rd in (("K12_f64_B64", "float64", trna[:64]),
                               ("K12_f64_B12", "float64", trna[64:]),
                               ("K12_f32_B64", "float32", trna[:64])):
            rec[key] = cyk_column_ms(rd, dev, funcs, dtype)["inside_ext_max"]
        rec["masks_ms"] = cuda_ms(
            lambda: J.effective_bp_mask_batch(cfg32, sd, dev), 3)
        print(json.dumps(rec), flush=True)
    print("card: %s" % card_line(), flush=True)


def print_ptxas(log, src):
    """The registers and spills nvcc -Xptxas -v gave the kernels of one
    source."""
    sec = log.split("== " + src)[-1].split("== ")[0]
    print("ptxas, %s (shipped):\n" % src + "\n".join(
        ln for ln in sec.splitlines() if "Function properties" in ln
        or "registers" in ln or "spill" in ln or "Compiling entry" in ln),
        flush=True)


def ext_adj_variants(dev, variants):
    """K7's device ms per column J0 (f32 B=128: the main path's S=29 and
    the masks' S=1; f64 B=64, S=29) and the masks' ms per 128-read batch
    (f32, CUDA events), for the shipped kernel and for ``variants``
    (ADJ_VARIANTS), each built from a patched copy of csrc under
    build/adj_variants/; the shipped build's registers and spills of
    ext_adj_kernel.  One JSON line per variant: the numbers behind the
    launch constants of outside_ext.cu."""
    cfg32, cfg64 = cfg_for("float32"), cfg_for("float64")
    reads = main_reads()
    p32, p64 = random_params(cfg32, dev), random_params(cfg64, dev)
    sd = J.stack_seqdata([J.make_seqdata(cfg32, s, q) for s, q in reads],
                         dev)
    funcs = kernel_functions()
    print_ptxas(K.build(("-Xptxas", "-v"))[1], "outside_ext.cu")
    for name in patched_builds(variants,
                               os.path.join(HERE, "build", "adj_variants")):
        t0 = time.time()
        K.lib()
        rec = {"variant": name, "build_s": round(time.time() - t0, 1)}
        sec = K.build(("-Xptxas", "-v"))[1].split("== outside_ext.cu")[-1]
        rec["ptxas"] = re.findall(r"Used (\d+) registers|(\d+) bytes spill "
                                  r"stores", sec.split("== ")[0])
        rec["K7_f32_B128"] = ext_adj_column_ms(cfg32, reads, p32, dev, funcs,
                                               J0)
        rec["K7_f32_B128_S1"] = ext_adj_column_ms(cfg32, reads, p32, dev,
                                                  funcs, J0, null=True)
        rec["K7_f64_B64"] = ext_adj_column_ms(cfg64, reads[:64], p64, dev,
                                              funcs, J0)
        rec["masks_ms"] = cuda_ms(
            lambda: J.effective_bp_mask_batch(cfg32, sd, dev), 3)
        print(json.dumps(rec), flush=True)
    print("card: %s" % card_line(), flush=True)


def launch_cost(dev, rounds=5, reps=3):
    """fn+grad of the evaluation path's batch (f32) under three launch
    wrappers, interleaved over rounds in this one process: "none" launches
    on the current stream with no device switch (the wrapper of PR 6),
    "always" enters torch.cuda.device on every launch, "checked" is
    ops/kernels._call (a switch only when the tensors' device is not the
    current one); and "torch_sums", the wrapper of PR 6 with the glue's
    per-read sums (ops/dp.read_sum, the batch-invariance repair of PR 7)
    replaced by torch's own sum, the parent's reductions.  Per call: host
    ms until batch_fn_grad returns, wall ms to a synchronize, CUDA-event
    ms; means and minima over rounds x reps."""
    import ctypes

    def wrapper(mode):
        def call(kernel, fname, like, *args):
            L = K.lib()
            fn = getattr(L, "rnaelem_%s_%s" % (fname, K._SUF[like.dtype]))
            if mode == "none":
                rc = fn(*args, ctypes.c_void_p(
                    torch.cuda.current_stream().cuda_stream))
            else:
                with torch.cuda.device(like.device):
                    rc = fn(*args, ctypes.c_void_p(
                        torch.cuda.current_stream(like.device).cuda_stream))
            if rc != 0:
                fail("launch_cost: kernel %s failed (%d)" % (fname, rc))
            K.KERNELS[kernel].launches += 1
        return call

    cfg = cfg_for("float32")
    params = random_params(cfg, dev)
    batch = OBJ.stack_reads(cfg, main_reads(), device=dev)
    K.reset_counts()
    shipped, read_sum = K._call, DP.read_sum
    torch_sum = lambda x, ndims: x.sum(dim=tuple(range(ndims)))
    modes = {"none": wrapper("none"), "always": wrapper("always"),
             "checked": shipped, "torch_sums": wrapper("none")}
    rec = {m: dict(host_ms=[], wall_ms=[], event_ms=[]) for m in modes}
    out = {}
    try:
        for r in range(rounds + 1):
            for m, call in modes.items():
                K._call = call
                DP.read_sum = torch_sum if m == "torch_sums" else read_sum
                for _ in range(reps):
                    torch.cuda.synchronize()
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    t0 = time.perf_counter()
                    s.record()
                    f, g, _ = OBJ.batch_fn_grad(cfg, params, batch,
                                                device=dev)
                    t1 = time.perf_counter()
                    e.record()
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    out[m] = (f, g)
                    if r:   # round 0 warms each wrapper up
                        rec[m]["host_ms"].append((t1 - t0) * 1e3)
                        rec[m]["wall_ms"].append((t2 - t0) * 1e3)
                        rec[m]["event_ms"].append(s.elapsed_time(e))
    finally:
        K._call, DP.read_sum = shipped, read_sum
    for m in ("none", "always"):
        if not (torch.equal(out[m][0], out["checked"][0]) and all(
                torch.equal(a, b) for a, b in zip(out[m][1],
                                                  out["checked"][1]))):
            fail("launch_cost: wrapper %s changed fn+grad" % m)
    if rel_err(out["torch_sums"][0], out["checked"][0]) > 1e-5:
        fail("launch_cost: torch's sums changed fn")
    res = {m: {k: dict(mean=float(np.mean(v)), min=float(np.min(v)))
               for k, v in rv.items()} for m, rv in rec.items()}
    print(json.dumps({"launch_cost": res, "launches_per_fn_grad": sum(
        kk.launches for kk in K.KERNELS.values()) // (
            len(modes) * (rounds + 1) * reps), "card": card_line()}),
        flush=True)


# ------------------------------------------------------------ phase 15: elem

# test_pipeline_planted.py's hairpin: a GC stem around a UUCGA loop (17 nt)
PLANT_STEM, PLANT_LOOP, PLANT_STEM_RC = "GGCAGC", "UUCGA", "GCUGCC"
# 15b's patterns with the state count each names: the planted shape, its
# unstructured decoy, and four lines of tests/fixtures/pattern_list, the
# last its widest grammar
ELEM_PATTERNS = (("(.....)", 29), (".....", 28), ("((.....)).", 38),
                 ("..(.....).", 45), ("((...*..))", 40), (".....*.....", 91))
ELEM_READS, ELEM_LEN = 256, 100   # 15b's positives (and as many negatives)
# 15b's settings: the flagship -w 50 (-c 30, the CLI's default), batches
# of 64 reads, 20 Adam steps a task; 2 folds, the best 2 refined
ELEM_TRAIN = ["-w", "50", "-b", "64", "-i", "20"]
ELEM_ARGS = ELEM_TRAIN + ["-k", "2", "-N", "2"]
# every kernel of a training step or a scan (K8/K9 run only with --no-rss)
ELEM_KERNELS = DP_KERNELS + ROWS_CD_KERNELS + CYK_KERNELS
ELEM_SAME = ("train/pattern-1/train.model", "train/pattern-1/train.raw",
             "test/pattern-1/positive.raw", "test/pattern-1/negative.raw")


def random_seq(rng, n):
    return "".join("ACGU"[c] for c in rng.randint(0, 4, n))


def planted_hairpins(rng, n):
    """test_pipeline_planted.py's set: the hairpin between random flanks
    of 4-8 nt."""
    seqs = []
    for _ in range(n):
        pre = random_seq(rng, rng.randint(4, 9))
        suf = random_seq(rng, rng.randint(4, 9))
        seqs.append(pre + PLANT_STEM + PLANT_LOOP + PLANT_STEM_RC + suf)
    return seqs


def flagship_hairpins(rng, n, length):
    """n reads of ``length`` nt: the hairpin at a random offset between
    random flanks."""
    hp = PLANT_STEM + PLANT_LOOP + PLANT_STEM_RC
    seqs = []
    for _ in range(n):
        o = rng.randint(0, length - len(hp) + 1)
        seqs.append(random_seq(rng, o) + hp
                    + random_seq(rng, length - len(hp) - o))
    return seqs


def write_fa(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">p%d\n%s\n" % (i, s))
    return path


def rss_mb():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") >> 20


class ElemRecorder:
    """Wraps elem's task runners and run_init while a phase runs: each
    CLI call's wall on the host clock between two device synchronizes,
    the kernel launches it made, device memory and host RSS after it."""

    def __init__(self, root):
        self.root, self.calls = root, []
        self.init_s = self.snapshot = None

    def _record(self, run, args, log, mode):
        before = {n: k.launches for n, k in K.KERNELS.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(args, log)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        args = [str(a) for a in args]
        out1 = args[args.index("--out1") + 1]
        self.calls.append({
            "mode": mode, "what": "scan" if args[0] == "scan" else "train",
            "out": os.path.relpath(out1, self.root), "s": s,
            "launches": {n: k.launches - before[n]
                         for n, k in K.KERNELS.items()
                         if k.launches > before[n]},
            "cuda_mb": torch.cuda.memory_allocated() / 2 ** 20,
            "rss_mb": rss_mb()})
        c = self.calls[-1]
        print("elem task %s %s %s: %.3f s, cuda_mb %.1f, rss_mb %d" % (
            mode, c["what"], c["out"], s, c["cuda_mb"], c["rss_mb"]),
            flush=True)

    def __enter__(self):
        self.saved = (ELEM._run_inproc, ELEM._run_cli, ELEM.run_init)
        inproc, sub, init = self.saved

        def run_init(*a, **kw):
            t0 = time.perf_counter()
            init(*a, **kw)
            self.init_s = time.perf_counter() - t0
            out = a[3] if len(a) > 3 else kw["outdir"]
            self.snapshot = out + ".init"
            shutil.copytree(out, self.snapshot)

        ELEM._run_inproc = lambda a, log: self._record(inproc, a, log, "in")
        ELEM._run_cli = lambda a, log: self._record(sub, a, log, "sub")
        ELEM.run_init = run_init
        return self

    def __exit__(self, *exc):
        ELEM._run_inproc, ELEM._run_cli, ELEM.run_init = self.saved


def elem_main(argv):
    """elem's entry point; its progress lines go to this stderr."""
    t0 = time.perf_counter()
    ELEM.main([str(a) for a in argv])
    return time.perf_counter() - t0


def read_cv(out):
    """{pattern index: [AUC of each fold]} from elem's cv table."""
    aucs = {}
    for line in open(os.path.join(out, "cv")):
        k, pi, llik, auc = line.split("\t")
        if not np.isfinite(float(llik)):
            fail("elem: cv-%s pattern %s: llik %s" % (k, pi, llik))
        aucs.setdefault(int(pi), []).append(float(auc))
    return aucs


def selected(out):
    """Pattern indices in select.txt's order."""
    return [int(re.search(r"pattern-(\d+)/", ln).group(1))
            for ln in open(os.path.join(out, "select.txt")) if ln.strip()]


def check_raw(path, n, what):
    """A scan record file of n well-formed records, every exist prob in
    [0, 1], the start and inner lines as long as the read, end one
    longer, none of them NaN."""
    with open(path) as f:
        recs = parse_raw(f.read())
    if len(recs) != n:
        fail("elem %s: %d records in %s, want %d" % (what, len(recs), path,
                                                     n))
    keys = {"id", "start", "end", "inner", "psihat", "motif region",
            "exist prob", "seq", "rss", "mot"}
    for r in recs:
        p = float(r.get("exist prob", "nan"))
        if set(r) != keys or not 0.0 <= p <= 1.0:
            fail("elem %s: bad record %s in %s" % (what, r.get("id"), path))
        for key, extra in (("start", 0), ("end", 1), ("inner", 0)):
            v = vec(r[key])
            if len(v) != len(r["seq"]) + extra or np.isnan(v).any():
                fail("elem %s: %s of %s in %s" % (what, key, r["id"], path))
    return recs


def check_model(path, pattern, what):
    text = open(path).read()
    if not text.startswith("pattern: %s\n" % pattern):
        fail("elem %s: %s is not a model of %s" % (what, path, pattern))
    for line in text.splitlines()[1:]:
        val = line.partition(":")[2]
        if re.search(r"nan|inf", val, re.I):
            fail("elem %s: %s has %s" % (what, path, line[:60]))


def elem_planted(root):
    """15a: test_pipeline_planted.py's set and bar through the port's elem
    on the card: `(.....)` against `.....`, init, train -i 12 -b 8 -w 24,
    select -N 1; pattern 1 first, its held-out AUC above 0.9 on both
    folds."""
    pos = write_fa(os.path.join(root, "planted.fa"),
                   planted_hairpins(np.random.RandomState(11), 24))
    plist = os.path.join(root, "planted_list")
    with open(plist, "w") as f:
        f.write("(.....)\n.....\n")
    out = os.path.join(root, "planted")
    t0 = time.perf_counter()
    elem_main(["init", "-p", pos, "-m", plist, "-o", out])
    elem_main(["train", "-M", out, "-i", "12", "-b", "8", "-w", "24",
               "--device", DEVICE, "--in-process"])
    elem_main(["select", "-M", out, "-N", "1"])
    aucs, sel = read_cv(out), selected(out)
    rec = {"s": time.perf_counter() - t0, "select": sel,
           "auc": {str(k): v for k, v in aucs.items()}}
    print("elem 15a (test_pipeline_planted's contract on the card): %s"
          % json.dumps(rec), flush=True)
    if sel[:1] != [1]:
        fail("elem 15a: the planted motif is not selected first: %s" % sel)
    if not min(aucs[1]) > 0.9:
        fail("elem 15a: the planted motif's held-out AUC %s is not above "
             "0.9 on every fold" % aucs[1])
    return rec


def clear_port_caches():
    """Drop the port's bounded device caches (the per-config kernels and
    the energy tables) and collect: what a task leaves behind after."""
    J._kernels_cached.cache_clear()
    ET._device_tables_cached.cache_clear()
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def task_table(calls):
    """The in-process calls grouped by pipeline task: "cv-k/pattern-i"
    (train and the scans of the held-out positives and negatives),
    "out/model-i" (refine), "scan/model-i" (elem scan)."""
    tasks = {}
    for c in calls:
        parts = c["out"].split(os.sep)
        if parts[1].startswith("cv-"):
            key = "%s/%s" % (parts[1], parts[3])
            what = "train" if c["what"] == "train" else \
                parts[-1].replace(".raw", "")
        else:
            key, what = "/".join(parts[:2]), c["what"]
        t = tasks.setdefault(key, {"s": {}, "launches": {}, "cuda_mb": 0.0,
                                   "rss_mb": 0})
        t["s"][what] = c["s"]
        for n, v in c["launches"].items():
            t["launches"][n] = t["launches"].get(n, 0) + v
        t["cuda_mb"], t["rss_mb"] = c["cuda_mb"], c["rss_mb"]
    return tasks


def elem_flagship(root):
    """15b: `elem pipeline` in process at the flagship shapes over
    ELEM_PATTERNS, then `elem scan` with both refined models; the outputs
    checked, the kernels' launches, in process against subprocesses on
    the (.....) fold-0 task byte for byte, device memory after the
    port's caches are cleared."""
    rng = np.random.RandomState(15)
    pos = write_fa(os.path.join(root, "positive.fa"),
                   flagship_hairpins(rng, ELEM_READS, ELEM_LEN))
    plist = os.path.join(root, "pattern_list")
    with open(plist, "w") as f:
        f.write("".join(p + "\n" for p, _ in ELEM_PATTERNS))
    for p, S in ELEM_PATTERNS:
        if compile_pattern(p).S != S:
            fail("elem: %s has S=%d, not %d" % (p, compile_pattern(p).S, S))
    out, scan_out = os.path.join(root, "out"), os.path.join(root, "scan")
    mem0 = clear_port_caches()
    K.reset_counts()
    t_phase = time.perf_counter()
    with ElemRecorder(root) as rec:
        pipe_s = elem_main(["pipeline", "-p", pos, "-m", plist, "-o", out,
                            *ELEM_ARGS, "--device", DEVICE, "--in-process"])
        scan_s = elem_main(["scan", "-M", out, "-s", pos, "-o", scan_out,
                            "--device", DEVICE, "--in-process"])
    phase_s = time.perf_counter() - t_phase
    launches = {n: k.launches for n, k in K.KERNELS.items()}
    for n in ELEM_KERNELS:
        if launches[n] <= 0:
            fail("elem: kernel %s was not launched by the pipeline" % n)
    # outputs
    n_test = ELEM_READS // 2
    for k in range(2):
        for pi, (p, _) in enumerate(ELEM_PATTERNS, 1):
            tdir = os.path.join(out, "cv-%d" % k, "train", "pattern-%d" % pi)
            sdir = os.path.join(out, "cv-%d" % k, "test", "pattern-%d" % pi)
            check_model(os.path.join(tdir, "train.model"), p, "15b")
            check_raw(os.path.join(tdir, "train.raw"), ELEM_READS - n_test,
                      "15b")
            for name in ("positive", "negative"):
                check_raw(os.path.join(sdir, name + ".raw"), n_test, "15b")
    aucs, sel = read_cv(out), selected(out)
    if len(aucs) != len(ELEM_PATTERNS) or len(sel) != 2:
        fail("elem 15b: cv has %d patterns, select.txt %d models"
             % (len(aucs), len(sel)))
    for i, pi in enumerate(sel, 1):
        mdir = os.path.join(out, "model-%d" % i)
        check_model(os.path.join(mdir, "train.model"),
                    ELEM_PATTERNS[pi - 1][0], "15b refine")
        check_raw(os.path.join(mdir, "train.raw"), ELEM_READS, "15b refine")
        for svg in ("rss.svg", "prf.svg"):
            text = open(os.path.join(mdir, svg)).read()
            if not (text.startswith("<svg") and text.endswith("</svg>")):
                fail("elem 15b: %s/%s is not an SVG" % (mdir, svg))
        check_raw(os.path.join(scan_out, "model-%d" % i, "scan.raw"),
                  ELEM_READS, "15b scan")
    # in process against subprocesses: the (.....) fold-0 task again from
    # a copy of the init dir that holds fold 0 alone
    sub = os.path.join(root, "sub")
    shutil.copytree(rec.snapshot, sub)
    shutil.rmtree(os.path.join(sub, "cv-1"))
    env_py = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [HERE] + ([env_py] if env_py else []))
    try:
        with ElemRecorder(root) as rec_sub:
            elem_main(["train", "-M", sub, "--pattern-index", "1",
                       *ELEM_TRAIN, "--device", DEVICE])
    finally:
        if env_py is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = env_py
    for rel in ELEM_SAME:
        a = open(os.path.join(out, "cv-0", rel), "rb").read()
        b = open(os.path.join(sub, "cv-0", rel), "rb").read()
        if not a or a != b:
            fail("elem: in process and in subprocesses differ: cv-0/%s"
                 % rel)
    torch.cuda.synchronize()
    mem1 = clear_port_caches()
    if abs(mem1 - mem0) > 2 ** 20:
        fail("elem: device memory %d bytes after the phase with the caches "
             "cleared, %d before" % (mem1, mem0))
    tasks = task_table(rec.calls)
    in0 = [c for c in rec.calls if c["out"].startswith(
        os.path.join("out", "cv-0")) and "pattern-1" in c["out"]]
    starts = [{"what": c["what"], "out": os.path.basename(c["out"]),
               "s_sub": c["s"], "s_in": c_in["s"],
               "start_s": c["s"] - c_in["s"]}
              for c, c_in in zip(rec_sub.calls, in0)]
    refine_s = sum(c["s"] for c in rec.calls if c["out"].startswith(
        os.path.join("out", "model-")))
    mean_auc = {ELEM_PATTERNS[pi - 1][0]: float(np.mean(v))
                for pi, v in sorted(aucs.items())}
    ranking = sorted(mean_auc, key=lambda p: -mean_auc[p])
    return {
        "phase_s": phase_s, "pipeline_s": pipe_s, "init_s": rec.init_s,
        "refine_s": refine_s, "scan_s": scan_s,
        "tasks": {k: {"s": v["s"], "cuda_mb": v["cuda_mb"],
                      "rss_mb": v["rss_mb"]} for k, v in tasks.items()},
        "launches_per_task": {k: v["launches"] for k, v in tasks.items()},
        "launches": {n: launches[n] for n in ELEM_KERNELS + CHAIN_KERNELS},
        "subprocess": starts, "same_bytes": list(ELEM_SAME),
        "cuda_bytes_before_after": [mem0, mem1],
        "planted_auc": aucs[1], "planted_rank": (
            sel.index(1) + 1 if 1 in sel else None),
        "planted_rank_by_mean_auc": ranking.index("(.....)") + 1,
        "select": [ELEM_PATTERNS[pi - 1][0] for pi in sel],
        "mean_auc": mean_auc, "S": {p: S for p, S in ELEM_PATTERNS},
        "reads": ELEM_READS, "length": ELEM_LEN, "args": ELEM_ARGS}


def elem_phase(dev):
    """Phase 15: 15a, then 15b; the {"elem": ...} record."""
    with tempfile.TemporaryDirectory() as root:
        planted = elem_planted(root)
        torch.cuda.empty_cache()
        flag = elem_flagship(root)
    flag["planted_15a"] = planted
    print("elem 15b: phase %.1f s (init %.1f, refine %.1f, scan %.1f); "
          "planted (.....) AUC per fold %s, select.txt %s, mean AUC %s"
          % (flag["phase_s"], flag["init_s"], flag["refine_s"],
             flag["scan_s"], flag["planted_auc"], flag["select"],
             json.dumps(flag["mean_auc"])), flush=True)
    return flag


# ------------------------------------------------------------ main

def load_package():
    """Import torch and the port into this module's globals; fail (no
    result) without CUDA, without the package beside this script, or
    where the port brought in JAX."""
    global np, torch, ET, J, DP, DMB, K, LIN, MIO, OBJ, TRN, CLI, SC, SCD
    global CYK, MESH, AJ, ELEM, seq_to_ints, ints_to_seq, FastqReader
    global compile_pattern
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail("numpy/torch missing: %s" % e)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    try:
        from rnaelem_tpu_torch import cli as CLI
        from rnaelem_tpu_torch.alphabet import ints_to_seq, seq_to_ints
        from rnaelem_tpu_torch.energy import tables as ET
        from rnaelem_tpu_torch.grammar.profile import compile_pattern
        from rnaelem_tpu_torch.io.fastq import FastqReader
        from rnaelem_tpu_torch.model import io as MIO
        from rnaelem_tpu_torch.model import joint as J
        from rnaelem_tpu_torch.ops import dp as DP
        from rnaelem_tpu_torch.ops import dp_maxb as DMB
        from rnaelem_tpu_torch.ops import kernels as K
        from rnaelem_tpu_torch.ops import linear as LIN
        from rnaelem_tpu_torch.parallel import arrayjob as AJ
        from rnaelem_tpu_torch.parallel import mesh as MESH
        from rnaelem_tpu_torch.pipeline import elem as ELEM
        from rnaelem_tpu_torch.scan import cyk as CYK
        from rnaelem_tpu_torch.scan import driver as SCD
        from rnaelem_tpu_torch.scan import scanner as SC
        from rnaelem_tpu_torch.train import objective as OBJ
        from rnaelem_tpu_torch.train import trainer as TRN
    except ImportError as e:
        fail("the rnaelem_tpu_torch package must sit beside this script "
             "(%s)" % e)
    if "jax" in sys.modules or "rnaelem_tpu" in sys.modules:
        fail("the port imported jax or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", default="",
                    help="also write nvcc -Xptxas -v output to this file")
    ap.add_argument("--profile", default="",
                    help="write the torch.profiler kernel table of one "
                         "main-path batch_fn_grad to this file")
    ap.add_argument("--launch-cost", action="store_true",
                    help="only time fn+grad under three kernel-launch "
                         "wrappers (see launch_cost) and exit")
    ap.add_argument("--ep-variants", action="store_true",
                    help="only time K3/K6 and the masks for variants of "
                         "the fused blocks' launch constants (see "
                         "ep_variants) and exit")
    ap.add_argument("--band-variants", action="store_true",
                    help="only time K2/K5 and the masks for variants of "
                         "band_bif's and bif_adj's launch constants (see "
                         "band_variants) and exit")
    ap.add_argument("--ext-variants", action="store_true",
                    help="only time K4/K12 and the masks for variants of "
                         "inside_ext.cu's launch constants, with the "
                         "shipped build's ptxas lines (see ext_variants), "
                         "and exit")
    ap.add_argument("--ext-adj-variants", action="store_true",
                    help="only time K7 and the masks for variants of "
                         "outside_ext.cu's launch constants, with the "
                         "shipped build's ptxas lines (see "
                         "ext_adj_variants), and exit")
    ap.add_argument("--k1-variants", action="store_true",
                    help="only time K1 for variants of its launch plan and "
                         "source, and probes that take a piece of its work "
                         "out (see k1_variants), and exit")
    ap.add_argument("--ep-probes", action="store_true",
                    help="only time K11 with one piece of its step taken "
                         "out (see ep_probes) and exit")
    ap.add_argument("--onehot-repro", action="store_true",
                    help="only build and run the reproducer of K15's first "
                         "one-hot form (see onehot_repro) and exit")
    ap.add_argument("--wide", action="store_true",
                    help="only build, check the launch plans' layouts and "
                         "run phase 14 (the wide grammars, 44 and 50 dots "
                         "among them), and exit")
    ap.add_argument("--rows-cd-times", action="store_true",
                    help="only build and time K14-K17 and K1 at the main "
                         "path's shapes (rows_cd_times; with the host "
                         "plans, K15 and K17 under every split), print the "
                         "SHA-256 of K1's and K16's outputs, and exit")
    ap.add_argument("--chain-times", action="store_true",
                    help="only build and time K8 and K9 at the main path's "
                         "shape, plain and pinned with the class probe "
                         "(chain_times_only), print the SHA-256 of their "
                         "outputs (f32, f64), and exit")
    ap.add_argument("--tb-times", action="store_true",
                    help="only build and time K13 on the two 76-tRNA scan "
                         "chunks at f64 and f32 under each plan, with the "
                         "SHA-256 of its outputs, the walk's cells and "
                         "candidates per read, a dependent load's latency "
                         "and both bounds (tb_times_only); with "
                         "--rows-cd-times both run; then exit")
    ap.add_argument("--chain-variants", action="store_true",
                    help="only time K8 and K9 per plan (the one-warp "
                         "block, K9's device variant) and with pieces of "
                         "their work taken out (see chain_variants), and "
                         "exit")
    ap.add_argument("--elem", action="store_true",
                    help="only build and run phase 15 (the elem pipeline "
                         "on the card: the planted contract, then the "
                         "pattern list's widths at the flagship shapes), "
                         "and exit")
    ap.add_argument("--glue", action="store_true",
                    help="only build, hold K18-K21 against their plain "
                         "twins (phase 2d), time them and run the glue "
                         "gate, and exit")
    ap.add_argument("--glue-times", action="store_true",
                    help="only build and time the walls this slice's glue "
                         "moves, K18-K21 where the tree has them, and the "
                         "glue census (see glue_times; a copy of this "
                         "script beside an older tree times that tree), "
                         "and exit")
    ap.add_argument("--shipped-only", action="store_true",
                    help="with --ep-variants, --band-variants, "
                         "--ext-variants, --ext-adj-variants or "
                         "--chain-variants: time the sources as they are, "
                         "no patched copy")
    # one rank of N2/N3, started by this script itself
    ap.add_argument("--mesh-worker", type=int, default=-1,
                    help=argparse.SUPPRESS)
    for flag in ("--mesh-devices", "--mesh-backend", "--mesh-fq",
                 "--mesh-out"):
        ap.add_argument(flag, default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    load_package()
    if args.mesh_worker >= 0:
        mesh_worker(args)
        return
    if args.launch_cost:
        launch_cost(DEVICE)
        return
    pick = (lambda v: {"shipped": ()}) if args.shipped_only else \
        (lambda v: v)
    if args.ep_variants:
        ep_variants(DEVICE, pick(EP_VARIANTS))
        return
    if args.band_variants:
        band_variants(DEVICE, pick(BAND_VARIANTS))
        return
    if args.ext_variants:
        ext_variants(DEVICE, pick(EXT_VARIANTS))
        return
    if args.ext_adj_variants:
        ext_adj_variants(DEVICE, pick(ADJ_VARIANTS))
        return
    if args.ep_probes:
        ep_probes(DEVICE)
        return
    if args.k1_variants:
        k1_variants(DEVICE, pick(K1_VARIANTS))
        return
    if args.onehot_repro:
        onehot_repro(DEVICE)
        return
    if args.chain_variants:
        chain_variants(DEVICE, pick(CHAIN_VARIANTS))
        return
    dev = DEVICE
    t_start = time.time()
    card = card_line()
    print("card: %s" % card, flush=True)

    # ---- phase 1: build
    t0 = time.time()
    K.lib()
    print("kernel build: %.1f s" % (time.time() - t0), flush=True)
    print("K3/K6/K11 layouts: ep_smem_bytes and the device plan's block "
          "bytes equal the kernels' layout and workspace stride in %d cases"
          % check_ep_smem(), flush=True)
    print("M chain (K2, K5) shared memory: band_smem_bytes equals the "
          "kernels' layout in %d cases (S to 1024, every group and ring a "
          "plan may pick)" % check_band_smem(), flush=True)
    if hasattr(K, "chain_plan"):
        print("K8/K9 layouts: chain_smem_bytes and chain_plan equal the "
              "kernels' layout in %d cases (S to 4,096, K9's tiles and "
              "device variant)" % check_chain_smem(), flush=True)
    if args.ptxas:
        _, log = K.build(("-Xptxas", "-v"))
        os.makedirs(os.path.dirname(os.path.abspath(args.ptxas)),
                    exist_ok=True)
        with open(args.ptxas, "w") as f:
            f.write(log)
    if args.rows_cd_times or args.tb_times:
        if args.rows_cd_times:
            rows_cd_times_only(dev)
        if args.tb_times:
            tb_times_only(dev)
        print("card: %s" % card_line(), flush=True)
        return
    if args.chain_times:
        chain_times_only(dev)
        print("card: %s" % card_line(), flush=True)
        return
    if args.wide:
        _, rows_w = wide_phase(dev)
        print(json.dumps({"kernels": rows_w}))
        print("card: %s" % card_line(), flush=True)
        return
    if args.elem:
        print(json.dumps({"elem": elem_phase(dev)}))
        print("card: %s" % card_line(), flush=True)
        return
    if args.glue:
        funcs = kernel_functions()
        check_glue_kernels(dev)
        cfg32 = cfg_for("float32")
        p32 = random_params(cfg32, dev)
        bm = OBJ.stack_reads(cfg32, main_reads(), device=dev)
        print("K18-K21 ms, plain ms, bounds, units: %s" % json.dumps(
            glue_kernel_times(bm, p32, dev, funcs)), flush=True)
        glue_gate(census_paths(dev, funcs, reps=1))
        print("card: %s" % card_line(), flush=True)
        return
    if args.glue_times:
        glue_times(dev)
        print("card: %s" % card_line(), flush=True)
        return

    # ---- phase 2: kernels vs plain versions
    small = make_reads(np.random.RandomState(0), *SMALL)
    reads = main_reads()
    cfg64, cfg32 = cfg_for("float64"), cfg_for("float32")
    err = {}
    e64 = check_score_tables(cfg64, small, dev)
    err["score_tables"] = check_score_tables(cfg32, reads, dev)
    print("check score_tables: f64 small batch max abs err %.3g; f32 main "
          "batch %.3g (floats within 1e-6 relative, ints/bools equal)"
          % (e64, err["score_tables"]), flush=True)

    p64, p32 = random_params(cfg64, dev), random_params(cfg32, dev)
    dp64, dp32 = J.kernels(cfg64, dev).dp, J.kernels(cfg32, dev).dp
    b16, d64, c64 = batch_factors_for(cfg64, small, dev, p64)
    j0 = J0
    s64 = check_stages(dp64, d64, c64, j0, 1e-9, False)
    print("check stages f64 small batch column %d: %s (1e-9 relative)"
          % (j0, json.dumps(s64)), flush=True)
    bm, d32, c32 = batch_factors_for(cfg32, reads, dev, p32)
    s32 = check_stages(dp32, d32, c32, j0, 1e-4, True)
    print("check stages f32 main batch column %d: %s (1e-4 relative)"
          % (j0, json.dumps(s32)), flush=True)
    err.update(s32)
    a64 = check_adj_stages(dp64, d64, c64, j0, 1e-9)
    print("check adjoint stages f64 small batch column %d: max abs err %s "
          "(within 1e-9 relative, max norm)" % (j0, json.dumps(a64)),
          flush=True)
    a32 = check_adj_stages(dp32, d32, c32, j0, 1e-4)
    print("check adjoint stages f32 main batch column %d: max abs err %s "
          "(within 1e-4 relative, max norm)" % (j0, json.dumps(a32)),
          flush=True)
    err.update(a32)
    # rows C and D: the factors and the hoisted exponentials, K14-K17
    err.update(check_rows_cd(dev))
    for kn, e in check_k1_k16_batches(dev).items():
        err[kn] = max(err.get(kn, 0.0), e)
    check_adj_splits(dev)

    parts_k64 = J.batch_logZ_parts(cfg64, p64, b16.sd, b16.bp_ok, device=dev)
    parts_p64 = plain_parts(cfg64, p64, b16, dev)
    b16_32 = OBJ.stack_reads(cfg32, small, device=dev)
    parts_k32 = J.batch_logZ_parts(cfg32, p32, b16.sd, b16.bp_ok,
                                   device=dev)
    fin = torch.isfinite(parts_p64)
    if not torch.equal(fin, torch.isfinite(parts_k64)) or \
            not torch.equal(fin, torch.isfinite(parts_k32)):
        fail("inside DP: -inf pattern of the parts differs")
    e_dp64 = float((parts_k64 - parts_p64)[fin].abs().max())
    e_dp32 = float((parts_k32.double() - parts_p64)[fin].abs().max())
    print("check inside DP small batch: f64 kernels vs f64 plain %.3g "
          "(<= 1e-9); f32 kernels vs f64 plain %.3g (<= 2e-3)"
          % (e_dp64, e_dp32), flush=True)
    if not e_dp64 <= 1e-9:
        fail("inside DP f64: parts differ by %.3g" % e_dp64)
    if not e_dp32 <= 2e-3:
        fail("inside DP f32: parts differ by %.3g" % e_dp32)
    del b16_32

    # ---- phase 2b: row K, the pinned stages and the class sums
    kp64, msg = check_pinned(cfg64, b16, p64, dev, 1e-9, False, full=True)
    print("check pinned stages and class sums (row K) f64 small batch, "
          "column %d, 1e-9 relative: %s" % (j0, msg), flush=True)
    b64 = OBJ.stack_reads(cfg32, reads[:B_SCAN], device=dev)
    err_pin, msg = check_pinned(cfg32, b64, p32, dev, 1e-4, True, full=False)
    print("check pinned stages and class sums (row K) f32 B=%d x %d nt, "
          "column %d, 1e-4 relative: %s" % (B_SCAN, LP, j0, msg), flush=True)
    del b64

    # ---- phase 2c: rows L and M, the CYK tables (K10-K12) under the pin
    # set against the plain max DP, and the traceback K13 against the host
    e_max64, cfg_m, dm, cm, tabs_m = check_max_tables(cfg64, small, p64,
                                                      dev, 1e-12)
    n_tb, tb_names = check_traceback(cfg_m, dm, cm, tabs_m, dev,
                                     "B=16 random weights")
    del tabs_m, dm, cm
    e_max32, *_ = check_max_tables(cfg32, reads[:B_SCAN], p32, dev, 1e-4)
    err.update(e_max32)
    err["cyk_traceback"] = 0.0
    print("check CYK tables (rows L, M; K10-K12) under the pin set (Ys, Ye, "
          "tail; a read with Ye == L, one with Ys == Ye) vs the plain max DP, "
          "column %d stages and whole tables, -inf placement identical, two "
          "runs bitwise equal: f64 B=%d max abs err %s (<= 1e-12); f32 B=%d x "
          "%d nt %s (<= 1e-4); K13 vs the host traceback on the f64 tables: "
          "%d reads' psihat and pair sets identical under plans %s" % (
              J0, len(small), json.dumps(e_max64), B_SCAN, LP,
              json.dumps(e_max32), n_tb, json.dumps(tb_names)), flush=True)
    torch.cuda.empty_cache()

    # ---- phase 2d: K18-K21, the passes' ends, the masks' threshold and
    # the scanner's posteriors, against their plain twins
    err.update(check_glue_kernels(dev))

    # ---- phases 3-4: full gradient and masks, small batch
    check_full_gradient(cfg64, cfg32, small, dev)
    check_masks(cfg64, cfg32, small, dev)

    # ---- phase 7 (checks): the no-rss chain
    err.update(check_chain(small, reads, dev))
    e_cp, msg = check_chain_pinned(small, reads, dev)
    err_pin.update(e_cp)
    print("check chain %s (no-rss) K8/K9 under a pin, K9's class sums, vs "
          "plain (f64 within 1e-9, f32 within 1e-4 relative, max norm; two "
          "runs bitwise equal): %s" % (NORSS, msg), flush=True)

    # ---- phase 5: per-call times at the main path's shapes
    k32 = J.kernels(cfg32, dev)
    seq, L, bp_ok, dots_cum = J.score_inputs(cfg32, k32, bm.sd, bm.bp_ok)
    sargs = (k32.tab, seq, L, bp_ok, dots_cum, cfg32.Wp, cfg32.max_span,
             cfg32.turn, cfg32.no_ene, cfg32.fix_rss)
    funcs = kernel_functions()
    ms, plain_ms, unit, ms_fn = {}, {}, {}, {}
    K.reset_counts()
    ET.score_tables(*sargs)
    unit["score_tables"] = ("batch", K.KERNELS["score_tables"].launches)
    ms["score_tables"] = device_ms(lambda: ET.score_tables(*sargs), REPS,
                                   funcs["score_tables"])
    plain_ms["score_tables"] = cuda_ms(
        lambda: ET.score_tables_plain(*sargs), 3)
    st = dp32.st
    h32 = DP.hoisted(d32, c32, st)
    fs = dp32.run_inside(d32, c32, h32)
    state = {k: fs[k] for k in fs}
    groups = {"inside_band": ("band_front", "band_bif", "band_m", "band_e"),
              "inside_ep": ("ep_stage",), "inside_ext": ("ext_stage",)}
    for kname, names in groups.items():
        ks, ps = DP.clone_state(state), DP.clone_state(state)
        kf = [getattr(DP, n) for n in names]
        pf = [getattr(DP, n + "_plain") for n in names]
        K.reset_counts()
        for f in kf:
            f(ks, j0, d32, c32, h32, st)
        unit[kname] = ("column %d" % j0, K.KERNELS[kname].launches)
        ms[kname], ms_fn[kname] = device_ms_by_function(
            lambda: [f(ks, j0, d32, c32, h32, st) for f in kf], REPS,
            funcs[kname])
        plain_ms[kname] = cuda_ms(
            lambda: [f(ps, j0, d32, c32, h32, st) for f in pf], 3)
        del ks, ps
    gbar = torch.as_tensor(np.random.RandomState(5).rand(B_MAIN, 3),
                           dtype=st.dtype, device=dev)
    gs = DP.init_grads(fs, d32, c32, h32)
    DP.seed_parts(gs, gbar, c32, st)
    dp32.outside_columns(fs, gs, d32, c32, h32, LP + 1, j0 + 1)
    adj = {"outside_band": ("e_adj", "band_adj"), "outside_ep": ("ep_adj",),
           "outside_ext": ("ext_adj",)}
    for kname, names in adj.items():
        kg = {k: v.clone() for k, v in gs.items() if not k.startswith("_")}
        pg = {k: v.clone() for k, v in gs.items() if not k.startswith("_")}
        kf = [getattr(DP, n) for n in names]
        pf = [getattr(DP, n + "_plain") for n in names]
        K.reset_counts()
        for f in kf:
            f(fs, kg, j0, d32, c32, h32, st)
        unit[kname] = ("column %d" % j0, K.KERNELS[kname].launches)
        ms[kname], ms_fn[kname] = device_ms_by_function(
            lambda: [f(fs, kg, j0, d32, c32, h32, st) for f in kf], REPS,
            funcs[kname])
        plain_ms[kname] = cuda_ms(
            lambda: [f(fs, pg, j0, d32, c32, h32, st) for f in pf], 3)
        del kg, pg
    # one block per (read, range of x): at B=33 the 132 blocks take one
    # SM each, so their time is one block's, at B=128 the card's
    # throughput for the main path's 512 blocks
    wave = ep_column_ms(cfg32, reads[:33], p32, dev, funcs, j0)
    print("K3 and K6 device ms per column %d at B=33 (132 blocks, one per "
          "SM: one block's time), f32: %s" % (j0, json.dumps(
              {n: v[0] for n, v in wave.items()})), flush=True)
    print("K3 (inside_ep) and K6 (outside_ep) device ms per column %d by "
          "CUDA function (B=%d x %d nt, f32): %s" % (
              j0, B_MAIN, LP, json.dumps({n: ms_fn[n] for n in (
                  "inside_ep", "outside_ep")})), flush=True)
    del state, fs, gs
    lin, eRc, Lc, gpc = chain_inputs(norss_cfg("float32"), reads, dev)
    _, rows_c = K.chain_fwd(lin, eRc, Lc)
    for kname, call in (
            ("linear_fwd", lambda: K.chain_fwd(lin, eRc, Lc)),
            ("linear_adj", lambda: K.chain_adj(lin, eRc, Lc, rows_c, gpc))):
        K.reset_counts()
        call()
        unit[kname] = ("batch", K.KERNELS[kname].launches)
        ms[kname] = device_ms(call, REPS, funcs[kname])
    plain_ms["linear_fwd"] = cuda_ms(lambda: LIN.chain_plain(lin, eRc, Lc), 3)
    leaf = eRc.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        graph = LIN.chain_plain(lin, leaf, Lc)
    plain_ms["linear_adj"] = cuda_ms(lambda: torch.autograd.grad(
        graph, leaf, gpc, retain_graph=True), 3)
    del graph, leaf, rows_c
    ms_pin, pin_fn = pinned_times(dp32, *scan_factors(cfg32, bm, p32, dev,
                                                      True), j0, funcs)
    mask_fn = masks_by_function(cfg32, bm.sd, dev, funcs)
    ms_by_fn = {k: {"column": ms_fn[k], "pinned": pin_fn[k],
                    "masks_batch": mask_fn[k]} for k in BAND_KERNELS}
    print("K2 (inside_band) and K5 (outside_band) device ms by CUDA "
          "function: per column %d (B=%d x %d nt, f32), the same under the "
          "pin with the class probe, and per masks batch (S=1, every "
          "column): %s" % (j0, B_MAIN, LP, json.dumps(ms_by_fn)), flush=True)
    sd_c = J.stack_seqdata([J.make_seqdata(cfg32, s_, q_) for s_, q_ in reads],
                           dev)
    pin_c = random_pin(sd_c, dev)
    gpc = torch.where(torch.isfinite(K.chain_fwd(lin, eRc, Lc, pin_c)[0]), gpc,
                      0.0)
    _, rows_p = K.chain_fwd(lin, eRc, Lc, pin_c)
    cls_c = torch.empty((4, LP, B_MAIN), dtype=eRc.dtype, device=dev)
    ms_pin["linear_fwd"] = device_ms(lambda: K.chain_fwd(lin, eRc, Lc, pin_c),
                                     REPS, funcs["linear_fwd"])
    ms_pin["linear_adj"] = device_ms(lambda: K.chain_adj(
        lin, eRc, Lc, rows_p, gpc, pin_c, cls_c), REPS, funcs["linear_adj"])
    print("pinned per-call device ms (a pin per read and the class probe, "
          "column %d / one batch, B=%d x %d nt, f32): %s" % (
              j0, B_MAIN, LP, json.dumps(ms_pin)), flush=True)
    del rows_p, cls_c
    ms_cd, plain_cd, bnd_cd, unit_cd = rows_cd_times(cfg32, p32, bm, dev,
                                                     funcs)
    ms.update(ms_cd)
    plain_ms.update(plain_cd)
    unit.update(unit_cd)
    print("K14-K17 (rows C, D) device ms per call (B=%d x %d nt, f32, %d "
          "calls): %s; plain %s; bounds %s" % (
              B_MAIN, LP, REPS, json.dumps(ms_cd), json.dumps(plain_cd),
              json.dumps(bnd_cd)), flush=True)
    glue = glue_rows(cfg32, p32, bm, dev, funcs)
    ms_g, plain_g, bnd_g, unit_g = glue_kernel_times(bm, p32, dev, funcs)
    ms.update(ms_g)
    plain_ms.update(plain_g)
    unit.update(unit_g)
    print("K18-K21 device ms per unit (%d calls): %s; plain %s; bounds %s; "
          "units %s" % (REPS, json.dumps(ms_g), json.dumps(plain_g),
                        json.dumps(bnd_g), json.dumps(unit_g)), flush=True)

    # ---- phase 6: the evaluation path
    K.reset_counts()
    t0 = time.time()
    batch = OBJ.stack_reads(cfg32, reads, device=dev)
    torch.cuda.synchronize()
    mask_warm_s = time.time() - t0
    mask_launches = {n: kk.launches for n, kk in K.KERNELS.items()}
    print("masks (stack_reads, S=1, B=%d) launches: %s" % (
        B_MAIN, json.dumps(mask_launches)), flush=True)
    for n in ("inside_ep", "outside_ep", "factors", "hoisted", "bpp_keep",
              "parts"):
        if mask_launches[n] <= 0:
            fail("the masks' S=1 pass did not launch %s" % n)
    fn, grads, eff = OBJ.batch_fn_grad(cfg32, p32, batch, device=dev)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    eval_launches = {n: kk.launches for n, kk in K.KERNELS.items()}
    eval_variants = {n: dict(kk.variants) for n, kk in K.KERNELS.items()}
    launches_fg = sum(eval_launches.values()) - sum(mask_launches.values())
    print("evaluation path launches (masks + fn+grad, B=%d): %s; by the "
          "variant of the launch plans: %s" % (
              B_MAIN, json.dumps(eval_launches), json.dumps(
                  {n: kk.variants for n, kk in K.KERNELS.items()
                   if kk.variants})), flush=True)
    for n in DP_KERNELS + ROWS_CD_KERNELS + GLUE_KERNELS[:3]:
        if eval_launches[n] <= 0:
            fail("kernel %s was not launched on the evaluation path" % n)
    K.reset_counts()
    OBJ.batch_fn_grad(cfg32, p32, batch, device=dev)
    per_fg = {n: kk.launches for n, kk in K.KERNELS.items()}
    for n in DP_KERNELS + ROWS_CD_KERNELS + ("parts", "lam_sum"):
        if per_fg[n] <= 0:
            fail("kernel %s was not launched by fn+grad" % n)
    print("K7 (outside_ext): %d launches per fn+grad, one per column of %d "
          "(two per column before its single entry point); %d launches of "
          "all kernels per fn+grad" % (per_fg["outside_ext"], LP,
                                        sum(per_fg.values())), flush=True)
    if not np.isfinite(float(fn)):
        fail("main path fn is not finite: %s" % float(fn))
    if any(not bool(torch.isfinite(g).all()) for g in grads):
        fail("main path gradient is not finite")
    reps = 3
    mask_ms = cuda_ms(lambda: OBJ.stack_reads(cfg32, reads, device=dev),
                      reps)
    fg_ms = cuda_ms(lambda: OBJ.batch_fn_grad(cfg32, p32, batch, device=dev),
                    reps)
    fwd_ms = cuda_ms(lambda: OBJ.batch_total(cfg32, p32, batch, device=dev),
                     reps)
    host, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        OBJ.batch_fn_grad(cfg32, p32, batch, device=dev)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    print("fn+grad: %d kernel launches; host ms to the call's return %s, "
          "wall ms to a synchronize %s (host ~ wall: host-bound)" % (
              launches_fg, json.dumps(host), json.dumps(wall)), flush=True)
    print("evaluation path: B=%d x %d nt %s W=50 C=30 min_bpp=%g tau=0.1 "
          "f32: fn %.6f sum eff %.4f; masks (stack_reads) %.3f ms/batch "
          "(first %.1f s); batch_fn_grad %.3f ms/batch (%.1f seqs/s); "
          "forward batch_total %.3f ms/batch (%.1f seqs/s); warm-up %.1f s; "
          "launches per fn+grad %s" % (
              B_MAIN, LP, PATTERN, MIN_BPP, float(fn), float(eff), mask_ms,
              mask_warm_s, fg_ms, B_MAIN * 1e3 / fg_ms, fwd_ms,
              B_MAIN * 1e3 / fwd_ms, warm_s, json.dumps(per_fg)),
          flush=True)
    per, prof, wall_us, busy_us = device_profile(
        lambda: OBJ.batch_fn_grad(cfg32, p32, batch, device=dev), 2)
    wall_us, busy_us = wall_us / 2, busy_us / 2
    fg_dev = {n: sum(per.get(f, 0.0) for f in fn_) / 1e3
              for n, fn_ in funcs.items() if n not in CYK_KERNELS}
    print("profile: batch_fn_grad %.1f ms wall (profiler on, mean of 2), "
          "device busy %.1f ms (%.1f%%); device ms per fn+grad by kernel %s"
          % (wall_us / 1e3, busy_us / 1e3, 100.0 * busy_us / wall_us,
             json.dumps(fg_dev)), flush=True)
    per_m, _, wall_m, busy_m = device_profile(
        lambda: OBJ.stack_reads(cfg32, reads, device=dev), 2)
    print("profile: masks (stack_reads) %.1f ms wall (profiler on, mean of "
          "2), device busy %.1f ms (%.1f%%); device ms by kernel %s"
          % (wall_m / 2e3, busy_m / 2e3, 100.0 * busy_m / wall_m,
             json.dumps({n: sum(per_m.get(f, 0.0) for f in fn_) / 1e3
                         for n, fn_ in funcs.items()
                         if n not in CYK_KERNELS})), flush=True)
    # the glue gate: torch's kernels by aten op and line, host syncs
    t0 = time.time()
    census = census_paths(dev, funcs, reps=1)
    glue_gate(census)
    for label, n_fn in (("fn+grad", sum(per_fg.values())),
                        ("masks batch", sum(mask_launches.values()))):
        n_torch, _, n_hand, n_cp, _, _ = census[label]
        print("%s launches (B=%d x %d nt f32): %d of the hand-written "
              "kernels (their launch counts), %g kernel launches in the "
              "profiler's trace (%g of them the hand-written kernels' "
              "functions, %g torch's), %g memcpy/memset events apart" % (
                  label, B_MAIN, LP, n_fn, n_torch + n_hand, n_hand, n_torch,
                  n_cp), flush=True)
    print("glue gate: no cub sort or select; torch kernels per call %s "
          "(at most %s); %.1f s" % (
              json.dumps({k_: v[0] for k_, v in census.items()}),
              json.dumps(GLUE_LIMITS), time.time() - t0), flush=True)
    if args.profile:
        os.makedirs(os.path.dirname(os.path.abspath(args.profile)),
                    exist_ok=True)
        with open(args.profile, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=50))

    # ---- phase 8: the training path (the production step)
    with tempfile.TemporaryDirectory() as tmp:
        step = production_step(PATTERN, False, tmp, dev)
        step_nr = production_step(NORSS, True, tmp, dev)
        for run, names in ((step, DP_KERNELS + ROWS_CD_KERNELS),
                           (step_nr, CHAIN_KERNELS + ("factors",
                                                      "factors_adj"))):
            for n in names:
                if run["launches"][n] <= 0:
                    fail("kernel %s was not launched on the training path "
                         "%s" % (n, run["pattern"]))
        # ---- phase 9: the C++ goldens on the card
        golden_trna_eval(tmp, dev)
        golden_small8_train(tmp, dev)
        # ---- phase 13: row N, data parallelism and the file array
        torch.cuda.empty_cache()
        n1 = mesh_n1(cfg32, reads, p32, dev)
        n2 = mesh_ranks(tmp, "N2", ["cuda:0", "cuda:0"], "gloo", n1, step)
        n3 = "skipped: one CUDA device (N3 needs two)"
        if torch.cuda.device_count() >= 2:
            launch_on_second_card(cfg32, reads[:16], p32)
            n3 = mesh_ranks(tmp, "N3", ["cuda:0", "cuda:1"], "nccl", n1,
                            step)
        else:
            print("N3 (two cards over NCCL, launches on cuda:1 from device "
                  "0): skipped, this machine has one CUDA device; not "
                  "counted as a pass", flush=True)
        arr = array_eval_check(tmp, dev)
        # ---- phases 11-12: the scan path (this slice's main path: the
        # structure-model scan at f64, its default)
        scan = scan_trna(tmp, dev)
        scan_nr = scan_norss(tmp, dev)
        for n in SCAN_KERNELS + ("factors", "hoisted") + GLUE_KERNELS:
            if scan["float64"]["launches"][n] <= 0:
                fail("kernel %s was not launched on the scan path" % n)
        # ---- phase 5 (rows L, M): per-column and per-chunk times
        cyk = cyk_times(scan["fq"], dev)
        for dtype in ("float64", "float32"):
            ct_ = cyk[dtype]
            if "bound_dep" in ct_:
                print("K13's dependent-path bound (f64 chunk 1): %s"
                      % json.dumps(ct_["bound_dep"]), flush=True)
            print("CYK kernels on a 64-read tRNA scan chunk (bucket 96), %s: "
                  "device ms per column %d (K10-K12) and per chunk (K13) %s, "
                  "launches %s; K11 and K12 on the second chunk (12 reads) "
                  "%s; plain %s (K13's: the host traceback, wall ms); bounds "
                  "%s; K13 walked %d cells, %d candidates up to the choices"
                  % (dtype, J0, json.dumps(ct_["ms"]),
                     json.dumps(ct_["launches"]),
                     json.dumps(ct_["ms_chunk2"]),
                     json.dumps(ct_["plain_ms"]), json.dumps(ct_["bound"]),
                     ct_["stats"]["cells"], ct_["stats"]["cands"]),
                  flush=True)
        print("K13 vs the host traceback on the 76 tRNAs (f64 tables): %d "
              "reads' psihat and pair sets identical under plans %s" % (
                  cyk["tb_reads"], json.dumps(cyk["tb_plans"])), flush=True)
        for n in CHAIN_KERNELS:
            if scan_nr[n] <= 0:
                fail("kernel %s was not launched on the no-rss scan" % n)
    # ---- phase 14: the wide grammars (the device variants, the M chain's
    # smaller groups of reads)
    torch.cuda.empty_cache()
    t_wide = time.time()
    wide, wide_rows = wide_phase(dev)
    print("wide grammars phase: %.1f s; variant rows %s" % (
        time.time() - t_wide, json.dumps([r["name"] for r in wide_rows])),
        flush=True)
    # ---- phase 15: the elem pipeline
    torch.cuda.empty_cache()
    elem = elem_phase(dev)

    # ---- phase 10: the kernel table
    # ms (the profiler's device time of the kernel's own functions over
    # REPS calls), plain_ms and bound_ms are per unit of work ("unit": K1,
    # K8, K9 one batch, K2-K7 one column j0, of "launches_per_unit"
    # launches); "ms_pin" the same unit under a pin per read with the
    # class probe (K2, K4, K5, K7, K8, K9), "max_abs_err_pin" its f32
    # check; "launches" counts the scan path's run of the kernel (the f32
    # posteriors of the 76 tRNAs for K1-K7, the no-rss scan of fixture
    # model 2 for K8/K9), "launches_step" the training path's (the
    # production step, (.....) for K1-K7, ..*.. --no-rss for K8/K9),
    # "launches_eval_path" the evaluation path's (masks + fn+grad),
    # "launches_fn_grad" and "ms_fn_grad" (device time) one batch_fn_grad
    bnd = bounds(cfg32, st, c32, k32.tab, j0, B_MAIN, 4)
    bnd.update(chain_bounds(lin, Lc.cpu().numpy(), LP, 4))
    bnd.update(bnd_cd)
    bnd.update(bnd_g)
    c64 = cyk["float64"]
    bnd.update(c64["bound"])
    ms.update(c64["ms"])
    plain_ms.update(c64["plain_ms"])
    for name in CYK_KERNELS:
        unit[name] = ("one 64-read tRNA scan chunk, f64" if
                      name == "cyk_traceback" else
                      "column %d of a 64-read tRNA scan chunk, f64" % J0,
                      c64["launches"][name])
        fg_dev[name] = None
    rows = []
    for name, kern in K.KERNELS.items():
        bms, by = bnd[name]
        u, n_unit = unit[name]
        chain = name in CHAIN_KERNELS
        launches = (step_nr if chain else step)["launches"]
        n_scan = (scan_nr if chain else scan["float64"]["launches"])[name]
        rows.append({
            "name": name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": n_scan,
            "max_abs_err": err[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": bms, "bound_by": by,
            "library_ms": None, "unit": u, "launches_per_unit": n_unit,
            "ms_pin": ms_pin.get(name),
            "max_abs_err_pin": err_pin.get(name),
            "launches_step": launches[name],
            "launches_eval_path": eval_launches[name],
            "launches_fn_grad": per_fg[name], "ms_fn_grad": fg_dev[name],
            "launches_masks_batch": mask_launches[name],
            "launches_chunk": scan["chunk_launches"][name],
            "ms_by_function": ms_by_fn.get(name),
            "variants": eval_variants[name]})
        if name == "cyk_traceback":
            rows[-1]["bound_dep_ms"] = c64["bound_dep"]["ms"]
        print("kernel %s: %.4f ms per %s of %d launches (plain %.3f ms, "
              "bound %.4f ms by %s; with the pin %s ms); %d launches on the "
              "scan path, %d in the production step, %d on the evaluation "
              "path, %d per fn+grad (%s ms of device time)" % (
                  name, ms[name], u, n_unit, plain_ms[name], bms, by,
                  ms_pin.get(name), n_scan, launches[name],
                  eval_launches[name], per_fg[name], fg_dev[name]),
              flush=True)
    mb_ms, mb_by = mask_pass_bound(cfg32, batch.sd, dev, 4)
    print("row I (the masks, K1-K7 at S=1 over every column, B=%d x %d nt): "
          "bound %.4f ms by %s; measured %.3f ms per batch (stack_reads)"
          % (B_MAIN, LP, mb_ms, mb_by, mask_ms), flush=True)
    print("chip_smoke total %.1f s" % (time.time() - t_start))
    print(json.dumps({"row_n": {
        "name": "data parallelism", "route": "torch.distributed",
        "source": "rnaelem_tpu_torch/parallel/mesh.py",
        "replaces": "rnaelem_tpu/parallel/mesh.py:126",
        "gather_ms": n1["gather_ms"], "gather_bytes": n1["gather_bytes"],
        "bound_ms": n1["bound_ms"], "bound_by": "bytes",
        "library_ms": n1["gather_ms"], "library": "NCCL all_gather",
        "collectives_per_step": 1, "launches_per_step": n1["launches"],
        "step_ms_one_rank": n1["step_ms"],
        "plain_step_ms": n1["plain_step_ms"], "n2": n2, "n3": n3,
        "array": arr}}))
    print(json.dumps({"rows_c_d": glue}))
    print(json.dumps({"elem": elem}))
    print(json.dumps({"kernels": rows + wide_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
