#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cholesky_tpu_torch`) on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card (and `nvidia-smi` name + power limit on its own line),
             torch's versions and the float32 matmul flag;
  2. build:  the hand-written kernels built from `cholesky_tpu_torch/kernels/
             csrc` with nvcc (one process per source, all started
             together), build seconds and the `-Xptxas -v` report; the
             native host core (`cholesky_tpu_torch/native/src/mndio.cc`)
             built with g++: seconds, cached or not, `g++ --version`;
  3. kernel: `chol_inv` vs its plain PyTorch version on [300, 128, 128] SPD
             blocks (errors against an f64 reference), then at each shape
             the main paths launch it with, [128|64|32, 128, 128] (50^3),
             [8192|1024|512|256|128, 128, 128] (140^3), [2048, 128, 128]
             (the 50^3 family at K = 16) and [16|8, 128, 128] (a slot of
             the mesh phase), checked the same way and timed
             beside its bound (bytes over 3.35 TB/s or fp32 flops over 67
             TFLOP/s, whichever is larger), its share of that bound, its
             plain version and the library pair `cholesky_ex` +
             `solve_triangular`;
             `factor_slab` (the kernels of csrc/factor_slab.cu) vs its plain
             version `factor_slab_ref` and vs the known factor of the slab
             (bench_front_kernels' `known_slab` and `slab_err`: each part
             of the result against its own largest entry) at the 17 level
             classes of tools/torch/bench_front_kernels.py and at
             SLAB_CLUSTER_CLASSES, at the IEEE and the TF32 rung (zeros
             above the diagonal, a repeated call bit-identical),
             then at the 50^3 leaf slab [128, 1440, 864] timed beside its
             plain version, the cuBLAS composite it replaced, the library
             pair `cholesky_ex` + `solve_triangular` and its bound;
             `form_front` (csrc/form_front.cu) at the shape of every level
             with children of the benchmark's two configurations
             (FRONT_LEVELS, seeded values and maps), f32: bitwise equal to
             its plain version `form_front_ref` and to itself on a second
             launch, zero sentinel row, then timed beside its byte bound
             at 3.35 TB/s and its plain version;
             `schur_syrk` (csrc/schur_syrk.cu) at the shape of every level
             with a boundary of both configurations (SCHUR_LEVELS, seeded
             ragged extents): against its plain version `schur_syrk_ref`
             within a summation-order bound in each mode (X X^T - E,
             X X^T + E in place, X X^T), bitwise equal to a second launch
             and in place to out of place, then timed beside its bound,
             the library product it replaced and its plain version, with
             the executed share of the padded product's flops;
             `signed_panel` (csrc/signed_panel.cu) at the shape of every
             level of the benchmark's signed configuration (SIGNED_LEVELS,
             seeded quasi-definite fronts), f32: its first, a middle and
             its last panel against its plain version `signed_panel_ref`,
             then the panels of one factorization of the level's fronts
             (no trailing updates) timed on the device (torch.profiler) and
             as issued (CUDA events) beside their byte bound at 3.35 TB/s
             and the plain version's wall;
  4. small:  a 15^3 Laplacian solved on the card vs SciPy's direct solve;
  5. slice:  the main path at full size — a 50^3 grid Laplacian under 8
             levels of nested dissection (125,000 dofs): from_coo ->
             factorize -> three solves, with per-level routing, walls,
             refinement sweeps, peak memory and f64 SciPy residuals. Kernel
             launch counts are reset just before and read just after;
  6. profile: the warm slice's per-level factor times (CUDA events) and,
             under torch.profiler, the factor's and one solve's device busy
             time, idle share and top kernels;
  7. regimes: 50^3 forced through each capacity regime (two-piece at every
             non-leaf level; plus bf16 updates; batch-chunked levels; a bf16
             factor offloaded to host memory and solved without pivot
             inverses): factor wall, sweeps, peak memory, residual, and the
             per-level difference of the f32-stored factors from the slice's;
  8. scale:  the capacity slice's main path, 140^3 under 14 levels (2.74M
             dofs), f32, with the default budget and then with a 40 GiB one:
             free memory, budget, the per-level regime plan, host plan
             seconds, factor walls (cold, warm), per level the CUDA-event ms
             and the measured peak beside its estimate, two solves with
             their sweeps and f64 SciPy residuals, `chol_inv` launches
             against the routing rule's count, seconds of the regime plan;
             refactorizations after the solves (pinned segments; two that
             keep the allocator's cache, one that releases it, as factorize()
             does by default) with the allocator's retry count; and
             one warm factorization under torch.profiler (device busy, idle
             share, top kernels); and one block of 8 right-hand sides;
  9. multi:  block right-hand sides on the slice's 50^3 factor: solve of
             [n, k] for k = 1, 16, 128 with per-column f64 SciPy residuals,
             sweeps, engine, loop, synchronized wall, wall per column
             beside a single-RHS solve, peak memory; under torch.profiler
             the k = 16 solve's busy / idle share and top kernels beside
             the k = 1 solve's (run right after the profile phase);
 10. ordering: the user-facing path with no ordering files: from_scipy on
             three gallery matrices (aniso3d 48^3, elasticity 168^2 x 3,
             circuit 13,500 dofs), f32: host ordering seconds, the chosen
             candidate (ND or MD), per-level shapes and routing, chol_inv
             launches against the routing rule, factor and solve walls, a
             block solve, f64 residuals; then update_values with a seeded
             SPD-preserving perturbation -> factorize (the regime plan is
             reused) -> solve against the new matrix, and logdet against
             the port's own f64 factor on the CPU. Every ordering must run
             on the native host core (`ordering_info["engine"]`), its
             seconds printed beside the Python engine's on the same
             matrices; then circuit at scale 1 ordered by both engines
             (identical dofs and clusters), `nd_order` of the aniso3d graph
             at 1 thread and at the default (identical), and the 140^3
             pattern ordered alone at 14 levels (seconds, symbolic FLOPs
             of its permutation beside the geometric ordering's) and at
             the automatic depth;
 11. cli:    a 30^3 problem written to files and run through
             `python -m cholesky_tpu_torch.cli` as a subprocess on the card
             (-o, -m, --profile, --save-factor, --inv-diag, -d; then
             --load-factor): exit codes, the SOLVE residual, the solution
             file against SciPy, FACTOR_SLAB lines exactly on the
             kernel-routed levels, the diag(A^-1) file against refined
             solves of unit vectors, the -d log's op lines against the
             schedule computed in process, both process walls beside the
             Python engine's; in process, read_coo of the matrix and
             write_coo of the factor file, native beside Python (the same
             bytes);
 12. selinv: selected inversion, gradients and sampling on the slice's
             50^3 f32 factor: inv_diag wall (cold, warm) and peak memory
             beside the `regimes.selinv_bytes` estimate; inv_diag at 64
             seeded dofs and inv_entries at 1,000 seeded entries of the
             pattern against refined block solves of unit vectors (each
             column at the residual contract); logdet_grad over every
             entry (wall with its host part), quadform_grad, solve_grad;
             sample at k = 1 and 64 and whiten(sample(z)) against z. The
             same inv_diag check runs on the ordering phase's aniso3d
             solver, and the scale phase's 140^3 solver must refuse
             inv_diag (BudgetError, nothing allocated);
 13. family: factorize_many at 50^3 L8 for K = 8 and 16 (a seeded
             scale-and-shift family): walls cold and warm beside K
             sequential update_values + factorize(), peak beside the
             family plan's estimate, chol_inv launches against the routing
             rule at the folded batch K 2^lvl, a solve of [K, n]
             right-hand sides and of one shared one with per-system f64
             SciPy residuals, and each system's logdet against the single
             solver's after update_values.
 14. qd:     the quasi-definite LDL^T path at 50^3 L8, f32: the grid's
             matrix with a seeded 40% of its diagonal signs flipped (|diag|
             + 0.5), from_coo with signs=: factor walls cold and warm beside
             the SPD slice's warm factor in the same run, per-level
             CUDA-event ms and peak beside the qd plan's estimate, the
             factor's kernel launches and idle share under torch.profiler,
             chol_inv launches (must be 0), three solves and a [n, 16] block
             with sweeps and f64 SciPy residuals, slogdet's sign and
             inertia against the signature, log|det| against the port's
             own f64 signed factor on the CPU; then a KKT system [[H, B^T],
             [B, -C]] (H the 24^3 grid Laplacian, B a seeded constraint
             block coupling grid neighbours, C diagonal; 17,280 dofs)
             through from_scipy: ordering seconds, factor wall, residuals,
             inertia (n1, n2, 0);
     mixed:  the benchmark's hybrid u-p elasticity (`elast_q1p0_48`, Q1
             displacements and one pressure a brick, nu = 0.4999) at ne 16
             (17,968 dofs, 10 levels) through its operator's `build`
             (`from_coo(..., signs=)`), f32 at IEEE products: factor walls
             cold and warm, the signed factorization's panels and columns
             (`factor_stats`) beside the plan's padded widths and one
             `signed_panel` launch a panel, the warm
             factor's kernel launches and idle share under torch.profiler,
             three refined solves against the operator's f64 reference
             (sweeps, residual), one unrefined application's backward
             error beside the configuration's `factor_eta` limit, inertia;
 15. companions: on the slice's 50^3 f32 factor: schur_complement,
             condense_rhs -> a dense NumPy solve -> expand_solution against
             a refined solve; solve_updated with 16 seeded unit columns
             (residual against A + U U^T) and logdet_updated against a
             second solver's logdet after update_values; solve_perturbed
             (PCG iterations, residual) beside update_values + factorize +
             solve; eigsh smallest (k = 6) and largest (k = 1) against the
             exact Dirichlet spectrum 4 sum sin^2(i pi / 102); condest by
             Lanczos against the exact lambda_max / lambda_min and by power
             iteration; synchronized walls of each.
 16. debug:  the 20^2 L5 problem (the reference's lapl_400x400 shape)
             through the CLI on the card with `--dtype float64 -d DIR
             --debug-dumps -m factored.mtx -b B.mtx`, then
             `verify.replay.debug_factor` at 1e-10 over its log, dumps and
             factor file: dumps, seconds. Then the native core's call
             counts: every ordering, fill analysis and matrix file read or
             written in this process ran natively.
 17. precision: the matmul-precision ladder (`precision=`; on the card
             TF32 or IEEE float32 cuBLAS products). On the slice's 50^3
             solver (after the companions) and the scale phase's 140^3
             solver (default budget, after that phase), for AUTO,
             "highest", "high" and "default": factorize(precision=) twice,
             the resolved rung, the flag before, inside the level loop and
             after (restored), factor walls, two solves (and a [n, 16]
             block at 50^3) with sweeps and f64 SciPy residuals at the
             contract, chol_inv launches against the routing rule (counts
             set to 0 before each rung); at 50^3 the solve's apply rung A/B
             (`demote_apply` off, on, on, off); the AUTO crossover (warm
             factor + one solve, "highest" against "default") at 50^3,
             140^3 and on aniso3d x4. Then, on their own: a batched
             [8192, 128, 128] f32 GEMM under each flag (time, bound, error
             against f64: TF32 must be faster and coarser), chol_inv at the
             140^3 batches bit-identical under both flags, the library pair
             (cholesky_ex, solve_triangular) under both flags, and
             factor_slab [128, 1440, 864] under both beside its bounds.
 18. mesh:   after the precision phase, before the scale phase:
             `parallel.mesh.make_mesh` of 4 slots over the machine's cards
             round robin: 4 distinct cards, or logical slots sharing fewer
             (then `scaling_figure` is false). 50^3 L8
             f32 at the AUTO rung: the per-level path (slot-sharded 7-2,
             row groups at 1, the root on the first slot), factor walls
             cold and warm, each slot's assembly on its device alone, one
             more factorization with per-level CUDA-event ms (after the
             launches are read), per level the relative difference from the
             mesh-free factor, the root level's ms forced through the 1-D
             collective scheme, per slot and level the stored bytes under
             `regimes.slot_bytes`, two solves with sweeps and f64 SciPy
             residuals, chol_inv launches against the rule times the
             slots; a 24^3 L6 f64 factor_coo of a mesh solver against the
             mesh-free one (1e-12); a K = 8 family on the mesh (per-system residuals,
             launches); the quasi-definite 50^3 system on the mesh
             (residual, exact inertia); then the 1-D and 2-D collective
             Cholesky of an [8192, 8192] f32 SPD matrix over 8 slots
             against cuSOLVER's f64 factor: error, wall, bytes between
             slots, beside cuSOLVER's f32 wall.
 19. oracle: the panel oracle engine (`verify.oracle.PanelsOracle`, one
             POTRF / TRSM / SYRK per level over full ancestor-path panels)
             on the card: at 24^3 L6 f64 its factor_dense against the
             production solver's and SciPy's Cholesky of the permuted
             matrix (max abs difference <= 1e-10); at 50^3 L8 f64 its
             factorize walls (cold, warm) and their parts (host assembly,
             upload, level loop), solve wall, peak memory beside the panel
             bytes (and the f64 panel bytes the 140^3 L14 plan would
             need), f64 SciPy residual (<= 1e-10), distance from
             the refined f32 production solve (<= 1e-9 relative), and
             2 sum log diag of its pivot blocks against the production f64
             factor's logdet() (<= 1e-9 relative); `profile_factor` on
             the same f64 panels (per level the POTRF / TRSM / GEMM
             microseconds and their sum beside the level loop's seconds,
             the peak memory; the record sequence against the plan's, the
             caller's panels unchanged); at 50^3 L8 f32 its factorize
             walls and parts and unrefined residual beside the production
             f32 factor's (printed only).
 20. examples: the six scripts of examples/torch run in process
             (runpy, stdout captured): gp_variance --dim 512 --levels 10,
             gmrf_learn --dim 256 --levels 9, kkt_solve --nx 300 --m 600,
             modal_analysis --nx 256 --k 6, fem_gallery --scale 4 and
             solve_mtx on the 50^3 matrix written to a temporary .mtx:
             wall, chol_inv launches against the routing rule over every
             factorization the script ran, peak memory, its output, and
             the output properties tests/test_examples.py asserts
             (residuals <= 1e-10, KKT <= 1e-8 with its inertia, coverage
             >= 80%, pencil residual <= 1e-6, a printed tau).
 21. tools:  the seven profiling tools of tools/torch run in process at
             their defaults (50^3 L8 where they build a problem): each
             one's table, JSON line and wall. bench_front_kernels (the
             kernel route, the composite it replaced and cuSOLVER + TRSM
             at 17 level classes, at both rungs; kernel and composite
             timed in three turns) must agree with the
             library within SLAB_REL_TOL (TF32: SLAB_TF32_REL_TOL) and
             launch factor_slab once and chol_inv once a panel at every
             class with W >= 128; prof_solve_levels prints the
             per-level solve steps' sum beside the whole chain's wall;
             prof_solve, exp_solve_profile and prof_scatter print their
             stages; bench_matvec's three ELL layouts must agree;
             nd_quality's rows must equal symbolic/quality.py's functions
             called directly.
 22. bench:  tools/torch/bench.py in process at its defaults (50^3 L8:
             factor_gflops at the TF32 "default" chain and the AUTO
             production row, with the peak, fixture, irregular 44^3 x 3 and
             warm-start rows), then --measure-baseline --quick and
             --kernel-rates: no row failed or missed 1e-10, each first
             factorization's peak under its plan's estimate, useful FLOPs
             equal schedule_flops called directly, each row's launches of
             one warm factorization (the primary's at both rungs) equal the
             routing rule's over the row's own plan, the warm-start process
             returned 0; one line with the three JSON results and the
             phase's wall.
Every phase line carries the card's name and power limit (`card`).
Then the kernels' summary line and, last, {"ok": true, "device": ...}.

Exits nonzero, without the last line, when there is no CUDA device, when
the package cannot be imported, or when any phase fails.
"""

import ast
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

TOL = 1e-10                        # the solver's relative-residual contract
L_REL_TOL = 1e-4                   # kernel vs plain, L (f32)
INV_REL_TOL = 1e-3                 # kernel vs plain, inv(L) (f32)
F64_REL_TOL = 2e-6                 # kernel vs f64 reference, L and inv(L)
SLAB_REL_TOL = 1e-4                # factor_slab, kernel vs plain (f32)
# ... at TF32: both round their products to TF32 (10 significand bits),
# in different orders
SLAB_TF32_REL_TOL = 5e-3
# factor_slab checked beside the shoot-out's classes: batches whose
# slab_diag clusters are 7, 6, 5 and 3 CTAs wide on a 132-SM H100
SLAB_CLUSTER_CLASSES = ((9, 700, 512), (11, 1440, 864), (13, 600, 512),
                        (20, 1008, 384))
# (level, B, F, W, K, mean rows of a child's update that land in the
# front) of every level with children of the benchmark's configurations,
# from the port's plan of each (`cholbench/configs`); K is the update's
# padded width
FRONT_LEVELS = {
    "lapl7_50": (
        (0, 1, 2504, 2504, 2504, 2500), (1, 2, 3760, 1256, 2504, 2450),
        (2, 4, 3136, 632, 1880, 1801), (3, 8, 2512, 632, 1856, 1467),
        (4, 16, 2160, 304, 1344, 998), (5, 32, 1488, 144, 864, 621),
        (6, 64, 1008, 144, 576, 429), (7, 128, 648, 72, 360, 263),
        (8, 256, 400, 40, 216, 152), (9, 512, 256, 40, 144, 94),
        (10, 1024, 168, 24, 96, 52)),
    "elast_q1_64": (
        (0, 1, 12480, 12480, 12480, 12480), (1, 2, 18624, 6144, 12480, 12480),
        (2, 4, 15552, 3072, 9512, 9410), (3, 8, 12584, 3072, 9656, 7826),
        (4, 16, 11192, 1536, 7296, 5474), (5, 32, 8064, 768, 5008, 3531),
        (6, 64, 5776, 768, 3424, 2534), (7, 128, 3808, 384, 2224, 1662),
        (8, 256, 2416, 192, 1360, 1033), (9, 512, 1552, 192, 952, 709),
        (10, 1024, 1048, 96, 640, 456), (11, 2048, 688, 48, 400, 281),
        (12, 4096, 448, 48, 288, 191), (13, 8192, 312, 24, 208, 123)),
}
# The Schur update of every level with a boundary of the benchmark's two
# configurations (lvl, B, K, W, least m_b, least p_b): the padded boundary
# K and pivots W of `build_frontal_plan`, the least front extents of the
# configuration's fronts (`cholbench.yardstick.front_sizes`)
SCHUR_LEVELS = {
    "lapl7_50": (
        (1, 2, 2504, 1256, 2500, 1200), (2, 4, 2504, 632, 2400, 576),
        (3, 8, 1880, 632, 1728, 576), (4, 16, 1856, 304, 1104, 264),
        (5, 32, 1344, 144, 649, 121), (6, 64, 864, 144, 363, 121),
        (7, 128, 576, 72, 231, 55), (8, 256, 360, 40, 135, 25),
        (9, 512, 216, 40, 75, 25), (10, 1024, 144, 24, 45, 10),
        (11, 2048, 96, 56, 24, 20)),
    "elast_q1_64": (
        (1, 2, 12480, 6144, 12480, 6144), (2, 4, 12480, 3072, 12480, 3072),
        (3, 8, 9512, 3072, 9312, 2976), (4, 16, 9656, 1536, 6048, 1395),
        (5, 32, 7296, 768, 3651, 675), (6, 64, 5008, 768, 2163, 675),
        (7, 128, 3424, 384, 1419, 315), (8, 256, 2224, 192, 867, 147),
        (9, 512, 1360, 192, 507, 147), (10, 1024, 952, 96, 327, 63),
        (11, 2048, 640, 48, 195, 27), (12, 4096, 400, 48, 111, 27),
        (13, 8192, 288, 24, 69, 9), (14, 16384, 208, 48, 39, 9)),
}
# (level, B, W) of every level of the benchmark's signed configuration,
# from the port's plan of `cholbench/configs/elast_q1p0_48.json`: B fronts
# of W padded pivot columns, 513 panels of at most 32 columns in all
SIGNED_LEVELS = {
    "elast_q1p0_48": tuple((lvl, 1 << lvl, W) for lvl, W in enumerate((
        7056, 3456, 1728, 1728, 864, 432, 432, 216, 112, 112, 56, 32, 32,
        64))),
}
# signed_panel against its plain version (f32, each part against its own
# largest entry): both IEEE, the 32-wide solve summed in another order
SIGNED_REL_TOL = 2e-5
SMALL_REL_TOL = 1e-8               # 15^3 solution vs SciPy's (f64)
# f32-stored regime factors vs the default (square, f32) factor, relative
# to the level's largest entry: summation order only (two-piece, chunks),
# and bf16 storage of the child updates (8 significand bits, ~4e-3 per
# rounding, through the level chain)
REGIME_F32_TOL = 1e-4
REGIME_BF16_TOL = 5e-2
SCALE = ((140, 140, 140), 14)      # the JAX package's largest verified run
SCALE_SMALL_BUDGET = 40 << 30      # half the card: forces two-piece levels
LOGDET_REL_TOL = 1e-6              # f32 factor's logdet vs the f64 CPU factor's
MULTI_K = (1, 16, 128)             # block widths of the multi phase
# (gallery name, scale) of the ordering phase: a 3-D anisotropic grid
# (110,592 dofs), 2-D 3-component elasticity (84,672) and a power-law
# circuit graph (13,500: under md_small, so the minimum-degree candidate
# runs)
ORDERING = (("aniso3d", 4), ("elasticity", 12), ("circuit", 3))
CLI_PROBLEM = ((30, 30, 30), 7)
# f32 selected inversion against refined unit-vector solves, relative per
# entry for the diagonal and to the largest entry for inv_entries: f32 vs
# f64 selected inversion on the CPU gave 1.2-2.4e-6 from 16^3 to 32^3 and
# on aniso3d 12^3 / 24^3, slowly growing with the size
SELINV_F32_TOL = 1e-4
SAMPLE_F32_TOL = 1e-4              # whiten(sample(z)) against z, f32
FAMILY_K = (8, 16)
# chol_inv launches per factorization of a 50^3 L8 family by the routing
# rule at the folded batch K 2^lvl: levels 7-3 (7 + 2 + 2 + 3 + 5) at K = 8,
# and level 2 (5 more) at K = 16
FAMILY_LAUNCHES = {8: 19, 16: 24}
FAMILY_LOGDET_TOL = 1e-6           # a family system's f32 logdet vs single
QD_NEG_FRAC = 0.4                  # diagonal signs flipped in the qd phase
QD_BLOCK_K = 16
KKT_GRID = 24                      # H: the KKT_GRID^3 grid Laplacian
SCHUR_REL_TOL = 1e-4               # condensed round trip vs a refined solve
EIG_REL_TOL = 1e-8                 # eigenvalues vs the exact spectrum
COND_REL_TOL = 1e-6                # condest(lanczos) vs the exact kappa
WOODBURY_K = 16
# the port's Python ordering engine on the ordering phase's matrices and
# the CLI phase's process walls with it, measured by this script on an
# NVIDIA H100 80GB HBM3 host at 700 W before the native core was wired in
PYTHON_ORDERING_S = {"aniso3d": 13.8, "elasticity": 91.8, "circuit": 33.2}
PYTHON_CLI_WALL_S = (41.6, 18.1)
ENGINE_PARITY = ("circuit", 1)     # ordered by both engines
SCALE_ORDER_LEVELS = 14            # the 140^3 pattern ordered alone
DEBUG_PROBLEM = ((20, 20), 5)      # the reference's lapl_400x400 shape
DEBUG_TOL = 1e-10                  # debug_factor's rtol / atol (f64)
# the matmul-precision ladder: AUTO (None), then each rung the card has
# (IEEE f32, then TF32 under two names)
PRECISION_RUNGS = (None, "highest", "high", "default")
PRECISION_BLOCK_K = 16
CROSSOVER = ("aniso3d", 4)         # the AUTO crossover's gallery matrix
GEMM_B = 8192                      # the 140^3 level-13 batch of fronts
CHOL_INV_140 = (8192, 1024, 512, 256, 128)   # its batches at 140^3 L14
# a TF32 product keeps 10 of f32's 23 significand bits: its error against
# an f64 product must exceed the IEEE product's by this factor, or the flag
# did not take effect
TF32_ERR_RATIO = 10.0
MESH_SLOTS = 4                     # slots of the mesh phase's solver
MESH_ROOT_SLOTS = 8                # slots of its collective Cholesky
MESH_ROOT_F = 8192                 # ... of an [F, F] SPD matrix
MESH_FACTOR_REL = 1e-5             # mesh factor vs the mesh-free one (f32)
ROOT_REL_TOL = 1e-5                # collective f32 factor vs cuSOLVER f64
SEED = 0                           # random blocks, slabs and right-hand sides


CARD = None                        # nvidia-smi's name, power limit
# factor_slab launches of each main path's run, for the kernels line
SLAB_BY_PATH = {}


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "card": CARD}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_median(fn, batches: int = 7, iters: int = 20) -> float:
    """Median over batches of the mean device time of fn() in ms: one batch
    can land in a slower mode of the card's memory system."""
    times = sorted(cuda_ms(fn, iters=iters) for _ in range(batches))
    return times[len(times) // 2]


def slab_library(a, W: int):
    """The library's partial factorization of slab a [B, F, W]:
    `cholesky_ex` of the pivot block, `solve_triangular` of the boundary
    strip (X = A_bw L^-T)."""
    import torch

    L, _ = torch.linalg.cholesky_ex(a[:, :W, :])
    X = torch.linalg.solve_triangular(L, a[:, W:, :].transpose(1, 2),
                                      upper=False)
    return L, X.transpose(1, 2)


def fp32_flag() -> str:
    """cuBLAS's float32 math: the flag the precision ladder sets."""
    import torch

    return torch.backends.cuda.matmul.fp32_precision


def rel_err(x, ref) -> float:
    return float((x.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_device():
    import torch

    from cholesky_tpu_torch.numeric.profile import card

    global CARD
    CARD = card("cuda:0")
    print(CARD, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "cuda_matmul_fp32_precision": fp32_flag(),
          "fp32_precision": torch.backends.fp32_precision})


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from cholesky_tpu_torch.kernels import build

    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(build.KERNELS)) as pool:
        list(pool.map(build.build, build.KERNELS))
    seconds = time.perf_counter() - t0
    info = {name: {"nvcc_s": round(build.BUILD_INFO[name]["seconds"], 3),
                   "cached": build.BUILD_INFO[name]["cached"],
                   "ptxas": [ln.strip() for ln in
                             build.BUILD_INFO[name]["ptxas"].splitlines()
                             if "Used" in ln or "spill" in ln]}
            for name in build.KERNELS}
    for name in build.KERNELS:
        build.load(name)                # the libraries just built
    emit({"phase": "build", "seconds": round(seconds, 3), "kernels": info,
          "native": native_build()})


def native_build() -> dict:
    """Build the native host core with g++ (nothing has loaded it yet);
    fails when it cannot be built."""
    from cholesky_tpu_torch.native import build, ext

    t0 = time.perf_counter()
    check(ext.available(), f"the native host core did not build: "
          f"{ext.build_error()}")
    gxx = subprocess.run([build.compiler(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    return {"seconds": time.perf_counter() - t0,
            "gxx_s": build.BUILD_INFO["seconds"],
            "cached": build.BUILD_INFO["cached"],
            "library": os.path.relpath(build.BUILD_INFO["path"],
                                       os.path.dirname(os.path.abspath(
                                           __file__))),
            "gxx": gxx.stdout.splitlines()[0]}


def check_chol_inv(x):
    """chol_inv on blocks x against its plain version on the same blocks
    and against an f64 reference: the relative errors, the largest absolute
    difference from the plain version; fails past the tolerances."""
    import torch

    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    l_k, m_k = hk.chol_inv(x)
    l_p, m_p = hk.chol_inv_ref(x)
    l_64, m_64 = hk.chol_inv_ref(x.double())
    torch.cuda.synchronize()
    errs = {"L_vs_f64": rel_err(l_k, l_64), "inv_vs_f64": rel_err(m_k, m_64),
            "plain_L_vs_f64": rel_err(l_p, l_64),
            "plain_inv_vs_f64": rel_err(m_p, m_64),
            "L_vs_plain": rel_err(l_k, l_p), "inv_vs_plain": rel_err(m_k, m_p),
            "max_abs_err": float(max((l_k - l_p).abs().max(),
                                     (m_k - m_p).abs().max()))}
    shape = list(x.shape)
    check(bool(torch.isfinite(l_k).all() and torch.isfinite(m_k).all()),
          f"chol_inv produced non-finite values at {shape}")
    check(errs["L_vs_plain"] <= L_REL_TOL,
          f"chol_inv L differs from plain at {shape}: {errs['L_vs_plain']}")
    check(errs["inv_vs_plain"] <= INV_REL_TOL,
          f"chol_inv inv(L) differs from plain at {shape}: "
          f"{errs['inv_vs_plain']}")
    check(errs["L_vs_f64"] <= F64_REL_TOL
          and errs["inv_vs_f64"] <= F64_REL_TOL,
          f"chol_inv differs from the f64 reference at {shape}: "
          f"{errs['L_vs_f64']}, {errs['inv_vs_f64']}")
    return errs


def phase_kernel():
    import torch

    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g = torch.randn(300, 128, 128, generator=gen, device=dev)
    eye = torch.eye(128, device=dev)
    d = g @ g.transpose(1, 2) / 128 + 0.5 * eye
    d[-1, 72:, :] = 0.0                 # one identity-padded block
    d[-1, :, 72:] = 0.0
    d[-1, 72:, 72:] = eye[72:, 72:]
    errs = check_chol_inv(d)
    emit({"phase": "kernel", "name": "chol_inv", "shape": [300, 128, 128],
          **errs, "tol_L": L_REL_TOL, "tol_inv": INV_REL_TOL,
          "tol_vs_f64": F64_REL_TOL})
    max_abs = errs["max_abs_err"]

    # the shapes the main paths launch it with: 50^3 levels 7, 6, 5 and
    # 140^3 levels 13, 10, 9, 8 (and 7, B = 128); the 50^3 family's
    # [2048|1024|512|256|128|64] at K = 8 and 16; a slot of the mesh
    # phase's 4-slot 50^3 at [32|16|8]; each checked against its plain
    # version and the f64 reference, then timed
    def library(x):
        L, _ = torch.linalg.cholesky_ex(x)
        return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)

    timed = {}
    big = torch.randn(8192, 128, 128, generator=gen, device=dev)
    big = big @ big.transpose(1, 2) / 128 + 0.5 * eye
    for B in (128, 64, 32, 16, 8, 8192, 2048, 1024, 512, 256):
        x = d[:B].contiguous() if B <= 300 else big[:B].contiguous()
        errs = check_chol_inv(x)
        max_abs = max(max_abs, errs["max_abs_err"])
        bound_ms, bound_by = hk.chol_inv_bound(B)
        ms = cuda_ms_median(lambda: hk.chol_inv(x))
        timed[B] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "share": bound_ms / ms,
                    "plain_ms": cuda_ms_median(lambda: hk.chol_inv_ref(x)),
                    "library_ms": cuda_ms_median(lambda: library(x)),
                    **errs}
        emit({"phase": "kernel", "name": "chol_inv", "timed_shape":
              [B, 128, 128], **timed[B]})
        del x
    del big
    emit({"phase": "kernel", "name": "chol_inv",
          "ms_B32_over_B128": timed[32]["ms"] / timed[128]["ms"]})
    return {**timed[128], "max_abs_err": max_abs,
            "per_shape": {f"[{B},128,128]": t for B, t in timed.items()}}


def slab_tool():
    """tools/torch/bench_front_kernels.py's globals (its level classes and
    slab maker), its main not run."""
    import runpy

    syspath = list(sys.path)
    try:
        return runpy.run_path(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tools", "torch",
            "bench_front_kernels.py"), run_name="tool")
    finally:
        sys.path[:] = syspath


def phase_slab_kernel():
    """factor_slab (the kernels of csrc/factor_slab.cu) on slabs with a
    known partial factor (bench_front_kernels' `known_slab`) at every
    level class of the shoot-out and at SLAB_CLUSTER_CLASSES, at both
    rungs: against its plain version `factor_slab_ref` on the same slab
    and against the known factor, each within SLAB_REL_TOL (IEEE) or
    SLAB_TF32_REL_TOL (TF32) by `slab_err` (each part of the result
    relative to its own largest entry); exact zeros above the diagonal; a
    repeated call bit-identical. Then at the 50^3 leaf class under
    "highest" its time beside the plain version, the composite it replaced
    (`factor_slab_ref(block_fn=chol_inv)`), the library pair and its
    bound."""
    import torch

    from cholesky_tpu_torch.numeric import hopper_kernels as hk
    from cholesky_tpu_torch.numeric.precision import precision_ctx

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    tool = slab_tool()
    err_of = tool["slab_err"]
    rows, max_abs = [], 0.0
    for B, F, W in [*tool["CLASSES"], *SLAB_CLUSTER_CLASSES]:
        a, exact = tool["known_slab"](B, F, W, gen, dev)
        row = {"shape": [B, F, W]}
        for rung, tol in (("highest", SLAB_REL_TOL),
                          ("tensorfloat32", SLAB_TF32_REL_TOL)):
            with precision_ctx(rung):
                k = hk.factor_slab(a, W)
                again = hk.factor_slab(a, W)
                p = hk.factor_slab_ref(a, W)
            torch.cuda.synchronize()
            errs = {"vs_plain": err_of(k, p, W),
                    "vs_known": err_of(k, exact, W),
                    "plain_vs_known": err_of(p, exact, W)}
            diff = float((k - p).abs().max())
            where = f"factor_slab [{B},{F},{W}] at {rung}"
            check(bool(torch.isfinite(k).all()), f"{where}: non-finite")
            for what in ("vs_plain", "vs_known"):
                check(errs[what] <= tol, f"{where}: {what} {errs[what]} > "
                      f"{tol}")
            check(bool((torch.triu(k[:, :W], 1) == 0).all()),
                  f"{where}: nonzero above the diagonal")
            check(bool(torch.equal(k, again)), f"{where}: not reproducible")
            row[rung] = {**errs, "max_abs_err": diff, "tol": tol}
            max_abs = max(max_abs, diff)
            del k, again, p
        rows.append(row)
        del a, exact
    emit({"phase": "kernel", "name": "factor_slab", "checks": rows})

    B, F, W = tool["CLASSES"][0]
    a, _ = tool["known_slab"](B, F, W, gen, dev)
    with precision_ctx("highest"):
        out = {"ms": cuda_ms(lambda: hk.factor_slab(a, W), iters=5),
               "plain_ms": cuda_ms(lambda: hk.factor_slab_ref(a, W), iters=5),
               "composite_ms": cuda_ms(lambda: hk.factor_slab_ref(
                   a, W, block_fn=hk.chol_inv), iters=5),
               "library_ms": cuda_ms(lambda: slab_library(a, W), iters=5)}
    out["bound_ms"], out["bound_by"] = hk.factor_slab_bound(B, F, W,
                                                            hk.FP32_FLOPS)
    out["executed_tflops"] = hk.factor_slab_flops(B, F, W) / out["ms"] / 1e9
    emit({"phase": "kernel", "name": "factor_slab", "timed_shape": [B, F, W],
          "precision": "highest", **out})
    return {**out, "max_abs_err": max_abs, "timed_shape": [B, F, W]}


def front_inputs(B, F, W, K, m, gen, dev):
    """Seeded f32 pivot slabs [B, F, W], child updates [2B, K, K] and maps
    [2B, F]: each child's first m update rows land on sorted random rows of
    the parent, the others nowhere (K)."""
    import torch

    piv = torch.randn(B, F, W, generator=gen, device=dev)
    U = torch.randn(2 * B, K, K, generator=gen, device=dev)
    pos = torch.rand(2 * B, F, generator=gen, device=dev).argsort(1)
    pos = pos[:, :m].sort(1).values
    inv = torch.full((2 * B, F), K, dtype=torch.int64, device=dev)
    inv.scatter_(1, pos, torch.arange(m, device=dev).expand(2 * B, m)
                 .contiguous())
    return piv, U, inv


def phase_form_front():
    """form_front (csrc/form_front.cu) at every level shape of FRONT_LEVELS:
    bitwise against `form_front_ref` and a second launch, the sentinel row
    zero; its time beside the least the card could take (each front element
    written once, the slab, the landing update entries and the maps read
    once, at 3.35 TB/s) and the plain version's, per level and summed per
    configuration."""
    import torch

    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)

    summary = {}
    for cfg, levels in FRONT_LEVELS.items():
        rows = []
        for lvl, B, F, W, K, m in levels:
            piv, U, inv = front_inputs(B, F, W, K, m, gen, dev)
            k = hk.form_front(piv, U, inv, F, W)
            again = hk.form_front(piv, U, inv, F, W)
            p = hk.form_front_ref(piv, U, inv, F, W)
            torch.cuda.synchronize()
            where = f"form_front {cfg} L{lvl} [{B}, {F}, {W}], K {K}"
            check(bool(torch.equal(k, p)), f"{where}: differs from plain")
            check(bool(torch.equal(k, again)), f"{where}: not reproducible")
            check(not bool(k[:, F].any()), f"{where}: sentinel row not 0")
            del again, p
            nbytes = 4 * (B * (F + 1) * F + B * F * W + 2 * B * m * m
                          + 2 * B * F * 2)
            bound_ms = nbytes / hk.HBM_BYTES_PER_S * 1e3
            row = {"level": lvl, "shape": [B, F, W, K, m], "bytes": nbytes,
                   "bound_ms": bound_ms,
                   "ms": cuda_ms(lambda: hk.form_front(piv, U, inv, F, W),
                                 iters=5, warmup=1),
                   "plain_ms": cuda_ms(lambda: hk.form_front_ref(
                       piv, U, inv, F, W), iters=3, warmup=1)}
            row["share"] = bound_ms / row["ms"]
            emit({"phase": "kernel", "name": "form_front", "config": cfg,
                  **row})
            rows.append(row)
            del piv, U, inv, k
            torch.cuda.empty_cache()
        tot = {key: sum(r[key] for r in rows)
               for key in ("bytes", "bound_ms", "ms", "plain_ms")}
        tot["share"] = tot["bound_ms"] / tot["ms"]
        emit({"phase": "kernel", "name": "form_front", "config": cfg,
              "levels": len(rows), "total": tot})
        summary[cfg] = tot
    return summary


def signed_inputs(B, W, gen, dev):
    """Seeded f32 quasi-definite fronts [B, W, W] and their signature:
    off-diagonal entries of variance 0.5 / W, the diagonal s (1 + W^0.5),
    so that each sign block is diagonally dominant and every panel's
    diagonal block factors alone."""
    import torch

    s = torch.where(torch.rand(B, W, generator=gen, device=dev) < 0.4,
                    -1.0, 1.0)
    a = torch.randn(B, W, W, generator=gen, device=dev)
    a = (a + a.transpose(1, 2)).mul_(0.5 / W ** 0.5)
    a.diagonal(dim1=1, dim2=2).copy_(s * (1 + W ** 0.5))
    return a, s


def signed_panels(fn, a, s, xbuf, *extra):
    """fn(work, s, c0, c1, x, *extra) over the panels of one blocked
    factorization of a clone of the fronts a, with no trailing update
    between them (every panel reads the fronts' own values): the clone is
    made first, then the panels are timed by CUDA events (ms)."""
    import torch

    B, W, _ = a.shape
    work = a.clone()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for c0 in range(0, W, 32):
        c1 = min(c0 + 32, W)
        fn(work, s, c0, c1,
           xbuf[:B * (W - c1) * (c1 - c0)].view(B, W - c1, c1 - c0), *extra)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_signed_panel():
    """signed_panel (csrc/signed_panel.cu) at every level shape of
    SIGNED_LEVELS, f32: its first, a middle and its last panel against
    `signed_panel_ref` (each part against its own largest entry), the
    tickets left zero; then all the panels of one blocked factorization of
    the level's fronts: the device time of the kernels (torch.profiler),
    the wall of the panels as the host issues them (CUDA events, median of
    three), the least the card could take (each panel read and written
    once, X written once, at 3.35 TB/s) and the plain version's wall (the
    column loop, solve_triangular and the sign scale that the level loop
    ran before), per level and summed."""
    import torch

    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    summary = {}
    for cfg, levels in SIGNED_LEVELS.items():
        rows = []
        for lvl, B, W in levels:
            a, s = signed_inputs(B, W, gen, dev)
            w0 = min(32, W)
            xbuf = torch.empty(B * (W - w0) * w0, device=dev)
            tickets = torch.zeros(B, dtype=torch.int32, device=dev)
            where = f"signed_panel {cfg} L{lvl} [{B}, {W}, {W}]"
            err = 0.0
            for c0 in sorted({0, (W // 64) * 32, (W - 1) // 32 * 32}):
                c1 = min(c0 + 32, W)
                k, p = a.clone(), a.clone()
                xk = torch.empty(B, W - c1, c1 - c0, device=dev)
                xp = torch.empty_like(xk)
                hk.signed_panel(k, s, c0, c1, xk, tickets)
                hk.signed_panel_ref(p, s, c0, c1, xp)
                torch.cuda.synchronize()
                for got, want in ((k[:, c0:c1, c0:c1].tril(),
                                   p[:, c0:c1, c0:c1].tril()),
                                  (k[:, c1:, c0:c1], p[:, c1:, c0:c1]),
                                  (xk, xp)):
                    if want.numel():
                        e = rel_err(got, want)
                        check(e <= SIGNED_REL_TOL, f"{where} panel {c0}: "
                              f"{e} from plain")
                        err = max(err, e)
                check(not bool(tickets.any()), f"{where}: tickets not 0")
                del k, p, xk, xp
            kernel = lambda: signed_panels(hk.signed_panel, a, s, xbuf,
                                           tickets)
            kernel()                                        # warm
            prof = profiled(kernel)
            walls = sorted(kernel() for _ in range(3))
            plain = lambda: signed_panels(hk.signed_panel_ref, a, s, xbuf)
            if not rows:
                plain()                                     # warm
            nbytes = hk.signed_panel_bytes(B, W)
            bound_ms = nbytes / hk.HBM_BYTES_PER_S * 1e3
            row = {"level": lvl, "shape": [B, W], "panels": -(-W // 32),
                   "bytes": nbytes, "bound_ms": bound_ms,
                   "device_ms": sum(r["ms"] for r in prof["top"]
                                    if "signed_panel" in r["kernel"]),
                   "launches": sum(r["count"] for r in prof["top"]
                                   if "signed_panel" in r["kernel"]),
                   "wall_ms": walls[1], "plain_ms": plain(),
                   "max_rel_err": err}
            check(row["launches"] == row["panels"],
                  f"{where}: {row['launches']} launches for "
                  f"{row['panels']} panels")
            row["share"] = bound_ms / row["device_ms"]
            emit({"phase": "kernel", "name": "signed_panel", "config": cfg,
                  **row})
            rows.append(row)
            del a, s, xbuf, tickets
            torch.cuda.empty_cache()
        tot = {key: sum(r[key] for r in rows)
               for key in ("panels", "bytes", "bound_ms", "device_ms",
                           "wall_ms", "plain_ms")}
        tot["share"] = tot["bound_ms"] / tot["device_ms"]
        tot["max_rel_err"] = max(r["max_rel_err"] for r in rows)
        emit({"phase": "kernel", "name": "signed_panel", "config": cfg,
              "levels": len(rows), "total": tot})
        summary[cfg] = tot
    return summary


def schur_inputs(B, K, W, m_min, p_min, gen, dev):
    """Seeded f32 boundary strips X [B, K, W] (the view [:, W:, :] of
    factors [B, W + K, W]), trailing blocks E (the view [:, W:W + K, W:] of
    fronts [B, W + K + 1, W + K]) and extents [B, 2]: m_b uniform on
    [m_min, K] and p_b on [p_min, W], front 0 at (K, W); X zero outside
    each extent, as the level loop's is; E symmetric, as a front is."""
    import torch

    F = W + K
    X = torch.randn(B, F, W, generator=gen, device=dev)[:, W:, :]
    E = torch.randn(B, F + 1, F, generator=gen, device=dev)[:, W:F, W:]
    E.copy_((E + E.transpose(1, 2)) / 2)
    m = torch.randint(m_min, K + 1, (B,), generator=gen, device=dev)
    p = torch.randint(p_min, W + 1, (B,), generator=gen, device=dev)
    m[0], p[0] = K, W
    rows = torch.arange(K, device=dev) < m[:, None]
    X.masked_fill_(~(rows[:, :, None] & (torch.arange(W, device=dev)
                                         < p[:, None])[:, None, :]), 0)
    return X, E, torch.stack([m, p], 1), rows


def schur_err(k, ref, X, E, ext, rows) -> float:
    """The largest |k - ref| inside the extents over its bound: each side
    of an f32 sum of p products lies within gamma_p = p 2^-24 / (1 - p
    2^-24) of |X| |X|^T from the exact one (Higham, Accuracy and Stability
    of Numerical Algorithms, 3.1), and adding E rounds once more; a
    different summation order can move them apart by twice that. Above 1
    fails."""
    import torch

    B, K, _ = X.shape
    step = max(1, (1 << 28) // (K * K))     # fronts a pass: 2 GiB of f64
    worst = 0.0
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        p = ext[sl, 1].double()[:, None, None]
        gamma = p * 2.0 ** -24 / (1 - p * 2.0 ** -24)
        ax = X[sl].abs().double()
        bound = 2 * gamma * (ax @ ax.transpose(1, 2))
        del ax
        bound += 2.0 ** -23 * (ref[sl].double().abs() + E[sl].double().abs())
        ratio = (k[sl].double() - ref[sl].double()).abs().div_(
            bound.clamp_(min=1e-300))
        del bound
        inside = rows[sl, :, None] & rows[sl, None, :]
        worst = max(worst, float(torch.where(inside, ratio, 0).max()))
        del ratio, inside
    return worst


def phase_schur_syrk():
    """schur_syrk (csrc/schur_syrk.cu) at every level shape of SCHUR_LEVELS
    with seeded ragged extents: inside each front's extent within the
    summation-order bound of `schur_err` of `schur_syrk_ref` (U = X X^T - E,
    U = X X^T + E in place, U = X X^T), bitwise equal to a second launch,
    in place equal to out of place; then timed at IEEE in the mode the
    level loop runs it (the leaf level X X^T, the others X X^T - E) beside
    its bound (the level's symmetric work, sum m_b^2 p_b flops, at 67
    TFLOP/s, or X, E's lower triangle and U once at 3.35 TB/s, whichever is
    larger), the library product the port ran before on the same views
    (`torch.baddbmm`, at the leaves `torch.bmm`: the padded full product,
    `library_ms`) and the plain version, with the share of the padded full
    product's flops that its tiles execute."""
    import torch

    from cholesky_tpu_torch.numeric import hopper_kernels as hk
    from cholesky_tpu_torch.numeric.precision import precision_ctx

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    summary = {}
    for cfg, levels in SCHUR_LEVELS.items():
        out = []
        for lvl, B, K, W, m_min, p_min in levels:
            X, E, ext, rows = schur_inputs(B, K, W, m_min, p_min, gen, dev)
            where = f"schur_syrk {cfg} L{lvl} [{B}, {K}, {W}]"

            def same(x, y):
                """x and y equal inside the extents, a pass of fronts at a
                time."""
                step = max(1, (1 << 30) // (K * K))
                return all(bool(torch.equal(
                    x[b0:b0 + step][inside], y[b0:b0 + step][inside]))
                    for b0 in range(0, B, step)
                    for inside in [rows[b0:b0 + step, :, None]
                                   & rows[b0:b0 + step, None, :]])

            with precision_ctx("highest"):
                errs = {}
                for mode, e, sign in (("minus", E, -1.0), ("plus", E, 1.0),
                                      ("none", None, -1.0)):
                    k = hk.schur_syrk(X, e, sign, ext)
                    again = hk.schur_syrk(X, e, sign, ext)
                    check(same(k, again), f"{where} {mode}: not "
                          f"reproducible")
                    del again
                    if mode == "plus":
                        inplace = E.contiguous()
                        hk.schur_syrk(X, inplace, 1.0, ext, out=inplace)
                        check(same(inplace, k), f"{where}: in place differs")
                        del inplace
                    ref = hk.schur_syrk_ref(X, e, sign, ext)
                    errs[mode] = schur_err(
                        k, ref, X, E if e is not None else torch.zeros_like(
                            k), ext, rows)
                    check(errs[mode] <= 1.0, f"{where} {mode}: differs from "
                          f"plain by {errs[mode]} of the bound")
                    del k, ref
                torch.cuda.synchronize()
                m, p = (ext[:, 0].cpu().numpy(), ext[:, 1].cpu().numpy())
                leaf = lvl == levels[-1][0]
                e = None if leaf else E
                flops = float((m.astype(float) ** 2 * p).sum())
                nbytes = 4 * float((m * p + (0 if leaf else m * (m + 1) / 2)
                                    + m * m).sum())
                flops_ms = flops / hk.FP32_FLOPS * 1e3
                bytes_ms = nbytes / hk.HBM_BYTES_PER_S * 1e3
                iters = 3 if B * K * K * W > 1e11 else 10
                row = {
                    "level": lvl, "shape": [B, K, W],
                    "least_extent": [m_min, p_min], "errs": errs,
                    "bound_ms": max(flops_ms, bytes_ms),
                    "bound_by": ("operations" if flops_ms >= bytes_ms
                                 else "bytes"),
                    "mode": "X X^T" if leaf else "X X^T - E",
                    "ms": cuda_ms(lambda: hk.schur_syrk(X, e, -1.0, ext),
                                  iters=iters, warmup=1),
                    "library_ms": cuda_ms(
                        (lambda: torch.bmm(X, X.transpose(1, 2))) if leaf
                        else (lambda: torch.baddbmm(
                            E, X, X.transpose(1, 2), beta=-1.0)),
                        iters=iters, warmup=1),
                    "plain_ms": cuda_ms(lambda: hk.schur_syrk_ref(
                        X, e, -1.0, ext), iters=1, warmup=1),
                    "tile_share": hk.schur_syrk_flops(m, p).sum()
                    / (2.0 * B * K * K * W)}
            row["share"] = row["bound_ms"] / row["ms"]
            row["executed_tflops"] = (hk.schur_syrk_flops(m, p).sum()
                                      / row["ms"] / 1e9)
            row["beats_library"] = row["ms"] < row["library_ms"]
            emit({"phase": "kernel", "name": "schur_syrk", "config": cfg,
                  **row})
            out.append(row)
            del X, E, e, ext, rows
            torch.cuda.empty_cache()
        tot = {key: sum(r[key] for r in out)
               for key in ("bound_ms", "ms", "library_ms", "plain_ms")}
        tot["share"] = tot["bound_ms"] / tot["ms"]
        tot["beats_library_everywhere"] = all(r["beats_library"]
                                              for r in out)
        emit({"phase": "kernel", "name": "schur_syrk", "config": cfg,
              "levels": len(out), "total": tot})
        summary[cfg] = tot
    return summary


def _scipy_matrix(n, rows, cols, vals):
    import numpy as np
    import scipy.sparse as sp

    lower = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    return (lower + lower.T - sp.diags(lower.diagonal())).tocsr().astype(
        np.float64)


def phase_small():
    import numpy as np
    import scipy.sparse.linalg as spla

    from cholesky_tpu_torch.utils.laplacian import generate_problem
    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    n, r, c, v, o, cl, b = generate_problem((15, 15, 15), 5)
    # default routing (no level is kernel-eligible at this size), then every
    # level with W >= 128 (levels 0 and 4) forced through the kernel
    rule = (hk.MIN_B, hk.W_PER_B)
    for routing, (min_b, w_per_b) in (("default", rule),
                                      ("kernel", (1, 1 << 20))):
        hk.MIN_B, hk.W_PER_B = min_b, w_per_b
        try:
            s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                        device="cuda")
            s.factorize()
            x = s.solve(b)
        finally:
            hk.MIN_B, hk.W_PER_B = rule
        a = _scipy_matrix(n, s.rows, s.cols, s.vals)
        x_ref = spla.spsolve(a.tocsc(), b)
        err = float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))
        res = float(np.linalg.norm(a @ x - b) / np.linalg.norm(b))
        check(err <= SMALL_REL_TOL, f"15^3 ({routing}) differs from SciPy: "
              f"{err}")
        check(res <= TOL, f"15^3 ({routing}) residual {res}")
        emit({"phase": "small", "problem": "15^3 L5", "routing": routing,
              "n": n, "rel_err_vs_scipy": err, "residual": res,
              **s.last_solve})


def level_routes(fp):
    """Per level the batch, the front and pivot widths and the f32 route:
    "kernel" where the rule sends the level through factor_slab."""
    import torch

    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    return [{"lvl": lvl, "B": 1 << lvl, "F": fp.F[lvl], "W": fp.W[lvl],
             "route": ("kernel" if hk.slab_kernel_eligible(
                 1 << lvl, fp.W[lvl], torch.float32) else "plain")}
            for lvl in range(fp.levels)]


def phase_slice():
    import numpy as np
    import torch

    from cholesky_tpu_torch.utils.laplacian import generate_problem
    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    t0 = time.perf_counter()
    n, r, c, v, o, cl, b0 = generate_problem((50, 50, 50), 8, seed=SEED)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                device="cuda")
    fp = s.fplan
    plan_s = time.perf_counter() - t0
    routes = level_routes(fp)
    emit({"phase": "plan", "problem": "50^3 L8", "n": n, "nnz_lower":
          int(len(s.vals)), "host_plan_s": plan_s, "levels": routes})
    check([x["lvl"] for x in routes if x["route"] == "kernel"] == [5, 6, 7],
          "expected the kernel route on levels 5-7")

    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, plan_s = [], []
    for _ in range(3):                  # cold (first use), then warm
        t = time.perf_counter()
        s.factorize()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        plan_s.append({k: s.factor_stats[k] for k in (
            "plan_s", "plan_reused", "released_cache")})
    a = _scipy_matrix(n, s.rows, s.cols, s.vals)
    solves = []
    for i in range(3):
        b = b0 if i == 0 else np.random.default_rng(SEED + i).integers(
            1, 11, size=n).astype(np.float64)
        t = time.perf_counter()
        x = s.solve(b, tol=TOL)
        wall = time.perf_counter() - t
        res = float(np.linalg.norm(a @ x - b) / np.linalg.norm(b))
        check(bool(np.all(np.isfinite(x))) and x.shape == (n,),
              "solution not finite or of the wrong shape")
        check(res <= TOL, f"solve {i}: residual {res} > {TOL}")
        solves.append({"wall_s": wall, "residual": res, **s.last_solve})
    launches = dict(hk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches["chol_inv"] > 0, "main path launched no chol_inv kernel")
    # levels 7, 6, 5: 7 + 2 + 2 panels of 128 (W = 864, 144, 144)
    check(launches["chol_inv"] == 11 * len(walls),
          f"expected 11 chol_inv launches per factorization, got "
          f"{launches['chol_inv']} in {len(walls)}")
    check_slab_launches(launches, 3 * len(walls), "50^3 L8 slice")
    # every level with children is square: one front formed a level
    check(launches["form_front"] == 7 * len(walls),
          f"expected 7 form_front launches per factorization, got "
          f"{launches['form_front']} in {len(walls)}")
    # every level with a boundary (1-7, the leaves' X X^T at level 6) forms
    # its Schur update in one launch at IEEE products
    check(launches["schur_syrk"] == 7 * len(walls),
          f"expected 7 schur_syrk launches per factorization, got "
          f"{launches['schur_syrk']} in {len(walls)}")
    SLAB_BY_PATH[f"50^3 L8 slice ({len(walls)} factorizations)"] = launches[
        "factor_slab"]
    check(all(x["sweeps"] + x["host_sweeps"] <= 2 for x in solves),
          "a solve took more than 2 refinement sweeps")
    emit({"phase": "slice", "problem": "50^3 L8", "n": n,
          "precision": s.precision, "factor_wall_s": walls[0], "factor_wall_warm_s": walls[1:],
          "plan_regimes": plan_s,
          "solves": solves, "max_memory_allocated": peak,
          "launches": launches, "factorizations": len(walls)})
    return launches, s, b0


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def phase_profile(s, b):
    """Where the time goes in the warm slice: per-level factor times by CUDA
    events, then torch.profiler over one factorization and one solve
    (device busy and idle share, top kernels by device time)."""
    import torch

    from cholesky_tpu_torch.numeric import frontal as tfrontal

    fp = s.fplan
    fronts = s.assemble()
    torch.cuda.synchronize()
    marks = {}
    U = None
    for lvl in range(fp.levels - 1, -1, -1):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        _, U = tfrontal._factor_level(fp, lvl, fronts[lvl], U)
        e1.record()
        marks[lvl] = (e0, e1)
    torch.cuda.synchronize()
    emit({"phase": "profile", "what": "factor per level (CUDA events)",
          "level_ms": [marks[lvl][0].elapsed_time(marks[lvl][1])
                       for lvl in range(fp.levels)]})

    for what, fn in (("factor", s.factorize), ("solve", lambda: s.solve(b))):
        fn()                                    # warm
        emit({"phase": "profile", "what": what, **profiled(fn)})


def profiled(fn) -> dict:
    """One call of fn under torch.profiler: wall, device busy time and idle
    share, kernel launches, chol_inv's share, the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # the solver's spans (`cholesky_tpu_torch.trace`) show on the device
    # as user annotations over its kernels: not work of their own
    rows = sorted(((e.key, _device_us(e) / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda x: -x[1])
    busy_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": sum(r[2] for r in rows),
            "chol_inv_ms": sum(r[1] for r in rows if "chol_inv" in r[0]),
            "chol_inv_count": sum(r[2] for r in rows if "chol_inv" in r[0]),
            "top": [{"kernel": k[:80], "ms": ms, "count": c}
                    for k, ms, c in rows[:12]]}



def per_call(kernel: str, W: int) -> int:
    """Launches counted by one factor_slab call on a slab of width W:
    itself once, chol_inv once per 128-wide panel."""
    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    return 1 if kernel == "factor_slab" else -(-W // hk.BS)


def rule_launches(levels, kernel: str = "chol_inv") -> int:
    """Launches of `kernel` (chol_inv, or factor_slab) in one factorization
    by the routing rule, over (fronts, W, chunks) of each level: one
    factor_slab call per chunk of an eligible level."""
    import torch

    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    return sum(chunks * per_call(kernel, W)
               for fronts, W, chunks in levels
               if hk.slab_kernel_eligible(fronts // chunks, W,
                                          torch.float32))


def schur_launches(rows, ieee: bool) -> int:
    """schur_syrk launches in one factorization by the level loop's route,
    over the rows of a regime plan's `describe()` with the level's F and W
    (tools/torch/bench.py's `regime_plan`): none at the TF32 rung; at IEEE
    products one a chunk of every level between the root and the leaves
    with a boundary and an f32 update, the gather tier's left out, and one
    a chunk of the leaves' parent for the leaves' X X^T where the leaves
    have a boundary (their X f32, or in the xxt tier the parent's update)."""
    if not ieee:
        return 0
    n = sum(lv["chunks"] for lv in rows[1:-1]
            if lv["F"] > lv["W"] and lv["update"] == "float32"
            and lv["path"] != "two-piece")
    leaf, parent = rows[-1], rows[-2]
    carrier = parent if parent["path"] == "two-piece/xxt" else leaf
    if leaf["F"] > leaf["W"] and carrier["update"] == "float32":
        n += parent["chunks"]
    return n


def expected_launches(fp, plan, kernel: str = "chol_inv") -> int:
    """rule_launches of a regime plan (a family's level holds plan.family
    2^lvl fronts)."""
    return rule_launches([(plan.family << lvl, fp.W[lvl], lp.chunks)
                          for lvl, lp in enumerate(plan.levels)], kernel)


def check_slab_launches(launches: dict, want: int, what: str) -> None:
    """factor_slab launches against the routing rule's count."""
    check(launches["factor_slab"] == want, f"{what}: "
          f"{launches['factor_slab']} factor_slab launches, the routing rule "
          f"gives {want}")


def level_probe(s, dev):
    """A level hook recording CUDA events and the allocator's peak per
    level (reset at each level's start), and a reader of both."""
    import torch

    marks = {}

    def hook(lvl, what):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        if what == "start":
            torch.cuda.reset_peak_memory_stats(dev)
            marks[lvl] = [e]
        else:
            marks[lvl] += [e, torch.cuda.max_memory_allocated(dev)]

    def read():
        torch.cuda.synchronize()
        base = s.factor_stats["allocated_at_start"]
        return {lvl: {"ms": m[0].elapsed_time(m[1]),
                      "peak_bytes": m[2] - base}
                for lvl, m in marks.items()}

    return hook, read


def pinned_segments(dev) -> dict:
    """Cached segments of 256 MiB or more in the allocator's common pool
    (the one fronts come from) that hold a live block: the segments a
    factorization could not reuse whole. Counted with no factor alive."""
    import torch

    from cholesky_tpu_torch.numeric import devmem

    pool = devmem._POOLS.get(dev.index or 0)
    pool = tuple(pool.id) if pool is not None else None
    segs = [g for g in torch.cuda.memory._snapshot()["segments"]
            if g["total_size"] >= (256 << 20)
            and tuple(g.get("segment_pool_id", (0, 0))) != pool
            and any(b["state"] == "active_allocated" for b in g["blocks"])]
    return {"segments": len(segs),
            "segment_bytes": sum(g["total_size"] for g in segs),
            "live_bytes": sum(g["allocated_size"] for g in segs)}


def regime_table(fp, plan, measured):
    rows = []
    for d in plan.describe():
        lvl = d["lvl"]
        rows.append({"lvl": lvl, "B": 1 << lvl, "F": fp.F[lvl],
                     "W": fp.W[lvl], **d, **measured.get(lvl, {})})
    return rows


def phase_regimes(base, b0):
    """50^3 L8 forced through each capacity regime under a small budget."""
    import numpy as np
    import torch

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.numeric import regimes

    n = base.plan.n
    a = _scipy_matrix(n, base.rows, base.cols, base.vals)
    ref = [p.double() for p in base.panels]
    # (name, forced choices (keywords of regimes.plan_regimes, installed
    # through the solver's private plan override), budget, tolerance of the
    # f32-stored factor);
    # the first three keep the factor f32 (under 1 GiB the budget alone
    # would store it bf16); 768 MiB leaves no room for pivot inverses beside
    # the solve's working set, so the last case solves without them from
    # host-resident levels
    f32 = {"store_dtype": torch.float32}
    cases = [
        ("two-piece", {"two_piece": True, **f32}, 2 << 30, REGIME_F32_TOL),
        ("two-piece, bf16 updates",
         {"two_piece": True, "update_dtype": torch.bfloat16, **f32},
         2 << 30, REGIME_BF16_TOL),
        ("chunked", {"chunks": {6: 4, 5: 2, 4: 2}, "lazy": True, **f32},
         2 << 30, REGIME_F32_TOL),
        ("bf16 store, offloaded, no re-upload",
         {"store_dtype": torch.bfloat16, "offload": True,
          "reupload": False}, 768 << 20, None)]
    for name, force, budget, tol in cases:
        s = SparseCholesky(base.plan, base.rows, base.cols, base.vals,
                           dtype=np.float32, device="cuda")
        s._fplan = base.fplan
        s._plan_override = regimes.plan_regimes(base.fplan, np.float32,
                                                budget, **force)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        s.factorize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated()
                - s.factor_stats["allocated_at_start"])
        x = s.solve(b0, tol=TOL)
        res = float(np.linalg.norm(a @ x - b0) / np.linalg.norm(b0))
        out = {"phase": "regimes", "problem": "50^3 L8", "case": name,
               "budget": budget, "lazy": s.regimes.lazy,
               "plan": s.regimes.describe(), "factor_wall_s": wall,
               "residual": res, **s.last_solve, "factor_peak_bytes": peak}
        check(res <= TOL, f"regime {name}: residual {res}")
        check(peak <= s.regimes.peak_bytes,
              f"regime {name}: peak {peak} > estimate "
              f"{s.regimes.peak_bytes}")
        if tol is not None:
            diff = [rel_err(p, r) for p, r in zip(s.panels, ref)]
            out.update(level_rel_diff=diff, tol=tol)
            check(max(diff) <= tol, f"regime {name}: factor differs by "
                  f"{max(diff)} > {tol}")
        else:
            check(all(p.device.type == "cpu" for p in s.panels[1:])
                  and s.last_solve["engine"] == "plain",
                  f"regime {name}: the solve did not read host levels")
        emit(out)
        del s


def phase_scale():
    """The capacity slice's main path: 140^3 L14 in f32 under the default
    budget, then under SCALE_SMALL_BUDGET."""
    import numpy as np
    import torch

    from cholesky_tpu_torch.utils.laplacian import generate_problem
    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.numeric import hopper_kernels as hk
    from cholesky_tpu_torch.numeric import regimes

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    shape, levels = SCALE
    n, r, c, v, o, cl, b0 = generate_problem(shape, levels, seed=SEED)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                device="cuda")
    fp = s.fplan
    plan_s = time.perf_counter() - t0
    problem = f"{shape[0]}^3 L{levels}"
    a = _scipy_matrix(n, s.rows, s.cols, s.vals)
    rhs = [b0, np.random.default_rng(SEED + 1).integers(
        1, 11, size=n).astype(np.float64)]
    results = {}
    for run, budget in (("default", None), ("40 GiB", SCALE_SMALL_BUDGET)):
        s.budget = budget
        free, total = torch.cuda.mem_get_info(dev)
        retries = torch.cuda.memory_stats(dev)["num_alloc_retries"]
        for k in hk.LAUNCHES:
            hk.LAUNCHES[k] = 0
        walls, plans_s = [], []
        hook, read = level_probe(s, dev)
        runs = 2 if run == "default" else 1     # cold, then warm
        for i in range(runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.factorize(level_hook=hook if i == runs - 1 else None)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            plans_s.append({k: s.factor_stats[k] for k in (
                "plan_s", "plan_reused", "released_cache")})
        launches = dict(hk.LAUNCHES)
        per_level = read()
        plan = s.regimes
        table = regime_table(fp, plan, per_level)
        emit({"phase": "scale", "problem": problem, "run": run, "n": n,
              "free_bytes": free, "total_bytes": total,
              "budget": s.factor_stats["budget"], "lazy": plan.lazy,
              "reupload": plan.reupload, "host_plan_s": plan_s,
              "precision": s.precision,
              "factor_wall_s": walls[0],
              "factor_wall_warm_s": walls[-1] if len(walls) > 1 else None,
              "plan_regimes": plans_s, "levels": table,
              "max_memory_reserved": torch.cuda.max_memory_reserved(dev)})
        over = [x["lvl"] for x in table if x["peak_bytes"] > x[
            "est_peak_bytes"]]
        check(not over, f"{problem} ({run}): measured peak over the "
              f"estimate at levels {over}")
        want = expected_launches(fp, plan)
        check(launches["chol_inv"] == want * len(walls),
              f"{problem} ({run}): {launches['chol_inv']} chol_inv launches "
              f"in {len(walls)} factorizations, the routing rule gives "
              f"{want} each")
        want_slab = expected_launches(fp, plan, "factor_slab")
        check_slab_launches(launches, want_slab * len(walls),
                            f"{problem} ({run})")
        SLAB_BY_PATH[f"{problem} {run} budget ({len(walls)} "
                     f"factorizations)"] = launches["factor_slab"]
        if run != "default":
            check(any(lp.two_piece for lp in plan.levels),
                  f"{problem} ({run}): no level took the two-piece path")
        solves = []
        torch.cuda.reset_peak_memory_stats(dev)
        for b in rhs:
            t = time.perf_counter()
            x = s.solve(b, tol=TOL)
            wall = time.perf_counter() - t
            res = float(np.linalg.norm(a @ x - b) / np.linalg.norm(b))
            check(bool(np.all(np.isfinite(x))) and x.shape == (n,),
                  "solution not finite or of the wrong shape")
            check(res <= TOL, f"{problem} ({run}): residual {res} > {TOL}")
            solves.append({"wall_s": wall, "residual": res,
                           **s.last_solve})
        block = None
        if run == "default":
            block = block_solve(s, a, 8, SEED + 2, f"{problem} ({run})")
        emit({"phase": "scale", "problem": problem, "run": run,
              "solves": solves, "block_solve": block, "launches": launches,
              "launches_per_factorization": want,
              "factor_slab_per_factorization": want_slab,
              "factorizations": len(walls),
              "solve_max_memory_allocated":
                  torch.cuda.max_memory_allocated(dev),
              "max_memory_reserved": torch.cuda.max_memory_reserved(dev)})
        results[run] = {"launches": launches["chol_inv"],
                        "per_factorization": want,
                        "factor_slab": launches["factor_slab"]}
        if run == "default":
            # refactorizations after the solves: with no factor alive, the
            # common pool's large segments that a live block pins (the
            # long-lived state has its own pool); then refactorizations that
            # keep the allocator's cache (the release turned off), which can
            # run out of memory on fragmentation, beside one that runs as
            # factorize() does by default, returning the cache to the driver
            s.panels, s._inv, s.factored = None, None, False
            refac = {"pinned before": pinned_segments(dev)}
            for what in ("kept cache", "released cache",
                         "kept cache after a release"):
                s._release_cache = what == "released cache"
                torch.cuda.synchronize()
                t = time.perf_counter()
                try:
                    s.factorize()
                    torch.cuda.synchronize()
                except torch.OutOfMemoryError as e:
                    check(not s._release_cache, f"{problem}: {e}")
                    refac[what] = {"out_of_memory": str(e)[:420]}
                    s.panels, s.factored = None, False
                    del e
                    continue
                refac[what] = {"wall_s": time.perf_counter() - t,
                               **{k: s.factor_stats[k] for k in (
                                   "plan_s", "plan_reused",
                                   "released_cache")}}
            s._release_cache = True
            check(refac["released cache"]["released_cache"],
                  f"{problem}: the refactorization kept the cache")
            stats = torch.cuda.memory_stats(dev)
            emit({"phase": "scale", "problem": problem, "run": run,
                  "what": "refactorization", **refac,
                  "num_alloc_retries": stats["num_alloc_retries"] - retries,
                  "inactive_split_bytes":
                      stats["inactive_split_bytes.all.current"],
                  "reserved_bytes": stats["reserved_bytes.all.current"]})
            emit({"phase": "scale", "problem": problem, "run": run,
                  "what": "warm factor under torch.profiler",
                  **profiled(s.factorize)})
            # selected inversion does not fit beside this factor: it must
            # refuse before it allocates anything
            before = torch.cuda.memory_allocated(dev)
            try:
                s.inv_diag()
                refused = None
            except regimes.BudgetError as e:
                refused = str(e)
            check(refused is not None, f"{problem}: inv_diag did not raise "
                  "BudgetError")
            check(torch.cuda.memory_allocated(dev) == before,
                  f"{problem}: inv_diag allocated before refusing")
            emit({"phase": "selinv", "problem": problem,
                  "what": "inv_diag refused", **s.selinv_stats,
                  "allocated_before": before,
                  "allocated_after": torch.cuda.memory_allocated(dev),
                  "error": refused[:400]})
    return results, s, a, rhs[0]


def column_residuals(a, B, X):
    import numpy as np

    bn = np.linalg.norm(B, axis=0)
    return np.linalg.norm(a @ X - B, axis=0) / np.where(bn > 0, bn, 1.0)


def block_solve(s, a, k: int, seed: int, what: str) -> dict:
    """One solve of a seeded [n, k] block through `s`, timed with the device
    synchronized, each column held to the residual contract against the
    SciPy matrix `a` in f64."""
    import numpy as np
    import torch

    n = s.plan.n
    B = np.random.default_rng(seed).standard_normal((n, k))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    X = s.solve(B if k > 1 else B[:, 0], tol=TOL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    X = X.reshape(n, k)
    res = column_residuals(a, B, X)
    check(bool(np.all(np.isfinite(X))), f"{what}: k = {k} solution not finite")
    check(float(res.max()) <= TOL,
          f"{what}: k = {k} worst column residual {res.max()} > {TOL}")
    return {"k": k, "wall_s": wall, "wall_per_column_s": wall / k,
            "residual_max": float(res.max()),
            "residual_median": float(np.median(res)),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            **s.last_solve}


def phase_multi(s):
    """Block right-hand sides against the slice's 50^3 factor."""
    import numpy as np

    a = _scipy_matrix(s.plan.n, s.rows, s.cols, s.vals)
    check(s.factored, "the slice's factor is gone")
    rows = []
    for k in MULTI_K:
        block_solve(s, a, k, SEED + 10 + k, "multi (warm-up)")
        rows.append(block_solve(s, a, k, SEED + 10 + k, "multi"))
        check(k == 1 or rows[-1]["loop"] == "device",
              f"multi: k = {k} left the device loop")
    emit({"phase": "multi", "problem": "50^3 L8", "n": s.plan.n,
          "solves": rows,
          "wall_per_column_vs_single": {
              str(r["k"]): r["wall_per_column_s"] / rows[0]["wall_s"]
              for r in rows}})
    B = np.random.default_rng(SEED + 26).standard_normal((s.plan.n, 16))
    for what, rhs in (("solve k=1", B[:, 0]), ("solve k=16", B)):
        emit({"phase": "multi", "what": what + " under torch.profiler",
              **profiled(lambda: s.solve(rhs, tol=TOL))})


def unit_solves(s, a, cols, what: str):
    """A^-1 e_j for the dofs `cols`: refined block solves of the unit
    vectors, 256 columns at a time, each column held to the residual
    contract against the SciPy matrix `a` in f64. [n, len(cols)]."""
    import numpy as np

    n = s.plan.n
    X = np.empty((n, len(cols)))
    for j0 in range(0, len(cols), 256):
        c = cols[j0:j0 + 256]
        E = np.zeros((n, len(c)))
        E[c, np.arange(len(c))] = 1.0
        X[:, j0:j0 + len(c)] = s.solve(E, tol=TOL).reshape(n, len(c))
        res = column_residuals(a, E, X[:, j0:j0 + len(c)])
        check(float(res.max()) <= TOL,
              f"{what}: a unit-vector solve's residual {res.max()} > {TOL}")
    return X


def inv_diag_check(s, a, seed: int, what: str, tol=SELINV_F32_TOL):
    """inv_diag() (synchronized wall, peak device bytes above what was
    allocated before, beside the estimate less the resident bytes) and its
    value at 64 seeded dofs against e_i^T A^-1 e_i from refined solves,
    held to `tol` (None: the error is reported, not held). Returns (the
    record, the diagonal)."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    d = s.inv_diag()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - before
    est = s.selinv_stats["estimate"] - s._resident_bytes()
    n = s.plan.n
    check(d.shape == (n,) and bool(np.all(np.isfinite(d)) and np.all(d > 0)),
          f"{what}: inv_diag not finite and positive")
    check(peak <= est, f"{what}: inv_diag peak {peak} > estimate {est}")
    dofs = np.random.default_rng(seed).choice(n, 64, replace=False)
    ref = unit_solves(s, a, dofs, what)[dofs, np.arange(64)]
    err = float((np.abs(d[dofs] - ref) / np.abs(ref)).max())
    check(tol is None or err <= tol, f"{what}: inv_diag differs from the "
          f"unit-vector solves by {err} > {tol}")
    return {"wall_s": wall, "peak_bytes": peak,
            "est_bytes": est, "est_with_resident": s.selinv_stats["estimate"],
            "budget": s.selinv_stats["budget"], "rel_err_64_dofs": err,
            "tol": tol}, d


def phase_selinv(s):
    """Selected inversion, value gradients and sampling on the slice's
    50^3 L8 f32 factor."""
    import numpy as np
    import torch

    check(s.factored, "the slice's factor is gone")
    n = s.plan.n
    a = _scipy_matrix(n, s.rows, s.cols, s.vals)
    cold, _ = inv_diag_check(s, a, SEED + 50, "selinv 50^3 (cold)")
    warm, d = inv_diag_check(s, a, SEED + 51, "selinv 50^3")
    emit({"phase": "selinv", "problem": "50^3 L8", "n": n,
          "what": "inv_diag", "cold": cold, "warm": warm})

    rng = np.random.default_rng(SEED + 52)
    pick = rng.choice(len(s.rows), 1000, replace=False)
    er, ec = s.rows[pick], s.cols[pick]
    torch.cuda.synchronize()
    t = time.perf_counter()
    e = s.inv_entries(er, ec)
    wall = time.perf_counter() - t
    cols, which = np.unique(ec, return_inverse=True)
    ref = unit_solves(s, a, cols, "inv_entries")[er, which]
    err = float(np.abs(e - ref).max() / np.abs(ref).max())
    check(err <= SELINV_F32_TOL, f"inv_entries differs from the unit-vector "
          f"solves by {err} > {SELINV_F32_TOL}")
    emit({"phase": "selinv", "what": "inv_entries", "entries": 1000,
          "wall_s": wall, "rel_err": err, "tol": SELINV_F32_TOL})

    t = time.perf_counter()
    g = s.logdet_grad()
    g_wall = time.perf_counter() - t
    diag = s.rows == s.cols
    g_diag = float(np.abs(g[diag] - d[s.rows[diag]]).max()
                   / np.abs(d).max())
    check(g.shape == s.vals.shape and bool(np.all(np.isfinite(g)))
          and g_diag <= 1e-6, f"logdet_grad: diagonal vs inv_diag {g_diag}")
    b = rng.standard_normal(n)
    t = time.perf_counter()
    q = s.quadform_grad(b)
    q_wall = time.perf_counter() - t
    t = time.perf_counter()
    vbar, lam = s.solve_grad(b, rng.standard_normal(n))
    sg_wall = time.perf_counter() - t
    check(bool(np.all(np.isfinite(q)) and np.all(np.isfinite(vbar))),
          "quadform_grad / solve_grad not finite")
    emit({"phase": "selinv", "what": "gradients", "entries": int(len(g)),
          "logdet_grad_wall_s": g_wall, "logdet_grad_diag_vs_inv_diag":
              g_diag, "quadform_grad_wall_s": q_wall,
          "solve_grad_wall_s": sg_wall})

    rows = []
    for k in (1, 64):
        z = rng.standard_normal((n, k) if k > 1 else n)
        s.sample(z)                                   # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        x = s.sample(z)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        t = time.perf_counter()
        w = s.whiten(x)
        torch.cuda.synchronize()
        w_wall = time.perf_counter() - t
        err = float(np.abs(w - z).max() / np.abs(z).max())
        check(x.shape == z.shape and bool(np.all(np.isfinite(x)))
              and err <= SAMPLE_F32_TOL,
              f"sample k = {k}: whiten(sample(z)) differs from z by {err}")
        rows.append({"k": k, "sample_wall_s": wall, "whiten_wall_s": w_wall,
                     "round_trip_rel_err": err})
    emit({"phase": "selinv", "what": "sample / whiten", "runs": rows,
          "tol": SAMPLE_F32_TOL})


def phase_family(base):
    """factorize_many at 50^3 L8 for K = 8 and 16."""
    import numpy as np
    import torch

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    n = base.plan.n
    fp = base.fplan
    diag = base.rows == base.cols
    out = {}
    for K in FAMILY_K:
        rng = np.random.default_rng(SEED + 60 + K)
        scales = 1.0 + rng.uniform(0, 2, size=K)
        shifts = rng.uniform(0, 1, size=K)
        vals = scales[:, None] * base.vals[None, :]
        vals[:, diag] += shifts[:, None]
        for k in hk.LAUNCHES:
            hk.LAUNCHES[k] = 0
        walls, peaks, bf = [], [], None
        for _ in range(2):                     # cold, then warm
            bf = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t = time.perf_counter()
            bf = base.factorize_many(vals)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            peaks.append(torch.cuda.max_memory_allocated() - before)
        launches = dict(hk.LAUNCHES)
        want = expected_launches(fp, bf.regimes)
        check(want == FAMILY_LAUNCHES[K], f"family K = {K}: the rule gives "
              f"{want} chol_inv launches, expected {FAMILY_LAUNCHES[K]}")
        check(launches["chol_inv"] == 2 * want,
              f"family K = {K}: {launches['chol_inv']} chol_inv launches in "
              f"2 factorizations, the rule gives {want} each")
        check_slab_launches(
            launches, 2 * expected_launches(fp, bf.regimes, "factor_slab"),
            f"family K = {K}")
        SLAB_BY_PATH[f"50^3 L8 family K={K} (2 factorizations)"] = launches[
            "factor_slab"]
        est = bf.regimes.peak_bytes
        check(max(peaks) <= est, f"family K = {K}: peak {max(peaks)} > "
              f"estimate {est}")

        seq = SparseCholesky(base.plan, base.rows, base.cols, base.vals,
                             dtype=np.float32, device="cuda")
        seq._fplan = fp
        seq.factorize()                       # its plan, index maps, warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(K):
            seq.update_values(vals[i])
            seq.factorize()
        torch.cuda.synchronize()
        seq_wall = time.perf_counter() - t
        logdets = []
        for i in range(K):
            seq.update_values(vals[i])
            logdets.append(seq.logdet())
        del seq

        B = rng.standard_normal((K, n))
        solves = []
        # the first solve builds the family's ELL planes on the host
        for rhs in (B, B, base_rhs(n)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            X = bf.solve(rhs, tol=TOL)
            wall = time.perf_counter() - t
            R = np.broadcast_to(rhs, (K, n))
            res = np.array([
                np.linalg.norm(_scipy_matrix(n, base.rows, base.cols, vals[i])
                               @ X[i] - R[i]) / np.linalg.norm(R[i])
                for i in range(K)])
            check(X.shape == (K, n) and bool(np.all(np.isfinite(X))),
                  f"family K = {K}: solution not finite or misshapen")
            check(float(res.max()) <= TOL, f"family K = {K}: worst system's "
                  f"residual {res.max()} > {TOL}")
            solves.append({"rhs": "per system" if rhs.ndim == 2 else "shared",
                           "first": not solves, "wall_s": wall,
                           "residual_max": float(res.max()),
                           **bf.last_solve})
        ld = bf.logdet()
        ld_err = float(np.max(np.abs(ld - logdets) / np.abs(logdets)))
        check(ld_err <= FAMILY_LOGDET_TOL, f"family K = {K}: logdet differs "
              f"from the single solver's by {ld_err}")
        emit({"phase": "family", "problem": "50^3 L8", "n": n, "K": K,
              "factor_many_wall_s": walls[0], "factor_many_warm_s": walls[1],
              "sequential_update_factorize_s": seq_wall,
              "warm_over_sequential": walls[1] / seq_wall,
              "peak_bytes": peaks, "est_peak_bytes": est,
              "lazy": bf.regimes.lazy, "plan": bf.regimes.describe(),
              "launches": launches, "launches_per_factorization": want,
              "solves": solves, "logdet_rel_diff_max": ld_err,
              "logdet_tol": FAMILY_LOGDET_TOL})
        out[K] = launches["chol_inv"]
        del bf
    return out


def base_rhs(n: int):
    """The shared right-hand side of the family solves: seeded integers
    1..10, as the slice's."""
    import numpy as np

    return np.random.default_rng(SEED + 70).integers(
        1, 11, size=n).astype(np.float64)


def spd_perturbation(rows, cols, vals, seed):
    """Values of D A D + sigma I for a seeded positive diagonal D and
    sigma > 0: a congruence and a positive shift, both SPD-preserving."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = rng.uniform(0.8, 1.25, size=int(rows.max()) + 1)
    new = vals * d[rows] * d[cols]
    diag = rows == cols
    new[diag] += 0.01 * float(np.abs(vals[diag]).mean())
    return new


def phase_ordering():
    """from_scipy -> factorize -> solves -> update_values -> factorize ->
    solve -> logdet on matrices that come with no ordering."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.numeric import hopper_kernels as hk
    from cholesky_tpu_torch.utils import problems

    total = 0
    for name, scale in ORDERING:
        n, r, c, v = problems.make_gallery(scale)[name]()
        lower = sp.csr_matrix((v, (r, c)), shape=(n, n))
        for k in hk.LAUNCHES:
            hk.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        s = SparseCholesky.from_scipy(lower, dtype=np.float32, device="cuda")
        build_s = time.perf_counter() - t0
        check(s.ordering_info["engine"] == "native",
              f"{name}: ordered by the {s.ordering_info['engine']} engine")
        if name == "aniso3d":
            graph = (f"{name} x{scale}", n, r, c, s.plan.levels)
        fp = s.fplan
        levels = level_routes(fp)
        walls = []
        for i in range(2):          # cold (pivots checked), then warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.factorize(check=i == 0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        want = expected_launches(fp, s.regimes)
        a = _scipy_matrix(n, s.rows, s.cols, s.vals)
        solves = [block_solve(s, a, k, SEED + 30 + k, name) for k in (1, 4)]
        problem = f"{name} x{scale}"
        emit({"phase": "ordering", "problem": problem, "n": n,
              "nnz_lower": int(len(s.vals)),
              "ordering": s.ordering_info, "build_s": build_s,
              "order_s": s.ordering_info["order_s"],
              "python_engine_order_s": PYTHON_ORDERING_S[name],
              "levels": levels, "factor_wall_s": walls[0],
              "factor_wall_warm_s": walls[1], "solves": solves,
              "chol_inv_launches_per_factorization": want})

        new = spd_perturbation(s.rows, s.cols, s.vals, SEED + 40)
        s.update_values(new)
        check(s.panels is None and not s.factored, "update_values kept "
              "the old factor")
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.factorize(check=True)
        torch.cuda.synchronize()
        refactor_s = time.perf_counter() - t
        check(s.factor_stats["plan_reused"],
              f"{problem}: the regime plan was searched again")
        a_new = _scipy_matrix(n, s.rows, s.cols, new)
        after = block_solve(s, a_new, 1, SEED + 41, problem + " updated")
        launches = dict(hk.LAUNCHES)
        check(launches["chol_inv"] == 3 * want,
              f"{problem}: {launches['chol_inv']} chol_inv launches in 3 "
              f"factorizations, the routing rule gives {want} each")
        check_slab_launches(launches, 3 * expected_launches(
            fp, s.regimes, "factor_slab"), problem)
        logdet = s.logdet()
        t = time.perf_counter()
        ref = SparseCholesky(s.plan, s.rows, s.cols, new, dtype=np.float64,
                             device="cpu")
        ref._fplan = fp
        logdet_ref = ref.logdet()
        ref_s = time.perf_counter() - t
        rel = abs(logdet - logdet_ref) / abs(logdet_ref)
        check(rel <= LOGDET_REL_TOL, f"{problem}: logdet {logdet} vs the f64 "
              f"CPU factor's {logdet_ref} ({rel})")
        if name == "aniso3d":
            sel, _ = inv_diag_check(s, a_new, SEED + 42, problem)
            emit({"phase": "selinv", "problem": problem, "n": n,
                  "what": "inv_diag", **sel})
        emit({"phase": "ordering", "problem": problem,
              "what": "update_values -> factorize -> solve -> logdet",
              "refactor_wall_s": refactor_s,
              "plan_reused": s.factor_stats["plan_reused"], "solve": after,
              "logdet": logdet, "logdet_f64_cpu": logdet_ref,
              "logdet_rel_diff": rel, "tol": LOGDET_REL_TOL,
              "f64_cpu_factor_s": ref_s, "launches": launches})
        total += launches["chol_inv"]
        del s, ref
    check(total > 0, "the ordering path launched no chol_inv kernel")
    ordering_engines(graph)
    ordering_scale()
    return total


def _same_ordering(a, b) -> bool:
    import numpy as np

    (oa, ca), (ob, cb) = a, b
    return ((oa.levels, sorted(oa.dofs)) == (ob.levels, sorted(ob.dofs))
            and all(np.array_equal(oa.dofs[s], ob.dofs[s]) for s in oa.dofs)
            and sorted(ca.intervals) == sorted(cb.intervals)
            and all(len(ca.intervals[s]) == len(cb.intervals[s])
                    and all(np.array_equal(x, y) for x, y in zip(
                        ca.intervals[s], cb.intervals[s]))
                    for s in ca.intervals))


def ordering_engines(graph):
    """The native core against the Python engine on this host: a gallery
    matrix at scale 1 ordered by both (identical dofs and clusters), and
    nd_order of the aniso3d graph at 1 thread and at the default
    (identical)."""
    import numpy as np

    from cholesky_tpu_torch.native import ext
    from cholesky_tpu_torch.symbolic.nd import nested_dissection_graph
    from cholesky_tpu_torch.utils import problems

    name, scale = ENGINE_PARITY
    n, r, c, _ = problems.make_gallery(scale)[name]()
    infos, orders = {}, {}
    for engine in ("native", "python"):
        infos[engine] = {}
        orders[engine] = nested_dissection_graph(
            n, r, c, info=infos[engine], native=engine == "native")
        check(infos[engine]["engine"] == engine,
              f"{name}: asked {engine}, ran {infos[engine]['engine']}")
    check(_same_ordering(orders["native"], orders["python"]),
          f"{name} x{scale}: the engines' orderings differ")
    problem, gn, gr, gc, levels = graph
    walls, sep_of = {}, {}
    for threads in (1, None):
        t = time.perf_counter()
        sep_of[threads] = ext.nd_order(gn, gr, gc, levels, threads=threads)
        walls[threads] = time.perf_counter() - t
    check(np.array_equal(sep_of[1], sep_of[None]),
          f"{problem}: nd_order differs between 1 thread and the default")
    emit({"phase": "ordering", "what": "engines", "problem":
          f"{name} x{scale}", "n": n, "identical": True,
          "native": infos["native"], "python": infos["python"],
          "nd_order": {"problem": problem, "n": gn, "levels": levels,
                       "threads_default": min(os.cpu_count() or 1, 8),
                       "threads_1_s": walls[1],
                       "threads_default_s": walls[None],
                       "identical": True}})


def ordering_scale():
    """The 140^3 pattern (2.74M dofs) ordered alone, not factored: native
    nested dissection at SCALE_ORDER_LEVELS levels with its seconds and the
    symbolic FLOPs and nnz(L) of its permutation (native col_counts) beside
    those of generate_problem's geometric ordering; then the automatic
    depth (levels=None)."""
    from cholesky_tpu_torch.symbolic.nd import nested_dissection_graph
    from cholesky_tpu_torch.symbolic.plan import build_plan
    from cholesky_tpu_torch.symbolic.quality import permuted_cost
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    shape, levels = SCALE
    n, r, c, _, o, cl, _ = generate_problem(shape, levels, seed=SEED)
    info, auto = {}, {}
    ordng, _ = nested_dissection_graph(n, r, c, levels=SCALE_ORDER_LEVELS,
                                       info=info)
    check(info["engine"] == "native", "140^3: ordered by the Python engine")
    t = time.perf_counter()
    nd_cost = permuted_cost(n, r, c, build_plan(ordng).perm)
    geo_cost = permuted_cost(n, r, c, build_plan(o, cl).perm)
    cost_s = time.perf_counter() - t
    nested_dissection_graph(n, r, c, info=auto)
    check(auto["engine"] == "native", "140^3: auto depth ran in Python")
    emit({"phase": "ordering", "what": "ordering only", "problem":
          f"{shape[0]}^3", "n": n, "levels": SCALE_ORDER_LEVELS,
          "order_s": info["order_s"], "ordering": info,
          "graph_nd": {"flops": nd_cost[0], "nnz_L": nd_cost[1]},
          "geometric": {"flops": geo_cost[0], "nnz_L": geo_cost[1]},
          "flops_ratio": nd_cost[0] / geo_cost[0],
          "two_costs_s": cost_s, "auto_depth": auto})


def qd_problem(shape, levels, seed):
    """The grid Laplacian with a seeded QD_NEG_FRAC of its diagonal signs
    flipped and |diag| + 0.5, so that both sign blocks stay strictly
    diagonally dominant (tests/test_ldlt.py's construction): (n, rows,
    cols, vals, ordering, clusters, b, signs)."""
    import numpy as np

    from cholesky_tpu_torch.utils.laplacian import generate_problem

    n, r, c, v, o, cl, b = generate_problem(shape, levels, seed=SEED)
    s = np.where(np.random.default_rng(seed).random(n) < QD_NEG_FRAC,
                 -1.0, 1.0)
    vq = v.copy()
    d = r == c
    vq[d] = s[r[d]] * (v[d] + 0.5)
    return n, r, c, vq, o, cl, b, s


def kkt_system(m: int, seed: int):
    """[[H, B^T], [B, -C]]: H the m^3 grid Laplacian (n1 dofs), B an
    [n1 / 4, n1] constraint block, each row coupling a seeded grid node
    and its +x neighbour with weights of opposite signs, C a seeded
    diagonal in [1, 2]. Returns (CSR matrix, signs, n1, n2)."""
    import numpy as np
    import scipy.sparse as sp

    from cholesky_tpu_torch.utils.laplacian import grid_laplacian

    n1, r, c, v = grid_laplacian((m, m, m))
    H = _scipy_matrix(n1, r, c, v)
    rng = np.random.default_rng(seed)
    n2 = n1 // 4
    p = rng.choice(np.arange(n1).reshape(m, m, m)[:, :, :-1].ravel(), n2,
                   replace=False)
    w = rng.uniform(0.5, 1.5, (n2, 2)) * np.array([1.0, -1.0])
    B = sp.csr_matrix((w.ravel(), (np.repeat(np.arange(n2), 2),
                                   np.stack([p, p + 1], 1).ravel())),
                      shape=(n2, n1))
    C = sp.diags(rng.uniform(1.0, 2.0, n2))
    K = sp.bmat([[H, B.T], [B, -C]]).tocsr()
    return K, np.concatenate([np.ones(n1), -np.ones(n2)]), n1, n2


def timed_sync(fn):
    """(fn(), synchronized wall seconds)."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_qd(spd):
    """The quasi-definite LDL^T path at 50^3 L8, f32, then a KKT system
    through from_scipy. `spd` is the slice's SPD solver (timed beside)."""
    import numpy as np
    import torch

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    n, r, c, vq, o, cl, b0, sg = qd_problem((50, 50, 50), 8, SEED + 90)
    s = SparseCholesky.from_coo(n, r, c, vq, o, cl, dtype=np.float32,
                                device="cuda", signs=sg)
    fp = s.fplan
    plan_s = time.perf_counter() - t0
    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    hook, read = level_probe(s, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for i in range(3):                  # cold, then warm (the last probed)
        _, wall = timed_sync(lambda: s.factorize(
            check=i == 0, level_hook=hook if i == 2 else None))
        walls.append(wall)
    per_level = read()
    launches = dict(hk.LAUNCHES)
    check(launches["chol_inv"] == 0, f"qd: {launches['chol_inv']} chol_inv "
          "launches in the signed factorizations")
    table = regime_table(fp, s.regimes, per_level)
    over = [x["lvl"] for x in table if x["peak_bytes"] > x["est_peak_bytes"]]
    check(not over, f"qd: measured peak over the estimate at levels {over}")
    spd_walls = [timed_sync(spd.factorize)[1] for _ in range(2)]
    prof = profiled(s.factorize)
    check(prof["chol_inv_count"] == 0, "qd: chol_inv in the profiled factor")
    emit({"phase": "qd", "problem": "50^3 L8", "n": n,
          "negative": int((sg < 0).sum()), "host_plan_s": plan_s,
          "factor_wall_s": walls[0], "factor_wall_warm_s": walls[1:],
          "spd_slice_factor_warm_s": spd_walls,
          "warm_over_spd": min(walls[1:]) / min(spd_walls),
          "plan_peak_bytes": s.regimes.peak_bytes, "levels": table,
          "chol_inv_launches": launches["chol_inv"],
          "factorizations": len(walls)})
    emit({"phase": "qd", "what": "warm factor under torch.profiler", **prof})

    a = _scipy_matrix(n, s.rows, s.cols, s.vals)
    solves = []
    for i in range(3):
        b = b0 if i == 0 else np.random.default_rng(SEED + 90 + i).integers(
            1, 11, size=n).astype(np.float64)
        x, wall = timed_sync(lambda: s.solve(b, tol=TOL))
        res = float(np.linalg.norm(a @ x - b) / np.linalg.norm(b))
        check(bool(np.all(np.isfinite(x))) and x.shape == (n,),
              "qd: solution not finite or of the wrong shape")
        check(res <= TOL, f"qd solve {i}: residual {res} > {TOL}")
        solves.append({"wall_s": wall, "residual": res, **s.last_solve})
    block = block_solve(s, a, QD_BLOCK_K, SEED + 93, "qd 50^3")
    neg = int((sg < 0).sum())
    sign, logabs = s.slogdet()
    check(sign == (-1) ** neg and s.inertia() == (n - neg, neg, 0),
          f"qd: slogdet sign {sign} / inertia {s.inertia()} vs the "
          f"signature ({n - neg}, {neg})")
    ref = SparseCholesky(s.plan, s.rows, s.cols, s.vals, dtype=np.float64,
                         device="cpu", signs=sg)
    ref._fplan = fp
    (ref_sign, ref_logabs), ref_s = timed_sync(ref.slogdet)
    rel = abs(logabs - ref_logabs) / abs(ref_logabs)
    check(ref_sign == sign and rel <= LOGDET_REL_TOL,
          f"qd: log|det| {logabs} vs the f64 CPU factor's {ref_logabs}")
    del ref
    emit({"phase": "qd", "problem": "50^3 L8", "solves": solves,
          "block_solve": block, "slogdet": [sign, logabs],
          "logabsdet_f64_cpu": ref_logabs, "logabsdet_rel_diff": rel,
          "tol": LOGDET_REL_TOL, "f64_cpu_factor_s": ref_s,
          "inertia": list(s.inertia())})
    del s

    K, ksg, n1, n2 = kkt_system(KKT_GRID, SEED + 94)
    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    ks = SparseCholesky.from_scipy(K, dtype=np.float32, device="cuda",
                                   signs=ksg)
    kfp = ks.fplan
    build_s = time.perf_counter() - t0
    kwalls = [timed_sync(lambda: ks.factorize(check=True))[1]
              for _ in range(2)]
    rows = []
    for i in range(2):
        b = np.random.default_rng(SEED + 95 + i).standard_normal(n1 + n2)
        x, wall = timed_sync(lambda: ks.solve(b, tol=TOL))
        res = float(np.linalg.norm(K @ x - b) / np.linalg.norm(b))
        check(res <= TOL, f"qd KKT: residual {res} > {TOL}")
        rows.append({"wall_s": wall, "residual": res, **ks.last_solve})
    check(ks.ordering_info["engine"] == "native",
          "qd KKT: ordered by the Python engine")
    check(ks.inertia() == (n1, n2, 0) and ks.slogdet()[0] == (-1) ** n2,
          f"qd KKT: inertia {ks.inertia()} != ({n1}, {n2}, 0)")
    check(hk.LAUNCHES["chol_inv"] == 0, "qd KKT: chol_inv launched")
    emit({"phase": "qd", "problem": f"KKT {KKT_GRID}^3 + {n2}", "n": n1 + n2,
          "n1": n1, "n2": n2, "nnz": int(K.nnz),
          "ordering": ks.ordering_info, "build_s": build_s,
          "levels": [{"lvl": l, "B": 1 << l, "F": kfp.F[l], "W": kfp.W[l]}
                     for l in range(kfp.levels)],
          "factor_wall_s": kwalls[0], "factor_wall_warm_s": kwalls[1],
          "solves": rows, "inertia": list(ks.inertia())})
    return launches["chol_inv"]


MIXED_NE, MIXED_LEVELS = 16, 10   # the mixed phase's cube: 17,968 dofs


def column_loop_ops(fn) -> list:
    """The operators of the signed column loop (`addcmul_`, `sqrt_`) that
    one call of fn runs, by torch.profiler's CPU records: none since each
    panel is one `signed_panel` launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if "addcmul" in e.key or "sqrt" in e.key})


def phase_mixed():
    """The hybrid u-p elasticity of `cholbench/configs/elast_q1p0_48.json`
    at ne MIXED_NE on the card, through the operator's own `build` and the
    solver's normal path, checked against the operator's f64 reference."""
    import numpy as np
    import torch

    from cholbench.operators import elasticity_q1p0 as op

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "cholbench/configs/elast_q1p0_48.json")) as f:
        cfg = json.load(f)
    ne = MIXED_NE
    cfg["operator"] = dict(cfg["operator"], ne=ne)
    cfg.update(n=3 * (ne + 1) * ne * (ne + 1) + ne ** 3, levels=MIXED_LEVELS)
    t0 = time.perf_counter()
    s, vals = op.build(cfg, torch.device("cuda"))
    plan_s = time.perf_counter() - t0
    ref = op.Reference(cfg)
    n, fp = cfg["n"], s.fplan
    walls = [timed_sync(s.factorize)[1] for _ in range(3)]
    stats = dict(s.factor_stats)
    W = [int(w) for w in fp.W]
    check(stats["signed_columns"] == sum(W) and stats["signed_panels"] == sum(
        -(-w // 32) for w in W), f"mixed: counters {stats} against the "
        f"plan's widths {W}")
    check(stats["signed_panel_launches"] == stats["signed_panels"],
          f"mixed: {stats['signed_panel_launches']} signed_panel launches "
          f"for {stats['signed_panels']} panels")
    prof = profiled(s.factorize)
    loop_ops = column_loop_ops(s.factorize)
    check(not loop_ops, f"mixed: the factorization still runs {loop_ops}")
    solves = []
    for i in range(3):
        b = np.random.default_rng(SEED + 97 + i).standard_normal(n)
        x, wall = timed_sync(lambda: s.solve(b, tol=TOL))
        res = float(np.linalg.norm(b - ref.matvec(x, 0.0))
                    / np.linalg.norm(b))
        check(res <= TOL, f"mixed solve {i}: residual {res} > {TOL}")
        solves.append({"wall_s": wall, "residual": res, **s.last_solve})
    x0 = s.solve(b, refine="never")
    eta = float(np.abs(b - ref.matvec(x0, 0.0)).max()
                / (ref.norm_inf(0.0) * np.abs(x0).max() + np.abs(b).max()))
    n_p = ne ** 3
    check(s.inertia() == (n - n_p, n_p, 0), f"mixed: inertia {s.inertia()}")
    emit({"phase": "mixed", "problem": f"hybrid u-p ne {ne} L{MIXED_LEVELS}",
          "n": n, "pressures": n_p, "host_plan_s": plan_s,
          "factor_wall_s": walls[0], "factor_wall_warm_s": walls[1:],
          "signed_panels": stats["signed_panels"],
          "signed_columns": stats["signed_columns"],
          "signed_panel_launches": stats["signed_panel_launches"],
          "levels": [{"lvl": l, "B": 1 << l, "F": int(fp.F[l]), "W": W[l]}
                     for l in range(fp.levels)],
          "profiled_factor": prof,
          "launches_per_column": prof["kernel_launches"]
          / stats["signed_columns"],
          "solves": solves, "factor_eta": eta,
          "factor_eta_limit": cfg["limits"]["factor_eta"],
          "inertia": list(s.inertia())})


def phase_companions(s, b0):
    """The factor's companions on the slice's 50^3 L8 f32 factor."""
    import numpy as np
    import scipy.sparse as sp

    from cholesky_tpu_torch import SparseCholesky

    check(s.factored, "the slice's factor is gone")
    n = s.plan.n
    a = _scipy_matrix(n, s.rows, s.cols, s.vals)
    S, schur_s = timed_sync(s.schur_complement)
    bh, cond_s = timed_sync(lambda: s.condense_rhs(b0))
    t = time.perf_counter()
    xr = np.linalg.solve(S, bh)
    dense_s = time.perf_counter() - t
    x, expand_s = timed_sync(lambda: s.expand_solution(b0, xr))
    x_ref = s.solve(b0, tol=TOL)
    err = float(np.abs(x - x_ref).max() / np.abs(x_ref).max())
    check(S.shape == (len(s.schur_dofs()),) * 2 and err <= SCHUR_REL_TOL,
          f"schur round trip differs from a refined solve by {err}")
    emit({"phase": "companions", "what": "schur", "problem": "50^3 L8",
          "schur_shape": list(S.shape), "root_W": s.fplan.W[0],
          "schur_complement_s": schur_s, "condense_rhs_s": cond_s,
          "numpy_dense_solve_s": dense_s, "expand_solution_s": expand_s,
          "rel_err_vs_refined_solve": err, "tol": SCHUR_REL_TOL})

    rng = np.random.default_rng(SEED + 100)
    dofs = rng.choice(n, WOODBURY_K, replace=False)
    U = np.zeros((n, WOODBURY_K))
    U[dofs, np.arange(WOODBURY_K)] = 1.0
    x, upd_s = timed_sync(lambda: s.solve_updated(b0, U, 1.0))
    a_up = a + sp.csr_matrix((np.ones(WOODBURY_K), (dofs, dofs)),
                             shape=(n, n))
    res = float(np.linalg.norm(a_up @ x - b0) / np.linalg.norm(b0))
    check(res <= TOL, f"solve_updated: residual {res} > {TOL}")
    ldu, ldu_s = timed_sync(lambda: s.logdet_updated(U, 1.0))
    vals2 = s.vals.copy()
    vals2[(s.rows == s.cols) & np.isin(s.rows, dofs)] += 1.0
    s2 = SparseCholesky(s.plan, s.rows, s.cols, vals2, dtype=np.float32,
                        device="cuda")
    s2._fplan = s.fplan
    s2.factorize()
    ld2 = s2.logdet()
    ld_rel = abs(ldu - ld2) / abs(ld2)
    check(ld_rel <= LOGDET_REL_TOL, f"logdet_updated {ldu} vs the updated "
          f"solver's logdet {ld2}")
    emit({"phase": "companions", "what": "woodbury", "k": WOODBURY_K,
          "solve_updated_s": upd_s, "residual": res,
          "logdet_updated_s": ldu_s, "logdet_updated": ldu,
          "logdet_after_update_values": ld2, "rel_diff": ld_rel,
          "tol": LOGDET_REL_TOL})

    new = spd_perturbation(s.rows, s.cols, s.vals, SEED + 101)
    xp, pert_s = timed_sync(lambda: s.solve_perturbed(
        b0, s.rows, s.cols, new - s.vals, tol=TOL))
    a_new = _scipy_matrix(n, s.rows, s.cols, new)
    res = float(np.linalg.norm(a_new @ xp - b0) / np.linalg.norm(b0))
    check(res <= TOL, f"solve_perturbed: residual {res} > {TOL}")

    def refactor():
        s2.update_values(new)
        s2.factorize()
        return s2.solve(b0, tol=TOL)

    x2, refac_s = timed_sync(refactor)
    res2 = float(np.linalg.norm(a_new @ x2 - b0) / np.linalg.norm(b0))
    del s2
    emit({"phase": "companions", "what": "solve_perturbed",
          "wall_s": pert_s, "iterations": s.last_perturbed["iterations"],
          "residual": res, "update_factorize_solve_s": refac_s,
          "update_factorize_solve_residual": res2})

    side = round(n ** (1 / 3))                 # the slice's N^3 grid
    i = np.arange(1, side + 1)
    l1 = 4.0 * np.sin(i * np.pi / (2 * (side + 1))) ** 2
    exact = np.sort((l1[:, None, None] + l1[None, :, None]
                     + l1[None, None, :]).ravel())
    anorm = float(np.abs(a).sum(axis=1).max())
    rows = []
    for which, k, m in (("smallest", 6, None), ("largest", 1, 256)):
        (w, V), wall = timed_sync(lambda: s.eigsh(k=k, which=which, m=m))
        rel = [float(np.min(np.abs(exact - x)) / x) for x in w]
        res = np.linalg.norm(a @ V - V * w, axis=0)
        check(max(rel) <= EIG_REL_TOL and float(res.max()) <= 1e-9 * anorm,
              f"eigsh({which}): {w} off the exact spectrum by {max(rel)}, "
              f"residual {res.max()}")
        rows.append({"which": which, "k": k, "m": m, "wall_s": wall,
                     "eigenvalues": w.tolist(), "rel_err_max": max(rel),
                     "residual_max": float(res.max()),
                     "gate": 1e-9 * anorm})
    kappa = float(exact[-1] / exact[0])
    kl, kl_s = timed_sync(lambda: s.condest(method="lanczos"))
    kp, kp_s = timed_sync(s.condest)
    k_rel = abs(kl - kappa) / kappa
    check(k_rel <= COND_REL_TOL, f"condest(lanczos) {kl} vs exact {kappa}")
    emit({"phase": "companions", "what": "spectra", "eigsh": rows,
          "exact_kappa": kappa, "condest_lanczos": kl,
          "condest_lanczos_s": kl_s, "condest_lanczos_rel_err": k_rel,
          "condest_power": kp, "condest_power_s": kp_s,
          "tol": COND_REL_TOL})


def _tagged(stdout: str, tag: str):
    return [ast.literal_eval(ln.split(": ", 1)[1])
            for ln in stdout.splitlines() if ln.startswith(tag + ": ")]


def phase_cli():
    """The command-line interface as a subprocess on the card."""
    import numpy as np
    import scipy.sparse.linalg as spla

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.io import mmio, ordering as ordio
    from cholesky_tpu_torch.numeric.frontal_plan import build_frontal_plan
    from cholesky_tpu_torch.symbolic import fill
    from cholesky_tpu_torch.symbolic.plan import build_plan
    from cholesky_tpu_torch.utils.laplacian import generate_problem
    from cholesky_tpu_torch.verify import schedule

    shape, levels = CLI_PROBLEM
    n, r, c, v, o, cl, b = generate_problem(shape, levels, seed=SEED)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory() as d:
        f = {k: os.path.join(d, k) for k in (
            "m.mtx", "ord.txt", "clust.txt", "b.mtx", "sol.txt", "sol2.txt",
            "factor.mtx", "ck.npz", "diag.txt", "dbg")}
        mmio.write_coo(f["m.mtx"], r, c, v, (n, n), symmetry="hermitian")
        ordio.write_ordering(f["ord.txt"], o)
        ordio.write_clusters(f["clust.txt"], cl)
        mmio.write_array(f["b.mtx"], b)
        base = [sys.executable, "-m", "cholesky_tpu_torch.cli", "-i",
                f["m.mtx"], "-s", f["ord.txt"], "-c", f["clust.txt"], "-b",
                f["b.mtx"], "--dtype", "float32", "--device", "cuda"]
        runs = []
        for extra in (["-o", f["sol.txt"], "-m", f["factor.mtx"], "--profile",
                       "--save-factor", f["ck.npz"], "--inv-diag",
                       f["diag.txt"], "--bench", "-d", f["dbg"]],
                      ["-o", f["sol2.txt"], "--load-factor", f["ck.npz"]]):
            t = time.perf_counter()
            p = subprocess.run(base + extra, cwd=root, env=env, timeout=600,
                               capture_output=True, text=True)
            check(p.returncode == 0, f"cli exited {p.returncode}: "
                  f"{p.stderr[-2000:]}")
            check("RuntimeWarning" not in p.stderr,
                  f"cli warned: {p.stderr[-2000:]}")
            runs.append((p.stdout, time.perf_counter() - t))
        log = os.path.join(f["dbg"], "output")
        check(os.path.isfile(log), "cli: -d wrote no log")
        with open(log) as fh:
            log_ops = sum(ln.startswith(("POTRF:", "TRSM:", "GEMM:"))
                          for ln in fh)
        fa = fill.analyze_fill(build_plan(o, cl), *mmio.dedup_lower(r, c, v))
        check(fa.engine == "native", "cli: the fill analysis ran in Python")
        n_ops = len(schedule.generate_schedule(fa))
        check(log_ops == n_ops, f"cli: the -d log has {log_ops} op lines, "
              f"the schedule {n_ops}")
        check("fill engine: native" in runs[0][0], "cli: -d's fill analysis "
              "did not run natively")
        io_s = file_io(f["m.mtx"], f["factor.mtx"], d)
        x = np.loadtxt(f["sol.txt"])
        x2 = np.loadtxt(f["sol2.txt"])
        inv_d = np.loadtxt(f["diag.txt"])
        with open(f["factor.mtx"]) as fh:
            fh.readline()
            fdim = [int(t) for t in fh.readline().split()]
    (out, wall), (out2, wall2) = runs
    a = _scipy_matrix(n, r, c, v)
    x_ref = spla.spsolve(a.tocsc(), b)
    err = float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))
    (factor,), (solve,) = _tagged(out, "FACTOR"), _tagged(out, "SOLVE")
    (solve2,) = _tagged(out2, "SOLVE")
    blas = _tagged(out, "BLAS")
    fp = build_frontal_plan(build_plan(o, cl), r, c)
    routed = [x["lvl"] for x in level_routes(fp) if x["route"] == "kernel"]
    slab_levels = sorted(x["Level"] for x in blas if x["op"] == "FACTOR_SLAB")
    potrf_levels = sorted(x["Level"] for x in blas if x["op"] == "POTRF")
    check(routed and slab_levels == routed,
          f"cli: FACTOR_SLAB on levels {slab_levels}, the rule routes "
          f"{routed}")
    check(potrf_levels == [lvl for lvl in range(fp.levels)
                           if lvl not in routed],
          f"cli: POTRF on levels {potrf_levels}")
    check(solve["residual"] <= TOL and solve2["residual"] <= TOL,
          f"cli: residuals {solve['residual']}, {solve2['residual']}")
    check(err <= SMALL_REL_TOL, f"cli: solution file differs from SciPy: "
          f"{err}")
    check(float(np.abs(x2 - x).max()) <= SMALL_REL_TOL * float(
        np.abs(x).max()), "cli: the resumed solve differs")
    check("Loaded factor:" in out2 and "Done factoring" not in out2,
          "cli: --load-factor factored again")
    check(fdim[:2] == [n, n] and fdim[2] > n, f"cli: factor file {fdim}")
    (invdiag,) = _tagged(out, "INVDIAG")
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                device="cuda")
    dofs = np.random.default_rng(SEED + 80).choice(n, 64, replace=False)
    ref = unit_solves(s, a, dofs, "cli --inv-diag")[dofs, np.arange(64)]
    inv_err = float((np.abs(inv_d[dofs] - ref) / np.abs(ref)).max())
    check(inv_d.shape == (n,) and inv_err <= SELINV_F32_TOL,
          f"cli: the --inv-diag file differs from unit-vector solves by "
          f"{inv_err}")
    emit({"phase": "cli", "problem": f"{shape[0]}^3 L{levels}", "n": n,
          "kernel_routed_levels": routed, "factor": factor, "solve": solve,
          "resumed_solve": solve2, "rel_err_vs_scipy": err,
          "invdiag": invdiag, "inv_diag_rel_err_64_dofs": inv_err,
          "factor_file_nnz": fdim[2], "blas": blas,
          "process_wall_s": [wall, wall2],
          "python_engine_process_wall_s": list(PYTHON_CLI_WALL_S),
          "debug_log_op_lines": log_ops, "file_io_s": io_s})


def file_io(matrix, factor, d) -> dict:
    """Seconds of mmio.read_coo of the matrix file and mmio.write_coo of
    the factor file's entries, native beside Python; both writers must
    write the same bytes."""
    import filecmp

    from cholesky_tpu_torch.io import mmio

    out = {}
    for native in (True, False):
        t = time.perf_counter()
        mmio.read_coo(matrix, native=native)
        out[f"read_coo_matrix_{'native' if native else 'python'}"] = (
            time.perf_counter() - t)
    banner, fr, fc, fv = mmio.read_coo(factor)
    paths = {}
    for native in (True, False):
        tag = "native" if native else "python"
        paths[tag] = os.path.join(d, f"rewrite_{tag}.mtx")
        t = time.perf_counter()
        mmio.write_coo(paths[tag], fr, fc, fv, (banner.rows, banner.cols),
                       symmetry=banner.symmetry, native=native)
        out[f"write_coo_factor_{tag}"] = time.perf_counter() - t
    check(filecmp.cmp(paths["native"], paths["python"], shallow=False),
          "the native and Python writers wrote different files")
    check(filecmp.cmp(paths["native"], factor, shallow=False),
          "the rewritten factor file differs from the CLI's")
    for path in paths.values():
        os.remove(path)
    out["factor_entries"] = int(banner.nnz)
    return out


def phase_debug():
    """The CLI's -d / --debug-dumps on the card at the reference's
    lapl_400x400 shape, checked by the replay oracle."""
    from cholesky_tpu_torch.io import mmio, ordering as ordio
    from cholesky_tpu_torch.utils.laplacian import generate_problem
    from cholesky_tpu_torch.verify import replay

    shape, levels = DEBUG_PROBLEM
    n, r, c, v, o, cl, b = generate_problem(shape, levels, seed=SEED)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory() as d:
        f = {k: os.path.join(d, k) for k in (
            "m.mtx", "ord.txt", "clust.txt", "B.mtx", "factored.mtx", "dbg")}
        mmio.write_coo(f["m.mtx"], r, c, v, (n, n), symmetry="hermitian")
        ordio.write_ordering(f["ord.txt"], o)
        ordio.write_clusters(f["clust.txt"], cl)
        mmio.write_array(f["B.mtx"], b)
        cmd = [sys.executable, "-m", "cholesky_tpu_torch.cli", "-i",
               f["m.mtx"], "-s", f["ord.txt"], "-c", f["clust.txt"], "-b",
               f["B.mtx"], "-m", f["factored.mtx"], "--dtype", "float64",
               "-d", f["dbg"], "--debug-dumps", "--device", "cuda"]
        t = time.perf_counter()
        p = subprocess.run(cmd, cwd=root, env=env, timeout=600,
                           capture_output=True, text=True)
        wall = time.perf_counter() - t
        check(p.returncode == 0, f"debug: cli exited {p.returncode}: "
              f"{p.stderr[-2000:]}")
        check("fill engine: native" in p.stdout
              and "RuntimeWarning" not in p.stderr,
              "debug: the fill analysis did not run natively")
        (solve,) = _tagged(p.stdout, "SOLVE")
        check(solve["residual"] <= TOL, f"debug: residual {solve}")
        dumps = [x for x in os.listdir(f["dbg"]) if x.endswith(".mtx")]
        check(len(dumps) > 0, "debug: --debug-dumps wrote no dump")
        t = time.perf_counter()
        ok = replay.debug_factor(f["m.mtx"], f["ord.txt"], f["factored.mtx"],
                                 os.path.join(f["dbg"], "output"),
                                 directory=f["dbg"], rtol=DEBUG_TOL,
                                 atol=DEBUG_TOL)
        oracle_s = time.perf_counter() - t
        check(ok, "debug: debug_factor rejected the card's factor")
    emit({"phase": "debug", "problem": f"{shape[0]}^2 L{levels}", "n": n,
          "dumps": len(dumps), "process_wall_s": wall,
          "debug_factor": ok, "debug_factor_s": oracle_s, "tol": DEBUG_TOL,
          "solve": solve})


def phase_native():
    """Every ordering, fill analysis and matrix file read or written in
    this process ran on the native host core: the count of each."""
    from cholesky_tpu_torch.native import ext

    calls = dict(ext.CALLS)
    for name in ("nd_order", "md_order", "col_counts", "fill_initial",
                 "fill_analyze", "read_coo_body", "write_coo"):
        check(calls.get(name, 0) > 0, f"the native {name} never ran")
    emit({"phase": "native", "calls": calls})


# ---------------------------------------------------------------------------
# The matmul-precision ladder


def _want_flag(resolved) -> str:
    return "ieee" if resolved in ("highest", "float32") else "tf32"


def rung_runs(s, a, b, what: str, rungs=PRECISION_RUNGS,
              block_k: int = 0) -> list:
    """Per rung (None: AUTO, through the setter; the others through
    factorize(precision=)), two factorizations of solver s (the first after
    the rung changed, then warm), two solves of b (the first computes the
    pivot inverses) and, with block_k, a seeded [n, block_k] block. Per
    rung: the resolved name, the flag before, inside the level loop and
    after, walls, sweeps, f64 residuals against the SciPy matrix a (each
    at the contract), and chol_inv launches, set to 0 before the rung's
    factorizations and read after them, against the routing rule."""
    import numpy as np
    import torch

    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    rows = []
    for rung in rungs:
        before = fp32_flag()
        inside = set()
        if rung is None:
            s.precision = None
        for k in hk.LAUNCHES:
            hk.LAUNCHES[k] = 0
        walls = []
        for i in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.factorize(precision=rung, level_hook=(
                lambda lvl, where: inside.add(fp32_flag())) if i == 0
                else None)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        launches = hk.LAUNCHES["chol_inv"]
        want = expected_launches(s.fplan, s.regimes) * len(walls)
        resolved = s.precision
        name = f"{what} at {rung or 'AUTO'}"
        check(launches == want, f"{name}: {launches} chol_inv launches, the "
              f"routing rule gives {want}")
        check_slab_launches(hk.LAUNCHES, expected_launches(
            s.fplan, s.regimes, "factor_slab") * len(walls), name)
        check(inside == {_want_flag(resolved)},
              f"{name}: the level loop ran under {inside}")
        solves = []
        for i in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            x = s.solve(b, tol=TOL)
            wall = time.perf_counter() - t
            res = float(np.linalg.norm(a @ x - b) / np.linalg.norm(b))
            check(bool(np.all(np.isfinite(x))), f"{name}: not finite")
            check(res <= TOL, f"{name}: residual {res} > {TOL}")
            solves.append({"wall_s": wall, "residual": res,
                           **s.last_solve})
        block = (block_solve(s, a, block_k, SEED + 80, name) if block_k
                 else None)
        after = fp32_flag()
        check(after == before, f"{name}: the flag was {before}, is {after}")
        rows.append({"rung": rung or "AUTO", "resolved": resolved,
                     "flag_before": before, "flag_in_factor": sorted(inside),
                     "flag_after": after, "factor_wall_s": walls[0],
                     "factor_wall_warm_s": walls[1], "solves": solves,
                     "block_solve": block,
                     "factor_plus_solve_s": walls[1] + solves[0]["wall_s"],
                     "chol_inv_launches": launches, "rule": want})
    return rows


def crossover(rows) -> dict:
    """Warm factor plus the first solve after it, "highest" against
    "default": the rung AUTO should pick for one solve a factorization."""
    by = {r["rung"]: r["factor_plus_solve_s"] for r in rows}
    return {"highest_s": by["highest"], "default_s": by["default"],
            "faster": min(("highest", "default"), key=by.get)}


def demote_ab(s, a, b) -> list:
    """The solve's apply rung, A/B in one run (off, on, on, off):
    `refine.solve_refined_df` with demote_apply False (the port's default:
    the solve at the factor's rung) and True (at the one-pass rung, the
    JAX package's default), under the solver's rung: sweeps, walls and
    f64 residuals at the contract."""
    import numpy as np
    import torch

    from cholesky_tpu_torch.numeric import refine
    from cholesky_tpu_torch.numeric.precision import precision_ctx

    ell, inv = s._ell_device(True), s._inv_pivots()
    perm, iperm = s._perm_device()
    runs = []
    for demote in (False, True, True, False):
        with precision_ctx(s.precision):
            torch.cuda.synchronize()
            t = time.perf_counter()
            xp, sweeps, rn = refine.solve_refined_df(
                s.fplan, s.panels, inv, torch.from_numpy(b).to(s.device)[perm],
                ell, tol=TOL / 3.0, demote_apply=demote)
            x = xp[iperm].cpu().numpy()
            wall = time.perf_counter() - t
        res = float(np.linalg.norm(a @ x - b) / np.linalg.norm(b))
        check(res <= TOL, f"demote_apply={demote}: residual {res} > {TOL}")
        runs.append({"demote_apply": demote, "sweeps": sweeps,
                     "wall_s": wall, "residual": res, "rn_rel": rn})
    return runs


def one_pass_companions(s, a) -> dict:
    """At the "default" rung: inv_diag against refined unit-vector solves,
    and a family of FAMILY_K[0] scaled systems solved per system to the
    contract. Selected inversion is not refined, so its error is the TF32
    factor's: it is reported beside the f32 bound SELINV_F32_TOL (which
    the selinv phase holds at the IEEE rung), not held to it."""
    import numpy as np

    s.factorize(precision="default")
    rec, _ = inv_diag_check(s, a, SEED + 82, "50^3 L8 at default", tol=None)
    rec["within_the_f32_bound"] = rec["rel_err_64_dofs"] <= SELINV_F32_TOL
    n, K = s.plan.n, FAMILY_K[0]
    scales = 1.0 + np.random.default_rng(SEED + 83).uniform(0, 2, size=K)
    vals = scales[:, None] * s.vals[None, :]
    bf = s.factorize_many(vals)
    B = np.random.default_rng(SEED + 84).standard_normal((K, n))
    X = bf.solve(B, tol=TOL)
    res = np.array([np.linalg.norm(scales[i] * (a @ X[i]) - B[i])
                    / np.linalg.norm(B[i]) for i in range(K)])
    check(float(res.max()) <= TOL, f"family at default: worst system's "
          f"residual {res.max()} > {TOL}")
    return {"resolved": s.precision, "inv_diag": rec, "family_K": K,
            "family_residual_max": float(res.max()),
            "family_solve": bf.last_solve}


def phase_precision(s, b):
    """The ladder on the slice's 50^3 solver (AUTO resolves "highest"),
    the A/B of the solve's apply rung, and the AUTO crossover at 50^3 and
    on a gallery matrix. Returns chol_inv launches by path."""
    import numpy as np
    import scipy.sparse as sp

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.utils import capacity, problems

    a = _scipy_matrix(s.plan.n, s.rows, s.cols, s.vals)
    flops = capacity.frontal_flops(s.fplan)
    rows = rung_runs(s, a, b, "50^3 L8", block_k=PRECISION_BLOCK_K)
    for r in rows:
        emit({"phase": "precision", "problem": "50^3 L8",
              "frontal_flops": flops, **r})
    check(rows[0]["resolved"] == "highest",
          f"50^3 L8: AUTO resolved {rows[0]['resolved']}")
    emit({"phase": "precision", "problem": "50^3 L8",
          "what": "selected inversion and a family at default",
          **one_pass_companions(s, a)})
    s.precision = None
    s.factorize()
    emit({"phase": "precision", "problem": "50^3 L8",
          "what": "apply rung A/B", "resolved": s.precision,
          "runs": demote_ab(s, a, b)})
    launches = {"50^3 L8": sum(r["chol_inv_launches"] for r in rows)}

    name, scale = CROSSOVER
    n, r, c, v = problems.make_gallery(scale)[name]()
    g = SparseCholesky.from_scipy(sp.csr_matrix((v, (r, c)), shape=(n, n)),
                                  dtype=np.float32, device="cuda")
    ga = _scipy_matrix(n, g.rows, g.cols, g.vals)
    gb = np.random.default_rng(SEED + 81).standard_normal(n)
    auto = g.precision
    g.solve(gb, tol=TOL)        # first use: the ELL planes, outside the A/B
    grows = rung_runs(g, ga, gb, f"{name} x{scale}",
                      rungs=("highest", "default"))
    for row in grows:
        emit({"phase": "precision", "problem": f"{name} x{scale}", "n": n,
              "frontal_flops": capacity.frontal_flops(g.fplan), **row})
    emit({"phase": "precision", "what": "AUTO crossover",
          "threshold_flops": 1e12,
          "50^3 L8": {"frontal_flops": flops, "auto": rows[0]["resolved"],
                      **crossover(rows)},
          f"{name} x{scale}": {
              "frontal_flops": capacity.frontal_flops(g.fplan),
              "auto": auto, **crossover(grows)}})
    launches[f"{name} x{scale}"] = sum(x["chol_inv_launches"] for x in grows)
    return launches


def phase_precision_scale(s, a, b):
    """The ladder on the scale phase's 140^3 solver under the default
    budget (AUTO resolves the one-pass rung there). Returns its chol_inv
    launches."""
    from cholesky_tpu_torch.utils import capacity

    s.budget = None
    flops = capacity.frontal_flops(s.fplan)
    rows = rung_runs(s, a, b, "140^3 L14")
    for r in rows:
        emit({"phase": "precision", "problem": "140^3 L14",
              "frontal_flops": flops, **r})
    check(rows[0]["resolved"] is None,
          f"140^3 L14: AUTO resolved {rows[0]['resolved']}")
    emit({"phase": "precision", "what": "AUTO crossover",
          "140^3 L14": {"frontal_flops": flops, "auto": None,
                        **crossover(rows)}})
    return sum(r["chol_inv_launches"] for r in rows)


def phase_precision_kernels():
    """What the flag does on its own, at the 140^3 shapes: a batched
    [GEMM_B, 128, 128] f32 GEMM under each flag (time, bound, error
    against an f64 product: TF32 must be faster and coarser); chol_inv at
    each 140^3 batch under both flags (bit-identical: it computes in
    scalar FMAs) after the kernel phase's check against its plain version;
    the library pair (`cholesky_ex`, `solve_triangular`) under both flags,
    reported; factor_slab under both flags beside its bounds."""
    import torch

    from cholesky_tpu_torch.numeric import hopper_kernels as hk
    from cholesky_tpu_torch.numeric.precision import precision_ctx

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    x = torch.randn(GEMM_B, 128, 128, generator=gen, device=dev)
    y = torch.randn(GEMM_B, 128, 128, generator=gen, device=dev)
    ref = torch.bmm(x.double(), y.double())
    flops = 2 * GEMM_B * 128 ** 3
    bytes_ms = 3 * GEMM_B * 128 * 128 * 4 / hk.HBM_BYTES_PER_S * 1e3
    gemm = {}
    for rung, peak in (("highest", hk.FP32_FLOPS),
                       ("default", hk.TF32_FLOPS)):
        with precision_ctx(rung):
            flag = fp32_flag()
            err = rel_err(torch.bmm(x, y), ref)
            ms = cuda_ms_median(lambda: torch.bmm(x, y))
        bound = max(bytes_ms, flops / peak * 1e3)
        gemm[flag] = {"ms": ms, "rel_err_vs_f64": err, "bound_ms": bound,
                      "bound_by": ("bytes" if bytes_ms * 1e-3 * peak >= flops
                                   else "operations"),
                      "tflops": flops / ms * 1e-9}
    del x, y, ref
    # reading the legacy flag after the new API set it: torch raises on
    # the mix, which is why nothing here reads `allow_tf32`
    with precision_ctx("default"):
        try:
            mixed = f"reads {torch.backends.cuda.matmul.allow_tf32}"
        except RuntimeError as e:
            mixed = f"raises: {str(e)[:160]}"
    emit({"phase": "precision", "what": "batched GEMM",
          "shape": [GEMM_B, 128, 128], **gemm,
          "legacy_allow_tf32_under_the_new_api": mixed})
    check(gemm["tf32"]["ms"] < gemm["ieee"]["ms"],
          "the GEMM is not faster under tf32")
    check(gemm["tf32"]["rel_err_vs_f64"]
          > TF32_ERR_RATIO * gemm["ieee"]["rel_err_vs_f64"],
          "the GEMM is no coarser under tf32: the flag took no effect")

    eye = torch.eye(128, device=dev)
    big = torch.randn(max(CHOL_INV_140), 128, 128, generator=gen, device=dev)
    big = big @ big.transpose(1, 2) / 128 + 0.5 * eye
    rows = []
    for B in CHOL_INV_140:
        d = big[:B].contiguous()
        errs = check_chol_inv(d)            # at the process flag, as before
        out = {}
        for rung in ("highest", "default"):
            with precision_ctx(rung):
                out[fp32_flag()] = (hk.chol_inv(d), hk.chol_inv_ref(d))
        torch.cuda.synchronize()
        (lk_i, mk_i), (lp_i, mp_i) = out["ieee"]
        (lk_t, mk_t), (lp_t, mp_t) = out["tf32"]
        same = bool(torch.equal(lk_i, lk_t) and torch.equal(mk_i, mk_t))
        check(same, f"chol_inv at [{B},128,128] differs under tf32")
        rows.append({"shape": [B, 128, 128], "bit_identical": same,
                     "max_abs_err": errs["max_abs_err"],
                     "cholesky_ex_identical": bool(torch.equal(lp_i, lp_t)),
                     "cholesky_ex_max_diff": float((lp_i - lp_t).abs().max()),
                     "solve_triangular_identical": bool(
                         torch.equal(mp_i, mp_t)),
                     "solve_triangular_max_diff": float(
                         (mp_i - mp_t).abs().max())})
        del out, d
    del big
    emit({"phase": "precision", "what": "chol_inv and the library pair "
          "under both flags", "rows": rows})
    # cuSOLVER / cuBLAS on the wider pivot blocks of the plain levels
    lib = []
    for B, W in ((64, 512), (1, 4096)):
        g = torch.randn(B, W, W, generator=gen, device=dev)
        d = g @ g.transpose(1, 2) / W + torch.eye(W, device=dev)
        del g
        out = {}
        for rung in ("highest", "default"):
            with precision_ctx(rung):
                L, _ = torch.linalg.cholesky_ex(d)
                out[fp32_flag()] = (L, torch.linalg.solve_triangular(
                    L, d, upper=False))
        torch.cuda.synchronize()
        lib.append({"shape": [B, W, W],
                    "cholesky_ex_identical": bool(torch.equal(
                        out["ieee"][0], out["tf32"][0])),
                    "cholesky_ex_rel_diff": rel_err(out["tf32"][0],
                                                    out["ieee"][0]),
                    "solve_triangular_identical": bool(torch.equal(
                        out["ieee"][1], out["tf32"][1])),
                    "solve_triangular_rel_diff": rel_err(out["tf32"][1],
                                                         out["ieee"][1])})
        del out, d
    emit({"phase": "precision", "what": "library pair under both flags",
          "rows": lib})

    B, F, W = 128, 1440, 864
    tool = slab_tool()
    a, _ = tool["known_slab"](B, F, W, gen, dev)
    slab = {}
    for rung, peak in (("highest", hk.FP32_FLOPS),
                       ("default", hk.TF32_FLOPS)):
        with precision_ctx(rung):
            f = hk.factor_slab(a, W)
            bound_ms, bound_by = hk.factor_slab_bound(B, F, W, peak)
            slab[fp32_flag()] = {
                "ms": cuda_ms(lambda: hk.factor_slab(a, W), iters=5),
                "plain_ms": cuda_ms(lambda: hk.factor_slab_ref(a, W),
                                    iters=5),
                "composite_ms": cuda_ms(lambda: hk.factor_slab_ref(
                    a, W, block_fn=hk.chol_inv), iters=5),
                "library_ms": cuda_ms(lambda: slab_library(a, W), iters=5),
                "bound_ms": bound_ms, "bound_by": bound_by, "out": f}
    diff = tool["slab_err"](slab["tf32"].pop("out"), slab["ieee"].pop("out"),
                            W)
    emit({"phase": "precision", "what": "factor_slab under both flags",
          "shape": [B, F, W], **slab, "tf32_vs_ieee_rel_diff": diff})


def mesh_devices(slots: int):
    """`slots` slots over the machine's cards, round robin: distinct cards
    when it has that many, else logical slots sharing them (all on cuda:0
    on a one-card machine); and how many distinct cards they use."""
    import torch

    count = min(torch.cuda.device_count(), slots)
    return [torch.device("cuda", i % count) for i in range(slots)], count


def expected_mesh_launches(fp, plan, mesh, paths,
                           kernel: str = "chol_inv") -> int:
    """Launches of `kernel` in one mesh factorization by the routing rule:
    per level the rule on the level's batch over the whole mesh (a chunk's
    with chunks), one launch per 128-wide panel per chunk, on every slot of
    a slot-sharded level and on the first slot of a replicated one; row
    groups and the collective root take none."""
    import torch

    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    total = 0
    for lvl, lp in enumerate(plan.levels):
        if paths[lvl] not in ("slot", "replicated"):
            continue
        b = (plan.family << lvl) // lp.chunks
        if hk.slab_kernel_eligible(b, fp.W[lvl], torch.float32):
            slots = mesh.size if paths[lvl] == "slot" else 1
            total += slots * lp.chunks * per_call(kernel, fp.W[lvl])
    return total


def slot_storage(panels, fp, plan, mesh, distinct: int) -> dict:
    """Per level the bytes each slot's part holds beside
    `regimes.slot_bytes` (logical slots: the storage of each slot's
    tensors; a replicated level is on the first slot); with distinct cards
    also each card's max_memory_allocated."""
    import torch

    from cholesky_tpu_torch.numeric import regimes
    from cholesky_tpu_torch.parallel.mesh import Sharded

    rows = []
    for lvl, p in enumerate(panels):
        held = (p.slot_nbytes() if isinstance(p, Sharded)
                else [p.numel() * p.element_size()])
        lp = plan.levels[lvl]
        est = regimes.slot_bytes(fp, lvl, mesh, dtype=plan.dtype,
                                 update_dtype=lp.update_dtype,
                                 store_dtype=lp.store_dtype)
        check(max(held) <= est, f"mesh: level {lvl} holds {max(held)} bytes "
              f"on a slot, over slot_bytes {est}")
        rows.append({"lvl": lvl, "max_slot_bytes": max(held),
                     "slot_bytes": est, "slots_holding": len(held)})
    out = {"levels": rows, "per_slot_total": [
        sum(p.slot_nbytes()[s] if isinstance(p, Sharded) else
            (p.numel() * p.element_size() if s == 0 else 0) for p in panels)
        for s in range(mesh.size)]}
    if distinct > 1:
        out["max_memory_allocated"] = {str(d): torch.cuda.max_memory_allocated(
            d) for d in mesh.distinct}
        out["plan_peak_bytes"] = plan.peak_bytes
    return out


def phase_mesh(base, b0):
    """The mesh (`parallel/`) on MESH_SLOTS slots over the machine's cards
    (`mesh_devices`; when slots share a card no wall is a scaling
    figure). 50^3 L8 f32 at the AUTO rung: per-level placement,
    factor walls, per-level difference from the mesh-free factor, per-slot
    stored bytes beside regimes.slot_bytes, two solves, chol_inv launches
    against the rule times the slots, the root level forced through the
    collective 1-D scheme; a 24^3 f64 factor exported from the mesh into
    host memory against the mesh-free one; a K = 8 family; the
    quasi-definite 50^3 system; then the 1-D and 2-D collective Cholesky of an
    [MESH_ROOT_F, MESH_ROOT_F] SPD matrix over MESH_ROOT_SLOTS slots
    against cuSOLVER in f64. Returns chol_inv launches by path."""
    import numpy as np
    import torch

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.numeric import frontal
    from cholesky_tpu_torch.numeric import hopper_kernels as hk
    from cholesky_tpu_torch.numeric.precision import precision_ctx
    from cholesky_tpu_torch.parallel import dist_cholesky as dc
    from cholesky_tpu_torch.parallel import mesh as mesh_mod
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    devices, distinct = mesh_devices(MESH_SLOTS)
    mesh = mesh_mod.make_mesh(devices=devices)
    where = {"slots": mesh.size, "distinct_devices": distinct,
             "scaling_figure": distinct == mesh.size}
    n = base.plan.n
    a = _scipy_matrix(n, base.rows, base.cols, base.vals)
    base.precision = None
    base.factorize()
    free = [p.clone() for p in base.panels]
    s = SparseCholesky(base.plan, base.rows, base.cols, base.vals,
                       dtype=np.float32, mesh=mesh)
    fp = s.fplan
    paths = frontal.level_paths(fp, mesh, frontal.root_spec(fp, mesh))
    check(paths == ["replicated", "rows"] + ["slot"] * 6,
          f"mesh: 50^3 placement {paths}")
    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    # distinct cards: each card's allocator peak over the factorizations
    for d in mesh.distinct:
        torch.cuda.reset_peak_memory_stats(d)
    walls = []
    for _ in range(2):                  # cold, warm
        _, w = timed_sync(s.factorize)
        walls.append(w)
    launches = dict(hk.LAUNCHES)        # read before the probed run
    storage = slot_storage(s.panels, fp, s.regimes, mesh, distinct)
    want = expected_mesh_launches(fp, s.regimes, mesh, paths)
    check(launches["chol_inv"] == 2 * want, f"mesh: {launches['chol_inv']} "
          f"chol_inv launches in 2 factorizations, the rule gives {want}")
    check_slab_launches(launches, 2 * expected_mesh_launches(
        fp, s.regimes, mesh, paths, "factor_slab"), "mesh")
    SLAB_BY_PATH["50^3 L8 mesh (2 factorizations)"] = launches["factor_slab"]
    check(want > 0, "mesh: no kernel-routed level")
    # where the warm factor's time goes: the assembly of each slot's slabs
    # on its device alone, then per level by CUDA events
    fronts, assembly_s = timed_sync(lambda: s._fronts(s.vals))
    del fronts
    hook, read = level_probe(s, devices[0])
    _, probed = timed_sync(lambda: s.factorize(level_hook=hook))
    levels = read()
    diffs = [rel_err(mesh_mod.local(s.panels[lvl], "cuda:0").float(),
                     free[lvl].float()) for lvl in range(fp.levels)]
    check(max(diffs) <= MESH_FACTOR_REL, f"mesh: factor differs from the "
          f"mesh-free one by {max(diffs)}")
    # the root forced through the collective 1-D scheme on the same mesh:
    # its level time beside the first slot's cuSOLVER call above
    prev = frontal.ROOT_DIST_MIN
    frontal.ROOT_DIST_MIN = 0
    try:
        forced = frontal.root_spec(fp, mesh).scheme
        s.factorize()                   # first use of the collective path
        hook, read = level_probe(s, devices[0])
        _, forced_wall = timed_sync(lambda: s.factorize(level_hook=hook))
        forced_ms = read()[0]["ms"]
        forced_diff = rel_err(mesh_mod.local(s.panels[0], "cuda:0").float(),
                              free[0].float())
    finally:
        frontal.ROOT_DIST_MIN = prev
    del free
    check(forced_diff <= MESH_FACTOR_REL, f"mesh: collective root differs "
          f"from the mesh-free one by {forced_diff}")
    s.factorize()
    solves = []
    for i in range(2):
        b = b0 if i == 0 else np.random.default_rng(SEED + 200).integers(
            1, 11, size=n).astype(np.float64)
        x, wall = timed_sync(lambda: s.solve(b, tol=TOL))
        res = float(np.linalg.norm(a @ x - b) / np.linalg.norm(b))
        check(bool(np.all(np.isfinite(x))), "mesh: solution not finite")
        check(res <= TOL, f"mesh: solve {i}: residual {res} > {TOL}")
        solves.append({"wall_s": wall, "residual": res, **s.last_solve})
    emit({"phase": "mesh", "problem": "50^3 L8", "n": n, **where,
          "precision": s.precision, "paths": paths,
          "root_scheme": frontal.root_spec(fp, mesh).scheme,
          "factor_wall_s": walls[0], "factor_wall_warm_s": walls[1],
          "assembly_and_placement_s": assembly_s,
          "probed_factor_wall_s": probed,
          "level_ms": {lvl: x["ms"] for lvl, x in sorted(levels.items())},
          "level_rel_diff_from_mesh_free": diffs,
          "root_forced": {"scheme": forced, "root_ms": forced_ms,
                          "probed_factor_wall_s": forced_wall,
                          "root_rel_diff_from_mesh_free": forced_diff},
          "storage": storage, "plan": s.regimes.describe(),
          "solves": solves, "launches": launches,
          "launches_per_factorization": want})
    out = {"50^3 L8 mesh (2 factorizations)": launches["chol_inv"]}
    del s

    # the mesh factor exported into host memory (every slot's part read
    # back) against the mesh-free factor's entries, f64 at 24^3 L6
    n6, r6, c6, v6, o6, cl6, _ = generate_problem((24, 24, 24), 6,
                                                  seed=SEED + 230)
    one = SparseCholesky.from_coo(n6, r6, c6, v6, o6, cl6, device="cuda")
    r1, c1, v1 = one.factor_coo()
    k1 = np.lexsort((c1, r1))
    em = SparseCholesky(one.plan, one.rows, one.cols, one.vals, mesh=mesh)
    (rD, cD, vD), export_s = timed_sync(em.factor_coo)
    kD = np.lexsort((cD, rD))
    check(np.array_equal(rD[kD], r1[k1]) and np.array_equal(cD[kD], c1[k1]),
          "mesh export: factor_coo pattern differs from the mesh-free one")
    export_err = float(np.abs(vD[kD] - v1[k1]).max() / np.abs(v1).max())
    check(export_err <= 1e-12, f"mesh export: factor_coo differs from the "
          f"mesh-free one by {export_err}")
    emit({"phase": "mesh", "problem": "24^3 L6 f64 factor_coo", **where,
          "entries": int(len(vD)), "factor_and_export_s": export_s,
          "rel_err_vs_mesh_free": export_err})
    del one, em

    # a family of K = 8 on the mesh: K / slots systems per slot
    K = 8
    rng = np.random.default_rng(SEED + 210)
    vals = (1.0 + rng.uniform(0, 2, size=K))[:, None] * base.vals[None, :]
    vals[:, base.rows == base.cols] += rng.uniform(0, 1, size=K)[:, None]
    fs = SparseCholesky(base.plan, base.rows, base.cols, base.vals,
                        dtype=np.float32, mesh=mesh)
    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    bf, wall = timed_sync(lambda: fs.factorize_many(vals))
    fam_launches = hk.LAUNCHES["chol_inv"]
    fpaths = frontal.level_paths(bf.fp, mesh)
    fwant = expected_mesh_launches(fp, bf.regimes, mesh, fpaths)
    check(fam_launches == fwant, f"mesh family: {fam_launches} chol_inv "
          f"launches, the rule gives {fwant}")
    check_slab_launches(hk.LAUNCHES, expected_mesh_launches(
        fp, bf.regimes, mesh, fpaths, "factor_slab"), "mesh family")
    SLAB_BY_PATH["50^3 L8 mesh family K=8"] = hk.LAUNCHES["factor_slab"]
    B = rng.standard_normal((K, n))
    X, swall = timed_sync(lambda: bf.solve(B, tol=TOL))
    res = np.array([np.linalg.norm(_scipy_matrix(n, base.rows, base.cols,
                                                 vals[i]) @ X[i] - B[i])
                    / np.linalg.norm(B[i]) for i in range(K)])
    check(float(res.max()) <= TOL, f"mesh family: residual {res.max()}")
    emit({"phase": "mesh", "problem": "50^3 L8 family", "K": K, **where,
          "paths": fpaths, "factor_many_wall_s": wall, "solve_wall_s": swall,
          "residual_max": float(res.max()), "residuals": res.tolist(),
          **bf.last_solve, "launches": fam_launches,
          "launches_rule": fwant})
    out["50^3 L8 mesh family K=8"] = fam_launches
    del bf, fs

    # the quasi-definite 50^3 system on the mesh
    n, r, c, vq, o, cl, bq, sg = qd_problem((50, 50, 50), 8, SEED + 90)
    q = SparseCholesky.from_coo(n, r, c, vq, o, cl, signs=sg,
                                dtype=np.float32, mesh=mesh)
    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    _, qwall = timed_sync(q.factorize)
    qa = _scipy_matrix(n, q.rows, q.cols, q.vals)
    x, qs = timed_sync(lambda: q.solve(bq, tol=TOL))
    qres = float(np.linalg.norm(qa @ x - bq) / np.linalg.norm(bq))
    inertia = q.inertia()
    check(qres <= TOL, f"mesh qd: residual {qres} > {TOL}")
    check(inertia == (int((sg > 0).sum()), int((sg < 0).sum()), 0),
          f"mesh qd: inertia {inertia}")
    emit({"phase": "mesh", "problem": "50^3 L8 quasi-definite", **where,
          "paths": frontal.level_paths(q.fplan, mesh, rows=False),
          "factor_wall_s": qwall, "solve_wall_s": qs, "residual": qres,
          **q.last_solve, "inertia": list(inertia),
          "slogdet_sign": q.slogdet()[0],
          "launches": hk.LAUNCHES["chol_inv"]})
    out["50^3 L8 mesh quasi-definite"] = hk.LAUNCHES["chol_inv"]
    del q

    # the collective Cholesky of a root-sized front over 8 slots
    rdev, rdistinct = mesh_devices(MESH_ROOT_SLOTS)
    rmesh = mesh_mod.make_mesh(devices=rdev)
    F = MESH_ROOT_F
    gen = torch.Generator(device="cuda").manual_seed(SEED + 220)
    g = torch.randn(F, F, generator=gen, device="cuda") / F ** 0.5
    spd = g @ g.T + 4.0 * torch.eye(F, device="cuda")
    del g
    ref = torch.linalg.cholesky(spd.double())
    rows = []
    with precision_ctx("highest"):
        lib, lib_wall = timed_sync(lambda: torch.linalg.cholesky(spd))
        lib_err = rel_err(lib, ref)
        del lib
        for name, fn in (("1d", dc.distributed_cholesky),
                         ("2d", dc.distributed_cholesky_2d)):
            fn(spd, rmesh, block=dc.ROOT_BLOCK)       # first use
            stats = {}
            L, wall = timed_sync(lambda: fn(spd, rmesh, block=dc.ROOT_BLOCK,
                                            stats=stats))
            err = rel_err(L, ref)
            del L
            check(err <= ROOT_REL_TOL, f"collective {name}: rel err {err} "
                  f"> {ROOT_REL_TOL}")
            rows.append({"scheme": name, "wall_s": wall, "rel_err_vs_f64":
                         err, "bytes_between_slots": stats.get("bytes", 0),
                         "gather_bytes": stats.get("gather_bytes", 0)})
    emit({"phase": "mesh", "problem": f"collective Cholesky [{F}, {F}] f32",
          "slots": rmesh.size, "distinct_devices": rdistinct,
          "scaling_figure": rdistinct == rmesh.size, "block": dc.ROOT_BLOCK,
          "picked": dc._pick_scheme(F, rmesh.size, dc.ROOT_BLOCK, rmesh),
          "cusolver_f32_wall_s": lib_wall, "cusolver_f32_rel_err": lib_err,
          "schemes": rows, "tol": ROOT_REL_TOL})
    del spd, ref
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The panel oracle engine and the examples


ORACLE_SMALL = ((24, 24, 24), 6)    # the three-way factor_dense check
ORACLE_PROBLEM = ((50, 50, 50), 8)  # the slice's problem, f64 and f32
ORACLE_DENSE_TOL = 1e-10            # max abs difference of the three factors
ORACLE_RES_TOL = 1e-10              # the f64 oracle's residual at 50^3
ORACLE_X_REL = 1e-9                 # ... its distance from the refined f32
ORACLE_LOGDET_REL = 1e-9            # ... its logdet vs the production f64's
# the 50^3 L8 f64 oracle's level loop on the card (chip_smoke, oracle phase,
# NVIDIA H100 80GB HBM3 at 700 W, before profile_factor was ported)
ORACLE_LOOP_EARLIER_S = 0.197
# each example at a size its users would run; solve_mtx reads the
# ORACLE_PROBLEM matrix from a temporary .mtx (its path is appended)
EXAMPLES = (("gp_variance", ["--dim", "512", "--levels", "10"]),
            ("gmrf_learn", ["--dim", "256", "--levels", "9"]),
            ("kkt_solve", ["--nx", "300", "--m", "600"]),
            ("modal_analysis", ["--nx", "256", "--k", "6"]),
            ("fem_gallery", ["--scale", "4"]),
            ("solve_mtx", []))


def oracle_logdet(oracle) -> float:
    """2 sum log diag of the oracle's pivot blocks over valid dofs (the
    padded diagonal is identity and adds 0)."""
    import torch

    plan, total = oracle.plan, 0.0
    for lvl, p in enumerate(oracle.panels):
        W = int(plan.S[lvl])
        sizes = torch.tensor([int(plan.sep_sizes[plan.tree.sep_at(lvl, t)])
                              for t in range(1 << lvl)], device=p.device)
        d = torch.diagonal(p[:, :W, :W], dim1=1, dim2=2)
        valid = torch.arange(W, device=p.device)[None, :] < sizes[:, None]
        total += float(torch.log(d.double())[valid].sum())
    return 2.0 * total


def panel_bytes(plan, itemsize: int) -> int:
    """Bytes of the oracle's [2^L, H(L), S(L)] panels of a plan."""
    import numpy as np

    return sum(int(np.prod(plan.panel_shape(lvl))) * itemsize
               for lvl in range(plan.levels))


def scale_panel_bytes() -> int:
    """The f64 panel bytes the oracle would need at the scale phase's
    problem (host plan only)."""
    from cholesky_tpu_torch.symbolic.plan import build_plan
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    *_, o, cl, _ = generate_problem(*SCALE, seed=SEED)
    return panel_bytes(build_plan(o, cl), 8)


def oracle_parts(oracle) -> dict:
    """Where an oracle factorization's wall goes, each part synchronized:
    the host panel assembly, the upload of the panels, the level loop on
    the card (its CUDA-event ms beside)."""
    import torch

    from cholesky_tpu_torch.numeric import assemble
    from cholesky_tpu_torch.numeric import factor as nfactor

    oracle.panels = None
    host, assembly_s = timed_sync(lambda: assemble.assemble_panels(
        oracle.plan, oracle.rows, oracle.cols, oracle.vals,
        dtype=oracle.dtype))
    panels, upload_s = timed_sync(lambda: nfactor._on(host, oracle.device))
    del host
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    oracle.panels, loop_s = timed_sync(
        lambda: nfactor.factor_panels(oracle.plan, panels))
    e1.record()
    e1.synchronize()
    return {"host_assembly": assembly_s, "upload": upload_s,
            "level_loop": loop_s, "level_loop_event_ms": e0.elapsed_time(e1)}


PROFILE_KEYS = ("op", "level", "batch", "n", "m", "k")


def expected_profile_ops(plan):
    """The records' PROFILE_KEYS profile_factor must give for a plan: per
    level, leaves to root, POTRF, then TRSM and UPDATE where the panel has
    rows below its pivots (no UPDATE at the root)."""
    seq = []
    for lvl in range(plan.levels - 1, -1, -1):
        W, H, B = int(plan.S[lvl]), int(plan.H[lvl]), 1 << lvl
        seq.append(("POTRF", lvl, B, W, None, None))
        if H > W:
            seq.append(("TRSM", lvl, B, W, H - W, None))
            if lvl:
                seq.append(("UPDATE", lvl, B, None, H - W, W))
    return seq


def oracle_profile(plan, s32, what, level_loop_s):
    """profile_factor on the oracle phase's f64 panels on the card: per
    level the POTRF / TRSM / UPDATE ('GEMM' lines) microseconds and their
    sum beside this run's level loop and the earlier reading, the peak
    memory, and the record sequence against the plan's."""
    import numpy as np
    import torch

    from cholesky_tpu_torch.numeric import assemble, profile

    host = assemble.assemble_panels(plan, s32.rows, s32.cols, s32.vals,
                                    dtype=np.float64)
    root = host[0].copy()       # the root: written by POTRF and UPDATE
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lines = []
    recs, wall = timed_sync(lambda: profile.profile_factor(
        plan, host, emit=lines.append, device="cuda"))
    peak = torch.cuda.max_memory_allocated() - base
    got = [tuple(r.get(k) for k in PROFILE_KEYS) for r in recs]
    per_level = {}
    for r in recs:
        per_level.setdefault(r["level"], {})[
            "GEMM" if r["op"] == "UPDATE" else r["op"]] = r["time_us"]
    total_us = sum(r["time_us"] for r in recs)
    emit({"phase": "oracle", "what": f"profile_factor {what} f64",
          "per_level_us": per_level, "sum_s": total_us / 1e6,
          "level_loop_s": level_loop_s,
          "level_loop_earlier_s": ORACLE_LOOP_EARLIER_S,
          "wall_s": wall, "peak_bytes": peak, "records": len(recs),
          "lines": lines[:3]})
    check(got == expected_profile_ops(plan),
          f"profile_factor records {got} differ from the plan's "
          f"{expected_profile_ops(plan)}")
    check(np.array_equal(root, host[0]),
          "profile_factor wrote into the caller's panels")
    check(all(r["time_us"] >= 0 for r in recs), "a negative stage time")


def _oracle_three_way():
    """24^3 L6 f64: the oracle's factor_dense, the production solver's and
    SciPy's Cholesky of the permuted matrix, all in the plan's
    permutation."""
    import numpy as np
    import scipy.linalg

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.symbolic.plan import permute_matrix_dense
    from cholesky_tpu_torch.utils.laplacian import generate_problem
    from cholesky_tpu_torch.verify.oracle import PanelsOracle

    shape, levels = ORACLE_SMALL
    n, r, c, v, o, cl, _ = generate_problem(shape, levels, seed=SEED)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64,
                                device="cuda")
    t = time.perf_counter()
    L_o = PanelsOracle(s.plan, s.rows, s.cols, s.vals,
                       device="cuda").factor_dense()
    oracle_s = time.perf_counter() - t
    L_p = s.factor_dense()
    t = time.perf_counter()
    a = permute_matrix_dense(s.plan,
                             _scipy_matrix(n, s.rows, s.cols, s.vals)
                             .toarray())
    L_s = scipy.linalg.cholesky(a + np.tril(a, -1).T, lower=True)
    scipy_s = time.perf_counter() - t
    diffs = {"oracle_vs_production": float(np.abs(L_o - L_p).max()),
             "oracle_vs_scipy": float(np.abs(L_o - L_s).max()),
             "production_vs_scipy": float(np.abs(L_p - L_s).max())}
    for k, d in diffs.items():
        check(d <= ORACLE_DENSE_TOL, f"24^3 factor_dense {k}: {d} > "
              f"{ORACLE_DENSE_TOL}")
    emit({"phase": "oracle", "problem": f"{shape[0]}^3 L{levels} f64 "
          "factor_dense", "n": n,
          "max_abs_diff": diffs, "limit": ORACLE_DENSE_TOL,
          "oracle_factor_dense_s": oracle_s, "scipy_s": scipy_s})


def phase_oracle():
    """The port's PanelsOracle on the card: the 24^3 three-way factor
    check, then 50^3 L8 in f64 (walls, peak beside the panel bytes,
    residual, distance from the refined f32 solve, logdet against the
    production f64 factor's) and in f32 (walls, unrefined residual beside
    the production f32 factor's)."""
    import numpy as np
    import torch

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.utils.laplacian import generate_problem
    from cholesky_tpu_torch.verify.oracle import PanelsOracle

    _oracle_three_way()

    shape, levels = ORACLE_PROBLEM
    what = f"{shape[0]}^3 L{levels}"
    n, r, c, v, o, cl, b = generate_problem(shape, levels, seed=SEED)
    s32 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                  device="cuda")
    plan = s32.plan
    a = _scipy_matrix(n, s32.rows, s32.cols, s32.vals)

    def residual(x):
        return float(np.linalg.norm(a @ x - b) / np.linalg.norm(b))

    _, prod_cold = timed_sync(s32.factorize)
    _, prod_warm = timed_sync(s32.factorize)
    x32 = s32.solve(b, tol=TOL)
    check(residual(x32) <= TOL, "the refined f32 solve missed the contract")
    prod_raw = residual(s32.solve(b, refine="never"))
    s64 = SparseCholesky(plan, s32.rows, s32.cols, s32.vals,
                         dtype=np.float64, device="cuda")
    _, prod64_s = timed_sync(s64.factorize)
    logdet64 = s64.logdet()
    del s64
    torch.cuda.empty_cache()

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    oracle = PanelsOracle(plan, s32.rows, s32.cols, s32.vals,
                          dtype=np.float64, device="cuda")
    _, cold = timed_sync(oracle.factorize)
    peak = torch.cuda.max_memory_allocated() - base
    oracle.panels = None
    _, warm = timed_sync(oracle.factorize)
    parts = oracle_parts(oracle)
    x, solve_s = timed_sync(lambda: oracle.solve(b))
    res = residual(x)
    x_rel = float(np.linalg.norm(x - x32) / np.linalg.norm(x))
    ld = oracle_logdet(oracle)
    ld_rel = abs(ld - logdet64) / abs(logdet64)
    emit({"phase": "oracle", "problem": f"{what} f64", "n": n,
          "panel_shapes": [plan.panel_shape(lvl)
                           for lvl in range(plan.levels)],
          "panel_bytes": panel_bytes(plan, 8),
          "scale_panel_bytes": scale_panel_bytes(),
          "factorize_cold_s": cold, "factorize_warm_s": warm,
          "factorize_parts_s": parts,
          "solve_s": solve_s, "peak_bytes": peak, "residual": res,
          "x_rel_vs_refined_f32": x_rel, "logdet": ld,
          "production_f64_logdet": logdet64, "logdet_rel": ld_rel,
          "production_f64_factor_s": prod64_s})
    check(bool(np.all(np.isfinite(x))) and x.shape == (n,),
          "oracle solution not finite or of the wrong shape")
    check(res <= ORACLE_RES_TOL, f"{what} oracle residual {res}")
    check(x_rel <= ORACLE_X_REL, f"{what} oracle vs refined f32: {x_rel}")
    check(ld_rel <= ORACLE_LOGDET_REL, f"{what} oracle logdet: {ld_rel}")
    del oracle, x
    torch.cuda.empty_cache()
    oracle_profile(plan, s32, what, parts["level_loop"])

    oracle = PanelsOracle(plan, s32.rows, s32.cols, s32.vals,
                          dtype=np.float32, device="cuda")
    _, cold = timed_sync(oracle.factorize)
    oracle.panels = None
    _, warm = timed_sync(oracle.factorize)
    parts = oracle_parts(oracle)
    raw = residual(oracle.solve(b))
    emit({"phase": "oracle", "problem": f"{what} f32",
          "panel_bytes": panel_bytes(plan, 4),
          "factorize_cold_s": cold, "factorize_warm_s": warm,
          "factorize_parts_s": parts,
          "unrefined_residual": raw, "precision": s32.precision,
          "production_factor_cold_s": prod_cold,
          "production_factor_warm_s": prod_warm,
          "production_unrefined_residual": prod_raw})
    check(np.isfinite(raw), "the f32 oracle's solve is not finite")
    del oracle, s32
    torch.cuda.empty_cache()


RESIDUAL_RE = r"residual[^\n]*?([0-9][0-9.]*e[+-]?[0-9]+)"


def _example_checks(name, out):
    """The output properties tests/test_examples.py asserts of the JAX
    twins, read from the script's stdout."""
    import re

    res = [float(m) for m in re.findall(RESIDUAL_RE, out)]
    got = {}
    if name in ("fem_gallery", "solve_mtx", "kkt_solve"):
        limit = 1e-8 if name == "kkt_solve" else TOL
        check(bool(res) and max(res) <= limit,
              f"{name}: residuals {res} over {limit}")
        got["max_residual"] = max(res)
    if name == "solve_mtx":
        check("logdet" in out and "condest" in out, "solve_mtx: no logdet "
              "or condest line")
    if name == "kkt_solve":
        check("slogdet" in out, "kkt_solve: no slogdet line")
        m = re.search(r"inertia \(([0-9]+), ([0-9]+)\) .* \(([0-9]+), "
                      r"([0-9]+) expected\)", out)
        check(bool(m) and m.group(1, 2) == m.group(3, 4),
              "kkt_solve: inertia not as expected")
    if name == "gp_variance":
        m = re.search(r"coverage of truth: ([0-9.]+)%", out)
        check(bool(m) and float(m.group(1)) >= 80.0,
              f"gp_variance: coverage {m and m.group(1)}")
        got["coverage_pct"] = float(m.group(1))
    if name == "gmrf_learn":
        m = re.search(r"MLE tau ~= ([0-9.]+)", out)
        check(bool(m), "gmrf_learn: no tau printed")
        got["tau"] = float(m.group(1))
    if name == "modal_analysis":
        m = re.search(r"worst pencil residual: ([0-9.]+e[+-]?[0-9]+)", out)
        check(bool(m) and float(m.group(1)) <= 1e-6,
              f"modal_analysis: pencil residual {m and m.group(1)}")
        got["pencil_residual"] = float(m.group(1))
    return got


class _RuleCount:
    """While active, adds to `want` the chol_inv launches the routing rule
    gives each factorization (SparseCholesky.factorize and
    factorize_many): 0 for a factor not in float32 or a signed one."""

    def __init__(self):
        self.want = 0

    def _rule(self, solver, plan) -> int:
        import numpy as np

        if solver.dtype != np.float32 or solver.signs is not None:
            return 0
        return expected_launches(solver.fplan, plan)

    def __enter__(self):
        from cholesky_tpu_torch.api import SparseCholesky

        self.orig = (SparseCholesky.factorize, SparseCholesky.factorize_many)
        f, fm = self.orig

        def factorize(solver, *a, **k):
            out = f(solver, *a, **k)
            self.want += self._rule(solver, solver.regimes)
            return out

        def factorize_many(solver, *a, **k):
            bf = fm(solver, *a, **k)
            self.want += self._rule(solver, bf.regimes)
            return bf

        SparseCholesky.factorize = factorize
        SparseCholesky.factorize_many = factorize_many
        return self

    def __exit__(self, *exc):
        from cholesky_tpu_torch.api import SparseCholesky

        SparseCholesky.factorize, SparseCholesky.factorize_many = self.orig


def run_example(script, args):
    """examples/torch/<script> in this process with `args`: (stdout,
    synchronized wall seconds)."""
    import contextlib
    import io
    import runpy

    import torch

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "torch", script)
    argv, syspath, out = sys.argv, list(sys.path), io.StringIO()
    sys.argv = [path, *args]
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
        torch.cuda.synchronize()
    finally:
        sys.argv, sys.path[:] = argv, syspath
    return out.getvalue(), time.perf_counter() - t


def phase_examples() -> dict:
    """The six examples of examples/torch on the card at their sizes, in
    process: wall, chol_inv launches against the routing rule, and the
    output properties tests/test_examples.py asserts of the JAX twins.
    Returns the chol_inv launches of each example that launched any."""
    import torch

    from cholesky_tpu_torch.io import mmio
    from cholesky_tpu_torch.numeric import hopper_kernels as hk
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    with tempfile.TemporaryDirectory() as d:
        mtx = os.path.join(d, "lapl.mtx")
        n, r, c, v, *_ = generate_problem(*ORACLE_PROBLEM, seed=SEED)
        mmio.write_coo(mtx, r, c, v, (n, n), symmetry="hermitian")
        launched = {}
        for name, args in EXAMPLES:
            if name == "solve_mtx":
                args = [*args, mtx]
            for k in hk.LAUNCHES:
                hk.LAUNCHES[k] = 0
            torch.cuda.reset_peak_memory_stats()
            with _RuleCount() as rule:
                out, wall = run_example(name + ".py", args)
            launches = hk.LAUNCHES["chol_inv"]
            lines = out.strip().splitlines()
            emit({"phase": "examples", "script": f"examples/torch/{name}.py",
                  "args": [os.path.basename(x) for x in args],
                  "wall_s": wall, "chol_inv_launches": launches,
                  "rule": rule.want, "max_memory_allocated":
                  torch.cuda.max_memory_allocated(), "output": lines,
                  **_example_checks(name, out)})
            check(launches == rule.want, f"{name}: {launches} chol_inv "
                  f"launches, the rule gives {rule.want}")
            if launches:
                launched[f"examples/torch/{name}.py"] = launches
    return launched


# ---------------------------------------------------------------------------
# The profiling tools of tools/torch


# each tool at its defaults (50^3 L8 where it builds a problem); prof_solve
# with all four of its stages
TOOLS = (("bench_front_kernels", []),
         ("prof_solve_levels", []),
         ("prof_solve", ["solve1", "refine", "api", "resid"]),
         ("exp_solve_profile", []),
         ("prof_scatter", []),
         ("bench_matvec", []),
         ("nd_quality", []))


def run_tool(script, args):
    """tools/torch/<script>'s main(args) in this process: (its result,
    stdout, synchronized wall seconds)."""
    import contextlib
    import io
    import runpy

    import torch

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "torch", script + ".py")
    syspath, out = list(sys.path), io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            tool = runpy.run_path(path, run_name="tool")
            result = tool["main"](
                args if script == "nd_quality" else [*args, "--device",
                                                     "cuda"])
        torch.cuda.synchronize()
    finally:
        sys.path[:] = syspath
    return result, out.getvalue(), time.perf_counter() - t


def nd_quality_direct(scale: int) -> dict:
    """compare()'s FLOPs and nnz(L) of every gallery matrix, from the
    port's symbolic/quality.py called directly."""
    from cholesky_tpu_torch.symbolic import quality
    from cholesky_tpu_torch.utils import problems

    out = {}
    for name, make in problems.make_gallery(scale).items():
        n, r, c, v = make()
        f_auto, _ = quality.nd_cost(n, r, c)
        f_deep, z_deep = quality.nd_cost(n, r, c, levels=8)
        f_rcm, z_rcm = quality.rcm_cost(n, r, c, v)
        f_mmd, z_mmd = quality.superlu_cost(n, r, c, v, "MMD_AT_PLUS_A")
        f_cola, _ = quality.superlu_cost(n, r, c, v, "COLAMD")
        out[name] = {"n": n, "nd_auto_flops": f_auto,
                     "nd_deep_flops": f_deep, "rcm_flops": f_rcm,
                     "mmd_flops": f_mmd, "colamd_flops": f_cola,
                     "nat_flops": quality.fill_flops(n, r, c)[0],
                     "nd_deep_nnz": z_deep, "rcm_nnz": z_rcm,
                     "mmd_nnz": z_mmd}
    return out


def phase_tools() -> int:
    """The seven tools of tools/torch in process on the card at their
    defaults: each one's JSON line and wall; bench_front_kernels' kernel
    route agrees with the library at every class within SLAB_REL_TOL (TF32:
    SLAB_TF32_REL_TOL) and launches factor_slab once and chol_inv once a
    panel at every class with W >= 128; bench_matvec's three layouts agree;
    nd_quality's rows equal symbolic/quality.py's functions called directly.
    Returns
    bench_front_kernels' chol_inv launches."""
    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    launches = 0
    for name, args in TOOLS:
        for k in hk.LAUNCHES:
            hk.LAUNCHES[k] = 0
        result, out, wall = run_tool(name, args)
        emit({"phase": "tools", "script": f"tools/torch/{name}.py",
              "args": args, "wall_s": wall,
              "chol_inv_launches": hk.LAUNCHES["chol_inv"],
              "table": out.strip().splitlines()[:-1]})
        print(out.strip().splitlines()[-1], flush=True)
        if name == "bench_front_kernels":
            launches = hk.LAUNCHES["chol_inv"]
            for row in result["classes"]:
                for flag, tol in (("ieee", SLAB_REL_TOL),
                                  ("tf32", SLAB_TF32_REL_TOL)):
                    r = row["rungs"][flag]
                    where = f"class {row['B']},{row['F']},{row['W']} {flag}"
                    if row["W"] < hk.BS:
                        continue
                    check(r["factor_slab_launches"] == 1
                          and r["chol_inv_launches"] == -(-row["W"] // hk.BS),
                          f"bench_front_kernels: launches {r} at {where}")
                    check(r["max_rel_diff"] <= tol, f"bench_front_kernels: "
                          f"kernel and library differ by "
                          f"{r['max_rel_diff']} at {where}")
        if name == "bench_matvec":
            check(result["agree"], "bench_matvec: the layouts disagree")
        if name == "nd_quality":
            direct = nd_quality_direct(result["scale"])
            for prob, want in direct.items():
                got = {k: result["rows"][prob][k] for k in want}
                check(got == want, f"nd_quality {prob}: {got} != {want}")
    return launches


# ---------------------------------------------------------------------------
# The bench of tools/torch


# after the bench at its defaults (50^3 L8 with every row): the host
# replay's rate at 20^3 L5 and the library yardsticks alone
BENCH_MORE = (["--measure-baseline", "--quick"], ["--kernel-rates"])
BENCH_PROBLEM = ((50, 50, 50), 8, 16)   # its shape, levels, cluster size


def schedule_flops_direct(shape, levels, cluster_size) -> float:
    """verify/schedule.schedule_flops of a grid problem's fill, called
    directly."""
    import numpy as np

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.symbolic.fill import analyze_fill
    from cholesky_tpu_torch.utils.laplacian import generate_problem
    from cholesky_tpu_torch.verify import schedule

    n, r, c, v, o, cl, _ = generate_problem(shape, levels,
                                            cluster_size=cluster_size)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                device="cuda")
    return schedule.schedule_flops(schedule.generate_schedule(
        analyze_fill(s.plan, s.rows, s.cols, s.vals)))


def check_bench(result) -> None:
    """The default run: no row failed or missed its residual, each first
    factorization's peak under its plan's estimate, useful FLOPs equal
    schedule_flops called directly, the launches of one warm factorization
    of each row (the primary at both rungs) equal the routing rule's over
    that row's own plan, and the warm-start process returned 0."""
    check(result["failed"] == [], f"bench: failed rows {result['failed']}")
    rows = {"primary": result}
    rows.update({k: result[k] for k in ("peak", "fixture_3375",
                                        "irregular_elasticity",
                                        "warm_start")})
    for name, r in rows.items():
        check("error" not in r, f"bench {name}: {r.get('error')}")
        check(r.get("residual_ok", True), f"bench {name}: residual "
              f"{r.get('residual')} (production "
              f"{r.get('residual_production')})")
        if "factor_peak_bytes" in r:
            check(r["factor_peak_bytes"] <= r["plan_peak_estimate_bytes"],
                  f"bench {name}: factor peak {r['factor_peak_bytes']} > "
                  f"estimate {r['plan_peak_estimate_bytes']}")
        if "regime_plan" in r:
            levels = [(lv["B"], lv["W"], lv["chunks"])
                      for lv in r["regime_plan"]]
            rule = {k: rule_launches(levels, k)
                    for k in ("chol_inv", "factor_slab")}
            # one front formed a chunk of every square level with children
            rule["form_front"] = sum(lv["chunks"] for lv in r["regime_plan"]
                                     if lv["path"] == "square")
            for key, rung in (("launches", r.get("factor_precision",
                                                 r.get("precision"))),
                              ("launches_production",
                               r.get("solve_precision"))):
                rule["schur_syrk"] = schur_launches(r["regime_plan"],
                                                    "ieee" in str(rung))
                check(r.get(key, rule) == rule, f"bench {name}: {key} "
                      f"{r.get(key)} of one warm factorization at {rung}, "
                      f"the routing rule gives {rule}")
    want = schedule_flops_direct(*BENCH_PROBLEM)
    check(result["useful_flops"] == want, f"bench: useful FLOPs "
          f"{result['useful_flops']} != schedule_flops {want}")
    check(result["launches"]["chol_inv"] > 0,
          "bench: no level of the primary row is kernel-routed")
    check(result["warm_start"]["returncode"] == 0,
          f"bench: warm_start returned {result['warm_start']}")


def phase_bench() -> int:
    """tools/torch/bench.py in process on the card, at its defaults and
    then BENCH_MORE: the default run's rows checked by check_bench, the
    host replay's rate positive, the yardsticks finite; one phase line
    with the three JSON results and the phase's wall. Returns the default
    run's chol_inv launches (factor_slab's go to SLAB_BY_PATH)."""
    import math

    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    t = time.perf_counter()
    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    runs, walls = {}, {}
    runs["defaults"], _, walls["defaults"] = run_tool("bench", [])
    launches = dict(hk.LAUNCHES)
    for args in BENCH_MORE:
        runs[" ".join(args)], _, walls[" ".join(args)] = run_tool("bench",
                                                                  args)
    check_bench(runs["defaults"])
    base = runs["--measure-baseline --quick"]
    check(base["value"] > 0 and base["key"] == "20x20x20_L5",
          f"bench --measure-baseline: {base}")
    rates = {k: x for k, x in runs["--kernel-rates"].items()
             if k.endswith(("_tflops_ieee", "_tflops_tf32"))}
    check(len(rates) == 6 and all(math.isfinite(x) and x > 0
                                  for x in rates.values()),
          f"bench --kernel-rates: {rates}")
    SLAB_BY_PATH["tools/torch/bench.py"] = launches["factor_slab"]
    emit({"phase": "bench", "script": "tools/torch/bench.py",
          "wall_s": time.perf_counter() - t, "run_walls_s": walls,
          "launches": launches, "runs": runs})
    return launches["chol_inv"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import cholesky_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import cholesky_tpu_torch: {e}",
              file=sys.stderr)
        return 2
    try:
        phase_device()
        phase_build()
        kern = phase_kernel()
        slab = phase_slab_kernel()
        front = phase_form_front()
        schur = phase_schur_syrk()
        signed = phase_signed_panel()
        phase_small()
        launches, solver, b = phase_slice()
        phase_profile(solver, b)
        phase_multi(solver)
        phase_regimes(solver, b)
        phase_selinv(solver)
        family = phase_family(solver)
        qd = phase_qd(solver)
        phase_mixed()
        phase_companions(solver, b)
        ladder = phase_precision(solver, b)
        mesh_launches = phase_mesh(solver, b)
        del solver
        scale, big, big_a, big_b = phase_scale()
        ladder["140^3 L14"] = phase_precision_scale(big, big_a, big_b)
        del big, big_a, big_b
        phase_precision_kernels()
        ordering_launches = phase_ordering()
        phase_cli()
        phase_debug()
        phase_native()
        phase_oracle()
        example_launches = phase_examples()
        tool_launches = phase_tools()
        bench_launches = phase_bench()
    except Exception:  # noqa: BLE001 — report the failing phase, exit 1
        traceback.print_exc()
        return 1
    emit({"kernels": [{
        "name": "chol_inv", "route": "cuda",
        "source": "cholesky_tpu_torch/kernels/csrc/chol_inv.cu",
        "replaces": "cholesky_tpu/numeric/pallas_kernels.py:66",
        "launches": scale["default"]["launches"],
        "launches_by_path": {
            "50^3 L8 slice": launches["chol_inv"],
            "140^3 L14 default budget": scale["default"]["launches"],
            "140^3 L14 40 GiB budget": scale["40 GiB"]["launches"],
            "50^3 L8 family K=8 (2 factorizations)": family[8],
            "50^3 L8 family K=16 (2 factorizations)": family[16],
            "50^3 L8 quasi-definite": qd,
            **{f"{k} precision ladder": v for k, v in ladder.items()},
            **mesh_launches,
            "from_scipy gallery (ordering phase)": ordering_launches,
            **example_launches,
            "tools/torch/bench_front_kernels.py": tool_launches,
            "tools/torch/bench.py": bench_launches},
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
        "timed_shape": [128, 128, 128], "per_shape": kern["per_shape"]}, {
        "name": "factor_slab", "route": "cuda",
        "source": "cholesky_tpu_torch/kernels/csrc/factor_slab.cu",
        "replaces": "cholesky_tpu/numeric/pallas_kernels.py:119",
        "launches": scale["default"]["factor_slab"],
        "launches_by_path": dict(SLAB_BY_PATH),
        **{k: slab[k] for k in (
            "max_abs_err", "ms", "plain_ms", "composite_ms", "library_ms",
            "bound_ms", "bound_by", "executed_tflops", "timed_shape")}}, {
        "name": "form_front", "route": "cuda",
        "source": "cholesky_tpu_torch/kernels/csrc/form_front.cu",
        "replaces": "no TPU kernel: the port's torch indexing for the "
                    "square path's extend-add (zero-fill, slab copy, "
                    "gather, accumulating index_put_)",
        "launches": launches["form_front"],
        "launches_by_path": {"50^3 L8 slice": launches["form_front"]},
        "per_config": front}, {
        "name": "schur_syrk", "route": "cuda",
        "source": "cholesky_tpu_torch/kernels/csrc/schur_syrk.cu",
        "replaces": "no TPU kernel: cuBLAS's padded full baddbmm of the "
                    "Schur update (the JAX package leaves it to XLA)",
        "launches": launches["schur_syrk"],
        "launches_by_path": {"50^3 L8 slice": launches["schur_syrk"]},
        "per_config": schur}, {
        "name": "signed_panel", "route": "cuda",
        "source": "cholesky_tpu_torch/kernels/csrc/signed_panel.cu",
        "replaces": "no TPU kernel: the port's PyTorch column loop of the "
                    "signed Cholesky's panels (the JAX package runs it "
                    "through XLA, ldlt.py:52-104)",
        "per_config": signed}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
