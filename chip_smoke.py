"""Drive the PyTorch/CUDA port of the solver once on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc
and no JAX.  Phases (each prints its lines; any failure raises and exits
non-zero before the result line):

0. require CUDA; print the card's name and power limit (nvidia-smi);
1. build the CUDA kernels from biem_helmholtz_sphere_tpu_torch/csrc
   (one nvcc per source, all at once, then one link), and time one launch
   of a trivial kernel (the launch latency);
2. hold each kernel against its plain PyTorch version on the card at the
   bench shapes, in complex64 and complex128, and time both (KB and KC on
   the bench routing's 240 compacted lanes with X's actual child-state
   permutation; KA in its many-point mode at 131,072 points and its
   few-point mode at 1 point x 4 k, near and far, summed and per ball;
   every kernel launched twice and required bit-for-bit equal); compute each
   kernel's bound from its shapes (the larger of its bytes over 3.35 TB/s
   and its operations over 67 TFLOP/s float32 / 34 TFLOP/s float64, the
   H100 SXM's published rates; padding counts as no work: only the lanes
   that route a pair, the offset slots that hold one, the bands inside
   the mask l + l' >= n and the (m, l) pairs with l >= |m|) and time the
   one PyTorch call that computes the same function where there is one
   (KB: one dense matmul over the padded lanes);
3. the README golden (two unit spheres, k=1, n_end=6) through the port in
   complex128, to 6 decimal places, and in complex64 (within 1e-4 of
   complex128): on the factored route, and with the default solver, which
   takes the direct LU;
4. the bench configuration (16 unit spheres on a 4x4 lattice, n_end=32,
   complex64, two k-blocks of 4 with warm starts) through `biem()`:
   launch counts of every kernel over the sweep, GMRES residuals,
   uscat(0) against the committed float64 golden of the JAX package, the
   sound-soft boundary residual, the peak device memory, a bit-for-bit
   repeat of the sweep, a stage split with synchronising timers in a pass
   of its own, KR (the plane-wave right-hand side) launched once a k-block
   and the RHS stage of a warm block at most 3 kernels and no copy on the
   card (torch.profiler), one matvec with at most 3 block_diag_cmm
   launches and no index_select, and the field evaluation path (uscat at 131,072 points
   for one k, its launch counts read around it) with its throughput;
5. the dense route on the 4x4 lattice, the first KB k of the sweep:
   (a) n_end=19 (5,776 unknowns, the LU tier) in complex64 with the
   default solver, which must pick LU, against the factored route (1e-3)
   and the boundary residual (1e-3); (b) the same in complex128 with
   stable=False (K5's unscaled mode and K2's zero-exponent mode at full
   width) against the factored route in complex128 (1e-8); (c) the bench
   configuration (n_end=32, 16,384 unknowns) with solver="gmres" in
   complex64, a dense matrix of 8.6 GB: relres, uscat(0) against the
   golden, the boundary residual, the assembled matrix repeated bit for
   bit, the peak device memory, the launch counts of the run (KD
   `dense_assemble` among them) and a stage split of each of (a)-(c);
6. the offset-table matrix-free route and the quadrature right-hand side
   on the 4x4 lattice at n_end=32, the first KB k of the sweep: (a) the
   bench in complex128 with the default solver and stable, which must
   take the offset-table route (the KC gather and scatter, K5 and K2's
   zero-exponent mode launched, KB not): every relres <= 1e-11, uscat(0)
   within 1e-7 of the float64 golden, the boundary residual (1e-3), the
   peak device memory and a stage split (RHS, radial rows, coax, the
   sandwich, the table product with its pad and unpad, the KC gather and
   scatter, the rest of GMRES, uscat(0)); (b) one offset-table matvec
   against the factored operator's on the same random vector, within
   1e-10 per (k, sphere, degree) block, timed beside its bound, and the
   table product, its pad and its unpad timed alone; (c) a point source
   at (0, 0, 3) in complex64 on its default route (the factored GMRES),
   its right-hand side by quadrature through K5 at 2,145 x 16 x 4 points:
   relres <= 3e-5, the boundary residual against the point source
   (1e-3), a stage split, and that K5 launch and the quadrature
   projection timed alone beside their bounds; (d) the bench plane wave
   in complex128 with its tags stripped (the quadrature right-hand side):
   uscat(0) within 1e-8 of (a)'s; then the bounds of the stages that run
   PyTorch or library calls (the sandwich, LU, K3, K6) from this run's
   shapes.
7. complex k, the 'bpa' tree and geometry along the batch, each path with
   the launch counts set to 0 just before it and read just after: (a) the
   bench at k + 0.1i (an absorbing medium) in complex64 with the default
   solver (the factored GMRES): relres <= 3e-5, the boundary residual
   (1e-3), uscat(0) within 1e-3 of the JAX package's float64 golden
   (data/bench_golden_complexk_f64.json), a repeat bit for bit, a stage
   split, and KA's many-point mode with that complex k against its plain
   version; (b) the same in complex128 on its default route (the offset
   table): relres <= 1e-11, uscat(0) within 1e-7 of the golden; (c) the
   'bpa' tree at the bench in two k-blocks with warm starts (KA not
   launched): uscat(0) within 1e-3 of the 'ba' golden, relres and the
   boundary residual, then the general field evaluation (KE, which must
   launch) at 131,072 points against KA's 'ba' field (1e-3), with its time
   and peak memory; (d)
   four lattice pitches (4, 4.5, 5, 5.5) along the batch in one call at
   n_end=19, complex64, the default solver (LU): each within 1e-4 of its
   geometry solved alone, and KD with its pair map per k against its
   plain version, equal entry for entry, timed beside its bound.
8. trees rooted at a 'b' or 'bp' node in d >= 4, each path with the
   launch counts set to 0 just before it and read just after: (a) the 4D
   path at full width, 'bba' with 16 unit spheres at the corners of
   {-2, 2}^4 (pitch 4), n_end=20 (H=2,870, 45,920 unknowns), complex64, a
   plane wave along x0, the first 4 k of linspace(3.5, 4.5, 100), the
   default solver (which must take the factored GMRES: KB in its row-panel
   mode, KC, K5, K2): its first block split by stage (RHS, radial rows,
   coax, the D build, and of it K3 and its tables on the card, GMRES,
   uscat(0)), relres <= 3e-5, the boundary residual (1e-3), the peak
   device memory, K3 and KE launched, K3 alone with its bound and peak,
   a warm block repeated bit for bit and split with KB's launches and time
   between CUDA events, uscat(0) within 1e-3 of the same call in
   complex128 (factored), and the general evaluation (KE) at 16,384
   points; (b) the same lattice at n_end=12:
   complex128 on its default route (the offset table) within 1e-7 of the
   JAX package's float64 golden (data/bench4d_golden_f64.json), complex64
   (factored) within 1e-3; (c) 'bpbpa' at (b)'s configuration within
   1e-3 of the same golden; (d) the jascome pair (unit spheres at (0, +-2,
   0, 0), k = 1) at n_end=19 (4,940 unknowns), complex64 with the default
   solver (LU) and complex128 with stable=False, each against the
   factored route (1e-3 / 1e-8), and KD at H = 2,470 equal to its plain
   version; (e) 'bbba', the 5D pair at n_end=8, complex64 on the forced
   factored route (KB's row panels at blocks of 204) within 1e-3 of
   complex128 LU.
9. 2D trees and the lattice-FFT route at the size of the JAX package's
   n_balls accuracy family (square lattices of unit spheres at pitch 4,
   k = 1, a plane wave along x0), each path with the launch counts set to
   0 just before it and read just after: (a) 'ba', 32 x 32 spheres at
   n_end=19 (369,664 unknowns), stable, solver="auto" (the lattice
   route: K5, K2 and K3 for the half table, no KB or KG; KA for uscat(0)),
   complex64 and complex128: relres (3e-5 / 1e-11), the boundary residual
   on the 4 central spheres (1e-3), the first solve split by stage (RHS,
   radial rows, the half table, the grid and FFT, GMRES, uscat(0)), peak
   memory, one matvec and its per-frequency product and FFTs alone beside
   their bounds, a second complex64 solve bit for bit, complex64 within
   1e-3 of complex128 and complex128 within 1e-4 of the JAX package's
   float32 TPU row of accuracy/accuracy.csv; (b) 'a', 64 x 64 spheres,
   complex64, stable, by the family's own method (tools/
   nballs_family4.py): a cold GMRES with a 4,608-vector basis at n_end=2,
   then the n_end ladder up to 32, each rung warm-started from the last
   density (KG and K5 each rung): relres and the boundary residual at
   n_end 16 and 32, a rung repeated bit for bit, one matvec and its parts;
   (c) anchors: complex128 on the default route (the lattice) within 1e-8
   of the 8 x 8 'a' value at n_end=19 (and 1e-10 of the JAX package's
   float64, data/nballs2d_golden_f64.json), the reference's 16 x 16 'a'
   value at n_end=53 and the 8 x 8 'ba' row at n_end=22; complex64 within
   1e-3 (the direct LU in 2D, the lattice in 3D); (d) the 2D pair goldens
   on the default route (LU: KG, KD); (e) KG against its plain version at
   (b)'s 8,064 half offsets, n_end 16 and 32, both modes and dtypes, each
   launched twice (timed beside its bound at n_end=32), K5's d = 2 mode
   there, and one lattice matvec against the dense pair-major matvec on a
   16 x 16 'a' lattice.
10. trees with a 'c' node, each path with the launch counts set to 0
   just before it and read just after: (a) 'caa' on the 16 corners of
   {-2, 2}^4 at n_end=14 (H=1,015, 16,240 unknowns), complex64, phase 8's
   first 4 k, the default solver (which must take the offset-table
   matrix-free GMRES: KS in fold mode, KC, K5; no KB, K2, KD or KG):
   a stage split, relres <= 3e-5, the boundary residual (1e-3), the peak
   memory; KS's and KF's registers, shared memory and spills (ptxas -v;
   a KF instance must not spill) and each KS instance's DMMA / HMMA count
   in the built library's SASS (complex128 must run DMMA, complex64 no
   tensor-core instruction); KS
   alone at these shapes timed in turns with its plain version (plain,
   KS, KS, plain) beside its bound and its achieved TFLOP/s, per degree
   block (1e-4) and bit for bit on repeat, a cuBLAS product of the same
   [H, Q] x [Q, H] shape x K NO as a yardstick, KF (F_N for one group of
   offsets) against its plain version per band (1e-5), zero past Q, with
   its time, its device time and its share of the bound, also at
   KF_WIDE_BANDS = 33 bands (past two of its chunks); then
   the block in complex128 unscaled (KS's unscaled mode, relres <= 1e-11),
   uscat(0) within 1e-4 of it, and KS (1e-11) and KF (1e-13) alone there
   in the same way; (b) the 'caa' pair by
   LU in complex128 within 2e-6 of the reference golden and 1e-9 of the
   JAX package's density, the hypercube at n_end=6 within 1e-9 of the JAX
   golden (data/caa4d_golden_f64.json), the float32 overflow pair (k=0.15,
   centers +-2.05, n_end=14) complex64 within 1e-4 of complex128; (c)
   'bcaa' (5D) at n_end=8: the factored route in complex64 (K3, K2, KB;
   no KS) within 1e-4 of the dense route in complex128 with "triplet"
   (KS), and at n_end=4 the rotation (S|R) and (R|R) within 1e-10 of the
   band scan per degree block; (d) the 8 x 8 'caa' lattice at n_end=6 in
   complex128 on the lattice route (its half table from KS) within 1e-8
   of the offset-table route; (e) KS against its plain version in all
   three modes and both dtypes at n_end=10 (4 offsets x 2 k), per degree
   block (complex64 1e-4, complex128 1e-11), bit for bit on repeat,
   timed beside its bound.

11. the Gumerov-Duraiswami translation (translational_coefficients_method
   "gumerov", the plain routes) and the public surfaces, each path with
   the launch counts set to 0 just before it and read just after: (a)
   phase 6 (a)'s bench in complex128 with "gumerov" and the default
   solver, which must take the offset-table route (the KC gather and
   scatter and K5 launched; K2 and KB not): relres <= 1e-11, uscat(0)
   within 1e-7 of the golden and 1e-9 of 6 (a)'s, the boundary residual
   (1e-3), the peak memory, its (S|R) table against 6 (a)'s per (k,
   offset, degree block) within 1e-10, and a stage split (the K5 column,
   the ladders, the sandwich, the table product, the KC gather and
   scatter); (b) phase 5 (b)'s LU at n_end=19 in complex128 with
   stable=False and "gumerov" (KD launched, K2 not) within 1e-9 of 5 (b);
   (c) phase 9 (a)'s 32 x 32 'ba' lattice at n_end=19 in complex128 with
   "gumerov" on the lattice route within 1e-8 of 9 (a)'s complex128; (d)
   `gd_coaxial` at (a)'s 4 k x 9 radii on the card against the same call
   on the CPU per (k, radius, degree block), complex128 1e-12 and
   complex64 2e-4, timed beside its bound, and its (R|R) at the same
   shapes (`GD_TOL`, the conditioning printed; complex64 also against
   float64 within 2x of the CPU float32's own error); (e) K5 unscaled at
   the ladders' 98 orders against its plain version at (a)'s kr and at
   (c)'s (where float32 overflows: the same entries must be non-finite;
   every output relative above 1, h and h' entry by entry, j and j' entry
   by entry in complex128 only; in complex64 every output against the
   float64 plain version within 2x of the plain float32 version's own
   error), and
   `regular_singular_component` and `potential_coef` on the card against
   the CPU.
12. parallel/ and the CLI (`parallel_and_frontends`): KD's row window at
   the dense path's shapes (the 4x4 lattice, n_end=19, both dtypes) equal
   entry for entry to the whole matrix's rows and to its plain version,
   timed beside its bound; (a) a one-rank NCCL group in this process:
   `sharded_sweep` on the bench (complex64, phase 4's 8 ks) bit for bit
   `biem()` on the 8 ks in one call, `sharded_uscat` at 131,072 points
   bit for bit `calc.uscat`, and `sharded_solve` in complex128 (dense at
   n_end=19 against dense GMRES 1e-8, the offset table at the bench
   against the single-card offset table 1e-10, phase 9 (a)'s lattice
   against its density 1e-10), the launch counts read around them; (b) two
   spawned gloo ranks with CUDA tensors on the one card: the same paths,
   the sweep within 1e-4 of (a), the solves at (a)'s gates, both ranks bit
   for bit equal, each rank's operator <= 0.55 of the whole one, the
   per-rank peak memory; (c) the CLI: `accuracy --mode n_balls` (1,024 'ba'
   spheres, n_end=19, float32) within 1e-4 of phase 9 (a)'s complex64
   uscat(0), and `bench` at its defaults; (d) each path's seconds split
   into compute and collectives.

Phase 2 also holds KB's row-panel mode (d >= 4: degree blocks too large
to stage whole) against its plain version, D^H and D in both dtypes, each
launched twice and required bit-for-bit equal: at (a)'s shapes (timed,
with its bound and a dense matmul over the padded lanes), the hypercube
at n_end=16 and the 5D pair at n_end=8.  It holds K5's base-2 (even d)
mode at the shapes the 4D route gives it (d = 4, n_end = 20: the coax bands of 4 k x 9 radii, the
radial rows of 4 k x 16 spheres), both dtypes, and times its seeds'
plain version `cyl_jh01`.  It also holds KD against its plain version
(complex64 at the bench's pair-major shapes, complex128 at the LU tier's
[B, H, B', H'] shapes, both launched twice and required bit-for-bit
equal, and equal to the plain version entry for entry: the kernel forms
the same products in the same order) and K2 in its zero-exponent mode
(coaxial_sr's unscaled band sum) at the LU tier's n_end and at the
bench's, its error relative to the largest entry of each (k, radius, l,
l') degree block.

Phase 2 also holds KE (`ops/harmonic_eval.py`, the general evaluation's
near field) against its plain version at the shapes phases 7 (c), 8 (a),
9 (b) and 10 (a) give it ('bpa' at 131,072 points, 'bba' at 16,384, 'a'
and 'caa' at one point in its few-point mode), within 3e-5 / 1e-12 of the
largest |u| (complex64 / complex128), and K3 (`rotation_blocks`) at
phases 8 (a), 4 and 9 (a)'s directions (64 at 4D n_end=20, 36 and 1,984
in 3D) per degree block within 5e-5 / 1e-12, its unitarity error within
twice the plain version's; both launched twice and required bit-for-bit
equal, timed beside their plain versions and bounds (KE: no single
PyTorch call evaluates a tree's harmonics, library none; K3: its
yardstick is one cuBLAS batched GEMM per degree block with the harmonics
already formed, `k3_library_ms`, and its plan's product padding and
harmonic generations per direction are printed beside).  KE's lines also
give, at (i) and (ii), its bound's share of the kernel's device time and
of the time around the wrapper, and for every shape the ptxas registers,
stack frame and spills of the kernel instance it ran and its local-memory
instructions (tools/torch_ke_ab.py's `ptxas_report`, `local_memory`;
phase 2 fails if any lies in an inner loop with floating-point work);
at (iii) and (iv) the time around the wrapper split into its host work,
K5's h table (with the even-d cylinder seeds) and the kernel
(`ke_split`).  Phases 4, 8 (a) and 9
(a, c) require K3 launched (phase 4 in its first block, D cached for the
sweep), phases 7 (c), 8 (a), 9 (b-d) and 10 (a) KE.

Phase 2 also holds KU (`ops/coax_u.py::coax_u`, the coaxial band tables
U at the packed entries and K2's tile image, formed on the card from the
root tables built there) against its plain version at (i) phase 8 (a)'s
'bba' n_end=20, (ii) the bench's 'ba' n_end=32, (iii) 'ba' n_end=64 and
(iv) the 5D pair's 'bbba' n_end=8, both table dtypes, each entry within
1e-14 of its sum of magnitudes (and one float32 rounding), exactly 0
wherever that sum is, launched twice and required bit-for-bit equal, timed
beside its plain version, its bound and its yardstick (the DGEMM of the
materialised factors, `ku_library_ms`), with its device time's share of
the bound, and (v) 'ba' at n_end=96, untimed (no size ceiling); it prints
each KU instance's ptxas registers, stack and spills and its DMMA count
in the built library's SASS (cuobjdump) and fails on an instance with no
DMMA or with spills.  Phases 4 (first block), 8 (a) and 9 (a) clear the
coax tables' caches and require KU launched; phase 8 (a) splits its coax
stage into the tables (host index and plan, the root tables on the card,
KU) and K5 + K2.

Phase 2 also holds K6 (`ops/gmres_step.py`: `arnoldi_step`, one Arnoldi
step of GMRES in one cooperative launch, and `backsolve`, a cycle's
back-substitution) against their plain versions: from the same state and
matvec at steps 0, 7 and 47 of (i) the bench block's factored operator
(complex64, 4 x 16,384, basis 48), steps 0, 10 and 20 of (ii) phase 6
(a)'s offset table (complex128, basis 192) and steps 0, 580 and 1,161 of
(iii) phase 9 (b)'s cold rung (complex64, 1 x 12,288, basis 4,608),
target 0 so that every step runs: V, R, Q, g and resid within 1e-5 /
1e-13 of each tensor's largest entry, steps and the flag word equal, two
launches bit for bit, a masked launch (no system active, or a residual
non-finite) leaving the state unchanged; one launch a step (torch.profiler
counts the step's kernels); each step's grid (CTAs, SMs used), whether its
tile was resident or streamed, its device time beside the plain step and
its bound (rows 0..j of V read once; this design's traffic, the rows read
once resident or four times streamed, printed beside), and
the back-substitution at each state's j_f beside
`torch.linalg.solve_triangular`.  Phase 4 prints the lag s of the host's
reads of the flag word, the reads, the steps launched and run per solve
and K6's launches per k-block, and runs a bench block with its GMRES under
torch.cuda.set_sync_debug_mode("error") (`no_host_sync`); phases 4, 6 (a),
8 (a), 9 (a, b) and 12 (a) require K6 launched, and phase 12 (a) runs the
three sharded solves on the one NCCL rank under the same check
(`sharded_no_host_sync`).

Phase 2 also holds KR (`ops/plane_rhs.py::plane_wave_rhs`, the plane-wave
right-hand side from K5's j and j' and Y at each k's direction by the
tree's program) against its plain version per (k, sphere, degree) block
(1e-5 / 1e-12), launched twice and required bit-for-bit equal: (i) at the
bench, timed beside its plain version and its bound (the [K, B, H] output
written, j and j' read; library none: no PyTorch call evaluates a tree's
harmonics) and run once under set_sync_debug_mode("error") with its
program and kept Y cached; (ii) the bench with complex k, a direction and
centers per k and both terms; (iii) phase 9 (b)'s 4,096 circles (complex
k, both terms).  At each, a cold call (the kept table and launch packs
cleared), a warm call (the same direction: Y read from the table) and a
call after the direction changed (to another, then to the last axis: a
pole), each against its plain version and for the same bits (warm
against cold; changed against a cold call at the new direction); at
(i) the device time of a warm call and of one whose direction changes
every call, and the wrapper's host time per call; the
ptxas figures of the instances run, which must have no stack frame.
Every phase that solves with a plane wave on the card runs it.

The spherical functions (K5) are compared on values: mant_k exp(e_k - e_p)
against mant_p, entry by entry; their max_abs_err is on those aligned
mantissas (|mant| ~ 1) and on the unscaled values, relative above 1.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_END = 32
N_END_LU = 19  # the 4x4 lattice's largest n_end on the LU tier (16 n_end^2 <= 6144)
N_END_4D = 20  # phase 2's base-2 (even d) K5 shapes: the 4D route's n_end
N_SIDE = 4
SPACING = 4.0
KB = 4
K0 = 8.0
EVAL_POINTS = 1 << 17
GOLDEN_README = (-0.741333, -0.669657)
SOURCE = (0.0, 0.0, 3.0)  # phase 6 (c): off the lattice plane, 4.12 from the nearest center
IMAG_K = 0.1  # phase 7 (a, b): Im k of an absorbing medium
PITCHES = (4.0, 4.5, 5.0, 5.5)  # phase 7 (d): the lattices along the batch
N_END_4D_ANCHOR = 12  # phase 8 (b, c): the 4D anchor's n_end (the JAX golden's)
N_END_4D_LU = 19  # phase 8 (d): the 4D pair's largest n_end on the LU tier (2 x 2470)
N_END_5D = 8  # phase 8 (e)
EVAL_POINTS_4D = 1 << 14  # phase 8 (a): the general evaluation's points
# phase 9, the n_balls family (k = 1, unit spheres, pitch 4)
N_SIDE_3D, N_END_3D = 32, 19  # (a): 1,024 spheres, H = 361
ARTIFACT_3D = -0.8141030073165894 + 0.015023995190858841j  # accuracy.csv, ba 1024 n_end 19
N_SIDE_2D = 64  # (b): 4,096 spheres
LADDER_2D = (2, 4, 6, 9, 13, 16, 19, 22, 26, 32)  # (b): the n_end ladder
GATES_2D = (16, 32)  # (b): the rungs held to the gates
COLD_RESTART, WARM_RESTART = 4608, 768  # (b): GMRES bases of tools/nballs_family4.py
# phase 10, trees with a 'c' node
N_END_C = 14  # (a): 'caa' on the hypercube, H = 1,015 (the JAX package's largest 'caa' case)
N_END_C_ANCHOR = 6  # (b): the pair and hypercube goldens (data/caa4d_golden_f64.json)
OVERFLOW_PAIR = (0.15, 2.05, 14)  # (b): k, +-x1 of the centers, n_end (test_biem.py:732)
N_END_BCAA = 8  # (c): the 5D 'bcaa' pair, H = 540
N_SIDE_C, N_END_C_LATTICE = 8, 6  # (d): the 'caa' lattice
N_END_KS, N_OFF_KS = 10, 4  # (e): KS against its plain version in every mode
KF_WIDE_BANDS, KF_WIDE_OFFSETS = 33, 8  # (a): KF past two of its chunks of 16 bands
ANCHORS = (  # (c): (tree, lattice side, n_end, value)
    ("a", 8, 19, -1.0537360062 + 0.0214642340j),  # tests/test_biem.py:866
    ("a", 16, 53, -0.9986093441 - 0.0011085159j),  # reference accuracy_n_balls_a.csv:82
    ("ba", 8, 22, -0.647372023208673 + 0.018550258564751655j),  # accuracy/accuracy.csv
)
TOL_REL = {"complex64": 1e-4, "complex128": 1e-10}
# phase 11 (d): the ladders on the card against the CPU, per degree block.
# (S|R) in complex64: the CPU comparison of the port's float32 ladders with
# the JAX package's at these shapes shows 4.9e-5 (with their float64 5.5e-5).
# (R|R): its blocks below GD_RR_FLOOR of the table are held against that
# floor (the ladder forms them by cancellation).  At n_end = 32 the (R|R)
# ladder is ill-conditioned: radii one ulp longer move the CPU float64
# table by 5.0e-12 per block, and the card differs from the CPU by about
# that (5.5e-12 on the H100, this phase); in complex64 the card differed
# from the CPU by 1.8e-3, the CPU's own float32 table from float64 by
# 2.0e-3.  So complex64 (R|R) is also held against float64: within
# GD_RR_F64_FACTOR of the CPU float32 table's own error there
GD_TOL = {("SR", "complex128"): 1e-12, ("SR", "complex64"): 2e-4,
          ("RR", "complex128"): 2e-11, ("RR", "complex64"): 5e-3}
GD_RR_FLOOR = 1e-3
GD_RR_F64_FACTOR = 2.0
# phase 11 (e): complex64 K5 against float64 within this multiple of the
# plain float32 version's own error against float64, each output
K5_F64_FACTOR = 2.0
# results of earlier phases that phase 11 holds its own against: uscat(0)
# of 6 (a) [KB], of 5 (b) (complex128, stable=False) [KB], of 9 (a)
# (complex128)
SHARED = {}
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s; FP32 / FP64
# operations/s outside the tensor cores; and those of a contraction, which
# in FP64 runs on the tensor cores (DMMA, exact IEEE FP64) at 67 TFLOP/s
# (float32 has no exact tensor-core path: TF32 stays off)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"complex64": 67e12, "complex128": 34e12}
PEAK_MMA_FLOPS = {"complex64": 67e12, "complex128": 67e12}


def sweep_ks():
    """The bench sweep's wavenumbers (float32, as bench.py makes them)."""
    return np.linspace(7.0, 9.0, 100).astype(np.float32)


def lattice_centers(n_side=N_SIDE, spacing=SPACING):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, 3))
    centers[:, 0] = xx.ravel()
    centers[:, 1] = yy.ravel()
    return centers


def cuda_ms(torch, fn, reps):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(torch, got, ref, mask=None):
    d = (got - ref).abs()
    r = ref.abs()
    if mask is not None:
        d, r = d[mask], r[mask]
    if not bool(torch.isfinite(d).all()):
        raise RuntimeError("kernel output is not finite")
    return float(d.max()), float(d.max() / r.max())


def far_rel_err(torch, got, ref):
    """max |got - ref| / max(|ref|, the median |ref|), point by point: an
    error relative to each point's own field (the median keeps a point
    where the field nearly cancels from setting the scale)."""
    r = ref.abs()
    return float(((got - ref).abs() / torch.clamp(r, min=float(r.median()))).max())


def randc(torch, rng, shape, dtype, dev):
    z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return torch.as_tensor(z, dtype=dtype, device=dev)


def same_bits(torch, a, b):
    """Bitwise equal tensors, or nested tuples of them (NaN included)."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_bits(torch, x, y) for x, y in zip(a, b))

    def bits(t):
        return (torch.view_as_real(t) if t.is_complex() else t).contiguous().view(torch.uint8)
    return torch.equal(bits(a), bits(b))


def bound(nbytes, flops, name, mma_flops=0.0):
    """(ms, "bytes" | "operations"): the least time the card could take,
    with mma_flops the operations of contractions (at the tensor cores'
    rate for the type) and flops the others."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = flops / PEAK_FLOPS[name] + mma_flops / PEAK_MMA_FLOPS[name]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def coax_bound(tab, n_pair, n_e, n_l, cs, rs, name):
    """K2's bound for n_pair (k, radius) pairs, n_e rows of L = n_l
    exponents: U's entries and band groups inside the mask l + l' >= n
    (the zero padding of U is no work), the bands in, the packed values
    out."""
    n_bands = 2 * n_l - 1
    nnz = tab.u.shape[1]
    top = (tab.l_row + tab.l_col).clamp(max=n_bands - 1).long()
    n_u, n_grp = int((top + 1).sum()), int((top // 8 + 1).sum())
    return bound(n_u * rs + n_pair * n_bands * (cs + rs) + n_bands * cs
                 + 2 * nnz * 4 + 2 * n_e * n_l * rs + n_pair * nnz * cs,
                 n_pair * (4 * n_u + 7 * n_grp + 10 * nnz) + n_pair * n_bands * 10, name)


def add_bounds(parts):
    """Sum of per-launch bounds; named by the largest part's limit."""
    ms = sum(b[0] for b in parts)
    return ms, max(parts, key=lambda b: b[0])[1]


def equal_by_k(torch, got, ref):
    """(torch.equal, max abs difference, max |ref|) over the leading axis
    one slice at a time (matrices of gigabytes: the difference of a slice is
    all that is held)."""
    same, d, m = True, 0.0, 0.0
    for g, r in zip(got, ref):
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError("kernel output is not finite")
        same = same and torch.equal(g, r)
        d, m = max(d, float((g - r).abs().max())), max(m, float(r.abs().max()))
    return same, d, m


def degree_block_rel_err(torch, got, ref, l_row, l_col, n_end):
    """(max abs error, max relative error) of packed entries [..., nnz],
    relative to the largest |ref| of each (leading index, l, l') block: the
    entries of one root-degree pair are alike in size (~|h_{l+l'}|), while
    across blocks they span many orders of magnitude."""
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("kernel output is not finite")
    nnz = got.shape[-1]
    d, r = (x.abs().reshape(-1, nnz) for x in (got - ref, ref))
    g = (l_row.long() * n_end + l_col.long()).expand_as(d)
    dm = d.new_zeros(d.shape[0], n_end * n_end).scatter_reduce(1, g, d, "amax")
    rm = r.new_zeros(d.shape[0], n_end * n_end).scatter_reduce(1, g, r, "amax")
    return float(d.max()), float((dm / rm.clamp_min(torch.finfo(rm.dtype).tiny)).max())


def dense_parts(torch, dev, rdt, n_end, stable):
    """KD's arguments for the first k-block of the sweep on the 4x4 lattice,
    as the dense route makes them (unit sound-soft spheres)."""
    from biem_helmholtz_sphere_tpu_torch.biem._core import _assembly_parts
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

    f = dict(dtype=rdt, device=dev)
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    nb = N_SIDE * N_SIDE
    return _assembly_parts(
        create_from_branching_types("ba"), n_end, lattice_centers(), torch.ones(KB, nb, **f),
        torch.as_tensor(sweep_ks()[:KB], **f), torch.ones(KB, **f),
        torch.ones(KB, nb, dtype=cdt, device=dev), torch.zeros(KB, nb, dtype=cdt, device=dev),
        stable=stable)


def scaled_err(torch, got, ref):
    """(max abs, max rel) error of scaled values (mant, e): mant_k
    exp(e_k - e_p) against mant_p, entry by entry."""
    (mk, ek), (mp, ep) = got, ref
    if not (bool(torch.isfinite(mk).all()) and bool(torch.isfinite(ek).all())):
        raise RuntimeError("kernel output is not finite")
    d = (mk * torch.exp(ek - ep) - mp).abs()
    return float(d.max()), float((d / mp.abs().clamp_min(torch.finfo(ek.dtype).tiny)).max())


def unscaled_err(torch, got, ref):
    """(max abs error, relative above 1; max rel error) of unscaled values,
    which must be finite where the plain ones are."""
    fin = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(got), fin):
        raise RuntimeError("kernel and plain version differ in where they are finite")
    d, r = (got - ref).abs()[fin], ref.abs()[fin]
    return (float((d / r.clamp_min(1.0)).max()),
            float((d / r.clamp_min(torch.finfo(r.dtype).tiny)).max()))


def launch_latency_us(torch, dev):
    """Microseconds per launch of a trivial kernel, back to back."""
    t = torch.zeros(1, device=dev)
    n = 200
    t.add_(1.0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        t.add_(1.0)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def coax_zero_args(torch, dev, rdt, n_end):
    """K2's arguments in its zero-exponent mode (coaxial_sr's unscaled band
    sum: the bands h_n(k r), zero exponents) for a k-block of the bench (4 k
    x 9 radii) at n_end."""
    from biem_helmholtz_sphere_tpu_torch.biem._core import _pair_routing
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.special._family import _UNSCALED, spherical_jh
    from biem_helmholtz_sphere_tpu_torch.translation._scaled import _coax_packed

    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    k4 = torch.linspace(7.0, 7.06, KB, dtype=rdt, device=dev)
    r = torch.as_tensor(_pair_routing(lattice_centers()).uniq_r, dtype=rdt, device=dev)
    hz = spherical_jh(_UNSCALED, 3, 2 * n_end - 1, (k4[:, None] * r).to(cdt).reshape(1, -1))[2]
    e0 = torch.zeros((1, n_end), dtype=rdt, device=dev)
    return (hz, torch.zeros_like(hz.real), e0, e0,
            _coax_packed(create_from_branching_types("ba"), n_end, rdt, dev))


def coax_args(torch, dev, rdt):
    """K2's arguments (radm, rade, e_r, e_b, tables) for a k-block of the
    bench (4 k x 9 radii), as the factored operator makes them."""
    from biem_helmholtz_sphere_tpu_torch.biem._core import _pair_routing, _radial_rows_scaled
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
    from biem_helmholtz_sphere_tpu_torch.special._family import _H_ONLY, spherical_jh
    from biem_helmholtz_sphere_tpu_torch.translation._scaled import _coax_packed

    c = create_from_branching_types("ba")
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    f = dict(dtype=rdt, device=dev)
    nb = N_SIDE * N_SIDE
    k4 = torch.linspace(7.0, 7.06, KB, **f)
    (_, _), (_, e_r), (_, e_b) = _radial_rows_scaled(
        c, N_END, torch.ones(KB, nb, **f), k4, torch.ones(KB, **f),
        torch.ones(KB, nb, dtype=cdt, device=dev), torch.zeros(KB, nb, dtype=cdt, device=dev))
    starts = torch.as_tensor(np.searchsorted(basis(c, N_END).n_root, np.arange(N_END)),
                             device=dev)
    e_r, e_b = (e.amax(dim=-2)[:, starts].contiguous() for e in (e_r, e_b))
    r = torch.as_tensor(_pair_routing(lattice_centers()).uniq_r, **f)
    radm, rade = spherical_jh(_H_ONLY, 3, 2 * N_END - 1, (k4[:, None] * r).to(cdt))
    return radm, rade, e_r, e_b, _coax_packed(c, N_END, rdt, dev)


def check_kernels(torch, dev, card):
    """Phase 2: each kernel against its plain version at the bench shapes."""
    from biem_helmholtz_sphere_tpu_torch.biem._core import _pair_routing
    from biem_helmholtz_sphere_tpu_torch.biem._eval_fused import (
        _fused_ba_eval_plain, fused_ba_eval, regroup)
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
    from biem_helmholtz_sphere_tpu_torch.ops.block_diag import (
        LaneSegments, _block_diag_cmm_plain, block_diag_cmm, pack, unpack)
    from biem_helmholtz_sphere_tpu_torch.ops.lane_route import (
        _lane_gather_plain, _lane_scatter_plain, lane_gather, lane_scatter,
        make_route)
    from biem_helmholtz_sphere_tpu_torch.special._cyl import cyl_jh01
    from biem_helmholtz_sphere_tpu_torch.special._family import (
        _H_ONLY, _SCALED, _UNSCALED, _spherical_h_scaled_plain,
        _spherical_jh_all_plain, _spherical_jh_scaled_plain, spherical_jh)
    from biem_helmholtz_sphere_tpu_torch.ops.dense import _dense_assemble_plain, dense_assemble
    from biem_helmholtz_sphere_tpu_torch.translation._scaled import (
        _child_state_blocks, _coax_fold_packed_plain, _coax_packed, coax_fold)

    c = create_from_branching_types("ba")
    n_root = basis(c, N_END).n_root
    h = len(n_root)
    centers_np = lattice_centers()
    nb = len(centers_np)
    routing = _pair_routing(centers_np)
    n_slots, n_rad = len(routing.uniq), len(routing.uniq_r)
    lps = 2 * routing.p_max
    cs_sizes, cs_perm = _child_state_blocks(c, N_END)
    results = {}
    for cdt in (torch.complex64, torch.complex128):
        name = str(cdt).split(".")[-1]
        rdt = torch.float32 if cdt == torch.complex64 else torch.float64
        cs, rs = (8, 4) if cdt == torch.complex64 else (16, 8)  # bytes per value
        rng = np.random.default_rng(1234)
        tol = TOL_REL[name]

        # K5: the four launches of a k-block, at its shapes and arguments
        k4 = torch.linspace(7.0, 7.06, KB, dtype=rdt, device=dev)
        z_rows = (k4[:, None] * torch.ones(nb, dtype=rdt, device=dev)).to(cdt)
        r_uniq = torch.as_tensor(routing.uniq_r, dtype=rdt, device=dev)
        z_coax = (k4[:, None] * r_uniq).to(cdt)
        n_bands = 2 * N_END - 1
        k5 = {"ms": 0.0, "plain_ms": 0.0, "abs": 0.0, "rel": 0.0, "bounds": []}
        for label, mode, n_end, z, plain, reps in (
            ("scaled j/j'/h/h' (radial rows)", _SCALED, N_END, z_rows,
             _spherical_jh_scaled_plain, 1),
            ("unscaled j/j'/h/h' (RHS, uscat's blc)", _UNSCALED, N_END, z_rows,
             _spherical_jh_all_plain, 2),
            ("scaled h (coax bands)", _H_ONLY, n_bands, z_coax,
             _spherical_h_scaled_plain, 1),
        ):
            got = spherical_jh(mode, 3, n_end, z)
            ref = plain(3, n_end, z)
            if not same_bits(torch, spherical_jh(mode, 3, n_end, z), got):
                raise RuntimeError(f"spherical_jh {label} {name}: two launches differ")
            if mode == _SCALED:
                errs = [scaled_err(torch, g, r) for g, r in zip(got, ref)]
            elif mode == _H_ONLY:
                errs = [scaled_err(torch, got, ref)]
            else:
                errs = [unscaled_err(torch, g, r) for g, r in zip(got, ref)]
            ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
            ms = cuda_ms(torch, lambda: spherical_jh(mode, 3, n_end, z), 20)
            pms = cuda_ms(torch, lambda: plain(3, n_end, z), 5)
            n_z, n_top = z.numel(), n_end
            steps = {_SCALED: 3 * n_top + 36, _H_ONLY: n_top, _UNSCALED: 3 * n_top + 36}[mode]
            per_order = {_SCALED: 4 * 8 + 2 * 30, _H_ONLY: 8, _UNSCALED: 2 * 20}[mode]
            n_out = {_SCALED: 4, _H_ONLY: 1, _UNSCALED: 4}[mode]
            out_bytes = n_z * n_end * n_out * (cs + (rs if mode != _UNSCALED else 0))
            b = bound(n_z * cs + out_bytes, n_z * (15 * steps + per_order * n_end), name)
            print(f"[2] spherical_jh {label} z {tuple(z.shape)} x {n_end} {name}: "
                  f"max_abs_err {ea:.3e} max_rel_err {er:.3e} kernel {ms:.4f} ms "
                  f"plain {pms:.4f} ms bound {b[0]:.6f} ms ({card})")
            if er > tol:
                raise RuntimeError(f"spherical_jh {label} {name}: rel err {er:.3e} > {tol}")
            k5 = {"ms": k5["ms"] + reps * ms, "plain_ms": k5["plain_ms"] + reps * pms,
                  "abs": max(k5["abs"], ea), "rel": max(k5["rel"], er),
                  "bounds": k5["bounds"] + [b] * reps}
        k5["bound_ms"], k5["bound_by"] = add_bounds(k5.pop("bounds"))
        k5["library_ms"] = None  # no one PyTorch call computes these functions
        results.setdefault("spherical_jh", {})[name] = k5

        # K5's base-2 (even d) mode at the shapes the 4D route will give it
        # (d = 4, n_end = N_END_4D): the coax bands h_n(k r), 4 k x 9 radii x
        # 2 N_END_4D - 1 bands, and the radial rows at 4 k x 16 spheres
        for label, mode, n_end, z, plain in (
            ("h (coax bands)", _H_ONLY, 2 * N_END_4D - 1, z_coax, _spherical_h_scaled_plain),
            ("scaled j/j'/h/h' (radial rows)", _SCALED, N_END_4D, z_rows,
             _spherical_jh_scaled_plain),
            ("unscaled j/j'/h/h'", _UNSCALED, N_END_4D, z_rows, _spherical_jh_all_plain),
        ):
            got = spherical_jh(mode, 4, n_end, z)
            ref = plain(4, n_end, z)
            if not same_bits(torch, spherical_jh(mode, 4, n_end, z), got):
                raise RuntimeError(f"spherical_jh base 2 {label} {name}: two launches differ")
            if mode == _SCALED:
                errs = [scaled_err(torch, g, r) for g, r in zip(got, ref)]
            elif mode == _H_ONLY:
                errs = [scaled_err(torch, got, ref)]
            else:
                errs = [unscaled_err(torch, g, r) for g, r in zip(got, ref)]
            ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
            ms = cuda_ms(torch, lambda: spherical_jh(mode, 4, n_end, z), 20)
            pms = cuda_ms(torch, lambda: plain(4, n_end, z), 5)
            # the seeds: 4 x 42 series (or 4 x 23 asymptotic) complex steps in
            # float64 per z, then the recurrences as in base 3
            steps = {_SCALED: 3 * n_end + 37, _H_ONLY: n_end + 1, _UNSCALED: 3 * n_end + 37}[mode]
            n_out = {_SCALED: 4, _H_ONLY: 1, _UNSCALED: 4}[mode]
            b = bound(z.numel() * cs + z.numel() * n_end * n_out * (cs + (rs if mode != _UNSCALED else 0)),
                      z.numel() * (15 * steps + 8 * 4 * 42), name)
            print(f"[2] spherical_jh base 2 (d = 4) {label} z {tuple(z.shape)} x {n_end} {name}: "
                  f"max_abs_err {ea:.3e} max_rel_err {er:.3e} kernel {ms:.4f} ms plain {pms:.4f} "
                  f"ms bound {b[0]:.6f} ms ({b[1]}) ({card})")
            if er > tol:
                raise RuntimeError(f"spherical_jh base 2 {label} {name}: rel err {er:.3e} > {tol}")
        # its seeds' plain version (plain torch, float64 inside): the series
        # and the asymptotics at every z (~2,100 float64 operations each)
        ms = cuda_ms(torch, lambda: cyl_jh01(z_rows), 20)
        b = bound(z_rows.numel() * 5 * cs, z_rows.numel() * 2100, "complex128")
        print(f"[2] cyl_jh01 (plain torch) z {tuple(z_rows.shape)} {name}: {ms:.4f} ms bound "
              f"{b[0]:.6f} ms ({b[1]}) ({card})")

        # K2: the packed folded coax factor of a k-block (4 k x 9 radii)
        args = coax_args(torch, dev, rdt)
        tab = args[-1]
        got = coax_fold(*args)
        ea, er = rel_err(torch, got, _coax_fold_packed_plain(*args))
        if not same_bits(torch, coax_fold(*args), got):
            raise RuntimeError(f"coax_fold {name}: two launches differ")
        ms = cuda_ms(torch, lambda: coax_fold(*args), 20)
        pms = cuda_ms(torch, lambda: _coax_fold_packed_plain(*args), 5)
        nnz = tab.u.shape[1]
        b = coax_bound(tab, KB * n_rad, KB, N_END, cs, rs, name)
        print(f"[2] coax_fold {KB} k x {n_rad} radii x {nnz} packed {name}: max_abs_err "
              f"{ea:.3e} max_rel_err {er:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms "
              f"bound {b[0]:.6f} ms ({card})")
        if er > tol:
            raise RuntimeError(f"coax_fold {name}: rel err {er:.3e} > {tol}")
        results.setdefault("coax_fold", {})[name] = {
            "ms": ms, "plain_ms": pms, "abs": ea, "rel": er, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": None}

        # K2 in its zero-exponent mode: coaxial_sr's unscaled band sum, 4 k
        # x 9 radii, at the LU tier's n_end (the plain dense route) and at
        # the bench's (the offset-table matrix-free route, phase 6)
        for n_z in (N_END_LU, N_END):
            zargs = coax_zero_args(torch, dev, rdt, n_z)
            got = coax_fold(*zargs)
            ea, er = degree_block_rel_err(torch, got, _coax_fold_packed_plain(*zargs),
                                          zargs[-1].l_row, zargs[-1].l_col, n_z)
            if not same_bits(torch, coax_fold(*zargs), got):
                raise RuntimeError(f"coax_fold zero-exponent n_end {n_z} {name}: two "
                                   "launches differ")
            ms = cuda_ms(torch, lambda: coax_fold(*zargs), 20)
            pms = cuda_ms(torch, lambda: _coax_fold_packed_plain(*zargs), 5)
            b = coax_bound(zargs[-1], KB * n_rad, 1, n_z, cs, rs, name)
            print(f"[2] coax_fold zero-exponent mode (coaxial_sr) n_end {n_z} {KB} k x "
                  f"{n_rad} radii x {got.shape[-1]} packed {name}: max_abs_err {ea:.3e} "
                  f"max_rel_err {er:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms bound "
                  f"{b[0]:.6f} ms ({b[1]}) ({card})")
            if er > tol:
                raise RuntimeError(f"coax_fold zero-exponent n_end {n_z} {name}: rel err "
                                   f"{er:.3e} > {tol}")

        # KD: the dense matrix of a k-block at the shapes phase 5 gives it:
        # complex64 stable and pair-major at the bench (dense GMRES),
        # complex128 plain in the [B, H, B', H'] layout at the LU tier
        n_kd, pair_major, stable = ((N_END, True, True) if cdt == torch.complex64
                                    else (N_END_LU, False, False))
        parts = dense_parts(torch, dev, rdt, n_kd, stable)
        got = dense_assemble(*parts, pair_major=pair_major)
        again = dense_assemble(*parts, pair_major=pair_major)
        if not torch.equal(again, got):
            raise RuntimeError(f"dense_assemble {name}: two launches differ")
        del again
        ref = _dense_assemble_plain(*parts, pair_major)
        # the kernel forms each entry by the plain version's products in its
        # order, so the two must be equal: a tolerance relative to the largest
        # entry would pass a kernel that spoils the small high-degree blocks
        same, ea, top = equal_by_k(torch, got, ref)
        er = ea / top
        del got, ref
        ms = cuda_ms(torch, lambda: dense_assemble(*parts, pair_major=pair_major), 10)
        pms = cuda_ms(torch, lambda: _dense_assemble_plain(*parts, pair_major), 3)
        table = parts[0]
        h_kd = table.shape[-1]
        # each output entry written once, the table and the factors read
        # once; two complex products per off-diagonal entry
        b = bound(KB * nb * nb * h_kd * h_kd * cs + table.numel() * cs
                  + 3 * KB * nb * h_kd * cs + h_kd * rs + nb * nb * 12,
                  12 * KB * nb * (nb - 1) * h_kd * h_kd, name)
        layout = "[K, B, B', H, H']" if pair_major else "[K, B, H, B', H']"
        print(f"[2] dense_assemble {KB} k x {nb}x{nb} blocks of {h_kd}x{h_kd} from "
              f"{table.shape[1]} offsets {layout} {name}: equal to the plain version {same}, "
              f"max_abs_err {ea:.3e} max_rel_err {er:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms bound {b[0]:.6f} ms ({b[1]}) "
              f"({card})")
        if not same:
            raise RuntimeError(f"dense_assemble {name}: differs from its plain version "
                               f"(max abs err {ea:.3e})")
        del parts, table
        torch.cuda.empty_cache()
        results.setdefault("dense_assemble", {})[name] = {
            "ms": ms, "plain_ms": pms, "abs": ea, "rel": er, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": None}

        # KB: D^H, X (its child-state permutation read by the kernel), D on
        # the bench routing's 240 compacted lanes
        d_bd = pack(torch.zeros((n_slots, h, h), dtype=cdt, device=dev),
                    2 * np.arange(N_END) + 1)
        d_bd = replace(d_bd, vals=randc(torch, rng, d_bd.vals.shape, cdt, dev))
        x_bd = pack(torch.zeros((KB, n_rad, h, h), dtype=cdt, device=dev),
                    cs_sizes, cs_perm)
        x_bd = replace(x_bd, vals=randc(torch, rng, x_bd.vals.shape, cdt, dev))
        d_dense, x_dense = unpack(d_bd), unpack(x_bd)
        n_used = len(routing.src)
        lanes = randc(torch, rng, (KB, n_used, h), cdt, dev)
        d_seg = LaneSegments(tuple(int(v) for v in routing.slot_ptr))
        x_seg = LaneSegments(tuple(int(v) for v in routing.rad_ptr))
        # the library yardstick: one dense matmul over the padded lanes
        padded = torch.zeros((KB, n_slots * lps, h), dtype=cdt, device=dev)
        padded[:, torch.as_tensor(routing.lane, device=dev)] = lanes
        pad_d = padded.reshape(KB, n_slots, lps, h)
        pad_x = padded.reshape(KB, n_rad, -1, h)
        # the matrices a product needs: the slots that hold an offset, the
        # (k, radius) pairs (every radius holds one)
        n_real = int((np.diff(routing.slot_ptr) > 0).sum())
        cases = [
            ("D^H", lambda: block_diag_cmm(d_bd, lanes, d_seg, adjoint=True),
             lambda: _block_diag_cmm_plain(d_dense, lanes, d_seg, True),
             lambda: torch.matmul(pad_d, d_dense.conj()), d_bd, n_real),
            ("X", lambda: block_diag_cmm(x_bd, lanes, x_seg),
             lambda: _block_diag_cmm_plain(x_dense, lanes, x_seg, False),
             lambda: torch.matmul(pad_x, x_dense.transpose(-1, -2)), x_bd, KB * n_rad),
            ("D", lambda: block_diag_cmm(d_bd, lanes, d_seg),
             lambda: _block_diag_cmm_plain(d_dense, lanes, d_seg, False),
             lambda: torch.matmul(pad_d, d_dense.transpose(-1, -2)), d_bd, n_real),
        ]
        kb = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "abs": 0.0, "rel": 0.0,
              "bounds": []}
        for label, kfn, pfn, lfn, bd, n_mat in cases:
            got = kfn()
            ea, er = rel_err(torch, got, pfn())
            if not same_bits(torch, kfn(), got):
                raise RuntimeError(f"block_diag_cmm {label} {name}: two launches differ")
            ms, pms, lms = cuda_ms(torch, kfn, 20), cuda_ms(torch, pfn, 5), cuda_ms(torch, lfn, 5)
            nnz = bd.vals.shape[-1]
            b = bound(n_mat * nnz * cs + 2 * KB * n_used * h * cs, 0, name,
                      mma_flops=8 * KB * n_used * nnz)
            print(f"[2] block_diag_cmm {label:3s} {KB} k x {n_used} lanes {name}: max_abs_err "
                  f"{ea:.3e} max_rel_err {er:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms "
                  f"library (dense matmul, padded lanes) {lms:.4f} ms bound {b[0]:.6f} ms "
                  f"({b[1]}) ({card})")
            if er > tol:
                raise RuntimeError(f"block_diag_cmm {label} {name}: rel err {er:.3e} > {tol}")
            kb = {"ms": kb["ms"] + ms, "plain_ms": kb["plain_ms"] + pms,
                  "library_ms": kb["library_ms"] + lms,
                  "abs": max(kb["abs"], ea), "rel": max(kb["rel"], er),
                  "bounds": kb["bounds"] + [b]}
        kb["bound_ms"], kb["bound_by"] = add_bounds(kb.pop("bounds"))
        results.setdefault("block_diag_cmm", {})[name] = kb

        # KC: gather and scatter with the bench routing's compacted lanes
        route = make_route(routing.src, routing.dst, routing.dn, nb, dev)
        pm = torch.as_tensor((-1.0) ** (n_root % 2), dtype=rdt, device=dev)
        xv, blc, diag, reg = (randc(torch, rng, (KB, nb, h), cdt, dev) for _ in range(4))
        y = randc(torch, rng, (KB, n_used, h), cdt, dev)
        small = h * rs + 2 * n_used * 4
        used = KB * n_used * h  # lane entries, all of which route a pair
        for kname, kfn, pfn, b in (
            ("lane_gather", lambda: lane_gather(xv, blc, pm, route),
             lambda: _lane_gather_plain(xv, blc, pm, route),
             bound(2 * xv.numel() * cs + small + used * cs, 8 * used, name)),
            ("lane_scatter", lambda: lane_scatter(y, xv, diag, reg, pm, route),
             lambda: _lane_scatter_plain(y, xv, diag, reg, pm, route),
             bound(used * cs + 4 * xv.numel() * cs + small,
                   4 * used + 14 * xv.numel(), name)),
        ):
            got = kfn()
            ea, er = rel_err(torch, got, pfn())
            if not same_bits(torch, kfn(), got):
                raise RuntimeError(f"{kname} {name}: two launches differ")
            ms, pms = cuda_ms(torch, kfn, 20), cuda_ms(torch, pfn, 20)
            print(f"[2] {kname} {n_used} lanes {name}: max_abs_err {ea:.3e} max_rel_err "
                  f"{er:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms bound {b[0]:.6f} ms ({card})")
            if er > tol:
                raise RuntimeError(f"{kname} {name}: rel err {er:.3e} > {tol}")
            results.setdefault(kname, {})[name] = {
                "ms": ms, "plain_ms": pms, "abs": ea, "rel": er, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": None}

        # KA in both modes: 131,072 points for one k (the many-point mode)
        # and uscat(0) for a k-block, 1 point x 4 k (the few-point mode);
        # near and far, summed and per ball
        ell = torch.as_tensor(n_root, device=dev)
        cen = torch.as_tensor(centers_np, dtype=rdt, device=dev)
        raw = np.random.default_rng(0).normal(size=(3, EVAL_POINTS))
        pts = torch.as_tensor(raw * 20.0, dtype=rdt, device=dev)[:, None, :]
        dirs = torch.as_tensor(raw / np.linalg.norm(raw, axis=0), dtype=rdt,
                               device=dev)[:, None, :]
        outside = (torch.linalg.vector_norm(
            pts[:, 0, :, None] - cen.T[:, None, :], dim=0) > 1.0).all(-1)
        k1 = torch.full((1,), K0, dtype=rdt, device=dev)
        w2 = regroup(c, N_END, randc(torch, rng, (1, nb, h), cdt, dev) * torch.exp(-ell.to(rdt)))
        kb4 = torch.linspace(7.0, 7.06, KB, dtype=rdt, device=dev)
        w2b = regroup(c, N_END, randc(torch, rng, (KB, nb, h), cdt, dev)
                      * torch.exp(-ell.to(rdt)))
        zero = torch.zeros((3, 1, 1), dtype=rdt, device=dev)
        n_m = 2 * N_END - 1
        # (near points, far directions) of each mode
        for row, label, xs, kk, ww, mask, n_pts in (
            ("fused_ba_eval", f"{EVAL_POINTS} pts x 1 k", (pts, dirs), k1, w2, outside,
             EVAL_POINTS),
            ("fused_ba_eval_few", f"1 pt x {KB} k", (zero, dirs[:, :, :1].contiguous()),
             kb4, w2b, None, 1),
        ):
            n_launch = (fused_ba_eval.launches, fused_ba_eval.few_launches)
            for far in (False, True):
                xx = xs[1] if far else xs[0]
                for per_ball in (False, True):
                    got = fused_ba_eval(xx, cen, kk, ww, far=far, per_ball=per_ball)
                    ref = _fused_ba_eval_plain(xx, cen, kk, ww, far, per_ball)
                    ea, er = rel_err(torch, got, ref, None if far else mask)
                    again = fused_ba_eval(xx, cen, kk, ww, far=far, per_ball=per_ball)
                    if not same_bits(torch, again, got):
                        raise RuntimeError(f"{row} {label}: two launches differ")
                    print(f"[2] {row} {label} {'far' if far else 'near'}"
                          f"{' per_ball' if per_ball else ''} {name}: max_abs_err {ea:.3e} "
                          f"max_rel_err {er:.3e}")
                    if er > tol:
                        raise RuntimeError(f"{row} {label} {name}: rel err {er:.3e} > {tol}")
                    if not (far or per_ball):
                        near_err = (ea, er)
            mode = (fused_ba_eval.launches - n_launch[0], fused_ba_eval.few_launches - n_launch[1])
            if mode != ((8, 0) if row == "fused_ba_eval" else (0, 8)):
                raise RuntimeError(f"{row} {label}: launched (many, few) = {mode}")
            ms = cuda_ms(torch, lambda: fused_ba_eval(xs[0], cen, kk, ww), 10)
            pms = cuda_ms(torch, lambda: _fused_ba_eval_plain(xs[0], cen, kk, ww, False, False), 3)
            # per (point, k, ball): the geometry, the h recurrence, 13 per
            # (m, l) pair with l >= |m| (sum_m (N_END - |m|) = N_END^2 of
            # them; the Legendre recurrence shared by +-m, the product and
            # the sum) and the phase of each of the 2 N_END - 1 orders
            n_pk = n_pts * len(kk)
            b = bound(3 * n_pts * rs + 4 * nb * rs + ww.numel() * cs + n_pk * cs,
                      n_pk * nb * (30 + 15 * N_END + 13 * N_END * N_END + 10 * n_m), name)
            print(f"[2] {row} near {label} {name}: kernel {ms:.4f} ms plain {pms:.4f} ms "
                  f"bound {b[0]:.6f} ms ({b[1]}) ({card})")
            results.setdefault(row, {})[name] = {
                "ms": ms, "plain_ms": pms, "abs": near_err[0], "rel": near_err[1],
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
    return results


def hypercube_centers(half=2.0, d=4):
    """The 2^d corners of {-half, half}^d (pitch 2 half), first axis slowest."""
    grid = np.stack(np.meshgrid(*([[-half, half]] * d), indexing="ij"), axis=-1)
    return grid.reshape(-1, d)


def pair_centers(d):
    """The jascome pair: unit spheres at (0, +-2, 0, ...)."""
    centers = np.zeros((2, d))
    centers[0, 1], centers[1, 1] = 2.0, -2.0
    return centers


def sweep_ks_4d():
    """Phase 8's wavenumbers: linspace(3.5, 4.5, 100) as float32."""
    return np.linspace(3.5, 4.5, 100).astype(np.float32)


def check_kb_panels(torch, dev, card):
    """Phase 2, KB's row-panel mode: D^H and D with the degree blocks of a
    d >= 4 tree ((n+1)^2 rows in 4D), on the factored route's compacted
    lanes, against the plain version, each launched twice and required bit
    for bit equal: the 4D path's shapes (the hypercube at n_end=N_END_4D, 40
    of 64 slots holding lanes, 240 lanes x 4 k; timed beside its bound and
    a dense matmul over the padded lanes), the hypercube at n_end=16 and the
    5D pair at N_END_5D.  Returns the timed results by dtype name."""
    from biem_helmholtz_sphere_tpu_torch.biem._core import _pair_routing
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import harm_n_ndim
    from biem_helmholtz_sphere_tpu_torch.ops.block_diag import (
        LaneSegments, _block_diag_cmm_plain, block_diag_cmm, pack_layout, unpack)

    results = {}
    for label, d, n_end, centers_np, timed in (
            (f"4D n_end {N_END_4D}", 4, N_END_4D, hypercube_centers(), True),
            ("4D n_end 16", 4, 16, hypercube_centers(), False),
            (f"5D n_end {N_END_5D}", 5, N_END_5D, pair_centers(5), False)):
        routing = _pair_routing(centers_np)
        sizes = [harm_n_ndim(n, d) for n in range(n_end)]
        h = sum(sizes)
        n_slots, lps = len(routing.uniq), 2 * routing.p_max
        n_used = len(routing.src)
        n_real = int((np.diff(routing.slot_ptr) > 0).sum())
        seg = LaneSegments(tuple(int(v) for v in routing.slot_ptr))
        for cdt in (torch.complex64, torch.complex128):
            name = str(cdt).split(".")[-1]
            cs = 8 if cdt == torch.complex64 else 16
            rng = np.random.default_rng(4321)
            a = pack_layout(sizes, None, h, dev)
            a = replace(a, vals=randc(torch, rng, (n_slots, a.rows.numel()), cdt, dev))
            lanes = randc(torch, rng, (KB, n_used, h), cdt, dev)
            dense = unpack(a)
            nnz = a.vals.shape[-1]
            row = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "abs": 0.0, "rel": 0.0,
                   "bounds": []}
            for op, adj in (("D^H", True), ("D", False)):
                n0 = block_diag_cmm.panel_launches
                got = block_diag_cmm(a, lanes, seg, adjoint=adj)
                if block_diag_cmm.panel_launches != n0 + 1:
                    raise RuntimeError(f"block_diag_cmm {label}: the panel mode did not run")
                ea, er = rel_err(torch, got, _block_diag_cmm_plain(dense, lanes, seg, adj))
                if not same_bits(torch, block_diag_cmm(a, lanes, seg, adjoint=adj), got):
                    raise RuntimeError(f"block_diag_cmm panels {label} {op} {name}: two "
                                       "launches differ")
                del got
                line = (f"[2] block_diag_cmm row panels {label} {op} {KB} k x {n_used} lanes, "
                        f"blocks up to {max(sizes)} {name}: max_abs_err {ea:.3e} max_rel_err "
                        f"{er:.3e}")
                if timed:
                    ms = cuda_ms(torch, lambda: block_diag_cmm(a, lanes, seg, adjoint=adj), 20)
                    pms = cuda_ms(torch, lambda: _block_diag_cmm_plain(dense, lanes, seg, adj), 3)
                    padded = torch.zeros((KB, n_slots * lps, h), dtype=cdt, device=dev)
                    padded[:, torch.as_tensor(routing.lane, device=dev)] = lanes
                    pad_d = padded.reshape(KB, n_slots, lps, h)
                    op_d = dense.conj() if adj else dense.transpose(-1, -2)
                    lms = cuda_ms(torch, lambda: torch.matmul(pad_d, op_d), 3)
                    del padded, pad_d, op_d
                    b = bound(n_real * nnz * cs + 2 * KB * n_used * h * cs, 0, name,
                              mma_flops=8 * KB * n_used * nnz)
                    line += (f" kernel {ms:.4f} ms plain {pms:.4f} ms library (dense matmul, "
                             f"padded lanes) {lms:.4f} ms bound {b[0]:.6f} ms ({b[1]})")
                    row = {"ms": row["ms"] + ms, "plain_ms": row["plain_ms"] + pms,
                           "library_ms": row["library_ms"] + lms,
                           "abs": max(row["abs"], ea), "rel": max(row["rel"], er),
                           "bounds": row["bounds"] + [b]}
                print(f"{line} ({card})")
                if er > TOL_REL[name]:
                    raise RuntimeError(f"block_diag_cmm panels {label} {op} {name}: rel err "
                                       f"{er:.3e}")
            if timed:
                row["bound_ms"], row["bound_by"] = add_bounds(row.pop("bounds"))
                results[name] = row
            del a, lanes, dense
            torch.cuda.empty_cache()
    return results


KE_TOL = {"complex64": 3e-5, "complex128": 1e-12}  # of the largest |u| of each call
K3_TOL = {"complex64": 5e-5, "complex128": 1e-12}  # of 1 (D is unitary), per degree block


def ke_bound(n_p, n_k, n_b, h, n_end, d, name):
    """KE's bound: x, the centers, the density in and the field out, once;
    per (point, k, ball) 15 real operations a harmonic, KE's own inner
    step (h times the root factor, 2; the complex product with the
    density, 8; the Jacobi step, 5), and 15 a degree for the h chain."""
    cs = 8 if name == "complex64" else 16
    return bound(d * n_p * cs // 2 + n_k * n_b * d * cs // 2 + n_k * n_b * h * cs
                 + n_p * n_k * cs, n_p * n_k * n_b * (15 * h + 15 * n_end), name)


def k3_bound(c, n_end, n_dir, name):
    """K3's bound: conj(Y) w [Q, H] read once, both forms of D written
    once (the degree groups, zeros between their blocks included, and the
    packed blocks); 8 real operations per node and exact degree-block
    entry (a contraction: the FP64 tensor cores' rate in complex128) and 16
    per node and harmonic at each direction's rotated nodes."""
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import harm_n_ndim
    from biem_helmholtz_sphere_tpu_torch.translation._rotation import _k3_plan, _rot_tables

    cs = 8 if name == "complex64" else 16
    q, h = _rot_tables(c, n_end)[1].shape
    plan = _k3_plan(c, n_end, name == "complex128")
    nnz, g_all = plan.nnz, plan.g_all
    g2 = sum(harm_n_ndim(n, c.c_ndim) ** 2 for n in range(n_end))
    return bound(q * h * cs + n_dir * (g_all + nnz) * cs, 16 * n_dir * q * h, name,
                 mma_flops=8 * n_dir * q * g2)


def k3_library_ms(torch, c, n_end, n_dir, cdt, dev):
    """K3's yardstick: ms of one cuBLAS batched complex GEMM per degree
    block, conj(Y) w's [g, Q] rows (broadcast over the directions) times
    [Q, g] harmonics per direction already formed (random values of the
    same shapes; K3 forms them itself), block after block."""
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import harm_n_ndim
    from biem_helmholtz_sphere_tpu_torch.translation._rotation import _rot_tables

    q = len(_rot_tables(c, n_end)[0])
    sizes = [harm_n_ndim(n, c.c_ndim) for n in range(n_end)]
    gen = torch.Generator(device=dev).manual_seed(71)
    b = torch.randn(n_dir * q * max(sizes), dtype=cdt, device=dev, generator=gen)
    a = torch.randn(q * max(sizes), dtype=cdt, device=dev, generator=gen)

    def run():
        for g in sizes:
            torch.bmm(a[: g * q].view(1, g, q).expand(n_dir, g, q),
                      b[: n_dir * q * g].view(n_dir, q, g))

    ms = cuda_ms(torch, run, 3)
    del a, b
    torch.cuda.empty_cache()
    return ms


def ke_instance(report, dbl, rad, shape, few, pt, glob):
    """(mangled name, ptxas figures) of the KE kernel instance a call ran:
    the many-point kernel <T, R, PT, S, GLOB> or the few-point one <T, R,
    S>."""
    t = "d" if dbl else "f"
    pat = (f"harmonic_eval_few_kernelI{t}Li{rad}ELi{shape}EE" if few else
           f"harmonic_eval_kernelI{t}Li{rad}ELi{pt}ELi{shape}ELb{int(glob)}EE")
    hits = [(n, v) for n, v in report.items() if pat in n]
    if len(hits) != 1:
        raise RuntimeError(f"ptxas report: {len(hits)} KE instances match {pat}")
    return hits[0]


def ke_split(torch, fn, k5_fn):
    """KE's wrapper at one call, split: ms around it (CUDA events), its host
    time (the enqueue with the card idle, perf_counter, median of 5), K5's
    h table alone (ms around `k5_fn` and its host time: with the even-d
    cylinder seeds), and the device us of KE's kernel and of the call's
    other kernels (torch.profiler, per call)."""
    from torch.profiler import ProfilerActivity, profile

    def host_ms(f):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    out = {"ms": cuda_ms(torch, fn, 5), "host_ms": host_ms(fn), "k5_ms": cuda_ms(torch, k5_fn, 5),
           "k5_host_ms": host_ms(k5_fn)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    evs = [(e.key, getattr(e, "device_time_total", 0.0)) for e in prof.key_averages()]
    out["ke_us"] = sum(t for k, t in evs if "harmonic_eval" in k) / 5
    out["other_us"] = sum(t for k, t in evs if "harmonic_eval" not in k) / 5
    return out


def check_ke(torch, dev, card):
    """Phase 2, KE (`ops/harmonic_eval.py`): the general evaluation against
    its plain version at the shapes the main path gives it, both dtypes,
    each launched twice and required bit-for-bit equal, within KE_TOL of
    the largest |u| at the points outside every sphere and, at the points
    a radius or more off every sphere, within KE_TOL of max(|u(x)|, the
    median |u|) there (`far_rel_err`; near a sphere h_31 sets the largest
    |u| far above the field elsewhere): (i) phase 7 (c),
    'bpa' at the bench (16 spheres, n_end=32) at 131,072 points x 1 k
    (many-point mode; timed, the record's row), (ii) phase 8 (a), 'bba' on
    the hypercube at n_end=20 at 16,384 points, (iii) phase 9 (b), 'a' on
    the 64 x 64 circles at n_end=32 at 1 point (few-point mode), (iv) phase
    10 (a), 'caa' on the hypercube at n_end=14 at 1 point x 4 k.  Returns
    the timed results of (i) by dtype name."""
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
    from biem_helmholtz_sphere_tpu_torch.ops import harmonic_eval as ke_mod
    from biem_helmholtz_sphere_tpu_torch.ops.harmonic_eval import (
        _harmonic_eval_plain, harmonic_eval, tree_radius)
    from biem_helmholtz_sphere_tpu_torch.ops.harmonic_program import shape_code
    from biem_helmholtz_sphere_tpu_torch.special._family import spherical_h_scaled
    from tools.torch_ke_ab import instance_name, local_memory, ptxas_report, sass_functions

    report, sass = ptxas_report("harmonic_eval.cu"), sass_functions()
    results = {}
    cases = (("(i) 'bpa' bench", "bpa", N_END, lattice_centers(), EVAL_POINTS, 1, True),
             ("(ii) 'bba' hypercube", "bba", N_END_4D, hypercube_centers(), EVAL_POINTS_4D, 1,
              True),
             ("(iii) 'a' 64x64 circles", "a", LADDER_2D[-1], square_lattice(N_SIDE_2D, 2), 1, 1,
              True),
             ("(iv) 'caa' hypercube", "caa", N_END_C, hypercube_centers(), 1, KB, True))
    for label, tree, n_end, centers_np, n_p, n_k, timed in cases:
        c = create_from_branching_types(tree)
        d, nb = c.c_ndim, len(centers_np)
        ell = basis(c, n_end).n_root
        h = len(ell)
        for cdt in (torch.complex64, torch.complex128):
            name = str(cdt).split(".")[-1]
            rdt = torch.float32 if cdt == torch.complex64 else torch.float64
            rng = np.random.default_rng(77)
            f = dict(dtype=rdt, device=dev)
            cen = torch.as_tensor(centers_np, **f).expand(n_k, nb, d)
            scale = 20.0 if n_p > 1 else 0.0  # one point: the origin, uscat(0)
            x = torch.as_tensor(rng.normal(size=(d, 1, n_p)) * scale, **f)
            k = torch.as_tensor(np.linspace(7.0, 7.06, n_k), **f)
            w = randc(torch, rng, (n_k, nb, h), cdt, dev) * torch.as_tensor(np.exp(-ell), **f)
            dist = torch.linalg.vector_norm(x[:, 0, :, None] - cen[0].T[:, None, :], dim=0)
            keep = (dist > 1.0).all(-1)
            far = (dist >= 2.0).all(-1)  # a radius or more off every sphere
            n0 = harmonic_eval.launches
            got = harmonic_eval(c, n_end, x, cen, k, w)
            ref = _harmonic_eval_plain(c, n_end, x, cen, k, w, False)
            ea, er = rel_err(torch, got[keep], ref[keep])
            ef = far_rel_err(torch, got[far], ref[far]) if bool(far.any()) else None
            if not same_bits(torch, harmonic_eval(c, n_end, x, cen, k, w), got):
                raise RuntimeError(f"harmonic_eval {label} {name}: two launches differ")
            if harmonic_eval.launches - n0 < 2:
                raise RuntimeError(f"harmonic_eval {label} {name}: the kernel did not launch")
            line = (f"[2] harmonic_eval (KE) {label}, n_end={n_end}, {n_p} points x {n_k} k x "
                    f"{nb} balls (H={h}) {name}: max_abs_err {ea:.3e} max_rel_err {er:.3e}, "
                    f"at the {int(far.sum())} points a radius off every sphere "
                    + ("none" if ef is None else f"{ef:.3e}")
                    + " of max(|u(x)|, the median |u|) there")
            few = n_p * n_k < 4 * 132
            glob = ke_mod._many_point_layout(c, n_end, w.element_size())[1]
            inst, pt = ke_instance(report, cdt == torch.complex128, 1 if d == 3 else 0,
                                   shape_code(c), few, ke_mod._PT[rdt], glob)
            n_local, n_inner, _ = local_memory(sass[inst])
            line += (f"; instance {instance_name(inst)}: {pt['registers']} registers, "
                     f"{pt['stack']} bytes stack frame, {pt['spill_stores']} / "
                     f"{pt['spill_loads']} bytes spill stores / loads (ptxas -v), {n_local} "
                     f"LDL/STL, {n_inner} of them in its inner FMA loops (cuobjdump)")
            if n_inner:
                raise RuntimeError(f"harmonic_eval {label} {name}: local memory in the inner "
                                   f"loops of {instance_name(inst)}")
            if timed:
                ms = cuda_ms(torch, lambda: harmonic_eval(c, n_end, x, cen, k, w), 5)
                pms = cuda_ms(torch, lambda: _harmonic_eval_plain(c, n_end, x, cen, k, w, False),
                              2)
                b = ke_bound(n_p, n_k, nb, h, n_end, d, name)
                kernel = "harmonic_eval_few" if few else "harmonic_eval_kernel"
                dus = device_us(torch, lambda: harmonic_eval(c, n_end, x, cen, k, w), kernel)
                line += (f" kernel {ms:.4f} ms ({dus:.2f} us on the device, torch.profiler) plain "
                         f"{pms:.4f} ms bound {b[0]:.6f} ms ({b[1]}) library none")
                if not few:
                    wwin, glob, threads = ke_mod._many_point_layout(c, n_end, w.element_size())
                    pt_ = ke_mod._PT[rdt]
                    per_sm = ke_mod._blocks_per_sm(shape_code(c), 1 if d == 3 else 0, threads,
                                                   n_end, wwin, glob, int(rdt == torch.float64))
                    bpz = ke_mod._ball_slices(-(-n_p // (threads * pt_)) * n_k, nb,
                                              per_sm * ke_mod._sm_count(dev))
                    line += (f"; the bound is {b[0] * 1e3 / dus:.3f} of the kernel's device time, "
                             f"{b[0] / ms:.3f} of the time around the wrapper; plan: {threads} "
                             f"threads x {pt_} points a CTA, {per_sm} CTAs an SM, {bpz} balls a "
                             f"slice, density window {wwin} of {h}")
                else:
                    rel = x[..., None] - cen.permute(2, 0, 1)[:, :, None, :]
                    sp = ke_split(torch, lambda: harmonic_eval(c, n_end, x, cen, k, w),
                                  lambda: spherical_h_scaled(d, n_end, k[:, None, None]
                                                             * tree_radius(c, rel)))
                    own = sp["host_ms"] - sp["k5_host_ms"]
                    line += (f"; split: around the wrapper {sp['ms']:.4f} ms, its host work "
                             f"{sp['host_ms']:.4f} ms (of it K5's h table with its host work "
                             f"{sp['k5_host_ms']:.4f}, KE's own {own:.4f}), "
                             f"K5's h table alone {sp['k5_ms']:.4f} ms around it, on the device "
                             f"KE {sp['ke_us']:.2f} us, K5 and the cylinder seeds "
                             f"{sp['other_us']:.2f} us")
                if label.startswith("(i)"):
                    results[name] = {"abs": ea, "rel": er, "ms": ms, "plain_ms": pms,
                                     "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
            print(f"{line} ({card})")
            if er > KE_TOL[name] or (ef is not None and ef > KE_TOL[name]):
                raise RuntimeError(f"harmonic_eval {label} {name}: rel err {er:.3e}, at the "
                                   f"points off the spheres {ef}")
            del got, ref, x, w
            torch.cuda.empty_cache()
    return results


def check_k3(torch, dev, card):
    """Phase 2, K3 (`translation/_rotation.py::rotation_blocks`): D against
    its plain version per degree block within K3_TOL, the unitarity error
    max |D D^H - I| of each degree group within twice the plain version's,
    both dtypes, launched twice and required bit-for-bit equal: (i) phase
    8 (a), 'bba' on the hypercube at n_end=20, its 64 slot directions (the
    record's row), (ii) phase 4, 'ba' at the bench, n_end=32, its 36 slots,
    (iii) phase 9 (a), 'ba' on the 32 x 32 lattice at n_end=19, its half
    table's 1,984 directions.  Each timed beside its plain version and its
    bound.  Returns the results of (i) by dtype name."""
    from biem_helmholtz_sphere_tpu_torch.biem._core import _offsets, _pair_routing
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
    from biem_helmholtz_sphere_tpu_torch.translation._rotation import (
        _k3_ratios, _rotation_blocks_plain, rotation_blocks)

    def half_dirs():  # the b < b' offsets: the lattice route's half table
        return _offsets(square_lattice(N_SIDE_3D, 3))[0]

    results = {}
    cases = (("(i) 'bba' hypercube slots", "bba", N_END_4D,
              lambda: _pair_routing(hypercube_centers()).uniq),
             ("(ii) 'ba' bench slots", "ba", N_END, lambda: _pair_routing(lattice_centers()).uniq),
             ("(iii) 'ba' 32x32 half table", "ba", N_END_3D, half_dirs))
    for label, tree, n_end, dirs_of, in cases:
        c = create_from_branching_types(tree)
        t_np = np.asarray(dirs_of(), dtype=np.float64)
        n_root = basis(c, n_end).n_root
        for cdt in (torch.complex64, torch.complex128):
            name = str(cdt).split(".")[-1]
            rdt = torch.float32 if cdt == torch.complex64 else torch.float64
            t = torch.as_tensor(t_np, dtype=rdt, device=dev)
            t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
            n0 = rotation_blocks.launches
            groups, got = rotation_blocks(c, t, n_end)
            if rotation_blocks.launches != n0 + 1:
                raise RuntimeError(f"rotation_blocks {label} {name}: the kernel did not launch")
            _, ref = _rotation_blocks_plain(c, t, n_end)
            ea, uni_k, uni_p = 0.0, 0.0, 0.0
            for (s, e), g, r in zip(groups, got, ref):
                if not bool(torch.isfinite(g).all()):
                    raise RuntimeError(f"rotation_blocks {label} {name}: not finite")
                nr = torch.as_tensor(n_root[s:e], device=dev)
                if not bool((g[:, nr[:, None] != nr[None, :]] == 0).all()):
                    raise RuntimeError(f"rotation_blocks {label} {name}: nonzero off its blocks")
                ea = max(ea, float((g - r).abs().max()))
                eye = torch.eye(e - s, dtype=cdt, device=dev)
                uk = float((g @ g.mH - eye).abs().max())
                up = float((r @ r.mH - eye).abs().max())
                if uk > 2 * up:
                    raise RuntimeError(f"rotation_blocks {label} {name}: group [{s}, {e}) "
                                       f"unitarity error {uk:.3e} > 2x the plain's {up:.3e}")
                uni_k, uni_p = max(uni_k, uk), max(uni_p, up)
            del ref
            _, again = rotation_blocks(c, t, n_end)
            if not all(same_bits(torch, a, b) for a, b in zip(again, got)):
                raise RuntimeError(f"rotation_blocks {label} {name}: two launches differ")
            del again, got
            ms = cuda_ms(torch, lambda: rotation_blocks(c, t, n_end), 3)
            pms = cuda_ms(torch, lambda: _rotation_blocks_plain(c, t, n_end), 1)
            b = k3_bound(c, n_end, len(t_np), name)
            dus = [device_us(torch, lambda: rotation_blocks(c, t, n_end), kn, per_call=True)
                   for kn in ("rotated_harmonics_kernel", "rotation_blocks_kernel")]
            lms = k3_library_ms(torch, c, n_end, len(t_np), cdt, dev)
            pad, gen = _k3_ratios(c, n_end, cdt == torch.complex128, len(t_np))
            print(f"[2] rotation_blocks (K3) {label}, n_end={n_end}, {len(t_np)} directions "
                  f"{name}: max_abs_err {ea:.3e} (of 1), max |D D^H - I| kernel {uni_k:.3e} "
                  f"plain {uni_p:.3e}; kernel {ms:.4f} ms (on the device per call, torch.profiler: "
                  f"harmonics {dus[0]:.2f} us, blocks {dus[1]:.2f} us) plain {pms:.4f} ms bound "
                  f"{b[0]:.6f} ms ({b[1]}) library {lms:.4f} ms (cuBLAS, the harmonics formed); "
                  f"plan: product entries computed / needed {pad:.4f}, harmonic generations "
                  f"per direction / H {gen:.4f} ({card})")
            if ea > K3_TOL[name]:
                raise RuntimeError(f"rotation_blocks {label} {name}: error {ea:.3e}")
            if label.startswith("(i)"):
                results[name] = {"abs": ea, "rel": ea, "ms": ms, "plain_ms": pms,
                                 "bound_ms": b[0], "bound_by": b[1], "library_ms": lms}
            torch.cuda.empty_cache()
    return results


KU_TOL = 1e-14  # of each entry's sum of magnitudes sum_q |tz w t_a t_b|
# KU's shapes (label, tree, n_end, timed): phase 8 (a)'s, the bench's, the
# accuracy range's top, the 5D pair's, and one past any size ceiling
KU_CASES = (("(i) 'bba' 4D first block", "bba", N_END_4D, True),
            ("(ii) 'ba' bench", "ba", N_END, True),
            ("(iii) 'ba'", "ba", 64, True),
            ("(iv) 'bbba' 5D pair", "bbba", N_END_5D, True),
            ("(v) 'ba', no size ceiling", "ba", 96, False))


def ku_bound(tables, plan, name):
    """KU's bound for tables in `name`'s real type: the root tables, the
    entries' rows, cols and order and the tiles read once, u and the tile
    image written once; per entry q products t_a t_b and, per band inside
    l + l' >= n (the bands outside are zero by definition: no work), 2 q
    operations of a float64 contraction (the FP64 tensor cores' rate).  The
    same count as csrc/coax_u.cu's header (3.61 GFLOP, 54.5 us at 'ba'
    n_end=64)."""
    t, tzw = tables
    (h, q), nb = t.shape, tzw.shape[1]
    rs = 4 if name == "complex64" else 8
    nnz = plan.order.shape[0]
    o = plan.order[:, 1].long()
    n_bands = int((((o & 0xFFFF) + (o >> 16)).clamp(max=nb - 1) + 1).sum())
    nbytes = ((h * q + q * nb) * 8 + nnz * 24 + plan.tiles.numel() * 4
              + (plan.ng * 8 * nnz + plan.slabs * 512) * rs)
    return bound(nbytes, q * nnz, "complex128", mma_flops=2 * q * n_bands)


def ku_library_ms(torch, tables, layout):
    """KU's yardstick: ms of the PyTorch product of the materialised
    factors, (tz w)^T (t_a t_b) at every packed entry (one elementwise pass
    and one DGEMM; it neither masks nor lays out the tiles)."""
    t, tzw = tables
    return cuda_ms(torch, lambda: torch.matmul(tzw.T, (t[layout.rows] * t[layout.cols]).T), 3)


def check_ku(torch, dev, card):
    """Phase 2, KU (`ops/coax_u.py::coax_u`): u and the tile image against
    the plain version at KU_CASES, both table dtypes, each entry within
    KU_TOL of its sum of magnitudes (and, in float32, one rounding of the
    plain value), exactly 0 wherever that sum is; launched twice and
    required bit-for-bit equal; timed beside its plain version, its bound
    and its yardstick.  Returns the results of (i) by the complex dtype
    whose path reads those tables."""
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.ops.coax_u import _coax_u_plain, coax_u
    from biem_helmholtz_sphere_tpu_torch.translation._rotation import _coax_tables_on
    from biem_helmholtz_sphere_tpu_torch.translation._scaled import _coax_plan_on

    from biem_helmholtz_sphere_tpu_torch.ops import kernels
    from tools.torch_ke_ab import ptxas_report, sass_functions

    results = {}
    kernels.library()
    report, sass = ptxas_report("coax_u.cu"), sass_functions()
    for mangled, fig in sorted(report.items()):
        if "coax_u_kernel" not in mangled:
            continue
        dbl = "coax_u_kernelId" in mangled
        direct = "Lb1E" in mangled
        dmma = sass[mangled].count("DMMA") if mangled in sass else 0
        print(f"[2] coax_u (KU) instance <{'double' if dbl else 'float'}, "
              f"{'true' if direct else 'false'}>: {fig['registers']} "
              f"registers, {fig['stack']} bytes stack frame, {fig['spill_stores']} / "
              f"{fig['spill_loads']} bytes spill stores / loads (ptxas -v), {dmma} DMMA in its "
              f"SASS (cuobjdump)")
        if dmma == 0 or fig["spill_stores"] or fig["spill_loads"]:
            raise RuntimeError(f"coax_u instance {mangled}: {dmma} DMMA, spills "
                               f"{fig['spill_stores']} / {fig['spill_loads']}")
    for label, tree, n_end, timed in KU_CASES:
        c = create_from_branching_types(tree)
        clear_coax_caches()  # the host index, plan and root tables timed cold
        t0 = time.perf_counter()
        layout, plan = _coax_plan_on(c, n_end, dev)[:2]
        t_plan = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables = _coax_tables_on(c, n_end, dev)
        torch.cuda.synchronize()
        t_tab = time.perf_counter() - t0
        (h, q), nb, nnz = tables[0].shape, tables[1].shape[1], plan.order.shape[0]
        mag = _coax_u_plain(tuple(x.abs() for x in tables), layout, plan, torch.float64)
        for rdt in (torch.float32, torch.float64):
            name = "complex64" if rdt == torch.float32 else "complex128"
            n0 = coax_u.launches
            got = coax_u(tables, layout, plan, rdt)
            if coax_u.launches != n0 + 1:
                raise RuntimeError(f"coax_u {label} {name}: the kernel did not launch")
            ref = _coax_u_plain(tables, layout, plan, rdt)
            rel = 2.0 ** -23 if rdt == torch.float32 else 0.0
            ea, er = 0.0, 0.0
            for g, r, m in zip(got, ref, mag):
                d = (g.double() - r.double()).abs()
                if not bool(torch.isfinite(g).all()):
                    raise RuntimeError(f"coax_u {label} {name}: not finite")
                if not bool((d <= KU_TOL * m + rel * r.double().abs()).all()):
                    raise RuntimeError(f"coax_u {label} {name}: off its plain version")
                if not bool((g[m == 0] == 0).all()):
                    raise RuntimeError(f"coax_u {label} {name}: not 0 where it must be")
                ea = max(ea, float(d.max()))
                er = max(er, float((d / m.clamp_min(1e-300))[m > 0].max()))
            if not same_bits(torch, coax_u(tables, layout, plan, rdt), got):
                raise RuntimeError(f"coax_u {label} {name}: two launches differ")
            del ref
            line = (f"[2] coax_u (KU) {label}, n_end={n_end}: q={q}, {nb} bands, H={h}, "
                    f"nnz={nnz}, {plan.slabs} slabs, {plan.tiles.shape[0]} tiles, tables "
                    f"{rdt}: max_abs_err {ea:.3e}, largest error / sum of magnitudes {er:.3e}")
            if timed:
                ms = cuda_ms(torch, lambda: coax_u(tables, layout, plan, rdt), 5)
                dus = device_us(torch, lambda: coax_u(tables, layout, plan, rdt), "coax_u_",
                                per_call=True)  # its two passes
                p1 = device_us(torch, lambda: coax_u(tables, layout, plan, rdt),
                               "coax_u_kernel", per_call=True)
                pms = cuda_ms(torch, lambda: _coax_u_plain(tables, layout, plan, rdt), 2)
                b = ku_bound(tables, plan, name)
                lms = ku_library_ms(torch, tables, layout)
                line += (f"; kernel {ms:.4f} ms ({dus:.2f} us on the device, torch.profiler, "
                         f"{100 * b[0] * 1e3 / dus:.1f}% of the bound; of it the tiles' pass "
                         f"{p1:.2f} us, u's rows {dus - p1:.2f} us) "
                         f"plain {pms:.4f} ms bound {b[0]:.6f} ms ({b[1]}) library {lms:.4f} ms "
                         f"(matmul of the materialised factors; the kernel "
                         f"{'below' if ms < lms else 'above'} it); host index and plan "
                         f"{t_plan:.4f} s, root tables on the card {t_tab:.4f} s (cold)")
                if label.startswith("(i)"):
                    results[name] = {"abs": ea, "rel": er, "ms": ms, "plain_ms": pms,
                                     "bound_ms": b[0], "bound_by": b[1], "library_ms": lms}
            print(f"{line} ({card})")
            del got
        del mag, tables, layout, plan
        torch.cuda.empty_cache()
    return results


KR_TOL = {"complex64": 1e-5, "complex128": 1e-12}  # of each (k, sphere, degree) block's largest


def kr_case(torch, dev, cdt, tree, n_end, centers_np, n_k, per_k=False):
    """KR's arguments as `_core._rhs_plane_wave` gives them: (c, n_end, j,
    j', k, direction, centers, alpha, beta, has_uin, has_grad).  The bench
    (per_k False): k = linspace(7, 7.06), one direction (x0, normalised
    as plane_wave does, so each k holds its own copy of the same bits), the
    centers shared, alpha 1 broadcast, the u_in term only; per_k: k + 0.1i,
    a direction and the centers moved per k, alpha and beta random, both
    terms."""
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.special._family import spherical_jh_all

    c = create_from_branching_types(tree)
    d = c.c_ndim
    rdt = torch.float32 if cdt == torch.complex64 else torch.float64
    f = dict(dtype=rdt, device=dev)
    rng = np.random.default_rng(21)
    n_b = len(centers_np)
    k = torch.linspace(7.0, 7.06, n_k, **f)
    direction = torch.zeros((d, n_k), **f)
    direction[0] = 1.0
    centers = torch.as_tensor(centers_np, **f)
    alpha = torch.ones((1, 1), dtype=cdt, device=dev).expand(n_k, n_b)
    beta = torch.zeros((1, 1), dtype=cdt, device=dev).expand(n_k, n_b)
    if per_k:
        k = k.to(cdt) + 0.1j
        direction = torch.as_tensor(rng.normal(size=(d, n_k)), **f)
        centers = centers + torch.as_tensor(rng.normal(size=(n_k, n_b, d)) * 0.1, **f)
        alpha, beta = (randc(torch, rng, (n_k, n_b), cdt, dev) for _ in range(2))
    direction = direction / torch.linalg.vector_norm(direction, dim=0, keepdim=True)
    z = (k[:, None] * torch.ones((n_k, n_b), **f)).to(cdt)
    j, jp, _, _ = spherical_jh_all(d, n_end, z)
    return c, n_end, j, jp, k, direction, centers, alpha, beta, True, per_k


def kr_cold():
    """Drop KR's kept Y tables and launch packs: the next call forms Y."""
    from biem_helmholtz_sphere_tpu_torch.ops import plane_rhs

    plane_rhs.kr_table.cache_clear()
    plane_rhs._packs.clear()


def check_kr(torch, dev, card):
    """Phase 2, KR (`ops/plane_rhs.py::plane_wave_rhs`, the plane-wave
    right-hand side): against its plain version, per (k, sphere, degree)
    block within KR_TOL, at (i) the bench, (ii) the bench with complex k, a
    direction and centers per k and both terms, (iii) phase 9 (b)'s 4,096
    circles at n_end=32: a cold call (`kr_cold`), a warm call (the same
    bits) and calls after the direction changed, to another and then to the
    last axis (a pole; each the bits of a cold call there); at (i) timed
    beside its plain version and its bound, warm and with the direction
    changed at every call, the wrapper's host time, the
    same call under set_sync_debug_mode("error") once the program and the
    kept Y are cached.  The ptxas figures of each instance run, which must
    have no stack frame.  Returns the results of (i) by dtype name."""
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
    from biem_helmholtz_sphere_tpu_torch.ops.harmonic_program import shape_code
    from biem_helmholtz_sphere_tpu_torch.ops.plane_rhs import (
        plane_wave_rhs, plane_wave_rhs_plain)
    from biem_helmholtz_sphere_tpu_torch.ops import kernels
    from tools.torch_ke_ab import ptxas_report
    from tools.torch_rhs_ab import _host_us

    kernels.library()
    report = ptxas_report("plane_rhs.cu")
    results = {}
    cases = (("(i) bench", "ba", N_END, lattice_centers(), KB, False),
             ("(ii) bench, complex k, a direction and centers per k, both terms", "ba", N_END,
              lattice_centers(), KB, True),
             ("(iii) 4,096 'a' circles, complex k, both terms", "a", 32,
              square_lattice(N_SIDE_2D, 2), 1, True))
    for label, tree, n_end, centers_np, n_k, per_k in cases:
        for cdt in (torch.complex64, torch.complex128):
            name = str(cdt).split(".")[-1]
            args = kr_case(torch, dev, cdt, tree, n_end, centers_np, n_k, per_k)
            n_root = basis(args[0], n_end).n_root
            turned = list(args)
            turned[5] = args[5] * 0.8 + torch.roll(args[5], 1, dims=0) * 0.6  # another one
            turned[5] = turned[5] / torch.linalg.vector_norm(turned[5], dim=0, keepdim=True)
            pole = list(args)  # the last axis: x = 1 in the polar recurrences
            pole[5] = torch.zeros_like(args[5])
            pole[5][-1] = 1.0
            errs = []
            kr_cold()
            n0 = plane_wave_rhs.launches
            got = plane_wave_rhs(*args)  # cold: every slice formed
            if plane_wave_rhs.launches != n0 + 1:
                raise RuntimeError(f"plane_wave_rhs {label} {name}: the kernel did not launch")
            for call, out, a in (("cold", got, args), ("warm", plane_wave_rhs(*args), args),
                                 ("turned", plane_wave_rhs(*turned), turned),
                                 ("pole", plane_wave_rhs(*pole), pole)):
                ref = plane_wave_rhs_plain(*a)
                er = ball_degree_rel_err(torch, out, ref, n_root)
                errs.append((call, float((out - ref).abs().max()), er))
                if er > KR_TOL[name]:
                    raise RuntimeError(f"plane_wave_rhs {label} {name} {call}: {er:.3e} > "
                                       f"{KR_TOL[name]}")
                if call == "warm" and not same_bits(torch, out, got):
                    raise RuntimeError(f"plane_wave_rhs {label} {name}: warm differs from cold")
                if call in ("turned", "pole"):
                    kr_cold()
                    if not same_bits(torch, plane_wave_rhs(*a), out):
                        raise RuntimeError(f"plane_wave_rhs {label} {name}: after a change of "
                                           f"direction differs from cold there")
            ea = max(e[1] for e in errs)
            line = (f"[2] plane_wave_rhs (KR) {label}: {tuple(got.shape)} {name}: "
                    + ", ".join(f"{c_} max_abs_err {a_:.3e} block {r_:.3e}" for c_, a_, r_ in errs)
                    + " (largest error / its (k, sphere, degree) block's largest); cold, warm "
                      "and changed-direction bits equal (turned, then to the last axis)")
            fig = next(v for k_, v in report.items()
                       if f"plane_rhs_kernelI{'d' if cdt == torch.complex128 else 'f'}"
                          f"Li{shape_code(args[0])}E" in k_)
            line += (f"; instance: {fig['registers']} registers, {fig['stack']} bytes stack "
                     f"frame, {fig['spill_stores']} / {fig['spill_loads']} bytes spills (ptxas)")
            if fig["stack"] or fig["spill_stores"] or fig["spill_loads"]:
                raise RuntimeError(f"plane_wave_rhs {label} {name}: a stack frame or spills")
            if label.startswith("(i)"):
                plane_wave_rhs(*args)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    plane_wave_rhs(*args)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                ms = cuda_ms(torch, lambda: plane_wave_rhs(*args), 20)
                dus = device_us(torch, lambda: plane_wave_rhs(*args), "plane_rhs_kernel")
                flip = [args, turned]
                state = [0]

                def changing():  # the direction changes at every call: every slice formed
                    state[0] ^= 1
                    return plane_wave_rhs(*flip[state[0]])

                ms_new = cuda_ms(torch, changing, 20)
                dus_new = device_us(torch, changing, "plane_rhs_kernel")
                host = _host_us(torch, lambda: plane_wave_rhs(*args), 200)
                pms = cuda_ms(torch, lambda: plane_wave_rhs_plain(*args), 5)
                cs = got.element_size()
                b = bound(cs * (got.numel() + 2 * args[2].numel()), 0, name)
                line += (f"; warm: kernel {ms:.4f} ms ({dus:.2f} us on the device, "
                         f"torch.profiler, {100 * b[0] * 1e3 / dus:.1f}% of the bound), "
                         f"wrapper host {host:.1f} us a call; direction changed every call: "
                         f"{ms_new:.4f} ms ({dus_new:.2f} us on the device); plain {pms:.4f} ms "
                         f"bound {b[0]:.6f} ms ({b[1]}: [K, B, H] written, j and j' read) "
                         f"library none (no PyTorch call evaluates a tree's harmonics); no host "
                         f"sync once the program and the kept Y are cached")
                results[name] = {"abs": ea, "rel": max(e[2] for e in errs), "ms": ms,
                                 "plain_ms": pms, "bound_ms": b[0], "bound_by": b[1],
                                 "library_ms": None}
            print(f"{line} ({card})")
            del got, args, turned
    return results


K6_TOL = {"complex64": 1e-5, "complex128": 1e-13}  # of each state tensor's largest entry
# K6's shapes (label, complex dtype name, restart m, the steps j held, the
# operator): the bench block (phase 4, the factored operator) and phase 6
# (a)'s complex128 offset table, both 4 k x 16,384 unknowns; phase 9 (b)'s
# cold rung (the 64 x 64 lattice of 'a' circles at n_end=2, 1 x 12,288
# unknowns, basis COLD_RESTART)
K6_CASES = (("(i) bench block", "complex64", 48, (0, 7, 47), "bench"),
            ("(ii) offset table", "complex128", 192, (0, 10, 20), "bench"),
            ("(iii) cold rung", "complex64", COLD_RESTART, (0, 580, 1161), "cold"))


def k6_bound(n_sys, n, j, name, v_reads=1):
    """K6's bound for step j, from the bytes the step must move: rows 0..j
    of V read once, w and diag read, V[j+1] written, the rows of Q in the
    rotation and rows j, j+1 of Q and row j of R; 8 real operations per
    complex multiply-add of the two passes' projections and updates.
    v_reads=4 gives instead this design's traffic (each pass of CGS2 reads
    the rows twice: once for its dots, once for its update)."""
    cs = 8 if name == "complex64" else 16
    nbytes = ((v_reads * (j + 1) + 3) * n_sys * n * cs
              + n_sys * ((j + 2) ** 2 // 2 + 3 * (j + 2)) * cs)
    return bound(nbytes, 32 * (j + 1) * n_sys * n, name)


def backsolve_bound(n_sys, j_f, name):
    """The back-substitution's bound: R's upper triangle over the j_f
    columns and g read, y written; a complex multiply-add per entry."""
    cs = 8 if name == "complex64" else 16
    tri = n_sys * j_f * (j_f + 1) // 2
    return bound((tri + 2 * n_sys * j_f) * cs, 8 * tri, name)


def k6_operator(torch, dev, name, m, kind="bench"):
    """(mv, diag, r): phase 4's bench operator (the factored route, c64)
    or phase 6 (a)'s offset table (c128, unscaled), 4 k x 16,384
    unknowns, or (kind "cold") phase 9 (b)'s cold rung ('a' on the 64 x 64
    lattice at n_end=2, k = 1, c64, 12,288 unknowns); and a random vector."""
    from biem_helmholtz_sphere_tpu_torch.biem import _core, _lattice
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

    rdt = torch.float32 if name == "complex64" else torch.float64
    cdt = torch.complex64 if name == "complex64" else torch.complex128
    if kind == "cold":
        c = create_from_branching_types("a")
        centers = square_lattice(N_SIDE_2D, 2)
        nb = len(centers)
        ones, k1 = torch.ones(1, nb, dtype=rdt, device=dev), torch.ones(1, dtype=rdt, device=dev)
        mv, diag = _lattice.lattice_operator(
            c, 2, centers, ones, k1, k1, torch.ones(1, nb, dtype=cdt, device=dev),
            torch.zeros(1, nb, dtype=cdt, device=dev), stable=True)
        r = randc(torch, np.random.default_rng(19), (1, nb * 3), cdt, dev)
        return mv, diag, r
    c = create_from_branching_types("ba")
    centers_np = lattice_centers()
    nb = len(centers_np)
    args = (torch.ones(KB, nb, dtype=rdt, device=dev),
            torch.as_tensor(sweep_ks()[:KB], dtype=rdt, device=dev),
            torch.ones(KB, dtype=rdt, device=dev),
            torch.ones(KB, nb, dtype=cdt, device=dev), torch.zeros(KB, nb, dtype=cdt, device=dev))
    if name == "complex64":
        mv, diag = _core._factored_operator(c, N_END, centers_np, *args)
    else:
        mv, diag = _core._matfree_operator(c, N_END, centers_np, *args, stable=False)
    r = randc(torch, np.random.default_rng(19), (KB, nb * N_END * N_END), cdt, dev)
    return mv, diag, r


def device_us_launches(torch, fn, kernel):
    """(mean device microseconds per launch, launches per call, the kernels'
    names) of the kernels whose names hold `kernel` (profile_kernels).  The
    profiler may drop a short kernel's event: launches per call is the
    count over the 5 calls rounded up, so one dropped event reads as 1."""
    total, count, names = profile_kernels(torch, fn, kernel)
    return total / count, -(-count // 5), names


def check_k6(torch, dev, card):
    """Phase 2, K6 (`ops/gmres_step.py::arnoldi_step`, one Arnoldi step,
    and `backsolve`): from the same state and matvec at steps j of the
    bench block's, phase 6 (a)'s and phase 9 (b)'s cold rung's solves
    (target 0: every step runs), the kernel's V, R, Q, g and resid within
    K6_TOL of the plain step's, steps and the flag word equal; launched
    twice and required bit-for-bit equal; a masked launch changes nothing;
    one launch a step (torch.profiler), timed beside the plain step and the
    bound, with its grid and whether the tile was resident; then the
    back-substitution of the last state's R and g against its plain
    version, timed beside `torch.linalg.solve_triangular`.  Returns the
    results of (i) step j = 7 by dtype name, and of the back-substitution
    at (i) and (ii), under "gmres_backsolve"."""
    from biem_helmholtz_sphere_tpu_torch.ops.gmres_step import (
        _arnoldi_step_plain, _backsolve_plain, _capacity, _cuda_plan, arnoldi_state,
        arnoldi_step, backsolve)

    def clone(st):
        return type(st)(*[t.clone() if isinstance(t, torch.Tensor) else t for t in st])

    def tensors(st):
        return {k: t for k, t in st._asdict().items()
                if isinstance(t, torch.Tensor) and k not in ("cwork", "rwork")}

    results = {"arnoldi_step": {}, "gmres_backsolve": {}}
    for label, name, m, js, kind in K6_CASES:
        mv, diag, r = k6_operator(torch, dev, name, m, kind)
        n_sys, n = r.shape
        rdt = r.real.dtype
        target = torch.zeros(n_sys, dtype=rdt, device=dev)
        tiny = float(torch.finfo(rdt).tiny) ** 0.5
        st = arnoldi_state(r, diag, target, m)
        plan = _cuda_plan(n_sys, n, r.dtype, dev)
        n_sm = _capacity(r.dtype == torch.complex128, dev.index or 0)[1]
        sms = min(plan.grid, n_sm)
        for j in range(max(js) + 1):
            w = mv(st.V[:, j])
            if j in js:
                got, again, ref = clone(st), clone(st), clone(st)
                n0 = arnoldi_step.launches
                arnoldi_step(got, w, j, target, tiny)
                arnoldi_step(again, w, j, target, tiny)
                if arnoldi_step.launches != n0 + 2:
                    raise RuntimeError(f"arnoldi_step {label} j={j}: the kernel did not launch")
                _arnoldi_step_plain(ref, w, j, target, tiny)
                if ref.flag.tolist() != [1, 0, j + 1]:
                    raise RuntimeError(f"arnoldi_step {label} j={j}: the step ran masked")
                errs = {}
                for key, t in tensors(got).items():
                    want = getattr(ref, key)
                    if not same_bits(torch, t, getattr(again, key)):
                        raise RuntimeError(f"arnoldi_step {label} j={j}: two launches differ")
                    if t.dtype == torch.int32:
                        if not torch.equal(t, want):
                            raise RuntimeError(f"arnoldi_step {label} j={j}: {key} differs")
                        continue
                    errs[key] = rel_err(torch, t, want)
                worst = max(e[1] for e in errs.values())
                if worst > K6_TOL[name]:
                    raise RuntimeError(f"arnoldi_step {label} j={j}: off its plain version {errs}")
                for word in ([0, 0, j], [1, 1, j]):
                    masked = clone(st)
                    masked.flag.copy_(torch.tensor(word, dtype=torch.int32))
                    before = clone(masked)
                    arnoldi_step(masked, w, j, target, tiny)
                    if not all(same_bits(torch, t, getattr(before, k))
                               for k, t in tensors(masked).items()):
                        raise RuntimeError(f"arnoldi_step {label} j={j}: a masked launch "
                                           f"changed the state")
                scratch = clone(st)
                ms = cuda_ms(torch, lambda: arnoldi_step(scratch, w, j, target, tiny), 10)
                dus, n_launch, names = device_us_launches(
                    torch, lambda: arnoldi_step(scratch, w, j, target, tiny), "k6_")
                if n_launch != 1 or len(names) != 1:
                    raise RuntimeError(f"arnoldi_step {label} j={j}: {n_launch} launches of "
                                       f"{names} a step")
                pms = cuda_ms(torch, lambda: _arnoldi_step_plain(scratch, w, j, target, tiny), 5)
                b = k6_bound(n_sys, n, j, name)
                resident = j + 1 <= plan.resident_rows
                traffic = k6_bound(n_sys, n, j, name, v_reads=1 if resident else 4)[0]
                print(f"[2] arnoldi_step (K6) {label}, {n_sys} x {n} unknowns, m={m}, step "
                      f"j={j} {name}: max_abs_err {max(e[0] for e in errs.values()):.3e}, "
                      f"largest error / largest entry {worst:.3e} (V {errs['V'][1]:.2e}, R "
                      f"{errs['R'][1]:.2e}, Q {errs['Q'][1]:.2e}, g {errs['g'][1]:.2e}, resid "
                      f"{errs['resid'][1]:.2e}); {n_launch} launch a step ({names[0]}), grid {plan.grid} "
                      f"CTAs on {sms} of {n_sm} SMs, slices of <= {plan.lmax} entries, tile "
                      f"{'resident' if resident else 'streamed'} (resident to j+1 = "
                      f"{plan.resident_rows}, ring {plan.stages} x {plan.rb} rows x {plan.cw}); "
                      f"kernel {ms:.4f} ms ({dus:.2f} us on the device, torch.profiler; the "
                      f"bound's share, V read once, {b[0] * 1e3 / dus:.3f}; this design's "
                      f"traffic, V read {'once' if resident else 'four times'}, {traffic:.6f} ms,"
                      f" its share {traffic * 1e3 / dus:.3f}) plain {pms:.4f} ms bound "
                      f"{b[0]:.6f} ms ({b[1]}) library none ({card})")
                if j == 7:
                    results["arnoldi_step"][name] = {
                        "abs": max(e[0] for e in errs.values()), "rel": worst, "ms": ms,
                        "plain_ms": pms, "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
                del got, again, ref, scratch
            _arnoldi_step_plain(st, w, j, target, tiny)
        j_f = int(st.flag[2])
        n0 = backsolve.launches
        y = backsolve(st.R, st.g, st.flag, tiny)
        if backsolve.launches != n0 + 1:
            raise RuntimeError(f"backsolve {label}: the kernel did not launch")
        ref = _backsolve_plain(st.R, st.g, st.flag, tiny)
        ea, er = rel_err(torch, y, ref)
        if er > K6_TOL[name] or not same_bits(torch, backsolve(st.R, st.g, st.flag, tiny), y):
            raise RuntimeError(f"backsolve {label}: off its plain version ({er:.3e}) or not "
                               f"repeated bit for bit")
        ms = cuda_ms(torch, lambda: backsolve(st.R, st.g, st.flag, tiny), 10)
        dus = device_us(torch, lambda: backsolve(st.R, st.g, st.flag, tiny), "k6_backsolve")
        pms = cuda_ms(torch, lambda: _backsolve_plain(st.R, st.g, st.flag, tiny), 3)
        upper = st.R[:, :j_f, :j_f].transpose(1, 2)
        rhs = st.g[:, :j_f, None]
        lms = cuda_ms(torch, lambda: torch.linalg.solve_triangular(upper, rhs, upper=True), 10)
        b = backsolve_bound(n_sys, j_f, name)
        print(f"[2] gmres_backsolve (K6) {label}, j_f={j_f} {name}: max_abs_err {ea:.3e} "
              f"max_rel_err {er:.3e}; kernel {ms:.4f} ms ({dus:.2f} us on the device, 1 "
              f"launch, a CTA a system) plain {pms:.4f} ms bound {b[0]:.6f} ms ({b[1]}) "
              f"library {lms:.4f} ms (torch.linalg.solve_triangular) ({card})")
        results["gmres_backsolve"].setdefault(name, {
            "abs": ea, "rel": er, "ms": ms, "plain_ms": pms, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": lms})
        del st, mv, diag, r, y, ref
        torch.cuda.empty_cache()
    return results


def readme_golden(torch, dev):
    """Phase 3: the README problem through the port on the card, on the
    factored route and with the default solver (a direct LU)."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

    c = create_from_branching_types("ba")
    for route, kw in (("factored", dict(solver="matfree", stable=True)), ("auto (LU)", {})):
        vals = {}
        for rdt in (torch.float64, torch.float32):
            f = dict(dtype=rdt, device=dev)
            uin, _ = plane_wave(k=torch.tensor(1.0, **f),
                                direction=torch.tensor([1.0, 0.0, 0.0], **f))
            calc = biem(c, centers=torch.tensor([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]], **f),
                        radii=torch.ones(2, **f), k=torch.tensor(1.0, **f), n_end=6,
                        uin=uin, **kw)
            if not kw and (calc.relres is not None or calc.matrix is None):
                raise RuntimeError("the default solver did not take the direct LU")
            vals[rdt] = complex(calc.uscat(torch.zeros(3, 1, **f))[0])
        u, u32 = vals[torch.float64], vals[torch.float32]
        print(f"[3] README golden, {route}: complex128 uscat(0) = {u.real:.6f}{u.imag:+.6f}j "
              f"(complex64 {u32:.6f}, rel diff {abs(u32 - u) / abs(u):.2e})")
        if (round(u.real, 6), round(u.imag, 6)) != GOLDEN_README:
            raise RuntimeError(f"README golden mismatch ({route}): {u} vs {GOLDEN_README}")
        if abs(u32 - u) > 1e-4 * abs(u):
            raise RuntimeError(f"README golden ({route}): complex64 off by {abs(u32 - u):.2e}")


def bench_sweep(torch, dev):
    """The bench configuration's k sweep through biem(): (block, sweep, ks).

    block(kb, dens0) solves one k-block and evaluates uscat(0); sweep()
    runs the 2 blocks of KB k with warm starts and returns their
    (calculator, uscat(0)) pairs.
    """
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

    c = create_from_branching_types("ba")
    f = dict(dtype=torch.float32, device=dev)
    centers_np = lattice_centers()
    nb = len(centers_np)
    centers = torch.as_tensor(centers_np, **f)
    direction = torch.tensor([1.0, 0.0, 0.0], **f)
    ks = sweep_ks()[: 2 * KB]

    def block(kb, dens0):
        kt = torch.as_tensor(kb, **f)
        uin, _ = plane_wave(k=kt, direction=direction[:, None].expand(3, KB))
        calc = biem(c, centers=centers.expand(KB, nb, 3), radii=torch.ones(KB, nb, **f),
                    k=kt, n_end=N_END, uin=uin, density0=dens0)
        return calc, calc.uscat(torch.zeros(3, 1, **f))[0]

    def sweep():
        dens = torch.zeros((nb, N_END * N_END), dtype=torch.complex64, device=dev)
        out = []
        for i0 in range(0, len(ks), KB):
            calc, u0 = block(ks[i0 : i0 + KB], dens)
            dens = calc.density[KB - 1]
            out.append((calc, u0))
        return out

    return block, sweep, ks


def bench_config(torch, dev, card):
    """Phase 4: the bench configuration through biem(); returns launches."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

    from biem_helmholtz_sphere_tpu_torch.biem import _core
    from biem_helmholtz_sphere_tpu_torch.ops import gmres as _gmres

    reset, read = kernel_counts()

    c = create_from_branching_types("ba")
    f = dict(dtype=torch.float32, device=dev)
    centers_np = lattice_centers()
    nb = len(centers_np)
    centers = torch.as_tensor(centers_np, **f)
    direction = torch.tensor([1.0, 0.0, 0.0], **f)
    block, sweep, ks = bench_sweep(torch, dev)

    torch.cuda.reset_peak_memory_stats()
    clear_coax_caches()  # phase 2 built the bench's; the first block builds them (KU)
    reset()
    block(ks[:KB] - 0.5, None)  # warm-up block: caches, allocator, kernel load, D (K3), U (KU)
    torch.cuda.synchronize()
    first = read()
    k3_first, ku_first = first["rotation_blocks"], first["coax_u"]
    print(f"[4] launches in the first block of K3 (rotation_blocks, D of the 36 slots) "
          f"{k3_first}, of KU (coax_u, the coax tables) {ku_first}, both cached for the sweep")
    if k3_first <= 0 or ku_first <= 0:
        raise RuntimeError("[4] the first block never launched K3 or KU")
    reset()
    gm0 = gmres_counts()
    t0 = time.perf_counter()
    run1 = sweep()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read()
    gm = {k: v - gm0[k] for k, v in gmres_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[4] launches in the sweep: {launches}")
    # the sweep evaluates uscat(0) only: the many-point KA runs in the field
    # evaluation path below, KD on the dense route (phase 5); KB's row panels
    # only in d >= 4 (phase 8), KG in 2D (phase 9), KS on 'c' trees (phase 10)
    # KE evaluates trees other than 'ba' (phases 7-10); K3 ran in the first
    # block, its D cached for the sweep
    require_launched(launches, [n for n in launches if n not in (
        "fused_ba_eval", "dense_assemble", "block_diag_cmm_panels", "graf_fold", "band_sr",
        "band_f", "harmonic_eval", "rotation_blocks", "coax_u")], "[4] the sweep")
    if launches["harmonic_eval"]:
        raise RuntimeError("[4] the 'ba' bench launched KE")
    if launches["band_sr"] or launches["band_f"]:
        raise RuntimeError("[4] the 3D bench launched KS or KF")
    if launches["graf_fold"]:
        raise RuntimeError("[4] the 3D bench launched KG")
    if launches["block_diag_cmm_panels"]:
        raise RuntimeError("[4] the 3D bench took KB's row panels")
    n_blocks = len(ks) // KB
    # per k-block: K5 for the RHS, the radial rows, the coax bands and
    # uscat(0)'s blc; K2 once
    if launches["spherical_jh"] < 4 * n_blocks or launches["coax_fold"] < n_blocks:
        raise RuntimeError(f"K5/K2 launched fewer times than the {n_blocks} blocks need")
    print(f"[4] peak device memory {peak:.3f} GiB (warm-up block and sweep, "
          f"torch.cuda.max_memory_allocated) ({card})")

    n_solves = len(run1)
    print(f"[4] GMRES (K6): lag s = {_gmres._LAG_CUDA} steps between the host's reads of the "
          f"flag word; per solve {gm['host_reads'] / n_solves:.2f} host reads, "
          f"{gm['steps_issued'] / n_solves:.2f} steps launched (each after a matvec), "
          f"{gm['steps_run'] / n_solves:.2f} run, so {gm['steps_issued'] - gm['steps_run']} "
          f"matvecs and masked steps past convergence in the sweep; K6 launches per k-block: "
          f"arnoldi_step {launches['arnoldi_step'] / n_blocks:.1f}, gmres_backsolve "
          f"{launches['gmres_backsolve'] / n_blocks:.1f}")
    no_host_sync(torch, _core, lambda: block(ks[:KB], None), "[4] the bench block")
    if launches["plane_wave_rhs"] != n_blocks:
        raise RuntimeError(f"[4] KR launched {launches['plane_wave_rhs']} times in {n_blocks} "
                           "k-blocks, not once a block")
    kinds = rhs_stage_kernels(torch, _core, lambda: block(ks[:KB], None))
    print(f"[4] KR (plane_wave_rhs) launches per k-block {launches['plane_wave_rhs'] / n_blocks:.1f}"
          f"; the RHS stage of a warm block ran {sum(kinds.values())} kernels on the card "
          f"(torch.profiler): {kinds}")
    if sum(kinds.values()) > 3 or any(n.startswith("Memcpy") for n in kinds):
        raise RuntimeError(f"[4] the RHS stage of a warm block ran more than 3 kernels or a copy: "
                           f"{kinds}")
    iters = [calc.iters.tolist() for calc, _ in run1]
    relres = [calc.relres.tolist() for calc, _ in run1]
    for calc, _ in run1:
        if not bool(torch.isfinite(calc.density).all()):
            raise RuntimeError("non-finite density")
    worst = max(max(r) for r in relres)
    print(f"[4] GMRES iters per system {iters}, max relres {worst:.3e}")
    if worst > 3e-5:
        raise RuntimeError(f"relres {worst:.3e} > 3e-5")
    iters_per_k = float(np.mean([max(i) for i in iters]))
    print(f"[4] per-k {dt / len(ks):.6f} s over {len(ks)} k ({len(ks) // KB} blocks "
          f"of {KB}, warm starts), GMRES iters per k {iters_per_k} ({card})")

    with open(os.path.join(ROOT, "biem_helmholtz_sphere_tpu_torch", "data",
                           "bench_golden_f64.json")) as fh:
        golden = json.load(fh)["points"]
    u_first = run1[0][1].cpu().numpy()
    for i, g in enumerate(golden[:KB]):
        if abs(g["k"] - float(ks[i])) > 1e-6:
            raise RuntimeError(f"golden k {g['k']} != sweep k {ks[i]}")
        ref = complex(*g["uscat0"])
        err = abs(u_first[i] - ref) / abs(ref)
        print(f"[4] k={ks[i]:.6f} uscat(0) = {u_first[i]:.6f} golden {ref:.6f} rel err {err:.2e}")
        if err > 1e-3:
            raise RuntimeError(f"uscat(0) at k={ks[i]} off the JAX f64 golden by {err:.2e}")

    res_max, res_mean = bc_residual(torch, run1[0][0])
    print(f"[4] sound-soft BC residual at 256 points on spheres 0,5,10,15: "
          f"max {res_max:.3e} mean {res_mean:.3e}")
    if not res_max <= 1e-3:
        raise RuntimeError(f"BC residual {res_max:.3e} > 1e-3")

    run2 = sweep()
    torch.cuda.synchronize()
    same = all(
        torch.equal(torch.view_as_real(a[1]), torch.view_as_real(b[1]))
        and torch.equal(torch.view_as_real(a[0].density), torch.view_as_real(b[0].density))
        for a, b in zip(run1, run2)
    )
    print(f"[4] repeated sweep bit-for-bit equal: {same}")
    if not same:
        raise RuntimeError("the repeated sweep differs")
    stage_split(torch, sweep, len(ks), card)
    matvec_path(torch, dev, run1[0][0])

    # the field evaluation path: uscat at EVAL_POINTS points for one k
    uin, _ = plane_wave(k=torch.tensor(K0, **f), direction=direction)
    calc = biem(c, centers=centers, radii=torch.ones(nb, **f), k=torch.tensor(K0, **f),
                n_end=N_END, uin=uin)
    x = eval_points(torch, dev)
    torch.cuda.synchronize()
    reset()
    u = calc.uscat(x)
    torch.cuda.synchronize()
    field = read()
    print(f"[4] launches in the field evaluation ({EVAL_POINTS} points): {field}")
    if field["fused_ba_eval"] <= 0:
        raise RuntimeError("the field evaluation never launched the many-point fused_ba_eval")
    outside = (torch.linalg.vector_norm(x[:, :, None] - centers.T[:, None, :], dim=0)
               > 1.0).all(-1)
    if not bool(torch.isfinite(u[outside]).all()):
        raise RuntimeError("uscat is not finite outside the spheres")
    launches["fused_ba_eval"] = field["fused_ba_eval"]
    launches["rotation_blocks"] = k3_first
    launches["coax_u"] = ku_first
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        calc.uscat(x)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    print(f"[4] uscat throughput {EVAL_POINTS / best:.1f} pts/s "
          f"({EVAL_POINTS} points, best of 5: {best:.6f} s) ({card})")
    return launches


def rhs_stage_kernels(torch, module, run):
    """{device event name: count} of `module._rhs_dispatch` (the RHS stage)
    within run(), under torch.profiler (a window that shows fewer than the
    stage's K5 and KR is profiled again, up to three runs)."""
    from torch.profiler import ProfilerActivity, profile

    rhs = module._rhs_dispatch
    kinds = {}

    def profiled(*args, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = rhs(*args, **kw)
            torch.cuda.synchronize()
        kinds.clear()
        for e in prof.events():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                kinds[e.name[:60]] = kinds.get(e.name[:60], 0) + 1
        return out

    module._rhs_dispatch = profiled
    try:
        for _ in range(3):
            run()
            if sum(kinds.values()) >= 2:
                break
    finally:
        module._rhs_dispatch = rhs
    torch.cuda.synchronize()
    return kinds


def bc_residual(torch, calc):
    """(max, mean) of |u_in + u_scat| at 256 points just outside spheres 0,
    5, 10 and 15 of the lattice (sound-soft: zero on the boundary), for
    each k of the calculator's batch; u_in is the solve's own incident
    field (calc.uin)."""
    rng = np.random.default_rng(7)
    centers_np = lattice_centers()
    pts = []
    for b in (0, 5, 10, 15):
        v = rng.normal(size=(3, 64))
        v /= np.linalg.norm(v, axis=0)
        pts.append(centers_np[b][:, None] + 1.0000005 * v)
    xb = torch.as_tensor(np.concatenate(pts, axis=1), dtype=calc.radii.dtype,
                         device=calc.radii.device)
    res = (calc.uin(xb) + calc.uscat(xb)).abs()
    return float(res.max()), float(res.mean())


def matvec_path(torch, dev, calc):
    """One matvec of the bench operator: at most 3 block_diag_cmm launches
    and no index_select (X's permutation is read inside the kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from biem_helmholtz_sphere_tpu_torch.biem import _core
    from biem_helmholtz_sphere_tpu_torch.ops.block_diag import block_diag_cmm

    n_k = calc.k.numel()
    mv, _ = _core._factored_operator(
        calc.c, N_END, calc.centers[0].cpu().numpy().astype(np.float64), calc.radii,
        calc.k, torch.ones(n_k, dtype=torch.float32, device=dev),
        torch.ones(calc.radii.shape, dtype=torch.complex64, device=dev),
        torch.zeros(calc.radii.shape, dtype=torch.complex64, device=dev))
    x = calc.density.reshape(n_k, -1)
    mv(x)
    torch.cuda.synchronize()
    n0 = block_diag_cmm.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mv(x)
        torch.cuda.synchronize()
    n_kb = block_diag_cmm.launches - n0
    ops = {e.key: e.count for e in prof.key_averages()}
    print(f"[4] one matvec: {n_kb} block_diag_cmm launches, index_select "
          f"{ops.get('aten::index_select', 0)} times")
    if n_kb > 3 or "aten::index_select" in ops:
        raise RuntimeError("the matvec permutes X's lanes outside block_diag_cmm")


def split_stages(torch, run, stages):
    """Run run() once with each (module, attribute, label) of stages
    wrapped in synchronising host timers (they add their own syncs, so the
    total exceeds an untimed run's); returns ({label: s}, total s)."""
    acc = {}

    def timed(fn, key):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in stages]
    try:
        for (obj, attr, fn), (_, _, label) in zip(saved, stages):
            setattr(obj, attr, timed(fn, label))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    return acc, total


def format_split(acc, total, labels, n_k):
    parts = ", ".join(f"{key} {acc.get(key, 0.0) / n_k:.6f}" for key in labels)
    return f"{parts}, other {(total - sum(acc.values())) / n_k:.6f}, total {total / n_k:.6f}"


def stage_split(torch, sweep, n_k, card):
    """Phase 4's stage split: one more sweep with each stage timed."""
    from biem_helmholtz_sphere_tpu_torch.biem import _core

    stages = [(_core, "_rhs_dispatch", "RHS"), (_core, "_radial_rows_scaled", "radial rows"),
              (_core, "coax_fold_packed", "K2 (with its K5)"),
              (_core, "gmres_solve_op", "solve"),
              (_core.BIEMResultCalculator, "uscat", "uscat(0)")]
    acc, total = split_stages(torch, sweep, stages)
    print(f"[4] stage split, s per k (synchronising timers, {n_k} k): "
          f"{format_split(acc, total, [label for _, _, label in stages], n_k)} ({card})")


def dense_route(torch, dev, card):
    """Phase 5: the dense route at full width; returns the launch counts of
    its bench run (c)."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.biem import _core
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.translation import _rotation

    reset, read = kernel_counts()

    c = create_from_branching_types("ba")
    centers_np = lattice_centers()
    nb = len(centers_np)
    ks = sweep_ks()[:KB]

    def solve(rdt, n_end, **kw):
        f = dict(dtype=rdt, device=dev)
        kt = torch.as_tensor(ks, **f)
        uin, _ = plane_wave(k=kt, direction=torch.tensor([1.0, 0.0, 0.0], **f)[:, None]
                            .expand(3, KB))
        return biem(c, centers=torch.as_tensor(centers_np, **f).expand(KB, nb, 3),
                    radii=torch.ones(KB, nb, **f), k=kt, n_end=n_end, uin=uin, **kw)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def split(label, rdt, n_end, stages, **kw):
        def run():
            calc = solve(rdt, n_end, **kw)
            calc.uscat(torch.zeros(3, 1, dtype=rdt, device=dev))
        stages = stages + [(_core.BIEMResultCalculator, "uscat", "uscat(0)")]
        acc, total = split_stages(torch, run, stages)
        print(f"[5] {label} stage split, s per k-block of {KB} (synchronising timers): "
              f"{format_split(acc, total, [s[2] for s in stages], 1)} ({card})")

    scaled = [(_core, "_rhs_dispatch", "RHS"), (_core, "_radial_rows_scaled", "radial rows"),
              (_core, "coax_fold_packed", "coax (K5 + K2)"), (_core, "_sandwich", "sandwich"),
              (_core, "dense_assemble", "KD")]
    plain = [(_core, "_rhs_dispatch", "RHS"), (_core, "_radial_rows", "radial rows"),
             (_rotation, "coaxial_sr", "coax (K5 + K2)"), (_rotation, "_sandwich", "sandwich"),
             (_core, "dense_assemble", "KD")]
    n_lu = nb * N_END_LU * N_END_LU
    for rdt, tol, label in ((torch.float32, 1e-3, "(a) complex64"),
                            (torch.float64, 1e-8, "(b) complex128 stable=False")):
        route = _core._route("auto", nb, n_lu, rdt, dev, True, False, centers_np)
        if route != "lu":
            raise RuntimeError(f"auto picks {route!r} for the n_end={N_END_LU} lattice")
        torch.cuda.synchronize()
        reset()
        calc = solve(rdt, N_END_LU)
        torch.cuda.synchronize()
        counts = read()
        if calc.relres is not None or calc.matrix is None:
            raise RuntimeError(f"{label}: the default solver did not take the direct LU")
        ref = solve(rdt, N_END_LU, solver="matfree", stable=True)
        err = rel(calc.density, ref.density)
        res_max, res_mean = bc_residual(torch, calc)
        print(f"[5] {label} lattice n_end={N_END_LU} ({n_lu} unknowns), auto -> LU: launches "
              f"{counts}; density vs the factored route rel err {err:.3e}; BC residual max "
              f"{res_max:.3e} mean {res_mean:.3e} ({card})")
        if not bool(torch.isfinite(calc.density).all()) or not err <= tol:
            raise RuntimeError(f"{label}: density off the factored route by {err:.3e} > {tol}")
        if rdt == torch.float32 and not res_max <= 1e-3:
            raise RuntimeError(f"{label}: BC residual {res_max:.3e} > 1e-3")
        if min(counts["dense_assemble"], counts["spherical_jh"], counts["coax_fold"]) <= 0:
            raise RuntimeError(f"{label}: the dense route skipped a kernel: {counts}")
        if rdt == torch.float64:  # for phase 11 (b)
            SHARED["5b"] = calc.uscat(torch.zeros(3, 1, dtype=rdt, device=dev)).reshape(-1) \
                .cpu().numpy()
        del calc, ref
        split(label, rdt, N_END_LU,
              (scaled if rdt == torch.float32 else plain) + [(torch.linalg, "solve", "LU")])

    # (c) the bench configuration on the dense GMRES route
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    calc = solve(torch.float32, N_END, solver="gmres")
    u0 = calc.uscat(torch.zeros(3, 1, device=dev))[0].cpu().numpy()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_sys = nb * N_END * N_END
    print(f"[5] (c) bench lattice n_end={N_END} ({n_sys} unknowns), solver='gmres', dense "
          f"matrix {calc.matrix.numel() * 8 / 1e9:.2f} GB: {dt:.3f} s for {KB} k, launches "
          f"{launches}, peak device memory {peak:.3f} GiB ({card})")
    require_launched(launches, ("dense_assemble", "spherical_jh", "coax_fold",
                                "fused_ba_eval_few"), "[5] (c) the dense route")
    worst = float(calc.relres.max())
    print(f"[5] (c) GMRES iters {calc.iters.tolist()}, max relres {worst:.3e}")
    if not bool(torch.isfinite(calc.density).all()) or worst > 3e-5:
        raise RuntimeError(f"(c) relres {worst:.3e} > 3e-5 or non-finite density")
    with open(os.path.join(ROOT, "biem_helmholtz_sphere_tpu_torch", "data",
                           "bench_golden_f64.json")) as fh:
        golden = json.load(fh)["points"]
    for i, g in enumerate(golden[:KB]):
        ref = complex(*g["uscat0"])
        err = abs(u0[i] - ref) / abs(ref)
        print(f"[5] (c) k={ks[i]:.6f} uscat(0) = {u0[i]:.6f} golden {ref:.6f} rel err {err:.2e}")
        if abs(g["k"] - float(ks[i])) > 1e-6 or err > 1e-3:
            raise RuntimeError(f"(c) uscat(0) at k={ks[i]} off the JAX f64 golden by {err:.2e}")
    res_max, res_mean = bc_residual(torch, calc)
    print(f"[5] (c) BC residual max {res_max:.3e} mean {res_mean:.3e}")
    if not res_max <= 1e-3:
        raise RuntimeError(f"(c) BC residual {res_max:.3e} > 1e-3")
    f = dict(dtype=torch.float32, device=dev)
    again = _core._assemble(
        c, N_END, centers_np, torch.ones(KB, nb, **f), torch.as_tensor(ks, **f),
        torch.ones(KB, **f), torch.ones(KB, nb, dtype=torch.complex64, device=dev),
        torch.zeros(KB, nb, dtype=torch.complex64, device=dev), stable=True, pair_major=True)
    same = torch.equal(again, calc.matrix.transpose(2, 3))
    print(f"[5] (c) the assembled matrix repeats bit for bit: {same}")
    if not same:
        raise RuntimeError("(c) the dense matrix differs between two assemblies")
    # one dense GMRES matvec (cuBLAS through torch.matmul): it reads the
    # matrix once, so its bound is the matrix's bytes over 3.35 TB/s
    mv, _ = _core._pairs_operator(again)
    x = calc.density.reshape(KB, -1)
    ms = cuda_ms(torch, lambda: mv(x), 10)
    print(f"[5] (c) one pair-major matvec (torch.matmul, then a sum over b'): {ms:.4f} ms, "
          f"bound {again.numel() * 8 / HBM_BYTES_PER_S * 1e3:.6f} ms (bytes) ({card})")
    del again, calc, mv, x
    torch.cuda.empty_cache()
    split("(c) complex64 dense GMRES", torch.float32, N_END,
          scaled + [(_core, "gmres_solve_op", "GMRES")], solver="gmres")
    return launches

def ball_degree_rel_err(torch, got, ref, n_root):
    """Max over (k, sphere, degree l) blocks of |got - ref| relative to the
    block's largest |ref|; got, ref [K, B*H].  A matvec's entries fall like
    (rho/t)^l: a norm over the whole vector would hide a wrong high-degree
    block."""
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("output is not finite")
    n_l = int(n_root.max()) + 1
    h = len(n_root)
    d, r = ((x.abs().reshape(-1, h)) for x in (got - ref, ref))
    g = torch.as_tensor(n_root, dtype=torch.long, device=got.device).expand_as(d)
    dm = d.new_zeros(d.shape[0], n_l).scatter_reduce(1, g, d, "amax")
    rm = r.new_zeros(d.shape[0], n_l).scatter_reduce(1, g, r, "amax")
    return float((dm / rm.clamp_min(torch.finfo(rm.dtype).tiny)).max())


def stage_bounds(torch, c, centers_np, card, iters):
    """Bounds of the stages that run plain PyTorch or library calls, from
    the shapes this run gives them: the sandwich (two degree-group
    products per offset), LU (8/3 n^3 real operations per system), K3 (D by
    quadrature: the per-group contraction and the harmonics at the rotated
    points) and K6 (a CGS2 Krylov step reads the basis's rows so far once,
    w and diag, and writes the next row; two passes of a projection and
    an update), for `iters` {label: (steps, dtype name)} Krylov steps per
    4-k block."""
    from biem_helmholtz_sphere_tpu_torch.biem._core import _offsets, _pair_routing
    from biem_helmholtz_sphere_tpu_torch.translation._rotation import (
        _degree_groups, _rot_tables)

    n_off = len(_offsets(centers_np)[0])
    nb, h = len(centers_np), N_END * N_END
    g2 = sum((e - s) ** 2 for s, e in _degree_groups(c, N_END))  # D's entries
    for name, cs in (("complex64", 8), ("complex128", 16)):
        b = bound(2 * KB * n_off * h * h * cs + n_off * g2 * cs, 0, name,
                  mma_flops=16 * KB * n_off * h * g2)
        print(f"[6] bound: sandwich {KB} k x {n_off} offsets n_end {N_END} {name}: "
              f"{b[0]:.6f} ms ({b[1]})")
        n = nb * N_END_LU * N_END_LU
        b = bound(2 * KB * n * n * cs, 0, name, mma_flops=KB * 8 / 3 * n ** 3)
        print(f"[6] bound: LU {KB} systems of {n} {name}: {b[0]:.6f} ms ({b[1]})")
    q = len(_rot_tables(c, N_END)[0])
    for label, n_d in (("dense / offset-table route", n_off),
                       ("factored route's slots", len(_pair_routing(centers_np).uniq))):
        b = bound(n_d * g2 * 8 + q * h * 8, n_d * q * (8 * g2 + 16 * h), "complex64")
        print(f"[6] bound: K3 rotation_blocks {n_d} directions ({label}), {q} nodes, "
              f"n_end {N_END} complex64: {b[0]:.6f} ms ({b[1]})")
    n = KB * nb * N_END * N_END
    for label, (m, name) in iters.items():
        cs = 8 if name == "complex64" else 16
        b = bound((m * (m + 1) // 2 + 3 * m) * n * cs, 16 * m * (m + 1) * n, name)
        print(f"[6] bound: K6 GMRES {m} CGS2 steps on {KB} x {n // KB} unknowns ({label}, "
              f"{name}): {b[0]:.6f} ms ({b[1]}) ({card})")


def matfree_route(torch, dev, card):
    """Phase 6: the offset-table matrix-free route and the quadrature
    right-hand side on the 4x4 lattice at n_end=32, the first k-block of
    the sweep; returns the launch counts of its run (a)."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave, point_source
    from biem_helmholtz_sphere_tpu_torch.biem import _core
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics._expand import _quad_harmonics
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
    from biem_helmholtz_sphere_tpu_torch.special import shn1
    from biem_helmholtz_sphere_tpu_torch.special._family import (
        _spherical_jh_all_plain, spherical_jh)
    from biem_helmholtz_sphere_tpu_torch.translation import _rotation

    reset, read = kernel_counts()

    c = create_from_branching_types("ba")
    centers_np = lattice_centers()
    nb = len(centers_np)
    ks = sweep_ks()[:KB]
    n_sys = nb * N_END * N_END
    n_root = basis(c, N_END).n_root
    with open(os.path.join(ROOT, "biem_helmholtz_sphere_tpu_torch", "data",
                           "bench_golden_f64.json")) as fh:
        golden = json.load(fh)["points"][:KB]

    def solve(rdt, field="plane"):
        f = dict(dtype=rdt, device=dev)
        kt = torch.as_tensor(ks, **f)
        if field == "point":
            uin, _ = point_source(k=kt, source=torch.tensor(SOURCE, **f)[:, None].expand(3, KB))
        else:
            uin, _ = plane_wave(k=kt, direction=torch.tensor([1.0, 0.0, 0.0], **f)[:, None]
                                .expand(3, KB))
            if field == "stripped":
                uin = (lambda u: lambda x: u(x))(uin)  # no plane-wave tag: the quadrature
        return biem(c, centers=torch.as_tensor(centers_np, **f).expand(KB, nb, 3),
                    radii=torch.ones(KB, nb, **f), k=kt, n_end=N_END, uin=uin)

    def uscat0(calc):
        return calc.uscat(torch.zeros(3, 1, dtype=calc.radii.dtype, device=dev))[0]

    def split(label, rdt, field, stages, nested=()):
        def run():
            uscat0(solve(rdt, field))
        stages = stages + [(_core.BIEMResultCalculator, "uscat", "uscat(0)")]
        acc, total = split_stages(torch, run, stages)
        labels = [s[2] for s in stages]
        if nested:  # GMRES's timer holds its matvecs' stages: keep the rest
            acc["GMRES (rest)"] = acc.pop("GMRES") - sum(acc.get(n, 0.0) for n in nested)
            labels[labels.index("GMRES")] = "GMRES (rest)"
        print(f"[6] {label} stage split, s per k-block of {KB} (synchronising timers): "
              f"{format_split(acc, total, labels, 1)} ({card})")

    # (a) the float64 bench on its default route: the offset table, unscaled
    route = _core._route("auto", nb, n_sys, torch.float64, dev, True, False, centers_np)
    if route != "matfree":
        raise RuntimeError(f"(a) auto picks {route!r} for the float64 bench lattice")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    calc = solve(torch.float64)
    u0 = uscat0(calc)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[6] (a) bench lattice n_end={N_END} ({n_sys} unknowns), complex128, default "
          f"solver and stable -> {route!r}: {dt:.3f} s for {KB} k, launches {launches}, "
          f"peak device memory {peak:.3f} GiB ({card})")
    if calc.matrix is not None or calc.relres is None:
        raise RuntimeError("(a) the default route formed the matrix or did not iterate")
    for name in ("lane_gather", "lane_scatter", "spherical_jh", "coax_fold", "arnoldi_step",
                 "gmres_backsolve"):
        if launches[name] <= 0:
            raise RuntimeError(f"(a) the offset-table route never launched {name}")
    if launches["block_diag_cmm"] != 0:
        raise RuntimeError("(a) the default float64 route took the factored operator")
    worst = float(calc.relres.max())
    print(f"[6] (a) GMRES iters {calc.iters.tolist()}, max relres {worst:.3e}")
    if not bool(torch.isfinite(calc.density).all()) or worst > 1e-11:
        raise RuntimeError(f"(a) relres {worst:.3e} > 1e-11 or non-finite density")
    u0 = u0.cpu().numpy()
    SHARED["6a"] = u0  # for phase 11 (a)
    for i, g in enumerate(golden):
        ref = complex(*g["uscat0"])
        err = abs(u0[i] - ref) / abs(ref)
        print(f"[6] (a) k={ks[i]:.6f} uscat(0) = {u0[i]:.12f} golden {ref:.12f} rel err "
              f"{err:.3e}")
        if abs(g["k"] - float(ks[i])) > 1e-6 or not err <= 1e-7:
            raise RuntimeError(f"(a) uscat(0) at k={ks[i]} off the JAX f64 golden by {err:.2e}")
    res_max, res_mean = bc_residual(torch, calc)
    print(f"[6] (a) BC residual max {res_max:.3e} mean {res_mean:.3e}")
    if not res_max <= 1e-3:
        raise RuntimeError(f"(a) BC residual {res_max:.3e} > 1e-3")
    iters_a = int(calc.iters.max())
    del calc
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uscat0(solve(torch.float64))
    torch.cuda.synchronize()
    print(f"[6] (a) again, warm: {time.perf_counter() - t0:.3f} s for {KB} k (the first solve "
          f"above also paid the route's first complex128 calls) ({card})")
    torch.cuda.empty_cache()
    split("(a) complex128 offset-table GMRES", torch.float64, "plane",
          [(_core, "_rhs_dispatch", "RHS"), (_core, "_radial_rows", "radial rows"),
           (_rotation, "coaxial_sr", "coax (K5 + K2)"), (_rotation, "_sandwich", "sandwich"),
           (_core, "gmres_solve_op", "GMRES"),
           (_core, "_table_product", "table product (pad, bmm, unpad)"),
           (_core, "lane_gather", "KC gather"), (_core, "lane_scatter", "KC scatter")],
          nested=("table product (pad, bmm, unpad)", "KC gather", "KC scatter"))

    # (b) one matvec of the offset table against the factored operator's
    f = dict(dtype=torch.float64, device=dev)
    args = (c, N_END, centers_np, torch.ones(KB, nb, **f), torch.as_tensor(ks, **f),
            torch.ones(KB, **f), torch.ones(KB, nb, dtype=torch.complex128, device=dev),
            torch.zeros(KB, nb, dtype=torch.complex128, device=dev))
    tables = []
    mv_t, _ = _core._matfree_operator(*args, sr_map=lambda s: tables.append(s) or s)
    mv_f, _ = _core._matfree_operator(*args, stable=True)
    x = randc(torch, np.random.default_rng(61), (KB, n_sys), torch.complex128, dev)
    err = ball_degree_rel_err(torch, mv_t(x), mv_f(x), n_root)
    table = tables[0]
    routing = _core._pair_routing(centers_np, radius_slots=False)
    n_off, n_lanes, lps = table.shape[1], len(routing.lane), 2 * routing.p_max
    ms, ms_f = cuda_ms(torch, lambda: mv_t(x), 20), cuda_ms(torch, lambda: mv_f(x), 20)
    vec = 5 * KB * n_sys * 16  # x, the row, column and diagonal factors in, out
    b = bound(table.numel() * 16 + vec, 0, "complex128", mma_flops=8 * KB * n_lanes * N_END ** 4)
    print(f"[6] (b) one matvec, offset table (stable=False) against factored (stable=True), "
          f"complex128: max rel err per (k, sphere, degree) block {err:.3e}; offset-table "
          f"{ms:.4f} ms (bound {b[0]:.6f} ms, {b[1]}: the {table.numel() * 16 / 1e9:.3f} GB "
          f"table), factored {ms_f:.4f} ms ({card})")
    if not err <= 1e-10:
        raise RuntimeError(f"(b) the offset-table matvec is off the factored one by {err:.3e}")
    # the table product alone, and its pad and unpad copies
    lane = torch.as_tensor(routing.lane, device=dev)
    lanes = randc(torch, np.random.default_rng(62), (KB, n_lanes, N_END * N_END),
                  torch.complex128, dev)
    padded = torch.zeros((KB, n_off * lps, N_END * N_END), dtype=torch.complex128,
                         device=dev)
    sr_t = table.reshape(KB * n_off, N_END * N_END, N_END * N_END).transpose(1, 2)
    ms_pad = cuda_ms(torch, lambda: padded.index_copy_(1, lane, lanes), 20)
    ms_bmm = cuda_ms(torch, lambda: torch.bmm(padded.view(KB * n_off, lps, -1), sr_t), 20)
    y_pad = torch.bmm(padded.view(KB * n_off, lps, -1), sr_t).view(KB, n_off * lps, -1)
    ms_unpad = cuda_ms(torch, lambda: y_pad.index_select(1, lane), 20)
    b_bmm = bound(table.numel() * 16 + 2 * padded.numel() * 16, 0, "complex128",
                  mma_flops=8 * KB * n_lanes * N_END ** 4)
    b_copy = bound(2 * lanes.numel() * 16, 0, "complex128")
    print(f"[6] (b) table product (torch.bmm, {KB} x {n_off} offsets, {n_lanes} of "
          f"{n_off * lps} padded lanes): {ms_bmm:.4f} ms, bound {b_bmm[0]:.6f} ms ({b_bmm[1]}); "
          f"pad (index_copy_) {ms_pad:.4f} ms, unpad (index_select) {ms_unpad:.4f} ms, "
          f"bound {b_copy[0]:.6f} ms each ({card})")
    del tables, table, sr_t, mv_t, mv_f, padded, y_pad
    torch.cuda.empty_cache()

    # (c) a point source in complex64 on its default route (the factored
    # GMRES), its right-hand side by quadrature through K5
    rhs_k5 = []
    expansion = _core._rhs_expansion

    def counted(*a, **kw):
        n0 = spherical_jh.launches
        out = expansion(*a, **kw)
        rhs_k5.append(spherical_jh.launches - n0)
        return out

    torch.cuda.synchronize()
    reset()
    _core._rhs_expansion = counted
    try:
        t0 = time.perf_counter()
        calc = solve(torch.float32, "point")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        _core._rhs_expansion = expansion
    counts = read()
    worst = float(calc.relres.max())
    res_max, res_mean = bc_residual(torch, calc)
    q = _quad_harmonics(c, N_END, 2 * N_END - 1, torch.float32, dev)[1].shape[0]
    print(f"[6] (c) point source at {SOURCE}, complex64, default route: {dt:.3f} s for {KB} "
          f"k, K5 launches in the RHS {rhs_k5} ({q} x {nb} x {KB} points), launches {counts}, "
          f"GMRES iters {calc.iters.tolist()}, max relres {worst:.3e}, BC residual max "
          f"{res_max:.3e} mean {res_mean:.3e} ({card})")
    if rhs_k5 != [1] or counts["block_diag_cmm"] <= 0:
        raise RuntimeError("(c) the point source's RHS or the factored route skipped a kernel")
    if not bool(torch.isfinite(calc.density).all()) or worst > 3e-5:
        raise RuntimeError(f"(c) relres {worst:.3e} > 3e-5 or non-finite density")
    if not res_max <= 1e-3:
        raise RuntimeError(f"(c) BC residual {res_max:.3e} > 1e-3")
    iters_c = int(calc.iters.max())
    split("(c) complex64 point source, factored GMRES", torch.float32, "point",
          [(_core, "_rhs_dispatch", "RHS"), (_core, "_radial_rows_scaled", "radial rows"),
           (_core, "coax_fold_packed", "coax (K5 + K2)"), (_core, "gmres_solve_op", "GMRES")])
    # the RHS's K5 launch and its projection alone, at (c)'s shapes
    xhat, wy = _quad_harmonics(c, N_END, 2 * N_END - 1, torch.float32, dev)
    cen = torch.as_tensor(centers_np, dtype=torch.float32, device=dev)
    xq = xhat[:, :, None] + cen.T[:, None, :]  # [3, Q, B], unit spheres
    kt = torch.as_tensor(ks, dtype=torch.float32, device=dev)
    src = torch.tensor(SOURCE, dtype=torch.float32, device=dev)
    z = (kt * torch.linalg.vector_norm(xq - src[:, None, None], dim=0)[..., None]).to(
        torch.complex64)
    ea, er = unscaled_err(torch, shn1(0, 3, z), _spherical_jh_all_plain(3, 1, z)[2][..., 0])
    ms_k5 = cuda_ms(torch, lambda: shn1(0, 3, z), 20)
    pms_k5 = cuda_ms(torch, lambda: _spherical_jh_all_plain(3, 1, z), 5)
    b_k5 = bound(z.numel() * (8 + 4 * 8), z.numel() * (15 * 39 + 40), "complex64")
    vals = randc(torch, np.random.default_rng(63), (q, nb * KB), torch.complex64, dev)
    ms_q = cuda_ms(torch, lambda: torch.matmul(vals.T, wy), 20)
    b_q = bound((vals.numel() + wy.numel() + nb * KB * wy.shape[1]) * 8,
                8 * vals.numel() * wy.shape[1], "complex64")
    print(f"[6] (c) point-source K5 (unscaled, 1 order) at {z.numel()} points: max_abs_err "
          f"{ea:.3e} max_rel_err {er:.3e} kernel {ms_k5:.4f} ms plain {pms_k5:.4f} ms bound "
          f"{b_k5[0]:.6f} ms ({b_k5[1]}); quadrature projection (torch.matmul [{nb * KB}, {q}] "
          f"x [{q}, {wy.shape[1]}]) {ms_q:.4f} ms bound {b_q[0]:.6f} ms ({b_q[1]}) ({card})")
    if er > TOL_REL["complex64"]:
        raise RuntimeError(f"(c) point-source K5: rel err {er:.3e}")
    del calc
    torch.cuda.empty_cache()

    # (d) the bench plane wave with its tags stripped: the quadrature RHS
    calc = solve(torch.float64, "stripped")
    u0q = uscat0(calc).cpu().numpy()
    err = float(np.max(np.abs(u0q - u0) / np.abs(u0)))
    worst = float(calc.relres.max())
    print(f"[6] (d) complex128 plane wave by quadrature: uscat(0) against (a)'s closed form "
          f"max rel diff {err:.3e}, max relres {worst:.3e}")
    if not err <= 1e-8 or worst > 1e-11:
        raise RuntimeError(f"(d) quadrature RHS off the closed form by {err:.3e}")
    del calc
    torch.cuda.empty_cache()
    stage_bounds(torch, c, centers_np, card,
                 {"(a) offset table": (iters_a, "complex128"),
                  "(c) factored": (iters_c, "complex64")})
    return launches


def kernel_counts():
    """(reset, read) of every kernel's launch count."""
    from biem_helmholtz_sphere_tpu_torch.biem._eval_fused import fused_ba_eval
    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import band_f, band_sr
    from biem_helmholtz_sphere_tpu_torch.ops.block_diag import block_diag_cmm
    from biem_helmholtz_sphere_tpu_torch.ops.dense import dense_assemble
    from biem_helmholtz_sphere_tpu_torch.ops.graf import graf_fold
    from biem_helmholtz_sphere_tpu_torch.ops.lane_route import lane_gather, lane_scatter
    from biem_helmholtz_sphere_tpu_torch.special._family import spherical_jh
    from biem_helmholtz_sphere_tpu_torch.translation._scaled import coax_fold
    from biem_helmholtz_sphere_tpu_torch.ops.harmonic_eval import harmonic_eval
    from biem_helmholtz_sphere_tpu_torch.translation._rotation import rotation_blocks
    from biem_helmholtz_sphere_tpu_torch.ops.coax_u import coax_u
    from biem_helmholtz_sphere_tpu_torch.ops.gmres_step import arnoldi_step, backsolve
    from biem_helmholtz_sphere_tpu_torch.ops.plane_rhs import plane_wave_rhs

    counters = {"fused_ba_eval": (fused_ba_eval, "launches"),
                "fused_ba_eval_few": (fused_ba_eval, "few_launches"),
                "block_diag_cmm": (block_diag_cmm, "launches"),
                "block_diag_cmm_panels": (block_diag_cmm, "panel_launches"),
                "lane_gather": (lane_gather, "launches"),
                "lane_scatter": (lane_scatter, "launches"),
                "spherical_jh": (spherical_jh, "launches"),
                "coax_fold": (coax_fold, "launches"),
                "dense_assemble": (dense_assemble, "launches"),
                "graf_fold": (graf_fold, "launches"),
                "band_sr": (band_sr, "launches"),
                "band_f": (band_f, "launches"),
                "harmonic_eval": (harmonic_eval, "launches"),
                "rotation_blocks": (rotation_blocks, "launches"),
                "coax_u": (coax_u, "launches"),
                "arnoldi_step": (arnoldi_step, "launches"),
                "gmres_backsolve": (backsolve, "launches"),
                "plane_wave_rhs": (plane_wave_rhs, "launches")}

    def reset():
        for obj, attr in counters.values():
            setattr(obj, attr, 0)

    def read():
        return {name: getattr(obj, attr) for name, (obj, attr) in counters.items()}

    return reset, read


def gmres_counts():
    """The GMRES loop's counts: host reads of the flag word, Arnoldi steps
    launched and run (`ops/gmres.py::gmres_solve_op`)."""
    from biem_helmholtz_sphere_tpu_torch.ops.gmres import gmres_solve_op

    return {k: getattr(gmres_solve_op, k) for k in ("host_reads", "steps_issued", "steps_run")}


def no_host_sync(torch, module, run, label):
    """run() with `module.gmres_solve_op` under torch.cuda.set_sync_debug_mode
    ("error"): a solve (its matvecs, K6's steps and back-substitution, the
    reads of the flag word through a pinned buffer and an event) that
    waits on the card raises.  Requires K6 launched."""
    from biem_helmholtz_sphere_tpu_torch.ops.gmres_step import arnoldi_step

    solve = module.gmres_solve_op

    def guarded(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return solve(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    n0 = arnoldi_step.launches
    module.gmres_solve_op = guarded
    try:
        run()
    finally:
        module.gmres_solve_op = solve
    torch.cuda.synchronize()
    if arnoldi_step.launches == n0:
        raise RuntimeError(f"{label}: K6 never launched")
    print(f"{label}: the GMRES solve ran under torch.cuda.set_sync_debug_mode('error'): no "
          f"host sync between the reads of the flag word")


def require_launched(counts, names, label):
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise RuntimeError(f"{label}: the path never launched {missing}: {counts}")


def clear_coax_caches():
    """Forget every coax table (host index vectors and plan, root tables,
    KU's U): the next 'b'/'bp'-rooted block in d >= 3 builds them cold."""
    from biem_helmholtz_sphere_tpu_torch.harmonics import _index
    from biem_helmholtz_sphere_tpu_torch.translation import _rotation, _scaled

    for fn in (_rotation._coax_index, _rotation._coax_tables_on, _rotation._coax_tables,
               _scaled._coax_plan_on, _scaled._coax_packed_on, _scaled._child_state_blocks,
               _index._child_states):
        fn.cache_clear()


def complex_and_trees(torch, dev, card):
    """Phase 7: complex k, the 'bpa' tree with the general evaluation, and
    geometry along the batch, each path driven through biem() with the
    launch counts set to 0 just before it and read just after.  Returns
    KE's launches in (c)'s field evaluation."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.biem import _core
    from biem_helmholtz_sphere_tpu_torch.biem._eval_fused import (
        _fused_ba_eval_plain, fused_ba_eval, regroup)
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.ops.dense import _dense_assemble_plain, dense_assemble

    reset, read = kernel_counts()
    c, c_bp = create_from_branching_types("ba"), create_from_branching_types("bpa")
    centers_np = lattice_centers()
    nb = len(centers_np)
    n_sys = nb * N_END * N_END
    ks = sweep_ks()[:KB]
    data = os.path.join(ROOT, "biem_helmholtz_sphere_tpu_torch", "data")
    with open(os.path.join(data, "bench_golden_complexk_f64.json")) as fh:
        golden_ck = json.load(fh)["points"][:KB]
    with open(os.path.join(data, "bench_golden_f64.json")) as fh:
        golden = json.load(fh)["points"][:KB]

    def solve(tree, rdt, kvals, centers=centers_np, n_end=N_END, **kw):
        f = dict(dtype=rdt, device=dev)
        cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
        kt = torch.as_tensor(kvals, dtype=cdt if np.iscomplexobj(kvals) else rdt, device=dev)
        n_k = kt.numel()
        cen = torch.as_tensor(centers, **f)
        cen = cen.expand(n_k, nb, 3) if cen.ndim == 2 else cen
        uin, _ = plane_wave(k=kt, direction=torch.tensor([1.0, 0.0, 0.0], **f)[:, None]
                            .expand(3, n_k))
        return biem(tree, centers=cen, radii=torch.ones(n_k, nb, **f), k=kt, n_end=n_end,
                    uin=uin, **kw)

    def uscat0(calc):
        return calc.uscat(torch.zeros(3, 1, dtype=calc.radii.dtype, device=dev))[0]

    def against_golden(label, u0, points, tol):
        for i, g in enumerate(points):
            ref = complex(*g["uscat0"])
            err = abs(complex(u0[i]) - ref) / abs(ref)
            print(f"[7] {label} k={ks[i]:.6f}{IMAG_K if points is golden_ck else 0:+g}j "
                  f"uscat(0) = {complex(u0[i]):.9f} golden {ref:.9f} rel err {err:.3e}")
            g_k = g["k"][0] if isinstance(g["k"], list) else g["k"]
            if abs(g_k - float(ks[i])) > 1e-6 or not err <= tol:
                raise RuntimeError(f"{label}: uscat(0) at k={ks[i]} off the golden by {err:.2e}")

    # (a) complex k at the bench, complex64, auto: the factored GMRES
    k_c64 = ks.astype(np.complex64) + np.complex64(1j * IMAG_K)
    route = _core._route("auto", nb, n_sys, torch.float32, dev, True, False, centers_np)
    if route != "matfree":
        raise RuntimeError(f"(a) auto picks {route!r} for the complex64 bench")
    solve(c, torch.float32, k_c64 - 0.5)  # warm-up: caches and the first complex calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    calc = solve(c, torch.float32, k_c64)
    u0 = uscat0(calc).cpu().numpy()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    worst = float(calc.relres.max())
    res_max, res_mean = bc_residual(torch, calc)
    print(f"[7] (a) bench lattice, k = sweep + {IMAG_K}j, complex64, auto -> factored GMRES: "
          f"{dt:.3f} s for {KB} k, launches {counts}, GMRES iters {calc.iters.tolist()}, max "
          f"relres {worst:.3e}, BC residual max {res_max:.3e} mean {res_mean:.3e}, peak device "
          f"memory {peak:.3f} GiB ({card})")
    require_launched(counts, ("block_diag_cmm", "lane_gather", "lane_scatter", "spherical_jh",
                              "coax_fold", "fused_ba_eval_few"), "(a)")
    if not bool(torch.isfinite(calc.density).all()) or worst > 3e-5 or not res_max <= 1e-3:
        raise RuntimeError(f"(a) relres {worst:.3e} or BC residual {res_max:.3e} off its gate")
    against_golden("(a)", u0, golden_ck, 1e-3)
    again = solve(c, torch.float32, k_c64)
    same = torch.equal(torch.view_as_real(again.density), torch.view_as_real(calc.density)) and \
        np.array_equal(uscat0(again).cpu().numpy(), u0)
    print(f"[7] (a) repeated solve bit-for-bit equal: {same}")
    if not same:
        raise RuntimeError("(a) the repeated complex-k solve differs")
    del again
    stages = [(_core, "_rhs_dispatch", "RHS"), (_core, "_radial_rows_scaled", "radial rows"),
              (_core, "coax_fold_packed", "K2 (with its K5)"), (_core, "gmres_solve_op", "solve"),
              (_core.BIEMResultCalculator, "uscat", "uscat(0)")]
    acc, total = split_stages(torch, lambda: uscat0(solve(c, torch.float32, k_c64)), stages)
    print(f"[7] (a) stage split, s per k (synchronising timers, {KB} k): "
          f"{format_split(acc, total, [label for _, _, label in stages], KB)} ({card})")
    # KA's many-point mode with a complex k, on (a)'s first density
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(3, EVAL_POINTS)) * 20.0, **f32)
    cen = torch.as_tensor(centers_np, **f32)
    from biem_helmholtz_sphere_tpu_torch.biem._layer import blc
    k1 = calc.k.reshape(-1)[:1].contiguous()
    w2 = regroup(c, N_END, calc.density.reshape(KB, nb, -1)[:1]
                 * blc(c, N_END, k1[:, None], torch.ones(1, nb, **f32),
                       torch.ones(1, 1, **f32)))
    outside = (torch.linalg.vector_norm(x[:, :, None] - cen.T[:, None, :], dim=0) > 1.0).all(-1)
    xk = x[:, None, :]
    got = fused_ba_eval(xk, cen, k1, w2)
    ea, er = rel_err(torch, got[outside], _fused_ba_eval_plain(xk, cen, k1, w2, False, False)[
        outside])
    if not same_bits(torch, fused_ba_eval(xk, cen, k1, w2), got):
        raise RuntimeError("(a) KA with a complex k: two launches differ")
    ms = cuda_ms(torch, lambda: fused_ba_eval(xk, cen, k1, w2), 10)
    pms = cuda_ms(torch, lambda: _fused_ba_eval_plain(xk, cen, k1, w2, False, False), 3)
    n_m = 2 * N_END - 1
    b = bound(3 * EVAL_POINTS * 4 + 4 * nb * 4 + w2.numel() * 8 + EVAL_POINTS * 8,
              EVAL_POINTS * nb * (30 + 30 * N_END + 13 * N_END * N_END + 10 * n_m), "complex64")
    print(f"[7] (a) fused_ba_eval many-point, complex k, {EVAL_POINTS} pts x 1 k complex64: "
          f"max_abs_err {ea:.3e} max_rel_err {er:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms "
          f"bound {b[0]:.6f} ms ({b[1]}) ({card})")
    if er > TOL_REL["complex64"]:
        raise RuntimeError(f"(a) KA with a complex k: rel err {er:.3e}")
    # and its few-point mode as uscat(0) runs it: 1 point x 4 complex k
    ka = calc.k.reshape(-1).contiguous()
    w2f = regroup(c, N_END, calc.density.reshape(KB, nb, -1)
                  * blc(c, N_END, ka[:, None], torch.ones(KB, nb, **f32), torch.ones(KB, 1, **f32)))
    zero = torch.zeros((3, 1, 1), **f32)
    got = fused_ba_eval(zero, cen, ka, w2f)
    ea, er = rel_err(torch, got, _fused_ba_eval_plain(zero, cen, ka, w2f, False, False))
    if not same_bits(torch, fused_ba_eval(zero, cen, ka, w2f), got) or er > TOL_REL["complex64"]:
        raise RuntimeError(f"(a) KA few-point with a complex k: rel err {er:.3e} or a repeat differs")
    ms = cuda_ms(torch, lambda: fused_ba_eval(zero, cen, ka, w2f), 20)
    pms = cuda_ms(torch, lambda: _fused_ba_eval_plain(zero, cen, ka, w2f, False, False), 5)
    b = bound(3 * 4 + 4 * nb * 4 + w2f.numel() * 8 + KB * 8,
              KB * nb * (30 + 30 * N_END + 13 * N_END * N_END + 10 * n_m), "complex64")
    print(f"[7] (a) fused_ba_eval few-point, complex k, 1 pt x {KB} k complex64: max_abs_err "
          f"{ea:.3e} max_rel_err {er:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms bound "
          f"{b[0]:.6f} ms ({b[1]}) ({card})")
    del calc
    torch.cuda.empty_cache()

    # (b) complex128 on its default route: the offset table, stable=False
    k_c128 = ks.astype(np.float64) + 1j * IMAG_K
    route = _core._route("auto", nb, n_sys, torch.float64, dev, True, False, centers_np)
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    calc = solve(c, torch.float64, k_c128)
    u0 = uscat0(calc).cpu().numpy()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read()
    worst = float(calc.relres.max())
    print(f"[7] (b) the same in complex128, auto -> {route!r} (offset table): {dt:.3f} s for "
          f"{KB} k, launches {counts}, GMRES iters {calc.iters.tolist()}, max relres "
          f"{worst:.3e} ({card})")
    require_launched(counts, ("lane_gather", "lane_scatter", "spherical_jh", "coax_fold",
                              "fused_ba_eval_few"), "(b)")
    if route != "matfree" or counts["block_diag_cmm"] != 0:
        raise RuntimeError("(b) the complex128 default route is not the offset table")
    if not bool(torch.isfinite(calc.density).all()) or worst > 1e-11:
        raise RuntimeError(f"(b) relres {worst:.3e} > 1e-11")
    against_golden("(b)", u0, golden_ck, 1e-7)
    del calc
    torch.cuda.empty_cache()

    # (c) 'bpa' at the bench, complex64, auto (factored), two k-blocks with
    # a warm start, then the general evaluation at EVAL_POINTS points
    ks8 = sweep_ks()[: 2 * KB]
    solve(c_bp, torch.float32, ks8[:KB] - 0.5)  # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    dens, runs = None, []
    for i0 in range(0, 2 * KB, KB):
        calc = solve(c_bp, torch.float32, ks8[i0 : i0 + KB], density0=dens)
        dens = calc.density[KB - 1]
        runs.append((calc, uscat0(calc).cpu().numpy()))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read()
    worst = max(float(r[0].relres.max()) for r in runs)
    res_max, res_mean = bc_residual(torch, runs[0][0])
    print(f"[7] (c) 'bpa' bench lattice, complex64, auto -> factored GMRES, 2 blocks of {KB} k "
          f"(warm starts): {dt:.3f} s, launches {counts}, GMRES iters "
          f"{[r[0].iters.tolist() for r in runs]}, max relres {worst:.3e}, BC residual max "
          f"{res_max:.3e} mean {res_mean:.3e} ({card})")
    require_launched(counts, ("block_diag_cmm", "lane_gather", "lane_scatter", "spherical_jh",
                              "coax_fold", "harmonic_eval"), "(c)")
    if counts["fused_ba_eval"] or counts["fused_ba_eval_few"]:
        raise RuntimeError("(c) the 'bpa' evaluation launched the 'ba' kernel")
    if worst > 3e-5 or not res_max <= 1e-3:
        raise RuntimeError(f"(c) relres {worst:.3e} or BC residual {res_max:.3e} off its gate")
    against_golden("(c) 'bpa' against the 'ba' golden:", runs[0][1], golden, 1e-3)
    del runs, calc, dens
    torch.cuda.empty_cache()
    calc_bp = solve(c_bp, torch.float32, np.array([K0], np.float32))
    calc_ba = solve(c, torch.float32, np.array([K0], np.float32))
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset()
    u_gen = calc_bp.uscat(x)
    torch.cuda.synchronize()
    counts = read()
    peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
    u_ka = calc_ba.uscat(x)
    keep = outside[:, None]
    diff = float((u_gen - u_ka).abs()[keep].max() / u_ka.abs()[keep].max())
    times = {}
    for label, cc in (("general", calc_bp), ("KA", calc_ba)):
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cc.uscat(x)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        times[label] = best
    h = N_END * N_END
    b = ke_bound(EVAL_POINTS, 1, nb, h, N_END, 3, "complex64")
    print(f"[7] (c) general evaluation ('bpa', KE) at {EVAL_POINTS} points, 1 k: "
          f"{times['general']:.6f} s ({EVAL_POINTS / times['general']:.1f} pts/s), launches "
          f"KE {counts['harmonic_eval']}, K5 {counts['spherical_jh']}, peak device memory "
          f"above its inputs {peak:.3f} GiB; KA ('ba') {times['KA']:.6f} s "
          f"({EVAL_POINTS / times['KA']:.1f} pts/s); rel diff of the two fields outside the "
          f"spheres {diff:.3e}; bound {b[0]:.6f} ms ({b[1]}); the plain torch version "
          f"(PERF.md): 0.375-0.523 s ({card})")
    require_launched(counts, ("spherical_jh", "harmonic_eval"), "(c) general evaluation")
    if counts["fused_ba_eval"] or counts["fused_ba_eval_few"]:
        raise RuntimeError("(c) the 'bpa' field launched the 'ba' kernel")
    if not bool(torch.isfinite(u_gen[keep]).all()) or not diff <= 1e-3:
        raise RuntimeError(f"(c) the general evaluation is off KA's field by {diff:.3e}")
    launches = {"harmonic_eval": counts["harmonic_eval"]}
    del calc_bp, calc_ba, u_gen, u_ka
    torch.cuda.empty_cache()

    # (d) geometry along the batch: four pitches of the 4x4 lattice in one
    # call, n_end = N_END_LU, complex64, k = K0, auto (the LU tier)
    geo = np.stack([lattice_centers(spacing=s) for s in PITCHES])
    n_lu = nb * N_END_LU * N_END_LU
    kk = np.full(len(PITCHES), K0, np.float32)
    route = _core._route("auto", nb, n_lu, torch.float32, dev, True, False, geo)
    if route != "lu":
        raise RuntimeError(f"(d) auto picks {route!r} for geometry along the batch")
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    calc = solve(c, torch.float32, kk, centers=geo, n_end=N_END_LU)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read()
    require_launched(counts, ("dense_assemble", "spherical_jh", "coax_fold"), "(d)")
    if calc.relres is not None or calc.matrix is None:
        raise RuntimeError("(d) geometry along the batch did not take the direct LU")
    errs = []
    for i in range(len(PITCHES)):
        one = solve(c, torch.float32, kk[:1], centers=geo[i], n_end=N_END_LU)
        errs.append(float((calc.density[i] - one.density[0]).abs().max()
                          / one.density[0].abs().max()))
    print(f"[7] (d) {len(PITCHES)} lattices of pitch {PITCHES} in one call, n_end={N_END_LU} "
          f"({n_lu} unknowns each), complex64, auto -> LU: {dt:.3f} s, launches {counts}; each "
          f"against its geometry alone: rel err {[f'{e:.2e}' for e in errs]} ({card})")
    if not max(errs) <= 1e-4:
        raise RuntimeError(f"(d) a member is off its geometry alone by {max(errs):.3e}")
    del calc
    torch.cuda.empty_cache()
    f = dict(dtype=torch.float32, device=dev)
    n4 = len(PITCHES)
    parts = _core._assembly_parts(
        c, N_END_LU, geo, torch.ones(n4, nb, **f), torch.as_tensor(kk, **f), torch.ones(n4, **f),
        torch.ones(n4, nb, dtype=torch.complex64, device=dev),
        torch.zeros(n4, nb, dtype=torch.complex64, device=dev), stable=True)
    got = dense_assemble(*parts)
    if not torch.equal(dense_assemble(*parts), got):
        raise RuntimeError("(d) KD per k: two launches differ")
    same, ea, top = equal_by_k(torch, got, _dense_assemble_plain(*parts, False))
    del got
    ms = cuda_ms(torch, lambda: dense_assemble(*parts), 10)
    pms = cuda_ms(torch, lambda: _dense_assemble_plain(*parts, False), 3)
    table, h_kd = parts[0], parts[0].shape[-1]
    b = bound(n4 * nb * nb * h_kd * h_kd * 8 + table.numel() * 8 + 3 * n4 * nb * h_kd * 8
              + h_kd * 4 + n4 * nb * nb * 12, 12 * n4 * nb * (nb - 1) * h_kd * h_kd, "complex64")
    print(f"[7] (d) dense_assemble with a pair map per k, {n4} k x {nb}x{nb} blocks of "
          f"{h_kd}x{h_kd} from {table.shape[1]} offsets each, complex64: equal to the plain "
          f"version {same}, max_abs_err {ea:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms bound "
          f"{b[0]:.6f} ms ({b[1]}) ({card})")
    if not same:
        raise RuntimeError(f"(d) KD per k differs from its plain version ({ea:.3e})")
    del parts, table
    torch.cuda.empty_cache()
    return launches


def bc_residual_of(torch, calc, centers_np, balls):
    """(max, mean) of |u_in + u_scat| at 64 points just outside each of the
    given spheres (sound-soft: zero on the boundary), in any dimension, for
    each k of the calculator's batch."""
    rng = np.random.default_rng(7)
    d = centers_np.shape[1]
    pts = []
    for b in balls:
        v = rng.normal(size=(d, 64))
        v /= np.linalg.norm(v, axis=0)
        pts.append(centers_np[b][:, None] + 1.0000005 * v)
    xb = torch.as_tensor(np.concatenate(pts, axis=1), dtype=calc.radii.dtype,
                         device=calc.radii.device)
    res = (calc.uin(xb) + calc.uscat(xb)).abs()
    return float(res.max()), float(res.mean())


def four_d(torch, dev, card):
    """Phase 8: trees rooted at a 'b' or 'bp' node in d >= 4 through biem(),
    each path with the launch counts set to 0 just before it and read just
    after.  Returns the launches of (a), the 4D path at full width."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.biem import _core
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
    from biem_helmholtz_sphere_tpu_torch.ops.dense import _dense_assemble_plain, dense_assemble
    from biem_helmholtz_sphere_tpu_torch.translation import _rotation, _scaled

    reset, read = kernel_counts()
    c4, c4p, c5 = (create_from_branching_types(t) for t in ("bba", "bpbpa", "bbba"))
    cube = hypercube_centers()
    nb = len(cube)
    ks = sweep_ks_4d()[:KB]
    with open(os.path.join(ROOT, "biem_helmholtz_sphere_tpu_torch", "data",
                           "bench4d_golden_f64.json")) as fh:
        golden = json.load(fh)["points"][:KB]

    def solve(tree, rdt, kvals, centers, n_end, **kw):
        f = dict(dtype=rdt, device=dev)
        d = tree.c_ndim
        kt = torch.as_tensor(np.asarray(kvals), **f).reshape(-1)
        n_k = kt.numel()
        cen = torch.as_tensor(centers, **f).expand(n_k, len(centers), d)
        direction = torch.zeros(d, n_k, **f)
        direction[0] = 1.0
        uin, _ = plane_wave(k=kt, direction=direction)
        return biem(tree, centers=cen, radii=torch.ones(n_k, len(centers), **f), k=kt,
                    n_end=n_end, uin=uin, **kw)

    def uscat0(calc):
        d = calc.c.c_ndim
        return calc.uscat(torch.zeros(d, 1, dtype=calc.radii.dtype, device=dev))[0]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    # (a) the 4D path at full width: 'bba', the hypercube, n_end=N_END_4D,
    # complex64, auto (the factored GMRES), first block split by stage
    h4 = basis(c4, N_END_4D).num
    n_sys = nb * h4
    route = _core._route("auto", nb, n_sys, torch.float32, dev, True, False, cube)
    if route != "matfree":
        raise RuntimeError(f"(a) auto picks {route!r} for the 4D hypercube")
    stages = [(_core, "_rhs_dispatch", "RHS"), (_core, "_radial_rows_scaled", "radial rows"),
              (_core, "coax_fold_packed", "coax (tables + K5 + K2)"),
              (_scaled, "_coax_packed_on", "of it the tables (KU and host index)"),
              (_scaled, "_coax_plan_on", "of them host index and plan"),
              (_scaled, "_coax_tables_on", "of them root tables on the card"),
              (_scaled, "coax_u", "of them KU"),
              (_scaled, "spherical_h_scaled", "of it K5"),
              (_core, "rotation_d", "D build (K3 and its tables)"),
              (_rotation, "_rot_ycw", "of it tables on the card"),
              (_rotation, "_k3_launch", "of it K3"),
              (_core, "gmres_solve_op", "GMRES"),
              (_core.BIEMResultCalculator, "uscat", "uscat(0)")]
    first = {}

    def first_block():
        first["calc"] = solve(c4, torch.float32, ks, cube, N_END_4D)
        first["u0"] = uscat0(first["calc"])

    # the first block builds D's tables cold on the card (phase 2 cached
    # them): the quadrature, conj(Y) w, the program and K3's plan
    from biem_helmholtz_sphere_tpu_torch.harmonics import _quad
    from biem_helmholtz_sphere_tpu_torch.ops import harmonic_program as _hp

    for fn in (_rotation._rot_tables_on, _rotation._rot_tables, _rotation._rot_ycw,
               _rotation._k3_layout, _rotation._k3_plan, _rotation._k3_jobs,
               _rotation._k3_tables, _hp.program_numpy, _hp.harmonic_program,
               _quad.sphere_quadrature):
        fn.cache_clear()
    clear_coax_caches()  # and the coax tables: host index and plan, root tables, U
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    acc, total = split_stages(torch, first_block, stages)
    calc, u0 = first["calc"], first["u0"]
    counts = read()
    panels = counts.pop("block_diag_cmm_panels")
    peak = torch.cuda.max_memory_allocated() / 2**30
    nested = ("of it tables on the card", "of it K3")  # inside the D build's timer
    d_parts = [acc.pop(n, 0.0) for n in nested]
    # inside the coax timer; K2 is the rest of it (`coax_fold` counts its
    # launches through its module's name, so it is not wrapped)
    coax_nested = ("of it the tables (KU and host index)", "of them host index and plan",
                   "of them root tables on the card", "of them KU", "of it K5")
    c_parts = [acc.pop(n, 0.0) for n in coax_nested]
    c_parts.append(acc.get("coax (tables + K5 + K2)", 0.0) - c_parts[0] - c_parts[4])
    nested += coax_nested
    labels = [label for _, _, label in stages if label not in nested]
    print(f"[8] (a) 'bba' 4D hypercube ({nb} unit spheres, pitch 4), n_end={N_END_4D} (H={h4}, "
          f"{n_sys} unknowns), complex64, auto -> factored GMRES, first block of {KB} k: "
          f"{total:.3f} s; split, s per block (synchronising timers): "
          f"{format_split(acc, total, labels, 1)}; of the coax: the tables {c_parts[0]:.6f} "
          f"(host index and plan {c_parts[1]:.6f}, root tables on the card {c_parts[2]:.6f}, "
          f"KU {c_parts[3]:.6f}), K5 {c_parts[4]:.6f}, K2 and the rest {c_parts[5]:.6f}; of the "
          f"D build: its "
          f"tables on the card {d_parts[0]:.6f}, K3 {d_parts[1]:.6f}; launches "
          f"{counts}, of them KB with row panels {panels}; GMRES iters {calc.iters.tolist()}, "
          f"max relres "
          f"{float(calc.relres.max()):.3e}; peak device memory {peak:.3f} GiB ({card})")
    require_launched(counts, ("block_diag_cmm", "lane_gather", "lane_scatter", "spherical_jh",
                              "coax_fold", "rotation_blocks", "harmonic_eval", "coax_u",
                              "arnoldi_step", "gmres_backsolve"), "(a)")
    if panels <= 0 or panels > counts["block_diag_cmm"]:
        raise RuntimeError(f"(a) KB's row-panel mode launched {panels} times")
    launches = dict(counts, block_diag_cmm_panels=panels)
    del first
    worst = float(calc.relres.max())
    res_max, res_mean = bc_residual_of(torch, calc, cube, (0, 5, 10, 15))
    print(f"[8] (a) BC residual at 256 points on 4 spheres: max {res_max:.3e} mean "
          f"{res_mean:.3e}")
    if not bool(torch.isfinite(calc.density).all()) or worst > 3e-5 or not res_max <= 1e-3:
        raise RuntimeError(f"(a) relres {worst:.3e} or BC residual {res_max:.3e} off its gate")
    # K3 alone, the first block's D of the 64 slots again (its tables cached)
    routing = _core._pair_routing(cube)
    t_vec = torch.as_tensor(routing.uniq, dtype=torch.float32, device=dev)
    t_hat = t_vec / torch.linalg.vector_norm(t_vec, dim=-1, keepdim=True)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _rotation.rotation_blocks(c4, t_hat, N_END_4D)
    torch.cuda.synchronize()
    t_k3 = time.perf_counter() - t0
    k3_peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
    q = len(_rotation._rot_tables(c4, N_END_4D)[0])
    n_d = len(routing.uniq)
    b = k3_bound(c4, N_END_4D, n_d, "complex64")
    # D's unitarity in complex64: each degree group's D D^H against I
    rot = _core.rotation_d(c4, N_END_4D, routing.uniq, torch.float32, dev)
    unit = max(float((dg @ dg.mH - torch.eye(dg.shape[-1], device=dev)).abs().max())
               for dg in rot.blocks)
    print(f"[8] (a) K3 rotation_blocks alone (the kernel): {n_d} directions x {q} "
          f"nodes x {h4} harmonics, complex64: {t_k3:.4f} s, peak device memory above its "
          f"inputs {k3_peak:.3f} GiB, bound {b[0]:.6f} ms ({b[1]}); D's unitarity error "
          f"max |D D^H - I| {unit:.3e} ({card})")
    del rot
    # a warm block, its repeat bit for bit, KB's device time in it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = solve(c4, torch.float32, ks, cube, N_END_4D)
    u_warm = uscat0(warm)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    same = torch.equal(torch.view_as_real(warm.density), torch.view_as_real(calc.density)) and \
        torch.equal(torch.view_as_real(u_warm), torch.view_as_real(u0))
    print(f"[8] (a) warm block of {KB} k: {t_warm:.3f} s (first {total:.3f} s); repeated solve "
          f"bit-for-bit equal: {same} ({card})")
    if not same:
        raise RuntimeError("(a) the repeated 4D solve differs")
    del warm
    events = []
    real_kb = _core.block_diag_cmm

    def kb_timed(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_kb(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    _core.block_diag_cmm = kb_timed
    try:
        acc_w, total_w = split_stages(torch, lambda: uscat0(solve(
            c4, torch.float32, ks, cube, N_END_4D)), stages)
    finally:
        _core.block_diag_cmm = real_kb
    kb_ms = sum(st.elapsed_time(en) for st, en in events)
    w_parts = [acc_w.pop(n, 0.0) for n in nested]
    print(f"[8] (a) warm block split, s per block: {format_split(acc_w, total_w, labels, 1)}, "
          f"of the coax K5 {w_parts[-1]:.6f}; "
          f"KB {len(events)} launches, {kb_ms:.3f} ms between CUDA events ({card})")
    # the field: uscat(0) against complex128 on the factored route
    calc128 = solve(c4, torch.float64, ks, cube, N_END_4D, solver="matfree", stable=True)
    u128 = uscat0(calc128)
    err = rel(u0.to(torch.complex128), u128)
    print(f"[8] (a) uscat(0) complex64 {[f'{complex(v):.7f}' for v in u0.cpu()]} against "
          f"complex128 (factored, GMRES iters {calc128.iters.tolist()}): rel err {err:.3e}")
    if not err <= 1e-3:
        raise RuntimeError(f"(a) uscat(0) off complex128 by {err:.3e}")
    del calc128
    torch.cuda.empty_cache()
    # the general evaluation at EVAL_POINTS_4D points for one k
    raw = np.random.default_rng(0).normal(size=(4, EVAL_POINTS_4D)) * 6.0
    x = torch.as_tensor(raw, dtype=torch.float32, device=dev)
    one = solve(c4, torch.float32, ks[:1], cube, N_END_4D)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    best = float("inf")
    reset()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = one.uscat(x)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    ev_counts = read()
    require_launched(ev_counts, ("harmonic_eval",), "(a) general evaluation")
    ev_peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
    outside = (torch.linalg.vector_norm(
        x[:, :, None] - torch.as_tensor(cube.T, dtype=torch.float32, device=dev)[:, None, :],
        dim=0) > 1.0).all(-1)
    b = ke_bound(EVAL_POINTS_4D, 1, nb, h4, N_END_4D, 4, "complex64")
    print(f"[8] (a) general evaluation (KE, {ev_counts['harmonic_eval'] // 3} launches a "
          f"call) at {EVAL_POINTS_4D} points, 1 k, 4D n_end={N_END_4D}: {best:.6f} s "
          f"({EVAL_POINTS_4D / best:.1f} pts/s), peak device memory above its inputs "
          f"{ev_peak:.3f} GiB, bound {b[0]:.6f} ms ({b[1]}); the plain torch version "
          f"(PERF.md) 0.107-0.151 s ({card})")
    if not bool(torch.isfinite(u[outside]).all()):
        raise RuntimeError("(a) the 4D field is not finite outside the spheres")
    del calc, one, u, x
    torch.cuda.empty_cache()

    def against_golden(label, u0, tol):
        for i, g in enumerate(golden):
            ref = complex(*g["uscat0"])
            err = abs(complex(u0[i]) - ref) / abs(ref)
            print(f"[8] {label} k={ks[i]:.6f} uscat(0) = {complex(u0[i]):.9f} golden {ref:.9f} "
                  f"rel err {err:.3e}")
            if abs(g["k"] - float(ks[i])) > 1e-6 or not err <= tol:
                raise RuntimeError(f"{label}: uscat(0) at k={ks[i]} off the golden by {err:.2e}")

    # (b) the 4D anchor at N_END_4D_ANCHOR against the JAX golden
    n_a = nb * basis(c4, N_END_4D_ANCHOR).num
    route = _core._route("auto", nb, n_a, torch.float64, dev, True, False, cube)
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    calc = solve(c4, torch.float64, ks, cube, N_END_4D_ANCHOR)
    u0 = uscat0(calc).cpu().numpy()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read()
    print(f"[8] (b) 4D anchor n_end={N_END_4D_ANCHOR} ({n_a} unknowns), complex128, auto -> "
          f"{route!r}: {dt:.3f} s for {KB} k, launches {counts}, GMRES iters "
          f"{calc.iters.tolist()}, max relres {float(calc.relres.max()):.3e} ({card})")
    require_launched(counts, ("lane_gather", "lane_scatter", "spherical_jh", "coax_fold"), "(b)")
    if route != "matfree" or counts["block_diag_cmm"] != 0:
        raise RuntimeError("(b) the complex128 default route is not the offset table")
    if float(calc.relres.max()) > 1e-11:
        raise RuntimeError("(b) relres above 1e-11")
    against_golden("(b) complex128 offset table", u0, 1e-7)
    del calc
    torch.cuda.empty_cache()
    reset()
    calc = solve(c4, torch.float32, ks, cube, N_END_4D_ANCHOR)
    counts = read()
    require_launched(counts, ("block_diag_cmm", "lane_gather", "lane_scatter"), "(b) complex64")
    print(f"[8] (b) complex64, auto -> factored, GMRES iters {calc.iters.tolist()}, launches "
          f"{counts}")
    against_golden("(b) complex64 factored", uscat0(calc).cpu().numpy(), 1e-3)
    del calc

    # (c) 'bpbpa' at (b)'s configuration: the field does not depend on the chart
    reset()
    calc = solve(c4p, torch.float32, ks, cube, N_END_4D_ANCHOR)
    counts = read()
    require_launched(counts, ("block_diag_cmm", "lane_gather", "lane_scatter"), "(c)")
    print(f"[8] (c) 'bpbpa' hypercube n_end={N_END_4D_ANCHOR}, complex64, auto -> factored, "
          f"GMRES iters {calc.iters.tolist()}, launches {counts}")
    against_golden("(c) 'bpbpa' against the 'bba' golden:", uscat0(calc).cpu().numpy(), 1e-3)
    del calc
    torch.cuda.empty_cache()

    # (d) the 4D dense route: the jascome pair at N_END_4D_LU, k = 1
    pair = pair_centers(4)
    one_k = np.array([1.0], np.float32)
    for rdt, kw, tol in ((torch.float32, {}, 1e-3), (torch.float64, dict(stable=False), 1e-8)):
        name = "complex64" if rdt == torch.float32 else "complex128"
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        calc = solve(c4, rdt, one_k, pair, N_END_4D_LU, **kw)
        u0 = uscat0(calc)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read()
        require_launched(counts, ("dense_assemble", "spherical_jh", "coax_fold"), "(d)")
        if calc.relres is not None or calc.matrix is None:
            raise RuntimeError(f"(d) {name}: the default solver did not take LU")
        ref = uscat0(solve(c4, rdt, one_k, pair, N_END_4D_LU, solver="matfree", stable=True))
        err = rel(u0, ref)
        print(f"[8] (d) 4D pair n_end={N_END_4D_LU} (2 x {basis(c4, N_END_4D_LU).num} unknowns), "
              f"{name}{' stable=False' if kw else ''}, auto -> LU: {dt:.3f} s, launches "
              f"{counts}, uscat(0) {complex(u0[0]):.9f}, against the factored route rel err "
              f"{err:.3e} ({card})")
        if not err <= tol:
            raise RuntimeError(f"(d) {name}: LU off the factored route by {err:.3e}")
        del calc
        f = dict(dtype=rdt, device=dev)
        cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
        parts = _core._assembly_parts(
            c4, N_END_4D_LU, pair, torch.ones(1, 2, **f), torch.as_tensor(one_k, **f),
            torch.ones(1, **f), torch.ones(1, 2, dtype=cdt, device=dev),
            torch.zeros(1, 2, dtype=cdt, device=dev), stable=rdt == torch.float32)
        got = dense_assemble(*parts)
        if not torch.equal(dense_assemble(*parts), got):
            raise RuntimeError(f"(d) KD {name}: two launches differ")
        same, ea, _ = equal_by_k(torch, got, _dense_assemble_plain(*parts, False))
        ms = cuda_ms(torch, lambda: dense_assemble(*parts), 10)
        pms = cuda_ms(torch, lambda: _dense_assemble_plain(*parts, False), 3)
        h_kd, cs = parts[0].shape[-1], (8 if rdt == torch.float32 else 16)
        b = bound(4 * h_kd * h_kd * cs + parts[0].numel() * cs + 6 * h_kd * cs + h_kd * cs // 2
                  + 4 * 12, 12 * 2 * h_kd * h_kd, name)
        us = device_us(torch, lambda: dense_assemble(*parts), "dense_assemble")
        print(f"[8] (d) dense_assemble 1 k x 2x2 blocks of {h_kd}x{h_kd} {name}: equal to the "
              f"plain version {same}, max_abs_err {ea:.3e} kernel {ms:.4f} ms (device {us:.2f} "
              f"us a launch: {b[0] * 1e3 / us:.3f} of the bound) plain {pms:.4f} ms bound "
              f"{b[0]:.6f} ms ({b[1]}) ({card})")
        if not same:
            raise RuntimeError(f"(d) KD {name} differs from its plain version ({ea:.3e})")
        del parts, got
        torch.cuda.empty_cache()

    # (e) 5D: 'bbba', the jascome pair at N_END_5D, complex64 on the forced
    # factored route (KB's row panels at blocks of 204) against complex128 LU
    pair5 = pair_centers(5)
    reset()
    calc = solve(c5, torch.float32, one_k, pair5, N_END_5D, solver="matfree", stable=True)
    u0 = uscat0(calc)
    counts = read()
    panels = counts["block_diag_cmm_panels"]
    ref = uscat0(solve(c5, torch.float64, one_k, pair5, N_END_5D))
    err = rel(u0.to(torch.complex128), ref)
    print(f"[8] (e) 'bbba' 5D pair n_end={N_END_5D} (H={basis(c5, N_END_5D).num}), complex64 "
          f"factored: GMRES iters {calc.iters.tolist()}, launches {counts}, KB with row "
          f"panels {panels}; uscat(0) {complex(u0[0]):.9f} against complex128 LU "
          f"{complex(ref[0]):.9f}: rel err {err:.3e} ({card})")
    require_launched(counts, ("block_diag_cmm", "lane_gather", "lane_scatter", "spherical_jh",
                              "coax_fold"), "(e)")
    if panels <= 0 or not err <= 1e-3:
        raise RuntimeError(f"(e) KB panels {panels} or rel err {err:.3e} off its gate")
    del calc
    torch.cuda.empty_cache()
    return launches


def square_lattice(n_side, d, spacing=SPACING):
    """The n_balls family's lattice: n_side^2 centers in the (x0, x1) plane
    (the JAX package's cli/_accuracy.py::lattice_centers)."""
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, d))
    centers[:, 0], centers[:, 1] = xx.ravel(), yy.ravel()
    return centers


def central_balls(centers_np, n=4):
    """The n spheres nearest the origin: float32 boundary points at 1.0000005
    radii keep their distance there (far out, 1e-7 of |x| is more)."""
    return tuple(int(b) for b in np.argsort(np.linalg.norm(centers_np, axis=1), kind="stable")[:n])


def lattice_matvec_parts(torch, mv, x, n_k, fx, fy, h, name):
    """One lattice matvec timed, and its per-frequency product and FFTs
    alone at the same shapes: {part: (ms, bound)}; the matvec's bound is the
    kernel grid read once (its 8 flops a complex MAC far below)."""
    cs = 8 if name == "complex64" else 16
    grid_bytes = n_k * fx * fy * h * h * cs
    khat = torch.zeros((n_k * fx * fy, h, h), dtype=x.dtype, device=x.device)
    z = torch.zeros((n_k, fx, fy, h), dtype=x.dtype, device=x.device)
    zc = z.reshape(n_k * fx * fy, h, 1)
    vec = 2 * n_k * fx * fy * h * cs
    fft_flops = 5 * n_k * fx * fy * h * np.log2(fx * fy) * 2  # c2c, 5 N log2 N a transform
    out = {
        "matvec": (cuda_ms(torch, lambda: mv(x), 10),
                   bound(grid_bytes + 4 * vec, 0, name, mma_flops=8 * n_k * fx * fy * h * h)),
        "product": (cuda_ms(torch, lambda: torch.matmul(khat, zc), 10),
                    bound(grid_bytes + vec, 0, name, mma_flops=8 * n_k * fx * fy * h * h)),
        "fftn": (cuda_ms(torch, lambda: torch.fft.fftn(z, dim=(1, 2)), 10),
                 bound(vec, fft_flops, name)),
        "ifftn": (cuda_ms(torch, lambda: torch.fft.ifftn(z, dim=(1, 2)), 10),
                  bound(vec, fft_flops, name)),
    }
    del khat, z
    return out


def lattice_build_bound(torch, centers_np, h, name):
    """The lattice kernel build's bound for a 'ba' lattice at N_END_3D, as
    text: K3 at the half offsets' directions and the sandwich (their
    operations, as `stage_bounds` counts them), the FFT over the cells
    (5 N log2 N real operations per entry), and the grid [Fx, Fy, H, H]
    written once."""
    from biem_helmholtz_sphere_tpu_torch.biem._lattice import _half_offsets, lattice_routing
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.translation._rotation import _degree_groups, _rot_tables

    c = create_from_branching_types("ba")
    routing = lattice_routing(centers_np)
    n_half = len(_half_offsets(routing, 3)[2])
    cells = 4 * routing[2][0] * routing[2][1]
    g2 = sum((e - s) ** 2 for s, e in _degree_groups(c, N_END_3D))
    q = len(_rot_tables(c, N_END_3D)[0])
    cs = 8 if name == "complex64" else 16
    ms, by = bound(cells * h * h * cs, n_half * q * 16 * h + 5 * cells * np.log2(cells) * h * h,
                   name, mma_flops=n_half * q * 8 * g2 + 16 * n_half * h * g2)
    return (f"{ms:.3f} ms ({by}: {n_half} half offsets, K3 at {q} nodes, the sandwich, the FFT "
            f"over {cells} cells, the {cells * h * h * cs / 1e9:.2f} GB grid written once)")


def format_parts(parts):
    return ", ".join(f"{k} {ms:.4f} ms (bound {b[0]:.6f} ms, {b[1]})"
                     for k, (ms, b) in parts.items())


def n_balls_family(torch, dev, card):
    """Phase 9: 2D trees and the lattice-FFT route at the size of the
    JAX package's n_balls accuracy family (square lattices of unit
    spheres at pitch 4, k = 1, a plane wave along x0), each path with the
    launch counts set to 0 just before it and read just after.  Returns
    (KG's timed results by dtype name, KG's launches on (b))."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.biem import _core, _lattice
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.ops.gmres import gmres_solve_op
    from biem_helmholtz_sphere_tpu_torch.ops.graf import _graf_fold_plain, graf_fold
    from biem_helmholtz_sphere_tpu_torch.special._family import (
        _H_ONLY, _SCALED, _spherical_h_scaled_plain, _spherical_jh_all_plain,
        _spherical_jh_scaled_plain, spherical_jh)
    from biem_helmholtz_sphere_tpu_torch.translation._ops import _a_node_m

    reset, read = kernel_counts()
    trees = {t: create_from_branching_types(t) for t in ("a", "ba")}
    with open(os.path.join(ROOT, "biem_helmholtz_sphere_tpu_torch", "data",
                           "nballs2d_golden_f64.json")) as fh:
        golden2d = {p["name"]: complex(*p["uscat0"]) for p in json.load(fh)["points"]}
    rdt_of = {torch.complex64: torch.float32, torch.complex128: torch.float64}

    def incident(d, rdt):
        direction = torch.zeros(d, dtype=rdt, device=dev)
        direction[0] = 1.0
        return plane_wave(k=torch.tensor(1.0, dtype=rdt, device=dev), direction=direction)[0]

    def solve(tree, n_side, n_end, cdt, **kw):
        rdt = rdt_of[cdt]
        c = trees[tree]
        f = dict(dtype=rdt, device=dev)
        centers = square_lattice(n_side, c.c_ndim)
        return biem(c, centers=torch.as_tensor(centers, **f),
                    radii=torch.ones(len(centers), **f), k=torch.tensor(1.0, **f),
                    n_end=n_end, uin=incident(c.c_ndim, rdt), **kw), centers

    def u0(calc):
        x = torch.zeros(calc.c.c_ndim, 1, dtype=calc.radii.dtype, device=dev)
        return complex(calc.uscat(x).reshape(-1)[0])

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30

    # (a) the 3D lattice: 1,024 'ba' spheres at n_end = 19 (369,664 unknowns)
    stages = [(_core, "_rhs_dispatch", "RHS"), (_lattice, "_radial_factors", "radial rows"),
              (_lattice, "_offset_table", "half table (K5 + KU + K2 + K3 + sandwich)"),
              (_lattice, "_kernel_fft", "kernel build"), (_core, "gmres_solve_op", "GMRES"),
              (_core.BIEMResultCalculator, "uscat", "uscat(0)")]
    u_a = {}
    for cdt in (torch.complex64, torch.complex128):
        name = str(cdt).split(".")[-1]
        captured = {}
        gmres = _core.gmres_solve_op

        def capture(mv, diag, b, **kw):
            captured.update(mv=mv, b=b)
            return gmres(mv, diag, b, **kw)

        out = {}

        def run():
            out["calc"], out["centers"] = solve("ba", N_SIDE_3D, N_END_3D, cdt, stable=True)
            u_a[name] = u0(out["calc"])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        clear_coax_caches()  # the half table's coax tables built cold (KU)
        reset()
        _core.gmres_solve_op = capture
        try:  # the first (cold) solve, split by stage
            acc, total = split_stages(torch, run, stages)
        finally:
            _core.gmres_solve_op = gmres
        counts = read()
        peak = peak_gib()
        calc, centers = out["calc"], out["centers"]
        require_launched(counts, ["coax_fold", "spherical_jh", "fused_ba_eval_few",
                                  "rotation_blocks", "coax_u", "arnoldi_step",
                                  "gmres_backsolve"], f"[9] (a) {name}")
        if counts["block_diag_cmm"] or counts["graf_fold"]:
            raise RuntimeError(f"[9] (a): the lattice route launched KB or KG: {counts}")
        dens, relres = calc.density, float(calc.relres.max())
        if not bool(torch.isfinite(dens).all()):
            raise RuntimeError("[9] (a): density not finite")
        if relres > (3e-5 if cdt == torch.complex64 else 1e-11):
            raise RuntimeError(f"[9] (a) {name}: relres {relres:.3e}")
        bc = bc_residual_of(torch, calc, centers, central_balls(centers))
        if not bc[0] <= 1e-3:
            raise RuntimeError(f"[9] (a) {name}: boundary residual {bc[0]:.3e}")
        split = dict(acc)
        split["grid and FFT"] = split.pop("kernel build", 0.0) - split.get(stages[2][2], 0.0)
        h = calc.density.shape[-1]
        parts = lattice_matvec_parts(torch, captured["mv"], captured["b"], 1, 2 * N_SIDE_3D,
                                     2 * N_SIDE_3D, h, name)
        print(f"[9] (a) 'ba' {N_SIDE_3D}x{N_SIDE_3D} lattice, n_end={N_END_3D} ({h} harmonics, "
              f"{N_SIDE_3D ** 2 * h} unknowns), {name}, stable, solver=auto -> lattice: "
              f"{int(calc.iters.max())} GMRES steps, relres {relres:.3e}, uscat(0) "
              f"{u_a[name]:.10f}, BC residual max {bc[0]:.3e} mean {bc[1]:.3e}, peak "
              f"{peak:.3f} GiB; launches {counts} ({card})")
        print(f"[9] (a) {name} the first solve split by stage, s (synchronising timers): "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f", other {total - sum(split.values()):.4f}, total {total:.4f} ({card})")
        print(f"[9] (a) {name} one lattice matvec and its parts alone: {format_parts(parts)} "
              f"({card})")
        print(f"[9] (a) {name} bound of the kernel build: "
              f"{lattice_build_bound(torch, centers, h, name)} ({card})")
        if cdt == torch.complex64:  # a second solve: its tables cached
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = solve("ba", N_SIDE_3D, N_END_3D, cdt, stable=True)[0]
            u0(again)
            torch.cuda.synchronize()
            print(f"[9] (a) {name} a second solve with uscat(0) {time.perf_counter() - t0:.4f} s "
                  f"(the geometry's tables cached), bit for bit the first ({card})")
            if not same_bits(torch, again.density, dens):
                raise RuntimeError("[9] (a): a repeated solve differs")
            del again
        if cdt == torch.complex128:  # for phase 12 (b)
            SHARED["9a density"] = dens.cpu()
        del calc, captured, out
        torch.cuda.empty_cache()
    SHARED["9a"] = u_a["complex128"]  # for phase 11 (c)
    SHARED["9a64"] = u_a["complex64"]  # for phase 12 (c)
    d_c = abs(u_a["complex64"] - u_a["complex128"])
    d_art = abs(u_a["complex128"] - ARTIFACT_3D)
    print(f"[9] (a) complex64 - complex128 {d_c:.3e}; complex128 - the JAX package's float32 "
          f"TPU row (accuracy.csv) {d_art:.3e}; a repeated complex64 solve bit for bit")
    if d_c > 1e-3 or d_art > 1e-4:
        raise RuntimeError(f"[9] (a): uscat(0) off ({d_c:.3e}, {d_art:.3e})")

    # (b) the 2D lattice: 4,096 'a' spheres, complex64, the family's own
    # method (tools/nballs_family4.py): a cold long-basis GMRES at n_end=2,
    # then the n_end ladder, each rung warm-started from the last density
    c = trees["a"]
    centers = square_lattice(N_SIDE_2D, 2)
    nb = len(centers)
    f32 = dict(dtype=torch.float32, device=dev)
    c64 = dict(dtype=torch.complex64, device=dev)
    uin = incident(2, torch.float32)
    ones, k1 = torch.ones(1, nb, **f32), torch.ones(1, **f32)
    alpha, beta = torch.ones(1, nb, **c64), torch.zeros(1, nb, **c64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    x_prev, gate_x0, last_run = None, {}, None
    t_all = time.perf_counter()
    for i, n_end in enumerate(LADDER_2D):
        h = 2 * n_end - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mv, diag = _lattice.lattice_operator(c, n_end, centers, ones, k1, k1, alpha, beta,
                                             stable=True)
        rhs = _core._rhs_dispatch(c, n_end, torch.as_tensor(centers, **f32), ones, alpha, beta,
                                  uin, None, (1,)).reshape(1, -1)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        x0 = None
        if x_prev is not None:
            x0 = torch.zeros(1, nb, h, **c64)
            x0[..., : x_prev.shape[-1]] = x_prev
            x0 = x0.reshape(1, -1)
        restart, cycles = (COLD_RESTART, 1) if i == 0 else (WARM_RESTART, 2)
        t0 = time.perf_counter()
        x, relres, iters = gmres_solve_op(mv, diag, rhs, x0=x0, restart=restart, maxiter=cycles)
        torch.cuda.synchronize()
        t_gmres = time.perf_counter() - t0
        relres, steps = float(relres), int(iters)
        calc = _core.BIEMResultCalculator(
            c=c, centers=torch.as_tensor(centers, **f32), radii=torch.ones(nb, **f32),
            k=torch.tensor(1.0, **f32), eta=torch.tensor(1.0, **f32), density=x.reshape(nb, h),
            uin=uin, n_end=n_end)
        line = (f"[9] (b) 'a' {N_SIDE_2D}x{N_SIDE_2D} lattice n_end={n_end} ({nb * h} unknowns)"
                f" complex64 stable: build (K5 + KG + grid + FFT) {t_build:.4f} s, GMRES "
                f"({'cold, basis' if i == 0 else 'warm, basis'} {restart}) {steps} steps "
                f"{t_gmres:.4f} s, relres {relres:.3e}, uscat(0) {u0(calc):.7f}")
        if n_end in GATES_2D:
            if not bool(torch.isfinite(x).all()) or relres > 3e-5:
                raise RuntimeError(f"[9] (b) n_end={n_end}: relres {relres:.3e}")
            bc = bc_residual_of(torch, calc, centers, central_balls(centers))
            if not bc[0] <= 1e-3:
                raise RuntimeError(f"[9] (b) n_end={n_end}: boundary residual {bc[0]:.3e}")
            gate_x0[n_end] = (mv, x)
            line += f", BC residual max {bc[0]:.3e} mean {bc[1]:.3e}"
        print(f"{line} ({card})")
        if steps > 0:
            last_run = (n_end, mv, diag, rhs, x0, x, restart, cycles)
        x_prev = x.reshape(1, nb, h)
        del mv, diag, rhs, x0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t_all
    counts = read()
    require_launched(counts, ["graf_fold", "spherical_jh", "harmonic_eval", "arnoldi_step",
                              "gmres_backsolve"], "[9] (b)")
    if counts["block_diag_cmm"] or counts["coax_fold"]:
        raise RuntimeError(f"[9] (b): the 2D lattice route launched KB or K2: {counts}")
    kg_launches = counts["graf_fold"]
    n_rep, mv, diag, rhs, x0, x, restart, cycles = last_run
    again, _, _ = gmres_solve_op(mv, diag, rhs, x0=x0, restart=restart, maxiter=cycles)
    if not same_bits(torch, again, x):
        raise RuntimeError("[9] (b): a repeated solve differs")
    del last_run, mv, diag, rhs, x0, x, again
    mv, x = gate_x0[GATES_2D[-1]]
    h = 2 * GATES_2D[-1] - 1
    parts = lattice_matvec_parts(torch, mv, x, 1, 2 * N_SIDE_2D, 2 * N_SIDE_2D, h, "complex64")
    print(f"[9] (b) the ladder {LADDER_2D} in {t_all:.3f} s, peak {peak_gib():.3f} GiB, "
          f"launches {counts}; the n_end={n_rep} rung (the last that iterated) repeated bit "
          f"for bit; at n_end={GATES_2D[-1]} one matvec and its parts alone: "
          f"{format_parts(parts)} ({card})")
    del gate_x0, mv, x
    torch.cuda.empty_cache()

    # (c) anchors: complex128 on the default route (the lattice); complex64
    # on the direct LU in 2D (at biem()'s float32 GMRES tolerance 3e-5 the 2D
    # lattices keep ~70x the residual in uscat(0): printed beside it) and on
    # the lattice in 3D
    for tree, n_side, n_end, ref in ANCHORS:
        reset()
        t0 = time.perf_counter()
        calc = solve(tree, n_side, n_end, torch.complex128)[0]
        got = u0(calc)
        t128 = time.perf_counter() - t0
        counts = read()
        if calc.matrix is not None or counts["block_diag_cmm"]:
            raise RuntimeError(f"[9] (c) {tree} {n_side}: not the lattice route: {counts}")
        require_launched(counts, ["graf_fold", "harmonic_eval"] if tree == "a" else
                         ["coax_fold", "rotation_blocks"], "[9] (c)")
        t0 = time.perf_counter()
        route32 = "LU" if tree == "a" else "lattice"
        calc32 = solve(tree, n_side, n_end, torch.complex64,
                       **({"solver": "direct"} if tree == "a" else {}))[0]
        got32 = u0(calc32)
        t64 = time.perf_counter() - t0
        line = (f"[9] (c) '{tree}' {n_side}x{n_side} n_end={n_end}: complex128 lattice "
                f"{got:.10f} ({int(calc.iters.max())} steps, {t128:.3f} s) off {abs(got - ref):.3e};"
                f" complex64 {route32} {got32:.7f} ({t64:.3f} s) off {abs(got32 - ref):.3e}")
        del calc, calc32
        torch.cuda.empty_cache()
        if tree == "a" and n_side == 8:
            calc = solve(tree, n_side, n_end, torch.complex64)[0]
            g = u0(calc)
            line += (f"; complex64 lattice at the float32 tolerance {g:.7f} "
                     f"(relres {float(calc.relres.max()):.2e}) off {abs(g - ref):.3e}")
            del calc
        if tree == "a" and n_side == 8:  # the JAX package's own float64 solve
            g = golden2d["lattice 8x8"]
            line += f"; complex128 off the JAX package's float64 by {abs(got - g):.3e}"
            if abs(got - g) > 1e-10:
                raise RuntimeError("[9] (c): off the JAX golden")
        print(f"{line} ({card})")
        if abs(got - ref) > 1e-8 or abs(got32 - ref) > 1e-3:
            raise RuntimeError(f"[9] (c) {tree} {n_side}x{n_side}: off the anchor")

    # (d) the 2D pair goldens on the default route (LU: KG and KD), against
    # the values tests/test_biem.py holds the JAX package to and the JAX
    # package's own float64 solves (data/nballs2d_golden_f64.json)
    pair = np.array([[0.0, 2.0], [0.0, -2.0]])
    for cdt, n_end, k, ref, tol, jax_tol in (
            (torch.complex128, 9, 1.0, -1.355933 - 0.657813j, 2e-6, 1e-10),
            (torch.complex64, 9, 1.0, -1.355933 - 0.657813j, 1e-5, 1e-5),
            (torch.complex128, 32, 16.0, 1.0035487245418335 + 0.09104501905173143j, 1e-10,
             1e-10)):
        rdt = rdt_of[cdt]
        f = dict(dtype=rdt, device=dev)
        reset()
        calc = biem(c, centers=torch.as_tensor(pair, **f), radii=torch.ones(2, **f),
                    k=torch.tensor(k, **f), n_end=n_end, uin=incident(2, rdt))
        got = u0(calc)
        counts = read()
        require_launched(counts, ["graf_fold", "dense_assemble", "harmonic_eval"], "[9] (d)")
        g = golden2d["pair" if k == 1.0 else "pair k=16"]
        print(f"[9] (d) 'a' pair k={k} n_end={n_end} {str(cdt).split('.')[-1]} (LU): "
              f"{got:.10f} off the golden by {abs(got - ref):.3e} (tolerance {tol:.0e}), off "
              f"the JAX package's float64 by {abs(got - g):.3e} (tolerance {jax_tol:.0e})")
        if calc.relres is not None or abs(got - ref) > tol or abs(got - g) > jax_tol:
            raise RuntimeError(f"[9] (d) pair n_end={n_end}: off the golden")

    # (e) KG against its plain version at (b)'s half offsets, both modes and
    # dtypes, each launched twice; K5's d = 2 mode there; one lattice matvec
    # against the dense pair-major matvec (16 x 16 'a' lattice)
    _, _, t_half = _lattice._half_offsets(_lattice.lattice_routing(centers), 2)
    results = {}
    for cdt in (torch.complex64, torch.complex128):
        name = str(cdt).split(".")[-1]
        rdt, cs = rdt_of[cdt], (8 if cdt == torch.complex64 else 16)
        t = torch.as_tensor(t_half, dtype=rdt, device=dev)
        r, theta = torch.linalg.vector_norm(t, dim=1), torch.atan2(t[:, 1], t[:, 0])[None]
        z = r.to(cdt)[None]
        gen = np.random.default_rng(9)
        for n_end in GATES_2D:
            h = n_mu = 2 * n_end - 1  # (b)'s table: orders 0 .. 2 max|m|
            m = torch.as_tensor(_a_node_m(c, n_end), device=dev)
            hm, he = spherical_jh(_H_ONLY, 2, n_mu, z)
            er = scaled_err(torch, (hm, he), _spherical_h_scaled_plain(2, n_mu, z))[1]
            z_rows = torch.ones(1, nb, dtype=cdt, device=dev)  # k rho of the radial rows
            rows = spherical_jh(_SCALED, 2, n_end, z_rows)
            sr = max(scaled_err(torch, g, p)[1] for g, p in
                     zip(rows, _spherical_jh_scaled_plain(2, n_end, z_rows)))
            if er > TOL_REL[name] or sr > TOL_REL[name] or not same_bits(
                    torch, spherical_jh(_H_ONLY, 2, n_mu, z), (hm, he)) or not same_bits(
                    torch, spherical_jh(_SCALED, 2, n_end, z_rows), rows):
                raise RuntimeError(f"[9] (e) K5 d=2 {name} n_end={n_end}: {er:.3e} {sr:.3e}")
            e_r = torch.as_tensor(-20.0 * gen.random((1, h)), dtype=rdt, device=dev)
            e_b = torch.as_tensor(-20.0 * gen.random((1, h)), dtype=rdt, device=dev)
            _, _, h_plain, _ = _spherical_jh_all_plain(2, n_mu, z)
            for mode, args in (("fold", (hm, theta, m, m, he, e_r, e_b)),
                               ("zero-exponent", (h_plain, theta, m, m, None, None, None))):
                got = graf_fold(*args)
                tab, th, mo, mi, e_tab, er_, eb_ = args
                ref = _graf_fold_plain(tab, e_tab, th, mo, mi, er_, eb_)
                fin = torch.isfinite(ref)
                if not torch.equal(torch.isfinite(got), fin):
                    raise RuntimeError(f"[9] (e) KG {mode} {name}: finite entries differ")
                d = (got - ref).abs()[fin]
                ka = float(d.max())
                kr = float((d / ref.abs()[fin].clamp_min(torch.finfo(rdt).tiny)).max())
                if kr > (1e-5 if cdt == torch.complex64 else 1e-13) or not same_bits(
                        torch, graf_fold(*args), got):
                    raise RuntimeError(f"[9] (e) KG {mode} {name} n_end={n_end}: rel {kr:.3e}")
                line = (f"[9] (e) KG {mode} n_end={n_end} {name}, {len(t_half)} offsets x "
                        f"{h}x{h}: max_abs_err {ka:.3e} max_rel_err {kr:.3e} (entry by entry), "
                        f"twice bit for bit")
                if mode == "fold" and n_end == GATES_2D[-1]:
                    ms = cuda_ms(torch, lambda: graf_fold(*args), 20)
                    pms = cuda_ms(torch, lambda: _graf_fold_plain(hm, he, theta, m, m, e_r, e_b), 3)
                    n_o = len(t_half)
                    # the table written once, its inputs read once; an entry's
                    # exponent sum, exp and scaling ~5 operations
                    b = bound(n_o * h * h * cs + n_o * n_mu * (cs + cs // 2) + n_o * cs // 2
                              + 2 * h * (4 + cs // 2), 5 * n_o * h * h, name)
                    us = device_us(torch, lambda: graf_fold(*args), "graf_fold")
                    line += (f"; kernel {ms:.4f} ms (device {us:.2f} us a launch: "
                             f"{b[0] * 1e3 / us:.3f} of the bound) plain {pms:.4f} ms bound "
                             f"{b[0]:.6f} ms ({b[1]}); library: none")
                    results[name] = {"abs": ka, "rel": kr, "ms": ms, "plain_ms": pms,
                                     "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
                print(f"{line} ({card})")
                del got, ref
            line = (f"[9] (e) K5 d=2 {name}: h alone at {len(t_half)} x {n_mu} orders "
                    f"max_rel_err {er:.3e}, scaled at {nb} x {n_end} orders {sr:.3e}, twice "
                    f"bit for bit")
            if n_end == GATES_2D[-1]:  # KG's input at (b)'s n_end=32 table, timed
                ms = cuda_ms(torch, lambda: spherical_jh(_H_ONLY, 2, n_mu, z), 20)
                pms = cuda_ms(torch, lambda: _spherical_h_scaled_plain(2, n_mu, z), 3)
                b = bound(len(t_half) * (cs + n_mu * (cs + cs // 2)),
                          len(t_half) * n_mu * 12, name)
                line += (f"; h alone kernel {ms:.4f} ms plain {pms:.4f} ms bound {b[0]:.6f} "
                         f"ms ({b[1]}); library: none")
            print(f"{line} ({card})")
    for cdt, tol in ((torch.complex128, 1e-10), (torch.complex64, 1e-4)):
        rdt = rdt_of[cdt]
        cen = square_lattice(16, 2)
        f = dict(dtype=rdt, device=dev)
        args = (torch.ones(1, 256, **f), torch.ones(1, **f), torch.ones(1, **f),
                torch.ones(1, 256, dtype=cdt, device=dev), torch.zeros(1, 256, dtype=cdt, device=dev))
        mv, diag = _lattice.lattice_operator(c, 16, cen, *args, stable=True)
        mv_d, _ = _core._pairs_operator(_core._assemble(c, 16, cen, *args, stable=True,
                                                        pair_major=True))
        xr = randc(torch, np.random.default_rng(5), diag.shape, cdt, dev)
        ea, er = rel_err(torch, mv(xr), mv_d(xr))
        print(f"[9] (e) one lattice matvec against the dense pair-major matvec, 'a' 16x16 "
              f"n_end=16 {str(cdt).split('.')[-1]}: max_abs_err {ea:.3e} max_rel_err {er:.3e}")
        if er > tol:
            raise RuntimeError(f"[9] (e) lattice matvec {cdt}: {er:.3e}")
    return results, kg_launches


def block_rel_err(torch, got, ref, n_o, n_i, floor=0.0):
    """(max abs error, max error relative to the largest |ref| of each
    (leading index, row degree, column degree) block) of tables [..., Ho,
    Hi] with degree-sorted rows n_o and columns n_i (host arrays): across
    blocks the (S|R) entries span many orders of magnitude.  A block below
    `floor` times its table's largest |ref| is held against that instead."""
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("kernel output is not finite")
    worst_abs, worst = 0.0, 0.0
    big = floor * ref.abs().amax(dim=(-2, -1))
    for a in np.unique(n_o):
        ra = np.flatnonzero(n_o == a)
        for b in np.unique(n_i):
            cb = np.flatnonzero(n_i == b)
            g = got[..., ra[0]:ra[-1] + 1, cb[0]:cb[-1] + 1]
            r = ref[..., ra[0]:ra[-1] + 1, cb[0]:cb[-1] + 1]
            d = (g - r).abs().amax(dim=(-2, -1))
            m = torch.maximum(r.abs().amax(dim=(-2, -1)), big).clamp_min(
                torch.finfo(d.dtype).tiny)
            worst_abs = max(worst_abs, float(d.max()))
            worst = max(worst, float((d / m).max()))
    return worst_abs, worst


def band_sr_bound(tab, n_k, n_off, name):
    """KS's bound: one complex multiply-add (8 real operations) per entry
    and quadrature node, a contraction (at the tensor cores' FP64 rate in
    complex128), or the table's write with the harmonics read once (one
    table when rows and columns share it), the larger."""
    cs = 8 if name == "complex64" else 16
    q, h_out, h_in = tab.w.shape[0], tab.yo.shape[1], tab.yi.shape[1]
    n_b = tab.n_bands
    n_y = h_in if tab.yo is tab.yi else h_out + h_in
    nbytes = (n_k * n_off * h_out * h_in * cs + q * n_y * cs
              + n_k * n_off * n_b * (n_b * cs + cs // 2) + 2 * n_k * (h_out + h_in) * cs // 2)
    return bound(nbytes, 0, name, mma_flops=8.0 * n_k * n_off * h_out * h_in * q)


def band_f_bound(tab, n_g, d, name, n_b=None):
    """KF's bound for n_g offsets of n_b bands (the tables' by default): F
    [n_g, Q, NB] written, coef, the nodes and weights read; the recurrence
    (~6 operations a band) and the prefix sums (NB (NB + 1) / 2
    complex-by-real products) at the CUDA cores' rate, the larger."""
    cs = 8 if name == "complex64" else 16
    q, n_b = tab.w.shape[0], n_b or tab.n_bands
    nbytes = n_g * q * n_b * cs + n_g * n_b * n_b * cs + (d + 1) * q * cs // 2
    return bound(nbytes, n_g * q * (6.0 * n_b + 4.0 * n_b * (n_b + 1) / 2), name)


def ks_build_report(torch):
    """KS's and KF's registers, shared memory and spills from ptxas (-v, kept
    by the build), and each KS instance's FP64 MMAs (DMMA) and any tensor-core
    float products (HMMA: TF32 among them) counted in cuobjdump's SASS of the
    built library; raises if a KF instance spills, a complex128 KS instance
    has no DMMA or a complex64 one any tensor-core instruction."""
    import shutil

    from biem_helmholtz_sphere_tpu_torch.ops import kernels

    from tools.torch_ke_ab import ptxas_report

    lines = [ln.strip() for ln in kernels.ptxas_path("band_sr.cu").read_text().splitlines()
             if "band_" in ln or "Used" in ln or "spill" in ln]
    print("[10] ptxas -v, csrc/band_sr.cu:\n    " + "\n    ".join(lines))
    kf = {n: fig for n, fig in ptxas_report("band_sr.cu").items() if "band_f_kernel" in n}
    for n, fig in kf.items():
        print(f"[10] KF instance {n}: {fig.get('registers')} registers, {fig.get('stack')} bytes "
              f"stack, {fig.get('spill_stores')} / {fig.get('spill_loads')} bytes spill stores / "
              "loads (ptxas -v)")
    if len(kf) != 2 or any(fig.get("spill_stores", 1) or fig.get("spill_loads", 1)
                           for fig in kf.values()):
        raise RuntimeError(f"KF instances {kf}: two wanted, none spilling")
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError(f"cuobjdump not found ({tool}): KS's DMMA / HMMA not counted")
    sass = subprocess.run([tool, "-sass", str(kernels.library_path())], capture_output=True,
                          text=True, check=True).stdout
    for func in sass.split("Function : ")[1:]:
        name = func.split("\n", 1)[0].strip()
        if "band_sr_kernel" not in name:
            continue
        dbl = name.split("band_sr_kernel", 1)[1].startswith("Id")  # <double, ...>
        dmma, hmma = func.count("DMMA"), func.count("HMMA")
        print(f"[10] SASS {'complex128' if dbl else 'complex64'} KS instance {name[:60]}...: "
              f"{dmma} DMMA, {hmma} HMMA")
        if (dbl and dmma == 0) or (not dbl and (hmma or dmma)):
            raise RuntimeError(f"KS instance {name}: {dmma} DMMA, {hmma} HMMA")


def ks_in_turns(torch, args, kw, name, card, label):
    """KS against its plain version at the main path's arguments, timed in
    turns: plain (host-timed, synchronised), KS, KS (CUDA events, the two
    outputs bit for bit equal), plain; per degree block against the plain
    version; beside the bound, the achieved TFLOP/s (8 K NO Ho Hi Q) and
    one cuBLAS [H, Q] x [Q, H] product x K NO as the yardstick."""
    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import _band_sr_plain, band_sr

    tab = args[2]
    n_k, n_off = args[0].shape[:2]
    h, q = tab.yo.shape[1], tab.w.shape[0]

    def plain_timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _band_sr_plain(*args, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def ks_timed():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = band_sr(*args, **kw)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    ref, plain1 = plain_timed()
    got, ms1 = ks_timed()
    again, ms2 = ks_timed()
    same = same_bits(torch, again, got)
    del again
    err_abs, err = block_rel_err(torch, got, ref, tab.n_o_host, tab.n_i_host)
    del got, ref
    torch.cuda.empty_cache()
    plain2 = plain_timed()[1]
    b = band_sr_bound(tab, n_k, n_off, name)
    flops = 8.0 * n_k * n_off * h * tab.yi.shape[1] * q
    y_t = tab.yo.T.conj().resolve_conj().contiguous()
    mm_ms = cuda_ms(torch, lambda: torch.matmul(y_t, tab.yi), 2)
    del y_t
    ms = min(ms1, ms2)
    print(f"[10] {label} KS band_sr alone, [{n_k}, {n_off}, {h}, {tab.yi.shape[1]}] x {q} nodes, "
          f"{name}, in turns: plain {plain1:.3f} ms, KS {ms1:.3f} / {ms2:.3f} ms, plain "
          f"{plain2:.3f} ms (KS {min(plain1, plain2) / ms:.3f}x faster than its plain version); "
          f"{flops / ms / 1e9:.2f} TFLOP/s, bound {b[0]:.3f} ms ({b[1]}): {b[0] / ms:.3f} of it; "
          f"per degree block {err:.3e} (max abs {err_abs:.3e}); bits repeated {same}; "
          f"yardstick one torch.matmul [{h}, {q}] x [{q}, {h}] {mm_ms:.3f} ms, x {n_k * n_off} = "
          f"{mm_ms * n_k * n_off:.3f} ms ({card})")
    tol = TOL_REL["complex64"] if name == "complex64" else 1e-11
    if not same or not err <= tol:
        raise RuntimeError(f"{label} KS {name}: {err:.3e} against its plain version, bits "
                           f"repeated {same}")
    return {"abs": err_abs, "rel": err, "ms": ms, "plain_ms": min(plain1, plain2),
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
            "matmul_ms": mm_ms * n_k * n_off}


def kf_alone(torch, args, name, launches, card, label):
    """KF for the first group of offsets of the main path's call, timed
    (CUDA events around the wrapper; device us a launch by torch.profiler)
    beside its plain version (host-timed) and its bound, held to it per
    band (complex64 1e-5, complex128 1e-13 of each band's largest |F|),
    bits repeated; then at KF_WIDE_BANDS bands (past two of KF's chunks in
    either dtype) on the same nodes and directions, for KF_WIDE_OFFSETS
    offsets, coefficients from h's mantissas and exponents."""
    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import (
        _band_f_plain, band_coefs, band_f, offset_groups)
    from biem_helmholtz_sphere_tpu_torch.special._family import spherical_h_scaled
    from biem_helmholtz_sphere_tpu_torch.translation._ops import _band_consts

    coef, t_hat, tab = args[0].contiguous(), args[1].contiguous(), args[2]
    n_k, n_off, n_b = coef.shape[:3]
    d = t_hat.shape[-1]
    groups = offset_groups(n_k * n_off, tab.q_pad, n_b, coef.element_size())
    rdt = t_hat.dtype
    kr = torch.linspace(3.0, 12.0, n_k * n_off, dtype=rdt, device=t_hat.device)
    hm, he = spherical_h_scaled(d, KF_WIDE_BANDS, kr.reshape(n_k, n_off))
    wide = band_coefs(hm, d, *_band_consts(d), he=he).contiguous()
    out = {}
    for case, cf, (ko0, ko1) in (("", coef, groups[0]),
                                 (" wide", wide, (0, min(KF_WIDE_OFFSETS, n_k * n_off)))):
        nb = cf.shape[2]
        ms = cuda_ms(torch, lambda: band_f(cf, t_hat, tab, ko0, ko1), 3)
        us = device_us(torch, lambda: band_f(cf, t_hat, tab, ko0, ko1), "band_f_kernel")
        got = band_f(cf, t_hat, tab, ko0, ko1)
        same = same_bits(torch, band_f(cf, t_hat, tab, ko0, ko1), got)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = _band_f_plain(cf, t_hat, tab, ko0, ko1)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        scale = ref.abs().amax(dim=2, keepdim=True).clamp_min(torch.finfo(ref.real.dtype).tiny)
        diff = (got - ref).abs()
        err, err_abs = float((diff / scale).max()), float(diff.max())
        zero_past_q = not bool(got[..., tab.w.shape[0]:].any())
        del got, ref, diff
        torch.cuda.empty_cache()
        b = band_f_bound(tab, ko1 - ko0, d, name, nb)
        tail = (f"{len(groups)} groups: KF ~{ms * len(groups):.3f} ms a table; launches on the "
                f"path {launches}; " if not case else "")
        print(f"[10] {label} KF band_f{case}, one group of {ko1 - ko0} offsets x "
              f"{tab.w.shape[0]} nodes x {nb} bands, {name}: {ms:.3f} ms (device {us:.2f} us a "
              f"launch: {b[0] * 1e3 / us:.3f} of the bound; plain {plain_ms:.3f} ms, "
              f"host-timed), bound {b[0]:.3f} ms ({b[1]}); {tail}per band {err:.3e} (max abs "
              f"{err_abs:.3e}); zero past Q {zero_past_q}; bits repeated {same} ({card})")
        if not same or not zero_past_q or not err <= (1e-5 if name == "complex64" else 1e-13):
            raise RuntimeError(f"{label} KF{case} {name}: {err:.3e}, bits repeated {same}, zero "
                               f"past Q {zero_past_q}")
        out[case] = {"abs": err_abs, "rel": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b[0], "bound_by": b[1], "library_ms": None, "device_us": us}
    return out[""]


def c_trees(torch, dev, card):
    """Phase 10: trees with a 'c' node through biem(), each path with the
    launch counts set to 0 just before it and read just after, and KS and
    KF against their plain versions.  Returns (KS's and KF's results by
    dtype, their launches in (a))."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.biem import _core, _lattice
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import _band_sr_plain, band_coefs, band_sr
    from biem_helmholtz_sphere_tpu_torch.special._family import spherical_h_scaled
    from biem_helmholtz_sphere_tpu_torch.translation import _ops, _scaled, translation_matrix

    reset, read = kernel_counts()
    caa, bcaa = create_from_branching_types("caa"), create_from_branching_types("bcaa")
    cube = hypercube_centers()
    nb = len(cube)
    ks = sweep_ks_4d()[:KB]
    with open(os.path.join(ROOT, "biem_helmholtz_sphere_tpu_torch", "data",
                           "caa4d_golden_f64.json")) as fh:
        golden = {}
        for row in json.load(fh)["points"]:
            golden.setdefault(row["name"], []).append(row)

    def solve(tree, rdt, kvals, centers, n_end, **kw):
        f = dict(dtype=rdt, device=dev)
        d = tree.c_ndim
        kt = torch.as_tensor(np.asarray(kvals), **f).reshape(-1)
        n_k = kt.numel()
        cen = torch.as_tensor(centers, **f).expand(n_k, len(centers), d)
        direction = torch.zeros(d, n_k, **f)
        direction[0] = 1.0
        uin, _ = plane_wave(k=kt, direction=direction)
        return biem(tree, centers=cen, radii=torch.ones(n_k, len(centers), **f), k=kt,
                    n_end=n_end, uin=uin, **kw)

    def uscat0(calc):
        d = calc.c.c_ndim
        return calc.uscat(torch.zeros(d, 1, dtype=calc.radii.dtype, device=dev))[0]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    calls = []
    real_band_sr = _scaled.band_sr

    def recorded(*args, **kw):  # KS's arguments on the main path, for (e)
        calls.append((args, kw))
        return real_band_sr(*args, **kw)

    # (a) 'caa' on the hypercube at full width: complex64, auto -> the
    # offset-table matrix-free GMRES, its table by KS in fold mode
    h = basis(caa, N_END_C).num
    n_sys = nb * h
    route = _core._route("auto", nb, n_sys, torch.float32, dev, True, False, cube)
    if route != "matfree":
        raise RuntimeError(f"(a) auto picks {route!r} for the 'caa' hypercube")
    stages = [(_core, "_rhs_dispatch", "RHS"), (_core, "_radial_factors", "radial rows"),
              (_core, "sr_banded_folded", "table (K5 + KS)"),
              (_core, "gmres_solve_op", "GMRES"),
              (_core.BIEMResultCalculator, "uscat", "uscat(0)")]
    first = {}

    def first_block():
        first["calc"] = solve(caa, torch.float32, ks, cube, N_END_C)
        first["u0"] = uscat0(first["calc"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    _scaled.band_sr = recorded
    try:
        acc, total = split_stages(torch, first_block, stages)
    finally:
        _scaled.band_sr = real_band_sr
    counts = read()
    calc, u0 = first.pop("calc"), first.pop("u0")
    peak = torch.cuda.max_memory_allocated() / 2**30
    labels = [label for _, _, label in stages]
    print(f"[10] (a) 'caa' 4D hypercube ({nb} unit spheres, pitch 4), n_end={N_END_C} "
          f"(H={h}, {n_sys} unknowns), complex64, auto -> offset-table matrix-free GMRES, "
          f"one block of {KB} k: {total:.3f} s; split, s per block (synchronising timers): "
          f"{format_split(acc, total, labels, 1)}; launches {counts}; GMRES iters "
          f"{calc.iters.tolist()}, max relres {float(calc.relres.max()):.3e}; peak device "
          f"memory {peak:.3f} GiB ({card})")
    require_launched(counts, ("band_sr", "band_f", "lane_gather", "lane_scatter", "spherical_jh",
                              "harmonic_eval"),
                     "(a)")
    for name in ("block_diag_cmm", "coax_fold", "coax_u", "dense_assemble", "graf_fold"):
        if counts[name]:
            raise RuntimeError(f"(a) a 'c' root launched {name}: {counts}")
    launches = {"band_sr": counts["band_sr"], "band_f": counts["band_f"]}
    worst = float(calc.relres.max())
    res_max, res_mean = bc_residual_of(torch, calc, cube, (0, 5, 10, 15))
    print(f"[10] (a) BC residual at 256 points on 4 spheres: max {res_max:.3e} mean "
          f"{res_mean:.3e}")
    if not bool(torch.isfinite(calc.density).all()) or worst > 3e-5 or not res_max <= 1e-3:
        raise RuntimeError(f"(a) relres {worst:.3e} or BC residual {res_max:.3e} off its gate")
    del calc
    torch.cuda.empty_cache()
    ks_build_report(torch)
    # KS and KF alone at the main path's shapes, against their plain versions
    (args, kw), = calls
    calls.clear()
    results = {"band_sr": {}, "band_f": {}}
    results["band_sr"]["complex64"] = ks_in_turns(torch, args, kw, "complex64", card, "(a)")
    results["band_f"]["complex64"] = kf_alone(torch, args, "complex64", counts["band_f"], card,
                                              "(a)")
    del args, kw
    # the same block in complex128, unscaled (KS's unscaled mode, route auto)
    reset()
    _scaled.band_sr = _ops.band_sr = recorded
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calc128 = solve(caa, torch.float64, ks, cube, N_END_C, stable=False)
        u128 = uscat0(calc128)
        torch.cuda.synchronize()
        t128 = time.perf_counter() - t0
    finally:
        _scaled.band_sr, _ops.band_sr = real_band_sr, real_band_sr
    counts = read()
    require_launched(counts, ("band_sr", "band_f", "lane_gather", "lane_scatter"),
                     "(a) complex128")
    err = rel(u0.to(torch.complex128), u128)
    print(f"[10] (a) complex128 unscaled (auto -> the offset table, KS unscaled): {t128:.3f} s, "
          f"GMRES iters {calc128.iters.tolist()}, max relres {float(calc128.relres.max()):.3e}; "
          f"uscat(0) complex64 {[f'{complex(v):.7f}' for v in u0.cpu()]} against complex128: "
          f"rel err {err:.3e}; launches {counts} ({card})")
    if not err <= 1e-4 or float(calc128.relres.max()) > 1e-11:
        raise RuntimeError(f"(a) uscat(0) off complex128 by {err:.3e}")
    del calc128
    torch.cuda.empty_cache()
    # KS alone in complex128 against its plain version (its ZGEMMs), in turns
    (args, kw), = calls
    calls.clear()
    results["band_sr"]["complex128"] = ks_in_turns(torch, args, kw, "complex128", card, "(a)")
    results["band_f"]["complex128"] = kf_alone(torch, args, "complex128", counts["band_f"], card,
                                               "(a)")
    del args, kw
    torch.cuda.empty_cache()

    # (b) the anchors
    pair = golden["pair caa"][0]
    reset()
    calc = solve(caa, torch.float64, 1.0, pair_centers(4), N_END_C_ANCHOR)
    u = complex(uscat0(calc)[0])
    dens = torch.as_tensor(np.array(pair["density"][0]) + 1j * np.array(pair["density"][1]),
                           device=dev).reshape(pair["density_shape"])
    err_d = rel(calc.density[0], dens)
    print(f"[10] (b) 'caa' pair, n_end={N_END_C_ANCHOR}, complex128, LU: uscat(0) = {u:.9f} "
          f"(reference -0.454651-0.423387j: {abs(u - (-0.454651 - 0.423387j)):.3e}); density "
          f"against the JAX package's {err_d:.3e}; launches {read()}")
    require_launched(read(), ("band_sr", "dense_assemble"), "(b)")
    if abs(u - (-0.454651 - 0.423387j)) > 2e-6 or not err_d <= 1e-9:
        raise RuntimeError("(b) the 'caa' pair is off its golden")
    calc = solve(caa, torch.float64, [r["k"] for r in golden["hypercube caa"]], cube,
                 N_END_C_ANCHOR)
    for v, r in zip(uscat0(calc).cpu(), golden["hypercube caa"]):
        ref = complex(*r["uscat0"])
        e = abs(complex(v) - ref) / abs(ref)
        print(f"[10] (b) hypercube n_end={N_END_C_ANCHOR} k={r['k']:.6f} complex128: uscat(0) = "
              f"{complex(v):.12f}, JAX golden {ref:.12f}, rel err {e:.3e}")
        if not e <= 1e-9:
            raise RuntimeError("(b) the 'caa' hypercube is off its golden")
    k_o, x_o, n_o = OVERFLOW_PAIR
    over = pair_centers(4) * (x_o / 2.0)
    u64 = complex(uscat0(solve(caa, torch.float64, k_o, over, n_o))[0])
    u32 = complex(uscat0(solve(caa, torch.float32, k_o, over, n_o))[0])
    e = abs(u32 - u64) / abs(u64)
    print(f"[10] (b) the float32 overflow pair (k={k_o}, centers +-{x_o}, n_end={n_o}): "
          f"complex64 {u32:.7f} (stable) against complex128 {u64:.9f}: rel err {e:.3e}")
    if not np.isfinite(u32.real + u32.imag) or not e <= 1e-4:
        raise RuntimeError("(b) the float32 overflow pair is off complex128")
    del calc
    torch.cuda.empty_cache()

    # (c) 'bcaa' (5D): the factored route against the dense band scan
    hb = basis(bcaa, N_END_BCAA).num
    reset()
    fact = solve(bcaa, torch.float32, 1.0, pair_centers(5), N_END_BCAA, solver="matfree",
                 stable=True)
    c_fact = read()
    reset()
    dense = solve(bcaa, torch.float64, 1.0, pair_centers(5), N_END_BCAA, stable=False,
                  translational_coefficients_method="triplet")
    c_dense = read()
    require_launched(c_fact, ("block_diag_cmm", "coax_fold", "lane_gather"), "(c) factored")
    require_launched(c_dense, ("band_sr", "dense_assemble"), "(c) triplet")
    if c_fact["band_sr"]:
        raise RuntimeError("(c) the factored route launched KS")
    e_u = rel(uscat0(fact).to(torch.complex128), uscat0(dense))
    e_d = rel(fact.density.to(torch.complex128), dense.density)
    print(f"[10] (c) 'bcaa' pair, n_end={N_END_BCAA} (H={hb}): factored complex64 (K3, K2, KB) "
          f"against the dense route complex128 with \"triplet\" (KS): uscat(0) {e_u:.3e}, "
          f"density {e_d:.3e}; launches {c_fact} / {c_dense}")
    if not e_u <= 1e-4 or not e_d <= 1e-4:
        raise RuntimeError("(c) 'bcaa' factored off the dense route")
    t = torch.as_tensor(np.random.default_rng(3).normal(size=(5, 3)) * 1.8,
                        dtype=torch.float64, device=dev)
    k2 = torch.tensor([[1.1], [0.7]], dtype=torch.float64, device=dev)
    n_root = basis(bcaa, 4).n_root
    for kind in ("SR", "RR"):
        rot = translation_matrix(bcaa, t, 4, k2, kind=kind, method="rotation")
        band = (translation_matrix(bcaa, t, 4, k2, method="triplet") if kind == "SR" else
                _ops._sr_banded(bcaa, None, t, 4, 4, k2, "RR"))
        e = block_rel_err(torch, band, rot, n_root, n_root)[1]
        print(f"[10] (c) 'bcaa' n_end=4 {kind}: rotation against the band scan (KS) per "
              f"degree block {e:.3e}")
        if not e <= 1e-10:
            raise RuntimeError(f"(c) 'bcaa' rotation {kind} off the band scan")
    del fact, dense
    torch.cuda.empty_cache()

    # (d) the lattice route on 'caa': its half table from KS
    lat = square_lattice(N_SIDE_C, 4)
    if _core._route("auto", len(lat), len(lat) * basis(caa, N_END_C_LATTICE).num,
                    torch.float64, dev, True, False, lat) != "lattice":
        raise RuntimeError("(d) auto does not take the lattice route")
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_lat = solve(caa, torch.float64, 1.0, lat, N_END_C_LATTICE)
    u_lat = uscat0(on_lat)
    torch.cuda.synchronize()
    t_lat = time.perf_counter() - t0
    c_lat = read()
    require_launched(c_lat, ("band_sr",), "(d)")
    found = _lattice.lattice_routing
    _lattice.lattice_routing = lambda centers: None  # the offset table instead
    try:
        off = solve(caa, torch.float64, 1.0, lat, N_END_C_LATTICE, solver="matfree")
    finally:
        _lattice.lattice_routing = found
    e = rel(u_lat, uscat0(off))
    print(f"[10] (d) 'caa' {N_SIDE_C} x {N_SIDE_C} lattice, n_end={N_END_C_LATTICE}, complex128, "
          f"auto -> lattice: {t_lat:.3f} s, GMRES iters {on_lat.iters.tolist()}, relres "
          f"{float(on_lat.relres.max()):.3e}; uscat(0) {complex(u_lat[0]):.12f} against the "
          f"offset-table route (iters {off.iters.tolist()}): rel err {e:.3e}; launches {c_lat}")
    if not e <= 1e-8:
        raise RuntimeError("(d) the 'caa' lattice route is off the offset table")
    del on_lat, off
    torch.cuda.empty_cache()

    # (e) KS against its plain version in every mode and dtype
    t_e = np.random.default_rng(11).normal(size=(1, N_OFF_KS, 4))
    r_e = np.linalg.norm(cube[0] - cube[1:1 + N_OFF_KS], axis=1)
    for cdt in (torch.complex64, torch.complex128):
        name = str(cdt).split(".")[-1]
        rdt = torch.float32 if cdt == torch.complex64 else torch.float64
        f = dict(dtype=rdt, device=dev)
        tab = _ops._quad_tables(caa, N_END_KS, N_END_KS, rdt, dev)
        t_hat = torch.as_tensor(t_e / np.linalg.norm(t_e, axis=-1, keepdims=True), **f)
        kk = torch.as_tensor(ks[:2], **f)
        hm, he = spherical_h_scaled(4, tab.n_bands, kk[:, None] * torch.as_tensor(r_e, **f))
        h_e = tab.yo.shape[1]
        gen = np.random.default_rng(12)
        e_r = torch.as_tensor(-5.0 * gen.random((2, h_e)), **f)
        e_b = torch.as_tensor(-5.0 * gen.random((2, h_e)), **f)
        for mode, coef, extra in (
                ("unscaled", band_coefs(hm * torch.exp(he), 4, *_ops._band_consts(4)), ()),
                ("scaled", band_coefs(hm, 4, *_ops._band_consts(4), he=he), ()),
                ("fold", band_coefs(hm, 4, *_ops._band_consts(4), he=he), (he, e_r, e_b))):
            got = band_sr(coef, t_hat, tab, *extra)
            same = same_bits(torch, band_sr(coef, t_hat, tab, *extra), got)
            ref = _band_sr_plain(coef, t_hat, tab, *extra)
            err_abs, err = block_rel_err(torch, got, ref, tab.n_o_host, tab.n_i_host)
            ms = cuda_ms(torch, lambda: band_sr(coef, t_hat, tab, *extra), 3)
            plain_ms = cuda_ms(torch, lambda: _band_sr_plain(coef, t_hat, tab, *extra), 1)
            b = band_sr_bound(tab, 2, N_OFF_KS, name)
            print(f"[10] (e) KS {mode} {name} [2, {N_OFF_KS}, {h_e}, {h_e}] x {tab.w.shape[0]} "
                  f"nodes: {ms:.3f} ms (plain {plain_ms:.3f} ms), bound {b[0]:.4f} ms ({b[1]}); "
                  f"per degree block {err:.3e} (max abs {err_abs:.3e}); bits repeated {same}")
            if not same or not err <= {"complex64": 1e-4, "complex128": 1e-11}[name]:
                raise RuntimeError(f"(e) KS {mode} {name}: {err:.3e}, bits repeated {same}")
    return results, launches


def gd_bound(n_pair, n_end, name):
    """The ladders' bound for n_pair (k, radius) pairs: the radial column's
    3 n_end + 2 orders, the sectorial ladder (n_end - 1 steps of 3
    multiplies and an add per n' and real part) and the n-advance ladder
    (n_end - 1 steps of 4 multiplies and 2 adds per (m, n') and real part)
    at the CUDA cores' rate, or the [H, H] factors written (the column read
    once), the larger."""
    cs = 8 if name == "complex64" else 16
    npl, h = 3 * n_end + 2, n_end * n_end
    flops = n_pair * (n_end - 1) * 2 * npl * (4 + 6 * n_end)
    return bound(n_pair * (npl * cs + h * h * cs), flops, name)


def gumerov_and_surfaces(torch, dev, card):
    """Phase 11: the Gumerov-Duraiswami translation on each plain route of
    the bench lattice and the 32 x 32 lattice, the ladders alone on the
    card against the CPU, K5 at their 98 orders, and the radial surfaces
    (`regular_singular_component`, `potential_coef`) against the CPU, each
    path with the launch counts set to 0 just before it and read just
    after."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.biem import _core, potential_coef
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics import regular_singular_component
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
    from biem_helmholtz_sphere_tpu_torch.special._family import (
        _UNSCALED, _spherical_jh_all_plain, spherical_jh)
    from biem_helmholtz_sphere_tpu_torch.translation import _gumerov, gd_coaxial

    reset, read = kernel_counts()
    c = create_from_branching_types("ba")
    centers_np = lattice_centers()
    nb = len(centers_np)
    ks = sweep_ks()[:KB]
    n_sys = nb * N_END * N_END
    n_root = basis(c, N_END).n_root
    gum = dict(translational_coefficients_method="gumerov")
    with open(os.path.join(ROOT, "biem_helmholtz_sphere_tpu_torch", "data",
                           "bench_golden_f64.json")) as fh:
        golden = json.load(fh)["points"][:KB]

    def solve(rdt, n_end, **kw):
        f = dict(dtype=rdt, device=dev)
        kt = torch.as_tensor(ks, **f)
        uin, _ = plane_wave(k=kt, direction=torch.tensor([1.0, 0.0, 0.0], **f)[:, None]
                            .expand(3, KB))
        return biem(c, centers=torch.as_tensor(centers_np, **f).expand(KB, nb, 3),
                    radii=torch.ones(KB, nb, **f), k=kt, n_end=n_end, uin=uin, **kw)

    def uscat0(calc):
        x = torch.zeros(calc.c.c_ndim, 1, dtype=calc.radii.dtype, device=dev)
        return calc.uscat(x).reshape(-1).cpu().numpy()

    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))))

    # (a) the float64 bench with "gumerov": the offset-table route, its
    # (S|R) table by the ladders at the 9 distinct radii and the sandwich
    route = _core._route("auto", nb, n_sys, torch.float64, dev, True, False, centers_np)
    if route != "matfree":
        raise RuntimeError(f"(a) auto picks {route!r} for the float64 bench lattice")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    calc = solve(torch.float64, N_END, **gum)
    u0 = uscat0(calc)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[11] (a) bench lattice n_end={N_END} ({n_sys} unknowns), complex128, \"gumerov\", "
          f"default solver -> {route!r}: {dt:.3f} s for {KB} k, launches {launches}, peak "
          f"device memory {peak:.3f} GiB ({card})")
    if calc.matrix is not None or calc.relres is None:
        raise RuntimeError("(a) the default route formed the matrix or did not iterate")
    require_launched(launches, ("lane_gather", "lane_scatter", "spherical_jh"), "[11] (a)")
    if launches["coax_fold"] or launches["block_diag_cmm"]:
        raise RuntimeError(f"(a) the Gumerov route launched K2 or KB: {launches}")
    worst = float(calc.relres.max())
    print(f"[11] (a) GMRES iters {calc.iters.tolist()}, max relres {worst:.3e}")
    if not bool(torch.isfinite(calc.density).all()) or worst > 1e-11:
        raise RuntimeError(f"(a) relres {worst:.3e} > 1e-11 or non-finite density")
    ref = [complex(*g["uscat0"]) for g in golden]
    e_gold, e_6a = rel(u0, ref), rel(u0, SHARED["6a"])
    print(f"[11] (a) uscat(0) {[f'{u:.12f}' for u in u0]}: rel err against the JAX f64 golden "
          f"{e_gold:.3e}, against phase 6 (a)'s default translation {e_6a:.3e}")
    if any(abs(g["k"] - float(k)) > 1e-6 for g, k in zip(golden, ks)):
        raise RuntimeError("(a) the golden's k are not the sweep's")
    if not e_gold <= 1e-7 or not e_6a <= 1e-9:
        raise RuntimeError(f"(a) uscat(0) off the golden ({e_gold:.3e}) or 6 (a) ({e_6a:.3e})")
    res_max, res_mean = bc_residual(torch, calc)
    print(f"[11] (a) BC residual max {res_max:.3e} mean {res_mean:.3e}")
    if not res_max <= 1e-3:
        raise RuntimeError(f"(a) BC residual {res_max:.3e} > 1e-3")
    del calc
    torch.cuda.empty_cache()
    uniq, _, uniq_r, r_inv = _core._offsets(centers_np)
    kt = torch.as_tensor(ks, dtype=torch.float64, device=dev)
    tab_g = _core._offset_table(c, N_END, uniq, uniq_r, r_inv, kt, None, "gumerov")
    tab_d = _core._offset_table(c, N_END, uniq, uniq_r, r_inv, kt, None, None)
    _, err = block_rel_err(torch, tab_g, tab_d, n_root, n_root)
    print(f"[11] (a) the (S|R) table [{KB}, {len(uniq)}, {len(n_root)}, {len(n_root)}] "
          f"against phase 6 (a)'s (the band sum, K2): max rel err per (k, offset, degree "
          f"block) {err:.3e}")
    if not err <= 1e-10:
        raise RuntimeError(f"(a) the Gumerov table is off the default one by {err:.3e}")
    del tab_g, tab_d
    torch.cuda.empty_cache()
    stages = [(_core, "_rhs_dispatch", "RHS"), (_core, "_radial_rows", "radial rows"),
              (_gumerov, "gd_coaxial", "ladders (K5 + the two ladders)"),
              (_gumerov, "spherical_jh_all", "K5 column"),
              (_gumerov, "_sandwich", "sandwich"), (_core, "gmres_solve_op", "GMRES"),
              (_core, "_table_product", "table product (pad, bmm, unpad)"),
              (_core, "lane_gather", "KC gather"), (_core, "lane_scatter", "KC scatter"),
              (_core.BIEMResultCalculator, "uscat", "uscat(0)")]
    acc, total = split_stages(torch, lambda: uscat0(solve(torch.float64, N_END, **gum)), stages)
    nested = ("table product (pad, bmm, unpad)", "KC gather", "KC scatter")
    acc["GMRES (rest)"] = acc.pop("GMRES") - sum(acc.get(n, 0.0) for n in nested)
    acc["ladders (rest)"] = acc.pop(stages[2][2]) - acc.get("K5 column", 0.0)
    labels = ["RHS", "radial rows", "K5 column", "ladders (rest)", "sandwich",
              "GMRES (rest)", *nested, "uscat(0)"]
    print(f"[11] (a) complex128 Gumerov offset-table GMRES stage split, s per k-block of {KB} "
          f"(synchronising timers): {format_split(acc, total, labels, 1)} ({card})")

    # (b) the LU tier, complex128, stable=False: "gumerov" against the default
    n_lu = nb * N_END_LU * N_END_LU
    route = _core._route("auto", nb, n_lu, torch.float64, dev, True, False, centers_np)
    if route != "lu":
        raise RuntimeError(f"(b) auto picks {route!r} for the n_end={N_END_LU} lattice")
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    calc = solve(torch.float64, N_END_LU, stable=False, **gum)
    u_b = uscat0(calc)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read()
    e_b = rel(u_b, SHARED["5b"])
    print(f"[11] (b) lattice n_end={N_END_LU} ({n_lu} unknowns), complex128 stable=False "
          f"\"gumerov\", auto -> LU: {dt:.3f} s, launches {counts}; uscat(0) against phase 5 "
          f"(b)'s default translation rel err {e_b:.3e} ({card})")
    if calc.relres is not None or calc.matrix is None:
        raise RuntimeError("(b) the default solver did not take the direct LU")
    require_launched(counts, ("dense_assemble", "spherical_jh"), "[11] (b)")
    if counts["coax_fold"] or not bool(torch.isfinite(calc.density).all()) or not e_b <= 1e-9:
        raise RuntimeError(f"(b) K2 launched or uscat(0) off by {e_b:.3e}: {counts}")
    del calc
    torch.cuda.empty_cache()

    # (c) the 32 x 32 'ba' lattice at n_end=19, complex128, "gumerov": the
    # lattice route, its half table by the ladders
    cen3 = square_lattice(N_SIDE_3D, 3)
    n3 = len(cen3) * N_END_3D * N_END_3D
    route = _core._route("auto", len(cen3), n3, torch.float64, dev, True, False, cen3)
    if route != "lattice":
        raise RuntimeError(f"(c) auto picks {route!r} for the {N_SIDE_3D}^2 lattice")
    f64 = dict(dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    calc = biem(c, centers=torch.as_tensor(cen3, **f64), radii=torch.ones(len(cen3), **f64),
                k=torch.tensor(1.0, **f64), n_end=N_END_3D,
                uin=plane_wave(k=torch.tensor(1.0, **f64),
                               direction=torch.tensor([1.0, 0.0, 0.0], **f64))[0], **gum)
    u_c = complex(uscat0(calc)[0])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    relres = float(calc.relres.max())
    e_c = abs(u_c - SHARED["9a"]) / abs(SHARED["9a"])
    print(f"[11] (c) 'ba' {N_SIDE_3D}x{N_SIDE_3D} lattice n_end={N_END_3D} ({n3} unknowns), "
          f"complex128 \"gumerov\" -> lattice: {dt:.3f} s (cold), {int(calc.iters.max())} GMRES "
          f"steps, relres {relres:.3e}, uscat(0) {u_c:.12f}, against phase 9 (a)'s complex128 "
          f"rel err {e_c:.3e}, peak {peak:.3f} GiB; launches {counts} ({card})")
    require_launched(counts, ("spherical_jh", "fused_ba_eval_few"), "[11] (c)")
    if counts["coax_fold"] or counts["block_diag_cmm"] or counts["graf_fold"]:
        raise RuntimeError(f"(c) the Gumerov lattice launched K2, KB or KG: {counts}")
    if not bool(torch.isfinite(calc.density).all()) or relres > 1e-11 or not e_c <= 1e-8:
        raise RuntimeError(f"(c) relres {relres:.3e} or uscat(0) off by {e_c:.3e}")
    del calc
    torch.cuda.empty_cache()

    # (d) the ladders alone at (a)'s 4 k x 9 radii, on the card against the CPU
    for cdt in (torch.complex128, torch.complex64):
        name = str(cdt).split(".")[-1]
        rdt = torch.float64 if cdt == torch.complex128 else torch.float32
        r_d = torch.as_tensor(uniq_r, dtype=rdt, device=dev)
        k_d = torch.as_tensor(ks, dtype=rdt, device=dev)[:, None]
        reset()
        got = gd_coaxial(c, r_d, N_END, k_d)
        n_k5 = read()["spherical_jh"]
        ref = gd_coaxial(c, r_d.cpu(), N_END, k_d.cpu()).to(dev)
        _, err = block_rel_err(torch, got, ref, n_root, n_root)
        ms = cuda_ms(torch, lambda: gd_coaxial(c, r_d, N_END, k_d), 10)
        z = (k_d * r_d).to(cdt)
        ms_k5 = cuda_ms(torch, lambda: spherical_jh(_UNSCALED, 3, 3 * N_END + 2, z), 10)
        b = gd_bound(z.numel(), N_END, name)
        npl, cs = 3 * N_END + 2, 8 if name == "complex64" else 16
        b_k5 = bound(z.numel() * cs + z.numel() * npl * 4 * cs,
                     z.numel() * (15 * (3 * npl + 36) + 40 * npl), name)
        tol = GD_TOL["SR", name]
        print(f"[11] (d) gd_coaxial {name} at {KB} k x {len(uniq_r)} radii, n_end={N_END} "
              f"({3 * N_END + 2} orders): card against CPU max rel err per (k, radius, degree "
              f"block) {err:.3e} (gate {tol:g}); {ms:.4f} ms ({n_k5} K5 launch; the K5 column "
              f"alone {ms_k5:.4f} ms, bound {b_k5[0]:.6f} ms ({b_k5[1]})), bound {b[0]:.6f} ms "
              f"({b[1]}) ({card})")
        if n_k5 != 1 or not err <= tol:
            raise RuntimeError(f"(d) gd_coaxial {name}: {err:.3e}, K5 launches {n_k5}")
        got = gd_coaxial(c, r_d, N_END, k_d, kind="RR")
        ref = gd_coaxial(c, r_d.cpu(), N_END, k_d.cpu(), kind="RR")
        ref64 = gd_coaxial(c, r_d.cpu().double(), N_END, k_d.cpu().double(), kind="RR")
        fl = dict(floor=GD_RR_FLOOR)
        err = block_rel_err(torch, got, ref.to(dev), n_root, n_root, **fl)[1]
        if name == "complex128":  # the ladder's conditioning: radii one ulp longer
            nudge = gd_coaxial(c, r_d.cpu() * (1 + 2.0**-52), N_END, k_d.cpu(), kind="RR")
            cond = block_rel_err(torch, nudge, ref, n_root, n_root, **fl)[1]
            extra, ok = f"radii one ulp longer move the CPU table by {cond:.3e}", True
        else:
            e64 = block_rel_err(torch, got.to(ref64.dtype).cpu(), ref64, n_root, n_root, **fl)[1]
            own = block_rel_err(torch, ref.to(ref64.dtype), ref64, n_root, n_root, **fl)[1]
            extra = (f"against float64 {e64:.3e}, the CPU float32 table's own {own:.3e} (gate "
                     f"{GD_RR_F64_FACTOR:g}x)")
            ok = e64 <= GD_RR_F64_FACTOR * own
        tol = GD_TOL["RR", name]
        print(f"[11] (d) gd_coaxial (R|R) {name}, the same shapes: card against CPU max rel err "
              f"per (k, radius, degree block), blocks below {GD_RR_FLOOR:g} of the table "
              f"against that, {err:.3e} (gate {tol:g}); {extra} ({card})")
        if not (err <= tol and ok):
            raise RuntimeError(f"(d) gd_coaxial RR {name}: {err:.3e}; {extra}")
        del got, ref, ref64
        torch.cuda.empty_cache()

    # (e) K5 at the ladders' 98 orders, then the radial surfaces, on the
    # card against the CPU: (a)'s kr (28-153) and (c)'s (4-17, past
    # float32's range at the top orders: the same non-finite entries)
    npl = 3 * N_END + 2
    for cdt in (torch.complex128, torch.complex64):
        name = str(cdt).split(".")[-1]
        rdt = torch.float64 if cdt == torch.complex128 else torch.float32
        for label, kv in (("(a)", ks), ("(c)", np.ones(1))):
            z = (torch.as_tensor(kv, dtype=rdt, device=dev)[:, None]
                 * torch.as_tensor(uniq_r, dtype=rdt, device=dev)).to(cdt)
            got = spherical_jh(_UNSCALED, 3, npl, z)
            ref = _spherical_jh_all_plain(3, npl, z)
            # every output relative above 1 (finite where the plain one is);
            # entry by entry relative where |plain| is normal: h and h' (what
            # the (S|R) ladders read) in both dtypes, j and j' in complex128
            # only: at these orders the float32 j_n(kr) are far below 1 (j_97(28)
            # ~ 1e-44) and the plain version's own float32 j, j' are up to
            # 2e-3 and 1.0 off its float64 ones, so two float32 runs of them
            # agree to no set relative tolerance.  In complex64 every output is
            # instead held against the float64 plain version, where that is a
            # normal float32: within K5_F64_FACTOR of the plain float32
            # version's own error there
            tiny = torch.finfo(rdt).tiny
            e_abs = max(unscaled_err(torch, g, r)[0] for g, r in zip(got, ref))
            rels = [float(((g - r).abs()[m] / r.abs()[m]).max())
                    for g, r, m in ((g, r, torch.isfinite(r) & (r.abs() >= tiny))
                                    for g, r in zip(got, ref))]
            ref64 = _spherical_jh_all_plain(3, npl, z.to(torch.complex128))

            def err64(x, r, r64):
                e = (x.to(r64.dtype) - r64).abs() / r64.abs()
                return float(e[torch.isfinite(r) & (r64.abs() >= tiny)].max())

            own = [err64(r, r, r64) for r, r64 in zip(ref, ref64)]
            k5_64 = [err64(g, r, r64) for g, r, r64 in zip(got, ref, ref64)]
            gated = rels[2:] if name == "complex64" else rels
            n_inf = int((~torch.isfinite(got[2])).sum())
            print(f"[11] (e) K5 unscaled {name} at {label}'s {z.numel()} kr x {npl} orders: "
                  f"max_abs_err {e_abs:.3e} (relative above 1); max_rel_err (normal values) "
                  f"j {rels[0]:.3e} j' {rels[1]:.3e} h {rels[2]:.3e} h' {rels[3]:.3e}; against "
                  f"float64 (where a normal float32) K5 j {k5_64[0]:.3e} j' {k5_64[1]:.3e} h "
                  f"{k5_64[2]:.3e} h' {k5_64[3]:.3e}, the plain version's own j {own[0]:.3e} j' "
                  f"{own[1]:.3e} h {own[2]:.3e} h' {own[3]:.3e}; {n_inf} h entries not finite, "
                  f"where the plain version's are not")
            if not max(e_abs, *gated) <= TOL_REL[name]:
                raise RuntimeError(f"(e) K5 at {npl} orders {name}: err {e_abs:.3e} / {rels}")
            if name == "complex64" and not all(
                    e <= K5_F64_FACTOR * o for e, o in zip(k5_64, own)):
                raise RuntimeError(f"(e) K5 at {npl} orders {name} against float64: {k5_64}, "
                                   f"the plain version's own {own}")
        f = dict(dtype=rdt, device=dev)
        r_e = torch.as_tensor(uniq_r, **f)[None, :] / 4.0
        k_e = torch.as_tensor(ks, **f)[:, None]
        worst = 0.0
        for tree in ("ba", "bba"):
            ct = create_from_branching_types(tree)
            for typ in ("regular", "singular"):
                for der in (False, True):
                    got = regular_singular_component(ct, r_e, 16, k_e, type=typ, derivative=der)
                    ref = regular_singular_component(ct, r_e.cpu(), 16, k_e.cpu(), type=typ,
                                                     derivative=der)
                    worst = max(worst, unscaled_err(torch, got, ref.to(dev))[0])
        n_deg = torch.arange(16, device=dev)[:, None]
        one = torch.ones((), **f)
        for d in (2, 3, 4):
            for kk in (k_e[:, 0], k_e[:, 0] + 0.1j):
                for der in ("S", "D"):
                    for ff in ("solution", "harmonics"):
                        got = potential_coef(n_deg, d, kk, one, 1.5 * one, der, for_func=ff)
                        ref = potential_coef(n_deg.cpu(), d, kk.cpu(), one.cpu(), 1.5 * one.cpu(),
                                             der, for_func=ff)
                        worst = max(worst, unscaled_err(torch, got, ref.to(dev))[0])
        print(f"[11] (e) regular_singular_component ('ba', 'bba' x 4 cases) and potential_coef "
              f"(d = 2, 3, 4, real and complex k, S/D x solution/harmonics) {name}, card against "
              f"CPU: max err {worst:.3e} (relative above 1)")
        if not worst <= TOL_REL[name]:
            raise RuntimeError(f"(e) the radial surfaces {name}: err {worst:.3e}")
    return launches


N_END_SHARDED = 19  # phase 12: the dense solve's n_end (16 x 361 = 5,776 unknowns)
SHARDED_TOL = {"sweep": 1e-4, "dense": 1e-8, "matfree": 1e-10, "lattice": 1e-10}


def sharded_paths(torch, dev, world, device_mesh, stats):
    """The paths of parallel/ at full width, on this process's rank of a
    world-size group (phase 12): the bench sweep (complex64, the 8 ks of
    phase 4), the points at 131,072 (rank 0's share), then in complex128
    the dense solve at n_end=19, the offset table at the bench and phase 9
    (a)'s lattice.  Returns {path: result on the host}; stats gets each
    path's `_stats`."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.parallel import (
        make_mesh, sharded_solve, sharded_sweep, sharded_uscat)

    ba = create_from_branching_types("ba")
    out = {}
    for rdt in (torch.float32, torch.float64):
        f = dict(dtype=rdt, device=dev)
        centers = torch.as_tensor(lattice_centers(), **f)
        radii = torch.ones(len(centers), **f)
        direction = torch.tensor([1.0, 0.0, 0.0], **f)
        if rdt == torch.float32:
            st = stats["sweep"] = {}
            out["sweep"] = sharded_sweep(
                ba, centers=centers, radii=radii, ks=torch.as_tensor(sweep_ks()[: 2 * KB], **f),
                n_end=N_END, direction=direction, _stats=st,
                mesh=make_mesh(world, ("sweep",), device=device_mesh)).cpu()
            k0 = torch.tensor(K0, **f)
            uin, _ = plane_wave(k=k0, direction=direction)
            calc = biem(ba, centers=centers, radii=radii, k=k0, n_end=N_END, uin=uin)
            st = stats["points"] = {}
            out["points"] = sharded_uscat(calc, eval_points(torch, dev), _stats=st,
                                          mesh=make_mesh(world, ("points",),
                                                         device=device_mesh)).cpu()
            continue
        solves = {"dense": (ba, centers, N_END_SHARDED, {}),
                  "matfree": (ba, centers, N_END, {"matfree": True}),
                  "lattice": (ba, square_lattice(N_SIDE_3D, 3), N_END_3D, {"lattice": True})}
        for name, (c, cen, n_end, kw) in solves.items():
            st = stats[name] = {}
            k = torch.tensor(1.0 if name == "lattice" else float(sweep_ks()[0]), **f)
            out[name] = sharded_solve(
                c, centers=cen, radii=torch.ones(len(cen), **f), k=k, n_end=n_end,
                direction=direction, mesh=make_mesh(world, ("rows",), device=device_mesh),
                _stats=st, **kw).cpu()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    return out


def sharded_no_host_sync(torch, dev):
    """Phase 12 (a)'s sharded solves in complex128 (dense, the offset table,
    the lattice) on the one-rank NCCL group, untimed (`_stats` times the
    collectives between device synchronizations), each with its GMRES under
    `no_host_sync`."""
    from biem_helmholtz_sphere_tpu_torch import parallel
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

    ba = create_from_branching_types("ba")
    f = dict(dtype=torch.float64, device=dev)
    direction = torch.tensor([1.0, 0.0, 0.0], **f)
    for name, cen, n_end, kw in (
            ("dense", lattice_centers(), N_END_SHARDED, {}),
            ("offset table", lattice_centers(), N_END, {"matfree": True}),
            ("lattice", square_lattice(N_SIDE_3D, 3), N_END_3D, {"lattice": True})):
        k = torch.tensor(1.0 if name == "lattice" else float(sweep_ks()[0]), **f)
        no_host_sync(torch, parallel, lambda: parallel.sharded_solve(
            ba, centers=cen, radii=torch.ones(len(cen), **f), k=k, n_end=n_end,
            direction=direction, mesh=parallel.make_mesh(1, ("rows",), device="cuda"), **kw),
            f"[12] (a) sharded_solve, {name}, one NCCL rank")
        torch.cuda.empty_cache()


def eval_points(torch, dev):
    """Phase 4's 131,072 field points (float32)."""
    return torch.as_tensor(
        np.random.default_rng(0).normal(size=(3, EVAL_POINTS)).astype(np.float32) * 20.0,
        device=dev)


def _two_ranks_on_one_card(rank, world, device, out_dir):
    """Phase 12 (b): one of two gloo ranks with CUDA tensors on one card."""
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    out = sharded_paths(torch, dev, world, "cuda", stats)
    torch.save({"out": out, "stats": stats, "peak": torch.cuda.max_memory_allocated()},
               os.path.join(out_dir, f"rank{rank}.pt"))


def format_comm_split(stats):
    return ", ".join(
        f"{name} {st['total_s']:.4f} s ({st['total_s'] - st['collective_s']:.4f} compute, "
        f"{st['collective_s']:.4f} in {sum(st['collectives'].values())} collectives)"
        for name, st in stats.items())


def kd_window(torch, dev, card):
    """KD's row window against KD's whole matrix (entry for entry) and its
    plain version, at the dense path's shapes (the 4x4 lattice, n_end=19,
    [B, H, B', H']), timed with its bound: the half window of two ranks.
    Returns KD's row-window results by dtype name."""
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.biem._core import _assembly_parts
    from biem_helmholtz_sphere_tpu_torch.ops.dense import _dense_assemble_plain, dense_assemble

    results = {}
    for cdt in (torch.complex64, torch.complex128):
        name = str(cdt).split(".")[-1]
        rdt = torch.float32 if cdt == torch.complex64 else torch.float64
        f = dict(dtype=rdt, device=dev)
        nb = N_SIDE * N_SIDE
        parts = _assembly_parts(
            create_from_branching_types("ba"), N_END_SHARDED, lattice_centers(),
            torch.ones(1, nb, **f), torch.tensor([float(sweep_ks()[0])], **f),
            torch.ones(1, **f), torch.ones(1, nb, dtype=cdt, device=dev),
            torch.zeros(1, nb, dtype=cdt, device=dev), stable=rdt == torch.float32)
        h = parts[2].shape[-1]
        n = nb * h
        whole = dense_assemble(*parts).reshape(1, n, n)
        for r0, r1 in ((0, n // 2), (n // 2, n), (n // 6, n // 2 + 1), (h - 5, h + 7)):
            got = dense_assemble(*parts, rows=(r0, r1))
            if not torch.equal(got.reshape(1, r1 - r0, n), whole[:, r0:r1]):
                raise RuntimeError(f"[12] KD rows [{r0}, {r1}) {name}: differ from the whole "
                                   "matrix's")
            if not torch.equal(got, _dense_assemble_plain(*parts, False, (r0, r1))):
                raise RuntimeError(f"[12] KD rows [{r0}, {r1}) {name}: differ from the plain "
                                   "version")
            if not same_bits(torch, dense_assemble(*parts, rows=(r0, r1)), got):
                raise RuntimeError(f"[12] KD rows [{r0}, {r1}) {name}: two launches differ")
        rows = (0, n // 2)
        ms = cuda_ms(torch, lambda: dense_assemble(*parts, rows=rows), 10)
        pms = cuda_ms(torch, lambda: _dense_assemble_plain(*parts, False, rows), 3)
        whole_ms = cuda_ms(torch, lambda: dense_assemble(*parts), 10)
        item = parts[2].element_size()
        n_off = parts[0].shape[1]
        nbytes = (n // 2) * n * item + n_off * h * h * item + 3 * nb * h * item
        b = bound(nbytes, 12.0 * (n // 2) * n, name)
        us = device_us(torch, lambda: dense_assemble(*parts, rows=rows), "dense_assemble")
        print(f"[12] KD row window, rows [0, {n // 2}) of the {n} x {n} matrix (4x4 lattice, "
              f"n_end={N_END_SHARDED}, {name}): {ms:.4f} ms (device {us:.2f} us a launch; the "
              f"whole matrix {whole_ms:.4f} ms), plain {pms:.4f} ms, bound {b[0]:.6f} ms "
              f"({b[1]}); equal entry for entry to the whole matrix's rows and to its plain "
              f"version at 4 windows, bits repeated ({card})")
        results[name] = {"ms": ms, "plain_ms": pms, "abs": 0.0, "rel": 0.0, "bound_ms": b[0],
                         "bound_by": b[1], "library_ms": None, "device_us": us}
    return results


def profile_kernels(torch, fn, kernel):
    """(device microseconds, launches, names) of the kernels whose names
    hold `kernel` over 5 calls of fn under torch.profiler.  A window whose
    trace holds no such kernel (the profiler has dropped a short kernel's
    events) is profiled again, up to four windows.  Where every window
    misses it (CUPTI has been seen to drop a kernel's records for the rest
    of a process), the 5 calls are timed between CUDA events instead (the
    call's whole time: an upper bound on the kernel's) and the launches
    are the wrappers' own counts over them; the line printed says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if kernel in e.key]
        if evs:
            total = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                        for e in evs)
            return total, sum(e.count for e in evs), sorted({e.key for e in evs})
        seen = sorted({e.key for e in prof.key_averages()})
    _, read = kernel_counts()
    before = read()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        fn()
    end.record()
    end.synchronize()
    count = sum(read().values()) - sum(before.values())
    if count < 1:
        raise RuntimeError(f"torch.profiler saw no {kernel} kernel and no wrapper counted a launch")
    print(f"[2] torch.profiler saw no {kernel} kernel in 4 windows of 5 calls (the last window "
          f"held {len(seen)} other kernel names: {seen[:4]}); timed between CUDA events "
          f"instead, {count} launches by the wrappers' counts")
    return start.elapsed_time(end) * 1e3, count, [f"{kernel}* (CUDA events)"]


def device_us(torch, fn, kernel, per_call=False):
    """Mean device microseconds of the kernel whose name holds `kernel`
    over 5 calls of fn (profile_kernels): per launch, or per call of fn
    (per_call; a call that launches it several times)."""
    total, count, _ = profile_kernels(torch, fn, kernel)
    return total / (5 if per_call else count)


def parallel_and_frontends(torch, dev, card):
    """Phase 12: parallel/ on the card at full width and the CLI.
    Returns (KD row-window results, launches of the main paths)."""
    import tempfile

    import torch.distributed as dist

    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.parallel._dryrun import spawn_ranks

    reset, read = kernel_counts()
    kd = kd_window(torch, dev, card)
    ba = create_from_branching_types("ba")

    # (a) a one-rank NCCL group in this process
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            torch.cuda.synchronize()
            reset()
            one = sharded_paths(torch, dev, 1, "cuda", stats)
            torch.cuda.synchronize()
            counts = read()
            sharded_no_host_sync(torch, dev)
        finally:
            dist.destroy_process_group()
    require_launched(counts, ["fused_ba_eval", "fused_ba_eval_few", "block_diag_cmm",
                              "lane_gather", "lane_scatter", "spherical_jh", "coax_fold",
                              "dense_assemble", "arnoldi_step", "gmres_backsolve"], "[12] (a)")
    f = dict(dtype=torch.float32, device=dev)
    centers = torch.as_tensor(lattice_centers(), **f)
    nb = len(centers)
    ks = torch.as_tensor(sweep_ks()[: 2 * KB], **f)
    direction = torch.tensor([1.0, 0.0, 0.0], **f)
    uin, _ = plane_wave(k=ks, direction=direction[:, None].expand(3, len(ks)))
    ref = biem(ba, centers=centers.expand(len(ks), nb, 3), radii=torch.ones(len(ks), nb, **f),
               k=ks, n_end=N_END, uin=uin, eta=torch.ones(len(ks), **f))
    u_ref = ref.uscat(torch.zeros(3, 1, **f))[0].cpu()
    if not same_bits(torch, one["sweep"], u_ref):
        raise RuntimeError("[12] (a): sharded_sweep differs from biem() on the same 8 ks")
    k0 = torch.tensor(K0, **f)
    uin, _ = plane_wave(k=k0, direction=direction)
    calc = biem(ba, centers=centers, radii=torch.ones(nb, **f), k=k0, n_end=N_END, uin=uin)
    if not same_bits(torch, one["points"], calc.uscat(eval_points(torch, dev)).cpu()):
        raise RuntimeError("[12] (a): sharded_uscat differs from calc.uscat")
    print(f"[12] (a) one-rank NCCL group: sharded_sweep on the bench (16 spheres, n_end={N_END}, "
          f"complex64, 8 ks) bit for bit biem() on the 8 ks in one call; sharded_uscat at "
          f"{EVAL_POINTS} points bit for bit calc.uscat; the dense (n_end={N_END_SHARDED}), "
          f"offset-table (n_end={N_END}) and lattice ({N_SIDE_3D}x{N_SIDE_3D}, n_end="
          f"{N_END_3D}) solves in complex128; launches {counts}")
    ref_dens = reference_densities(torch, dev)
    check_densities(torch, one, ref_dens, "(a)")
    print(f"[12] (d) (a)'s split, s per call: {format_comm_split(stats)} ({card})")

    # (b) two gloo ranks with CUDA tensors on the one card
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_ranks(_two_ranks_on_one_card, 2, tmp, "cuda", tmp, backend="gloo")
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    for name in ("sweep", "points", "dense", "matfree", "lattice"):
        if not same_bits(torch, ranks[0]["out"][name], ranks[1]["out"][name]):
            raise RuntimeError(f"[12] (b): the two ranks' {name} differ")
    e_sweep = float(((ranks[0]["out"]["sweep"] - one["sweep"]).abs() / one["sweep"].abs()).max())
    if not e_sweep <= SHARDED_TOL["sweep"]:
        raise RuntimeError(f"[12] (b): the sweep is {e_sweep:.3e} from (a)'s")
    check_densities(torch, ranks[0]["out"], ref_dens, "(b)")
    for name in ("dense", "matfree", "lattice"):
        for r, res in enumerate(ranks):
            mine, whole = res["stats"][name]["bytes"], res["stats"][name]["whole_bytes"]
            if not mine <= 0.55 * whole:
                raise RuntimeError(f"[12] (b) rank {r}: {name} holds {mine} of {whole} bytes")
    print(f"[12] (b) two gloo ranks with CUDA tensors on one card ({wall:.1f} s with the "
          f"spawn): the sweep within {e_sweep:.2e} of (a), the ranks bit for bit equal; per-rank "
          "operator bytes (of the whole): " + ", ".join(
              f"{n} {ranks[0]['stats'][n]['bytes'] / 2**20:.1f} MiB "
              f"({ranks[0]['stats'][n]['bytes'] / ranks[0]['stats'][n]['whole_bytes']:.3f})"
              for n in ("dense", "matfree", "lattice"))
          + "; per-rank peak " + " / ".join(f"{res['peak'] / 2**30:.3f} GiB" for res in ranks))
    for r, res in enumerate(ranks):
        print(f"[12] (d) (b) rank {r}'s split, s per call: {format_comm_split(res['stats'])} ({card})")

    # (c) the CLI on the card
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run_cli("accuracy", "--mode", "n_balls", "--branching-types", "ba", "--dtype",
                "float32", "--n-balls-min-log4", "4", "--n-balls-max-log4", "4",
                "--n-end-min-log2", "4.25", "--n-end-max-log2", "4.25", "--out-dir", tmp)
        acc_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "accuracy.csv")) as fh:
            lines = fh.read().splitlines()
    head, rows = lines[0].split(","), [r.split(",") for r in lines[1:]]
    if len(rows) != 1:
        raise RuntimeError(f"[12] (c): accuracy wrote {len(rows)} rows")
    row = dict(zip(head, rows[0]))
    u_cli = complex(float(row["uscat_real"]), float(row["uscat_imag"]))
    e_cli = abs(u_cli - SHARED["9a64"]) / abs(SHARED["9a64"])
    print(f"[12] (c) accuracy --mode n_balls (1,024 'ba' spheres, n_end={row['n_end']}, "
          f"float32): uscat(0) {u_cli:.8f}, {e_cli:.2e} from phase 9 (a)'s complex64, "
          f"{row['solve_iters']} GMRES steps, relres {row['solve_relres']}, device "
          f"{row['device']}, {row['seconds']} s in the row ({acc_s:.1f} s with the process)")
    if row["n_end"] != "19" or row["n_balls"] != "1024" or not e_cli <= 1e-4:
        raise RuntimeError(f"[12] (c): accuracy row {row}")
    t0 = time.perf_counter()
    bench = run_cli("bench").strip().splitlines()[-1]
    print(f"[12] (c) bench at its defaults: {bench} ({time.perf_counter() - t0:.1f} s with "
          f"the process; {card})")
    if "per k-point" not in bench or "cuda:" not in bench:
        raise RuntimeError(f"[12] (c): bench printed {bench!r}")
    return kd, counts


def run_cli(*args):
    """`python -m biem_helmholtz_sphere_tpu_torch *args` from the checkout:
    its standard output; raise with its errors if it fails."""
    out = subprocess.run([sys.executable, "-m", "biem_helmholtz_sphere_tpu_torch", *args],
                         cwd=ROOT, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"[12] (c): {' '.join(args[:1])} exited {out.returncode}: "
                           f"{out.stderr[-3000:]}")
    return out.stdout


def reference_densities(torch, dev):
    """The single-device references of phase 12's complex128 solves: dense
    GMRES at n_end=19, the offset table at the bench, and phase 9 (a)'s
    lattice density (its complex128 solve)."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

    f = dict(dtype=torch.float64, device=dev)
    ba = create_from_branching_types("ba")
    centers = torch.as_tensor(lattice_centers(), **f)
    k = torch.tensor(float(sweep_ks()[0]), **f)
    uin, _ = plane_wave(k=k, direction=torch.tensor([1.0, 0.0, 0.0], **f))
    out = {}
    for name, n_end, solver in (("dense", N_END_SHARDED, "gmres"), ("matfree", N_END, "matfree")):
        calc = biem(ba, centers=centers, radii=torch.ones(len(centers), **f), k=k, n_end=n_end,
                    uin=uin, solver=solver)
        if name == "matfree" and calc.matrix is not None:
            raise RuntimeError("[12]: the matfree reference formed a matrix")
        out[name] = calc.density.cpu()
        del calc
        torch.cuda.empty_cache()
    out["lattice"] = SHARED["9a density"]
    return out


def check_densities(torch, got, ref, label):
    for name in ("dense", "matfree", "lattice"):
        e = float((got[name] - ref[name]).abs().max() / ref[name].abs().max())
        print(f"[12] {label} sharded_solve {name}: {e:.3e} of the largest entry from its "
              f"single-device reference (gate {SHARDED_TOL[name]:g})")
        if not e <= SHARDED_TOL[name]:
            raise RuntimeError(f"[12] {label}: sharded_solve {name} is {e:.3e} off")



def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from biem_helmholtz_sphere_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on")
    dev = torch.device("cuda", 0)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[0] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.library()
    print(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({kernels.library_path().name} from {', '.join(kernels.SOURCES)})")
    print(f"[1] launch latency {launch_latency_us(torch, dev):.2f} us per launch of a "
          f"trivial kernel, back to back ({card})")

    results = check_kernels(torch, dev, card)
    results["block_diag_cmm_panels"] = check_kb_panels(torch, dev, card)
    results["harmonic_eval"] = check_ke(torch, dev, card)
    results["rotation_blocks"] = check_k3(torch, dev, card)
    results["coax_u"] = check_ku(torch, dev, card)
    results.update(check_k6(torch, dev, card))
    results["plane_wave_rhs"] = check_kr(torch, dev, card)
    readme_golden(torch, dev)
    launches = bench_config(torch, dev, card)
    launches.update(dense_assemble=dense_route(torch, dev, card)["dense_assemble"])
    matfree_route(torch, dev, card)
    launches["harmonic_eval"] = complex_and_trees(torch, dev, card)["harmonic_eval"]
    launches["block_diag_cmm_panels"] = four_d(torch, dev, card)["block_diag_cmm_panels"]
    results["graf_fold"], launches["graf_fold"] = n_balls_family(torch, dev, card)
    c_results, c_launches = c_trees(torch, dev, card)
    results.update(c_results)
    launches.update(c_launches)
    gumerov_and_surfaces(torch, dev, card)
    results["dense_assemble_rows"], p_launches = parallel_and_frontends(torch, dev, card)
    launches["dense_assemble_rows"] = p_launches["dense_assemble"]

    sources = {
        "fused_ba_eval": ("csrc/fused_ba_eval.cu",
                          "biem_helmholtz_sphere_tpu/biem/_eval_fused.py:114"),
        "fused_ba_eval_few": ("csrc/fused_ba_eval.cu",
                              "biem_helmholtz_sphere_tpu/biem/_eval_fused.py:114"),
        "block_diag_cmm": ("csrc/block_diag_cmm.cu",
                           "biem_helmholtz_sphere_tpu/biem/_core.py:640"),
        # the same kernel's row-panel mode on the 4D path (phase 8 (a))
        "block_diag_cmm_panels": ("csrc/block_diag_cmm.cu",
                                  "biem_helmholtz_sphere_tpu/biem/_core.py:640"),
        "lane_gather": ("csrc/lane_route.cu",
                        "biem_helmholtz_sphere_tpu/biem/_core.py:632"),
        "lane_scatter": ("csrc/lane_route.cu",
                         "biem_helmholtz_sphere_tpu/biem/_core.py:647"),
        "spherical_jh": ("csrc/spherical_jh.cu",
                         "biem_helmholtz_sphere_tpu/special/_family.py:215"),
        "coax_fold": ("csrc/coax_fold.cu",
                      "biem_helmholtz_sphere_tpu/translation/_scaled.py:86"),
        "dense_assemble": ("csrc/dense_assemble.cu",
                           "biem_helmholtz_sphere_tpu/biem/_core.py:826"),
        # the same kernel's row window on the row-sharded solve (phase 12)
        "dense_assemble_rows": ("csrc/dense_assemble.cu",
                                "biem_helmholtz_sphere_tpu/parallel/__init__.py:279"),
        "graf_fold": ("csrc/graf_fold.cu",
                      "biem_helmholtz_sphere_tpu/translation/_scaled.py:58"),
        "band_sr": ("csrc/band_sr.cu",
                    "biem_helmholtz_sphere_tpu/translation/_ops.py:160"),
        # KS's F pass: the band kernel's prefix F_N of the same band scan
        "band_f": ("csrc/band_sr.cu",
                   "biem_helmholtz_sphere_tpu/translation/_ops.py:160"),
        # the general evaluation's near field (phase 7 (c)'s launches)
        "harmonic_eval": ("csrc/harmonic_eval.cu",
                          "biem_helmholtz_sphere_tpu/biem/_eval.py:146"),
        # the rotation D (phase 4's first block)
        "rotation_blocks": ("csrc/rotation_blocks.cu",
                            "biem_helmholtz_sphere_tpu/translation/_rotation.py:251"),
        # the coax band tables U (phase 4's first block)
        "coax_u": ("csrc/coax_u.cu", "biem_helmholtz_sphere_tpu/translation/_scaled.py:135"),
        # GMRES's Arnoldi step and back-substitution (phase 4's sweep)
        "arnoldi_step": ("csrc/gmres_step.cu", "biem_helmholtz_sphere_tpu/ops/cplx.py:569"),
        "gmres_backsolve": ("csrc/gmres_step.cu", "biem_helmholtz_sphere_tpu/ops/cplx.py:627"),
        # the plane-wave right-hand side (phase 4's sweep, one a k-block)
        "plane_wave_rhs": ("csrc/plane_rhs.cu", "biem_helmholtz_sphere_tpu/biem/_core.py:239"),
    }
    record = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": "biem_helmholtz_sphere_tpu_torch/" + src,
            "replaces": rep,
            "launches": launches[name],
            "max_abs_err": results[name]["complex64"]["abs"],
            "ms": results[name]["complex64"]["ms"],
            "plain_ms": results[name]["complex64"]["plain_ms"],
            "bound_ms": results[name]["complex64"]["bound_ms"],
            "bound_by": results[name]["complex64"]["bound_by"],
            "library_ms": results[name]["complex64"]["library_ms"],
        }
        for name, (src, rep) in sources.items()
    ]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
