#!/usr/bin/env python3
"""Smoke run of mdgrad_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--against OTHER.cu ...]

Builds the port's CUDA kernels from ``mdgrad_tpu_torch/csrc`` and runs
its phases, printing one line as each check ends:

1. build   -- one nvcc process per source, in parallel, and one link into
   one shared library; its wall time.
2. kernels -- each kernel against its plain PyTorch version on the card at
   the shapes of the main paths (sentinel indices included); K1, K2a and
   K2b also at F = 1, 3, 40, 128, 130, 132, K = 1, 12, 40 and four sentinel
   layouts, and through views at a 4-byte offset (their scalar path), K2b
   also on rows of 0 and 300 edges; the SchNet force through the kernels
   against the plain gather path, and the force's vector-Jacobian product
   (its grad-of-grad) likewise; K2b's CSR build (the cluster path, and the
   grid path forced) integer-equal to the plain build, twice, on the main
   path's index, on edge cases, on water tables at K = 16-72, on each
   side of the cluster build's capacity and on the grid build's shapes
   (the 4096-row water and a-Si tables, 1728 and 48668 rows, one key of
   more than 65536 edges, each side of a digit, more than 256 tiles), and
   K2b bit-equal through either CSR;
   then the LJ pair kernels (K5 energy and forces, K6 force, K6b its vjp,
   K7 force and parameter sums, the four modes of one i < j walk) on
   perturbed FCC boxes of 108, 100 (the bounds mask), 1372 and 4000 atoms,
   powers (12, 6), (9, 6) and (12, 0), and at 2 and 8788 atoms, on positions
   unwrapped by whole cells, on pairs at the minimum image's edges (d =
   +-L/2 and one ulp around it, past a box length) and on pairs whose r^2
   lies within an ulp of cutoff^2, each giving the same bits twice, with
   the library's scratch sizes equal to ``ops/pair.py``'s; K3/K4 and
   K3b/K4b at 1, 3 and 50 frames of the water box and K3/K4 at the fit's
   inference shape (1 frame, 800 bins), both at the water pair fits' (10
   frames, 400 bins), each giving the same bits twice,
   and on ``ops/time_rdf.py``'s edge cases (N = 2-1372, F =
   1-10, 1500 bins, unsorted centres, an unbounded bin, pairs at the
   cutoff and the image's edges); the library's reach argument equal to
   ``ops/rdf.py``'s; then the bf16 instantiations of K1, K2a and K2b
   (``split=False``) against their plain versions on the same edge cases
   (K1 at F % 4 != 0, K2a at F % 8 != 0 their scalar path), at the water
   shape and through views at a 2-byte offset, each giving the same bits
   twice, bf16 K1's scalar path giving its 8-byte path's bits.
3. main    -- the water SchNet NVT sampling path at full width: 512 O sites
   on a diamond lattice at 0.99749 g/cm^3, Stack{SchNet(128/128/40, 2 convs,
   cutoff 6.0, (N, K) table), ExcludedVolume prior}, Nose-Hoover chain at
   298 K (Q=50, 5 chains), dt = 0.5 fs, 1000 steps with a frame every 20,
   then the 109-bin RDF over (1.8, 7.5) A on those frames.  Weights come
   from a seeded init.
3b. lj sampling -- large-N LJ NVE through ``PallasLJPair``: 4000 atoms
   (FCC 10^3 at a = 1.679), T = 1.2, sigma 0.9, eps 1.0, cutoff 2.5, dt
   0.002, 50 epochs of frequency 20 (950 steps, 1000 forces); the energy
   drift from K5 plus the kinetic energy.
4. train   -- the water SchNet RDF fit on the same model: first, at tau =
   11, the replay adjoint's parameter gradient against direct backprop;
   then 3 optimizer steps at tau = 52 (51 MD steps, the RDF of frames 0, 20
   and 40, compute_D against the H20_0.997_298K target, the replay adjoint
   into the SchNet parameters, clip_by_global_norm(10), Adam(1.839e-4)),
   each epoch restarting from the last state.
4b. lj fit -- d/d(sigma, eps) of an RDF loss through one NVE epoch
   (1372 atoms, frequency 50, dt 0.002) and the replay adjoint, K6 and K6b
   in every step, against the dense LennardJones path and against direct
   backprop, with the RDF kernels held against their plain versions on
   that epoch's frames; then 3 clipped-Adam steps on (sigma, eps).  Then
   float32 exp on the card exactly +0 from each bin's reach on (the terms
   the RDF kernels skip) at the bins of the paths' RDF ops.
4c. fit   -- the port's ``fit_rdf`` as ``scripts/run_water_torch.py``
   calls it, at ``scripts/run_water.py``'s GNN assignments and defaults:
   512 O sites (H20_298K_redd), SchNet "low" (128/128, 30 Gaussians, 2
   convolutions, cutoff 6.0, K = 48 at slack 1.6), the ExcludedVolume
   prior, opt_freq 52, 109 bins, lr 1.839e-4, dt 0.5 fs, Q 50, the pallas
   RDF backend.  A fresh fit of 3 epochs with a checkpoint after each,
   one 100-step inference rollout and the 800-bin RDF; its resume to 4
   epochs (one epoch run); a 2-epoch fit whose K = 16 table overflows at
   epoch 0 and regrows to K = 72, whose CSR build (36864 edges) takes the
   cluster kernel, as every fit's does.
   Each call launches K1, K2a, K2b, the CSR build, K3/K4 and K3b/K4b, no
   LJ kernel and no plain version.
4d. bf16  -- ``bench.py:33-69`` as it is: phase 3's model with SchNet
   ``compute_dtype="bf16"`` at ``capacity_slack=1.25`` (K = 40).  The
   dense layers' bf16 GEMMs on cuBLAS against an f32-accumulated product
   (one bf16 ulp at most); the bf16 force against the f32 force of the same
   weights and against the port's bf16 force on the CPU (the plain
   versions); then phase 3's sampling run cut to 500 steps (25 frames and
   their RDF) and 3
   optimizer steps of ``bench.py``'s loss (a tau = 52 epoch through the
   replay adjoint, mean((g - 1)^2) of the 109-bin g(r) of every 10th frame,
   here through K3/K4; clipped Adam), and the same 3 steps in f32.  The bf16
   runs launch the bf16 K1, K2a and K2b, no f32 gather kernel, and no plain
   version.
4e. mixed and skin -- ``fit_rdf`` at phase 4c's settings in ``'mixed'``
   (the f32 gather kernels, a bf16 node filter) for one epoch, then with
   ``gnn_skin`` 0.5 and ``topology_update_freq`` 3 for two; K, the
   launches an epoch and epochs/s beside 4c's skinless fit.
4f. pair  -- the pair slice at full width.  ``fit_lj`` at
   ``scripts/run_lj.py``'s assignments (lj_0.7_1 at size 4, 256 atoms; a
   PairMLP of 24 Gaussians, width 128, 3 layers, SELU; the LJ-family
   prior; NHC Q 50 x 5; 120-step epochs, 100 bins, t_range 50,
   frame_skip 5), cut to 3 epochs after 100 pretraining iterations, then
   one epoch with the VACF and virial-pressure terms against a
   self-generated target (the ground truth simulated, 4 runs of 100
   steps); ``fit_rdf`` at
   ``scripts/run_water.py --pair -rdf_backend pallas``'s settings (512
   sites, a PairMLP of 40 Gaussians, width 115, 3 layers, ELU, cutoff 6.0,
   400 bins, 192-step epochs, the ExcludedVolume prior) for 2 epochs, then
   ``--tpair`` for 1, each after 100 pretraining iterations; the water GNN
   fit at 1728 sites (size 6), whose prior takes 'sparse': one 20-step
   sampling epoch, then that prior's energy and forces against the dense
   prior's.  ``fit_lj`` launches no kernel (its RDF is the dense plain
   one, as in the JAX package); the water pair fits launch K3/K4 and
   K3b/K4b in every epoch and nothing else; the 1728-site epoch K1, K2a,
   K2b and the CSR build.  Losses, gradient norms, epochs/s and peak
   memory.
4g. isom  -- ``fit_isomerization`` as ``scripts/run_isom_torch.py`` runs
   it: the retinal operators (D = 716), the Gaussian pulse (6095 field
   samples), SGD at lr 1e-2, look_back 20000, 2 of 40 epochs, each cut
   from 30479 RK4 steps to 10000, through the replay adjoint; each
   epoch's seconds, the
   replay's forward and backward seconds, peak memory, the yields; then a
   2000-step gradient of the yield objective with respect to the field
   held to the same run of the port on the CPU in float64 (a process of
   its own, started with the phase).  No kernel of ``csrc/`` launches.
4h. multistate -- ``fit_rdf_multistate`` as
   ``scripts/run_water_multi_torch.py`` runs it: H20_298K_redd,
   H20_308K_redd and H20_338K_redd at 512 sites each, SchNet "low"
   (cutoff 6.0, K at slack 2.0 on the densest box), opt_freq 52, 109
   bins, frame_skip 20, the states one after another with one summed
   gradient; 2 of 500 epochs, one 100-step rollout and the 800-bin RDF per
   state; then ``--tpair`` (192-step epochs) for 1 epoch after 50
   pretraining iterations.  The GNN fit launches K1, K2a, K2b and the CSR
   build in every epoch (its soft RDF is plain torch, as in the JAX
   package) and nothing else; the tpair fit no kernel.
4i. mts and share -- ``fit_rdf`` at phase 4c's settings with
   ``mts_inner`` 2 (26 frames of 1.0 fs an epoch, every 10th frame; the
   SchNet at the outer step, the prior at 0.5 fs) for 2 epochs, counting
   the forces of each outer step (1 slow, 3 fast); then with
   ``share_prior_aux`` (the prior in mode 'table' on the SchNet's table)
   for 1 epoch.  Each launches every water kernel.
4j. large n -- the cell list (``ops/cells.py``): the 4096-site water box
   (``run_water.py -size 8``, diamond at 0.99749 g/cm^3, positions moved
   by 0.1 A) through ``GNNPotentials(nbr_mode='cells')``, its table held as
   row sets to the dense ``generate_neighbor_table`` (K from the dense
   count, slack 1.6), both builds timed; K2b's CSR build at that table (the
   grid path, past 2047 rows) against the plain build and timed; K1, K2a
   and K2b on that table and K3/K4, K3b/K4b at 52 x 4096 (and K3/K4 at 1 x
   4096 x 800) against their plain versions; ``CellLJPair`` at 48,668
   atoms (FCC 23^3, a = 1.679, ``benchmarks/bench_large_n.py``) against
   K5 on the same positions, then 200 NVE steps through it (dt 0.002):
   steps/s and the energy drift; then ``fit_rdf`` as ``run_water.py -size
   8 -nbr_mode cells -rdf_backend pallas -frame_skip 1`` runs it (SchNet
   "low", seeded weights), 2 epochs and one 100-step rollout before the
   800-bin RDF: seconds an epoch, peak memory, the launches of every water
   kernel an epoch (each must launch, every CSR build on the grid path).
4k. npt, reverse and langevin -- ``scripts/run_npt_fit_torch.py``'s
   reduced LJ mode (lj_0.845_1.2, 108 atoms, the truth NVT for P_target,
   ``NPTMTKNHC`` through the replay adjoint, the RDF term) for 2 epochs
   at its defaults (4 evaluation epochs of 16): the losses and the
   densities; its water mode at 512
   sites (SchNet 128/128, 30 Gaussians, bf16), 1 epoch and 1 evaluation
   epoch: the bf16 K1, K2a and K2b and the CSR build launch, no f32
   gather; the reverse-time adjoint's d/d(sigma, eps) on phase 4b's
   1372-atom ``PallasLJPair`` NVE epoch (a loss on the last frame's
   g(r)) against the replay's, K6, K6b, K3/K4 and K3b/K4b launching in
   both; ``Langevin`` (friction 5) on 4000-atom ``PallasLJPair``: the
   mean temperature over 500 steps after 200 within 5% of its target, one
   K6 a step.
4l. angle and difftre -- phase 4c's fit with the water angle target
   (``--angle``, 3.7 A, 64 bins) for 1 epoch: a finite ``angle_mse``,
   every water kernel launched; ``scripts/run_difftre_torch.py`` at its
   full size (lj_0.7_1, 500 atoms, the PairMLP after 500 of its 2000 BI
   iterations, 16 frames every 30 steps after 300, from 48 every 60 after
   1200), 2 outers of up to 5 inner steps: the losses and the ESS.  The NPT LJ fit, the cell-list LJ run
   and DiffTRE launch no kernel (plain PyTorch, as the JAX package's
   ``jnp``).
4m. fold, salt and mix -- ``scripts/run_fold_torch.py``'s defaults
   through ``train_fold`` (50 atoms, SchNet 64/64, 32 Gaussians, 3
   convolutions, cutoff 4.0, tau 49, dt 0.02): the warm-up epoch alone,
   then the warm-up and 2 of 500 trained epochs (each trained epoch's
   launches, the losses, seconds, peak memory); K1, K2a, K2b and the CSR
   build at the fold's shapes (N = 50, K = 16, F = 64, on the perturbed
   straight chain) against their plain versions, and the fold SchNet's
   force and its vector-Jacobian product through the kernels against the
   plain gather path; at tau 11 the replay gradient of the fold loss
   against direct backprop.  The molten salt at ``scripts/run_salt.py``'s
   box (216 ions, a = 6.2 A, 2500 K, r_cut 9.114 A, alpha 0.3511, 618
   half-space k-vectors): ``generate_targets`` cut from 6 burn-in and 16
   sampling epochs of 80 steps to 1 and 2; an MD step (no gradient) and
   the stack's, the Ewald's and the core's force, each timed back to back
   with CUDA events; the card's float32 Ewald energy and forces at the
   melt against the CPU's float64 (``EWALD_U_TOL`` of |U|,
   ``EWALD_F_TOL`` of max |F|), and the same with TF32 switched on, which
   must miss both; one tau-60 epoch's d(loss)/d(qscale),
   finite and nonzero; ``fit_salt`` for 2 of 200 epochs (its own targets
   at 6 burn-in and 2 sampling epochs).  ``fit_mix`` at its defaults (108
   atoms, 3 epochs at tau 21, 4 target epochs of 40 steps): finite
   losses and recovered potentials.
4n. supervised and ti -- ``scripts/run_supervised_torch.py`` at
   ``scripts/run_supervised.py``'s defaults (lj_0.845_1.2, 108 atoms,
   cutoff 2.5, dt 0.005; 20 burn-in epochs of 120 steps, 400 frames one
   every 20 steps, labelled by autograd of the dense LJ; batch 16, lr
   1e-3; SchNet 64/64, 2.5 // 0.1 = 24 Gaussians, 2 convolutions; 12
   validation epochs of 120 steps), cut from 150 training epochs to 3: the
   label seconds, training steps/s and seconds an epoch, the test MAEs,
   the RDF MSE against the ground truth, peak memory; ``batched_predict``
   on the card against the port on the CPU for one batch of 16 frames;
   then ``TI`` with the trained weights as a ``GraphConvIntegration`` on
   the same box, the last atom switched off over 200 steps, lambda moved
   every 20: a finite delta_f, and dU/dlambda at one configuration against
   the CPU's float64.  On TI's table at that configuration (N = 108, F =
   64), K1, K2a and K2b against their plain versions and the CSR build
   integer-equal to the plain build; TI's force -dU/dq at lambda 0.5, its
   vjp in q, in ``aggr_wgt`` and in the weights, and dU/d(aggr_wgt),
   through the kernels against a copy on the plain gather path.
4o. si, sharded and profile -- ``scripts/run_si_torch.py`` at its
   defaults (``Si_2.293_100K``, 512 sites, SchNet 64/128, 3 convolutions,
   cutoff 5.0, the anneal from 1500 K, 40-step epochs, 20 inference
   rollouts) cut to 2 epochs, with the pallas RDF backend, its
   configuration set to checkpoint each epoch: finite losses, K1, K2a,
   K2b, the CSR build (cluster path), K3/K4 and K3b/K4b in every epoch;
   K1, K2a, K2b and the CSR build against their plain versions on the
   a-Si table (N = 512, K = 48, F = 128); K3/K4 and K3b/K4b against
   theirs on the fit's RDF (119 bins) and the frames of one epoch of its
   MD, K3/K4 at the inference's 800 bins;
   ``scripts/si_transfer_torch.py`` from the checkpoint just written at
   4096 sites on the cell list, cut to 1 anneal, 1 equilibration and 1
   sampling epoch, the MTK chain at 500 dt (see ``SI_TRANSFER_ARGV``):
   the 800-bin RDF, K3/K4 against its plain version on the last
   sampling epoch's frames (1 and 25), the CSR build on the grid path
   against the plain build, both timed.  Then, in an NCCL world of one
   (a ``FileStore`` in a temporary directory), each sharded path
   against its unsharded counterpart, with its launches counted:
   ``make_sharded_fit_step`` in ``dryrun_multichip``'s configuration
   (the loss, d/d(sigma, eps), the final positions, the updated
   parameters; no kernel and no plain version), the row-sharded SchNet
   epoch (``ShardedGNNPotentials``) on phase 3's water model at tau 52
   (the loss and the SchNet's gradient), and
   ``make_stack_multistate_train_step`` over phase 4h's three states
   (the losses, the summed gradient, the parameters after one Adam
   step; K1, K2a, K2b and the CSR build), each within ``SHARD_TOL`` of
   its largest entry.  Last,
   one ``profiling.trace`` of 40 water sampling steps: the device-busy
   share of a step.
4p. trained si -- the JAX package's trained a-Si SchNet
   (``results/si_r2/0/fit-ckpt-5699.pkl``, read by
   ``train/checkpoint.py::read_jax_pickle``) in ``run_si_torch.py``'s
   512-site stack: K1, K2a, K2b and the CSR build against their plain
   versions on its table, its energy, force and the force's vjp through
   the kernels against the plain gather path; then
   ``scripts/diag_si4k_torch.py`` at the JAX run's settings (4096 sites
   on the cell list, 1500 K, hot start, the MTK chain at 50 dt, 30 chunks
   of 10 steps), every chunk's line printed: every position finite, no
   table overflow, T_kin over steps 210-300 within 1350-1650 K (the
   reference's band), the CSR build on the grid path, integer-equal to
   the plain build on the diagnostic's last table and timed; last
   ``scripts/si_transfer_torch.py`` from the trained model at its own tau
   50 dt, cut to 1 + 1 + 1 epochs, at 1728 sites, its 800-bin MSE held
   to the JAX script's (see ``SI_TRAINED_TRANSFER_ARGV``).
5. times   -- each kernel, its plain version and its library yardstick with
   CUDA events (the LJ kernels at 1372, 4000 and 8788 atoms; K3/K4 at 50
   and 3 frames of 512 sites, at 10 of 1372, at 1 of 512 with 800
   bins and at 10 of 512 with 400, K3b/K4b at 3 x 512, 10 x 1372 and
   10 x 512 x 400,
   with bounds that count the exponentials inside the reach on these
   frames at the SFU's rate; K2b's CSR
   build at every water table width (K = 16-72) with the path it takes,
   against the grid path and the plain build, K2b beside each at K = 40,
   and on the grid build at the 4096-row water and a-Si tables and the
   1728-row one (``time_gather.CSR_GRID_CASES``) against the plain build;
   K1, K2a and K2b warm,
   their inputs in the L2 as on the MD path, and cold, cycling over input
   sets larger than the L2, with the cold share of the bound, in f32 and
   in bf16), MD, training and fit steps/s, bf16 against f32 from phase
   4d, the skinned fit against the skinless, the wall seconds of each
   phase, and the card's name and power limit.
5b. a/b    -- only with ``--against``: each OTHER.cu, another version of
   ``csrc/gather.cu`` (a file named ``gather*.cu``), ``csrc/rdf.cu``
   (``rdf*.cu``) or ``csrc/pair.cu`` (``pair*.cu``), built alone into a
   library of its own, held against the plain versions, and timed with
   this build's kernels on the same inputs in turns -- the others, this,
   this, the others in reverse (A B B A for one other) -- ``ROUNDS``
   times.  Gather: K1, K2a and K2b warm, cold and on one row, in f32 and
   bf16, the medians and the cold share of the bound; K2b's CSR build at
   E = 20480 and 36864 and at phase 5's grid tables (E = 196608, 360448
   and 82944; each library's own path, and the grid forced) and with K2b
   after it, and each launch of the grid build apart
   (``torch.profiler``); the largest difference between the libraries'
   outputs (the CSR integer-equal); one JSON line ``{"gather_ab": ...}``.
   An older ``gather.cu`` without ``mdg_table_index_csr_scratch`` gets
   the scratch of its own rule (n + 1 ints) or more.
   RDF: K3/K4 and K3b/K4b at phase 5's shapes, an older ``rdf.cu`` called
   through its own C interface (``ops/time_rdf.py``), one JSON line
   ``{"rdf_ab": ...}``.  Pair: K5, K6, K6b and K7 at N = 1372 and 4000, an
   older ``pair.cu`` with scratch sized by its own rule
   (``ops/time_pair.py``); the largest difference between each kernel's
   outputs in the two libraries; one JSON line ``{"pair_ab": ...}``.

Launch counts are zeroed just before phases 3, 3b, 4 and 4b, each call
of 4c, 4e, 4f, 4g, 4h, 4i, 4j, 4k, 4l, 4m, 4n, 4o and 4p and each run of
4d, and
read just after each: phases 3, 4, 4c, 4e, 4i, 4j's fit and 4l's angle fit must
launch every water kernel, the CSR build included, 4d and 4k's NPT water
fit the bf16 gather kernels in their place, 4f's water pair fits K3/K4
and K3b/K4b in every epoch, 4h's GNN fit K1, K2a, K2b and the CSR build in
every epoch, 4k's reverse-time and replay epochs K6, K6b, K3/K4 and
K3b/K4b, its Langevin run K6, 4m's fold K1, K2a, K2b and the CSR build
in every trained epoch (read at each epoch's log line) and nothing else,
4n's validation MD and TI K1, K2a, K2b and the CSR build in every
epoch (each validation epoch's and TI segment's log line), and nothing
else, 4o's a-Si fit every water kernel in every epoch, its 4096-site
transfer K1, K2a, K2b, the CSR build and K3/K4, and the sharded SchNet
epoch every water kernel, and nothing else, 4p's trained SchNet checks
and its 4096-site diagnostic K1, K2a, K2b and the CSR build, and its
transfer those and K3/K4, and nothing else, 4g, 4m's salt and mixture fits and 4n's label MD, trainer,
``evaluate``, ground-truth validation and ``batched_predict`` no kernel
at all, and none may call a plain version.  The line before the last is
a JSON object with one record per kernel; the last line is ``{"ok":
true, "device": {...}}``.  Any failed check raises and the script exits
non-zero.  Without a CUDA device it exits 1 and prints no result.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, f32 outside tensor cores
# exponentials a second on the SFU: compute capability 9.0 gives 16 results
# of ex2 a clock an SM; 132 SMs at 1.98 GHz (the boost clock)
SFU_EXP_PER_S = 132 * 16 * 1.98e9
SEED = 0
TARGET = "H20_0.997_298K"     # the fit's experimental O-O RDF
LR, GRAD_CLIP = 1.839e-4, 10.0
LJ_KERNELS = ("lj_energy_forces", "lj_force", "lj_force_vjp",
              "lj_force_param")       # K5, K6, K6b, K7
ROUNDS = 3                    # A B B A rounds of the a/b phases
RDF_REPLACES = {
    "rdf_counts": "mdgrad_tpu/ops/pallas_rdf.py:194 (counts) + :267 "
                  "(counts.frames)",
    "rdf_counts_bwd": "mdgrad_tpu/ops/pallas_rdf.py:200 (counts_bwd) + :273 "
                      "(counts_frames_bwd)"}
# the shapes each RDF kernel runs at on a path: the sampling run's 50
# frames (K3/K4 only), a training step's 3, the LJ fit's 10 of 1372 atoms,
# the fit's inference, one frame at 800 bins (K3/K4 only), and the water
# pair fits' epoch, 10 frames at 400 bins
RDF_SHAPES = {"rdf_counts": ("50x512", "3x512", "10x1372", "1x512x800",
                             "10x512x400"),
              "rdf_counts_bwd": ("3x512", "10x1372", "10x512x400")}
# the shape of each RDF row's own numbers in the JSON line (every shape is
# under its "by_shape"): K3/K4 at the sampling run's 50 frames, K3b/K4b at
# a training step's 3
RDF_ROW_SHAPE = {"rdf_counts": "50x512", "rdf_counts_bwd": "3x512"}


def line(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound_pipe(n_bytes, n_ops, n_exp=0):
    """(least ms, the pipe that sets it: "hbm", "fp32" or "sfu") for
    ``n_bytes`` moved once, ``n_ops`` f32 operations and ``n_exp``
    exponentials on the SFU."""
    times = {"hbm": n_bytes / HBM_BYTES_PER_S,
             "fp32": n_ops / FP32_FLOPS_PER_S,
             "sfu": n_exp / SFU_EXP_PER_S}
    pipe = max(times, key=times.get)
    return 1e3 * times[pipe], pipe


def bound_ms(n_bytes, n_ops, n_exp=0):
    """(least ms, "bytes" or "operations"): the exponentials count as
    operations at the SFU's rate."""
    ms, pipe = bound_pipe(n_bytes, n_ops, n_exp)
    return ms, "bytes" if pipe == "hbm" else "operations"


def max_errs(got, ref):
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return err, err / max(scale, 1e-30), scale


def build_water(mt, device, gather_mode="auto", compute_dtype="float32"):
    import numpy as np
    from mdgrad_tpu_torch import potentials
    from mdgrad_tpu_torch.data.registry import get_unit_len
    L = get_unit_len(0.99749, 18.01528, 8)
    system = mt.System.from_lattice("diamond", 4, L, symbol="O")
    system.masses = np.full(512, 18.01528)
    system.set_temperature(298.0, rng=np.random.default_rng(SEED))
    gnn = mt.SchNet({"n_atom_basis": 128, "n_filters": 128,
                     "n_gaussians": 40, "n_convolutions": 2, "cutoff": 6.0,
                     "compute_dtype": compute_dtype,
                     "gather_mode": gather_mode},
                    seed=SEED)
    stack = mt.Stack({
        "nn": mt.GNNPotentials(system, gnn, cutoff=6.0, capacity_slack=1.25,
                               device=device),
        "prior": mt.PairPotentials(system, potentials.ExcludedVolume(
            sigma=2.6, epsilon=0.01, power=12), cutoff=6.0, mode="dense",
            device=device),
    })
    return system, stack


def train_phase(mt, torch, dev, records):
    """Phase 4: the water SchNet RDF fit at full width (see the module
    docstring).  Fills ``records[name]['launches']`` with the launches of
    the 3-step run and returns its numbers."""
    import numpy as np
    from mdgrad_tpu_torch import ops, units
    from mdgrad_tpu_torch.train import fit_rdf
    system, stack = build_water(mt, dev)
    train = fit_rdf.fit_parameters(stack)
    _, g_target, obs = fit_rdf.get_observer(system, TARGET, 109,
                                            backend="pallas", device=dev)
    dt = 0.5 * units.fs

    def make_sim(adjoint):
        integ = mt.NoseHooverChain(stack, system, T=298.0, Q=50.0,
                                   num_chains=5, adjoint=adjoint, device=dev)
        return mt.Simulation(system, integ)

    def flat_grad():
        return torch.cat([(torch.zeros_like(p) if p.grad is None
                           else p.grad).reshape(-1) for p in train])

    # replay == direct at a short depth (tau 11: frames 0, 5 and 10 to the
    # RDF; direct mode keeps every step's double-backward graph)
    grads = {}
    for adjoint in (True, False):
        sim = make_sim(adjoint)
        state, aux = sim.initial_state()
        loss_fn = fit_rdf.make_epoch_loss(sim, obs, g_target, system, 11, dt,
                                          frame_skip=5)
        loss, _ = loss_fn(state, aux, sim.integrator.default_ctrl())
        grads[adjoint] = flat_grad()
        for p in train:
            p.grad = None
    err, _, scale = max_errs(grads[True], grads[False])
    line(f"train: replay vs direct at tau=11: max_abs_err {err:.3e} (tol "
         f"{5e-3 * scale:.3e}, largest entry {scale:.3e}; loss "
         f"{loss.item():.6f})")
    require(scale > 0 and np.isfinite(scale) and err <= 5e-3 * scale,
            "the replay adjoint's gradient equals direct backprop")
    del grads

    sim = make_sim(True)
    ctrl = sim.integrator.default_ctrl()
    loss_fn = fit_rdf.make_epoch_loss(sim, obs, g_target, system, 52, dt,
                                      frame_skip=20)
    update = fit_rdf.FitUpdate(train, LR, GRAD_CLIP)
    before = [p.detach().clone() for p in train]
    state, aux = sim.initial_state()
    n_epochs, n_steps = 3, 51
    torch.cuda.synchronize()
    ops.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for epoch in range(n_epochs):
        loss, (g_r, state, aux) = loss_fn(state, aux, ctrl)
        if epoch == 0:
            peak = torch.cuda.max_memory_allocated()
        norm = update()
        sim.check_flags()
        loss_v, norm_v = loss.item(), norm.item()
        line(f"train: epoch {epoch}: loss {loss_v:.6f}  grad norm "
             f"{norm_v:.6f}  clipped {norm_v >= GRAD_CLIP}  g(r) max "
             f"{g_r.max().item():.4f}")
        require(np.isfinite(loss_v), "the loss is finite")
        require(np.isfinite(norm_v) and norm_v > 0,
                "the gradient is finite and nonzero")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.counts()
    moved = max((p.detach() - b).abs().max().item()
                for p, b in zip(train, before))
    steps_per_s = n_epochs * n_steps / wall
    line(f"train: {n_epochs} optimizer steps x {n_steps} MD steps in "
         f"{wall:.3f} s: {steps_per_s:.2f} training steps/s; peak memory "
         f"of the replay epoch {peak / 2 ** 20:.1f} MiB; parameters moved "
         f"by up to {moved:.3e}")
    line(f"train: launches {counts['launches']}  plain_calls "
         f"{counts['plain_calls']}")
    # where an epoch's time goes: the same epoch forward only, no grad
    # (the sampling loop: no stored states, no graph), twice, the second
    # timed; the rest of a training epoch is the replay, the RDF and its
    # backward, and the update
    ode = sim.epoch_fn(dt, 52)
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ode(state, aux, ctrl)
            torch.cuda.synchronize()
            fwd = time.perf_counter() - t1
    epoch_s = wall / n_epochs
    line(f"train: split per epoch: {epoch_s * 1e3:.1f} ms in all, the "
         f"forward alone {fwd * 1e3:.1f} ms, the rest (replay, RDF and its "
         f"backward, update) {(epoch_s - fwd) * 1e3:.1f} ms")
    require(moved > 0, "the parameters moved")
    require(not sim.overflowed, "no neighbor-table overflow in training")
    require(not sim.drifted, "no minimum-image drift in training")
    require(bool(torch.isfinite(state.q).all()), "positions are finite")
    for name, c in counts["launches"].items():
        if name in LJ_KERNELS:
            require(c == 0, f"the water fit launches no {name}")
            continue
        require(c > 0, f"kernel {name} launched in the train phase")
        records.setdefault(name, {})["launches"] = c
        records[name]["launches_per_train_step"] = c / n_epochs
    for name, c in counts["plain_calls"].items():
        require(c == 0, f"plain version of {name} not used in training")
    return {"steps_per_s": steps_per_s, "wall": wall, "peak": peak,
            "fwd_s": fwd, "rdf_op": obs._counts}


# the water fit of scripts/run_water.py: its GNN assignments and
# sys_params at full width (512 sites), cut to 3 epochs and one 100-step
# inference rollout; the pallas RDF backend, so that K3/K4 and K3b/K4b run
FIT_ASSIGNMENTS = {
    "cutoff": 6.0, "epsilon": 0.010637550996566496,
    "gaussian_width": 0.195, "lr": 0.0001839, "mse_weight": 3.2,
    "n_atom_basis": "low", "n_filters": "low", "n_convolutions": 2,
    "nbins": 109, "opt_freq": 52, "sigma": 2.61227614490785,
    "rdf_backend": "pallas", "compute_dtype": "float32"}
FIT_SYS_PARAMS = {
    "dt": 0.5, "n_epochs": 3, "n_sim": 1, "data": ["H20_298K_redd"],
    "val": None, "size": 4, "anneal_flag": "False", "pair_flag": False,
    "tpair_flag": False, "topology_update_freq": 1, "adjoint": True,
    "share_prior_aux": False, "gnn_skin": 0.0, "capacity_slack": 1.6,
    "nbr_mode": "table", "mts_inner": 0, "frame_skip": 20,
    "overflow_policy": "warn", "regrow_factor": 1.5, "prior_mode": "auto",
    "init_pkl": None, "test_nbins": 800, "ckpt_every": 1}
# the regrow call: a table of K = 16 (slack 0.5 of the lattice's 28
# neighbors) overflows at once and regrows to K = 72 (36864 edges), which
# the CSR build's cluster path holds (the grid build, a radix sort over
# the grid, takes over only past 65536 edges or 2047 rows)
FIT_REGROW = {"n_epochs": 2, "n_sim": 0, "capacity_slack": 0.5,
              "overflow_policy": "regrow", "regrow_factor": 4.5}
WATER_KERNELS = ("gather_mul_reduce", "table_gather", "table_scatter",
                 "table_index_csr", "rdf_counts", "rdf_counts_bwd")
GATHER_KERNELS = WATER_KERNELS[:3]    # K1, K2a, K2b: f32 and bf16


class CsrWidths:
    """Records the (edges, rows) of every CSR build while it is entered,
    and the last build's (index, rows) as ``last``: wraps
    ``gather._launch_table_index_csr``, which ``TableIndex.csr`` calls,
    and puts it back on exit."""

    def __init__(self, gather):
        self.gather = gather
        self.seen = {}
        self.last = None

    def __enter__(self):
        self.real = self.gather._launch_table_index_csr

        def record(idx, n, cluster=True):
            key = (idx.shape[0], n)
            self.seen[key] = self.seen.get(key, 0) + 1
            self.last = (idx, n)
            return self.real(idx, n, cluster)

        self.gather._launch_table_index_csr = record
        return self

    def __exit__(self, *exc):
        self.gather._launch_table_index_csr = self.real

    def paths(self):
        """The build each recorded width takes."""
        return {self.gather.table_index_csr_path(e, n) for e, n in self.seen}

    def describe(self):
        return ", ".join(
            f"K={e // n} ({e} edges): {c} builds, "
            f"{self.gather.table_index_csr_path(e, n)}"
            for (e, n), c in sorted(self.seen.items()))


def fit_call(torch, fit_rdf, ops, gather, model_path, assignments=None,
             **sys_params):
    """One ``fit_rdf`` call on the card at the water fit's settings plus
    ``assignments`` and ``sys_params``; returns (result, log lines,
    per-epoch marks (time, counts) taken at each epoch's log line,
    CsrWidths, wall seconds)."""
    import numpy as np
    msgs, marks = [], []

    def log(msg):
        msgs.append(str(msg))
        if " | loss" in str(msg):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), ops.counts()))

    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    with CsrWidths(gather) as widths:
        out = fit_rdf.fit_rdf({**FIT_ASSIGNMENTS, **(assignments or {})},
                              {**FIT_SYS_PARAMS, **sys_params},
                              model_path=model_path, log=log,
                              rng=np.random.default_rng(SEED),
                              device=torch.device("cuda", 0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    marks = [(t - t0, c) for t, c in marks]
    return out, msgs, marks, widths, wall


def check_no_kernel(counts, what, allowed=()):
    """No kernel outside ``allowed`` launched, no bf16 instantiation, no
    plain version called."""
    for name, c in counts["launches"].items():
        if name not in allowed:
            require(c == 0, f"the {what} launches no {name}")
    for name, c in counts["launches_bf16"].items():
        require(c == 0, f"the {what} launches no bf16 {name}")
    for group in ("plain_calls", "plain_calls_bf16"):
        for name, c in counts[group].items():
            require(c == 0, f"plain version of {name} not used in the {what}")


def check_fit_counts(counts, what):
    """Every water kernel launched (the f32 gather kernels: the fits run
    float32 or 'mixed'), nothing else, no plain version."""
    for name in WATER_KERNELS:
        require(counts["launches"][name] > 0,
                f"kernel {name} launched in the {what}")
    check_no_kernel(counts, what, allowed=WATER_KERNELS)


def fit_phase(mt, torch, dev, records):
    """Phase 4c: the port's ``fit_rdf`` (see the module docstring): a fresh
    3-epoch fit with checkpoints, its resume to 4 epochs, and a fit whose
    table overflows and regrows.  Fills ``records[name]['launches_fit_*']``
    and returns the fresh fit's numbers."""
    import tempfile
    import numpy as np
    from mdgrad_tpu_torch import ops
    from mdgrad_tpu_torch.ops import gather
    from mdgrad_tpu_torch.train import fit_rdf
    initial = fit_rdf._build_net_and_prior(FIT_ASSIGNMENTS)[0].state_dict()

    def moved(params):
        return max((params[k] - v).abs().max().item()
                   for k, v in initial.items())

    with tempfile.TemporaryDirectory() as model_path:
        torch.cuda.reset_peak_memory_stats()
        out, msgs, marks, widths, wall = fit_call(torch, fit_rdf, ops, gather,
                                                  model_path)
        peak = torch.cuda.max_memory_allocated()
        counts = ops.counts()
        losses = out["loss_log"]
        n_epochs, n_steps = FIT_SYS_PARAMS["n_epochs"], \
            FIT_ASSIGNMENTS["opt_freq"] - 1
        for msg in msgs:
            line(f"fit: {msg}")
        line(f"fit: losses {losses}  objective {out.get('objective')!r}  "
             f"parameters moved by up to {moved(out['params']):.3e}")
        require(not out.get("nan_bailout") and len(losses) == n_epochs
                and bool(np.isfinite(losses).all()), "3 finite losses")
        require(np.isfinite(out["objective"]), "a finite objective")
        require(out["final"]["H20_298K_redd"]["g_sim"].shape == (800,),
                "the inference RDF has 800 bins")
        require(moved(out["params"]) > 0, "the parameters moved")
        require(not any("overflow" in m for m in msgs),
                "no neighbor-table overflow in the fit")
        check_fit_counts(counts, "fit")
        per_epoch = []
        prev = {name: 0 for name in counts["launches"]}
        for _, c in marks:
            per_epoch.append({name: c["launches"][name] - prev[name]
                              for name in prev})
            prev = c["launches"]
        inference = {name: counts["launches"][name] - prev[name]
                     for name in prev}
        for i, c in enumerate(per_epoch):
            line(f"fit: launches in epoch {i}: {c}")
        line(f"fit: launches in the inference phase: {inference}")
        line(f"fit: CSR builds {widths.describe()}")
        require(widths.paths() == {"cluster"},
                "the fit's CSR builds take the cluster kernel")
        k_fresh = sorted({e // n for e, n in widths.seen})[0]
        require(inference["rdf_counts"] == 2
                and inference["rdf_counts_bwd"] == 0,
                "inference: one 800-bin K3 launch per frame, no backward")
        for name in WATER_KERNELS:
            records.setdefault(name, {})["launches_fit_per_epoch"] = \
                per_epoch[-1][name]
            records[name]["launches_fit_inference"] = inference[name]
        epochs_s = marks[-1][0]
        steady_s = (marks[-1][0] - marks[0][0]) / (n_epochs - 1)
        infer_s = wall - marks[-1][0]

        # the resume: one more epoch from the checkpoint of epoch 2
        out2, msgs2, marks2, _, wall2 = fit_call(torch, fit_rdf, ops, gather,
                                                 model_path, n_epochs=4)
        for msg in msgs2:
            line(f"fit resume: {msg}")
        require("resumed from checkpoint at epoch 2" in msgs2,
                "the fit resumed from its epoch-2 checkpoint")
        epoch_lines = [m for m in msgs2 if " | loss" in m]
        require(len(epoch_lines) == 1 and epoch_lines[0].startswith(
            "epoch 3 |"), "the resume ran exactly one epoch, epoch 3")
        require(out2["loss_log"][:3] == losses and len(out2["loss_log"]) == 4
                and np.isfinite(out2["objective"]),
                "the resumed log extends the fresh one")
        check_fit_counts(ops.counts(), "resumed fit")
        line(f"fit resume: {wall2:.3f} s, the epoch {marks2[0][0]:.3f} s in "
             f"the call; objective {out2['objective']!r}")

    # the regrow: epoch 0 overflows, its update is skipped, the table grows
    out3, msgs3, marks3, widths3, wall3 = fit_call(torch, fit_rdf, ops,
                                                   gather, None, **FIT_REGROW)
    for msg in msgs3:
        line(f"fit regrow: {msg}")
    line(f"fit regrow: CSR builds {widths3.describe()}")
    ks = sorted({e // n for e, n in widths3.seen})
    require(any("capacity grown" in m for m in msgs3)
            and "epoch 0: parameter update skipped (overflow_policy='regrow')"
            in msgs3, "epoch 0 overflowed and the table regrew")
    require(not any(m.startswith("epoch 1: parameter update skipped")
                    for m in msgs3) and len(out3["loss_log"]) == 2
            and moved(out3["params"]) > 0,
            "the last epoch applied its update")
    require(ks == [16, 72], f"the CSR builds ran at K = 16, then 72 ({ks})")
    require(widths3.paths() == {"cluster"},
            "the regrown table's CSR builds take the cluster kernel")
    check_fit_counts(ops.counts(), "regrown fit")
    line(f"fit regrow: k_max {ks[0]} -> {ks[-1]}; {wall3:.3f} s")
    return {"wall": wall, "epochs_s": epochs_s, "steady_s": steady_s,
            "infer_s": infer_s, "peak": peak, "k": k_fresh,
            "steps_per_s": n_epochs * n_steps / epochs_s,
            "epochs_per_s": n_epochs / epochs_s,
            "per_epoch": per_epoch[-1], "inference": inference,
            "resume_s": wall2, "regrow_s": wall3}


# the fits of phase 4e: 'mixed' for one epoch at the fit's settings; the
# Verlet skin with the table refreshed every 3rd step for 2 epochs
# (VERDICT.md's measured next lever)
FIT_MIXED = {"n_epochs": 1, "n_sim": 0}
FIT_SKIN = {"n_epochs": 2, "n_sim": 0, "gnn_skin": 0.5,
            "topology_update_freq": 3}


def mixed_and_skin_phase(torch, records, fitted):
    """Phase 4e (see the module docstring): ``fit_rdf`` in 'mixed' for one
    epoch, then with ``gnn_skin`` 0.5 and ``topology_update_freq`` 3 for
    two, beside the skinless fit of phase 4c (``fitted``)."""
    import numpy as np
    from mdgrad_tpu_torch import ops, topology
    from mdgrad_tpu_torch.ops import gather
    from mdgrad_tpu_torch.train import fit_rdf
    out, msgs, marks, widths, wall = fit_call(
        torch, fit_rdf, ops, gather, None, {"compute_dtype": "mixed"},
        **FIT_MIXED)
    for msg in msgs:
        line(f"fit mixed: {msg}")
    require(len(out["loss_log"]) == 1 and np.isfinite(out["loss_log"][0])
            and np.isfinite(out["objective"]),
            "the 'mixed' fit epoch gives a finite loss")
    require(not any("overflow" in m for m in msgs),
            "no neighbor-table overflow in the 'mixed' fit")
    counts = ops.counts()
    check_fit_counts(counts, "'mixed' fit")
    line(f"fit mixed: launches {counts['launches']}; one epoch "
         f"{marks[0][0]:.3f} s from the call, build included")

    builds = []
    real_build = topology.generate_neighbor_table

    def counted(*args, **kwargs):
        builds.append(1)
        return real_build(*args, **kwargs)

    topology.generate_neighbor_table = counted
    try:
        out, msgs, marks, widths, wall = fit_call(torch, fit_rdf, ops, gather,
                                                  None, **FIT_SKIN)
    finally:
        topology.generate_neighbor_table = real_build
    for msg in msgs:
        line(f"fit skin: {msg}")
    require(len(out["loss_log"]) == 2
            and bool(np.isfinite(out["loss_log"]).all())
            and np.isfinite(out["objective"]),
            "the skinned fit gives 2 finite losses")
    require(not any("overflow" in m for m in msgs),
            "no neighbor-table overflow in the skinned fit")
    counts = ops.counts()
    check_fit_counts(counts, "skinned fit")
    ks = sorted({e // n for e, n in widths.seen})
    require(len(ks) == 1, f"one table width in the skinned fit ({ks})")
    line(f"fit skin: CSR builds {widths.describe()}")
    require(widths.paths() == {"cluster"},
            "the skinned fit's CSR builds take the cluster kernel")
    per_epoch = {name: marks[1][1]["launches"][name]
                 - marks[0][1]["launches"][name]
                 for name in WATER_KERNELS}
    tables = len(builds)
    steady_s = marks[1][0] - marks[0][0]
    line(f"fit skin: K = {ks[0]} (skin 0.5, a table every 3rd step) against "
         f"K = {fitted['k']} (no skin, a table every step); "
         f"{tables} neighbor-table builds in the 2-epoch call")
    line(f"fit skin: launches in epoch 1: {per_epoch}; without the skin: "
         f"{fitted['per_epoch']}")
    line(f"fit skin: {2 / marks[-1][0]:.4f} fit epochs/s from the call "
         f"(build included), epoch 1 {steady_s:.3f} s; without the skin "
         f"{fitted['epochs_per_s']:.4f} epochs/s, {fitted['steady_s']:.3f} "
         f"s an epoch over epochs 1-2")
    # a table every 3rd of 2 x 51 steps, the entry primes and the final
    # evaluation's: 2 x 17 + a few, against one a step without the skin
    require(tables <= 2 * 51 // 3 + 6,
            f"the skinned fit builds a table every 3rd step ({tables})")
    return {"k": ks[0], "per_epoch": per_epoch, "steady_s": steady_s,
            "epochs_per_s": 2 / marks[-1][0], "tables": tables}


# ---- the pair slice ------------------------------------------------------
# fit_lj at scripts/run_lj.py's assignments and defaults: the lj_0.7_1
# target at size 4 (256 atoms), a PairMLP of 2.5 // 0.1 = 24 Gaussians,
# width 128, 3 layers, SELU, over the LJ-family prior, NHC Q 50 x 5 chains,
# 120-step epochs, 100 bins, t_range 50, frame_skip 5, lr 2e-3; cut from
# 300 epochs and 1000 pretraining iterations to 3 and 100
LJ_FIT_ASSIGNMENTS = {
    "nbins": 100, "opt_freq": 120, "lr": 2e-3, "sigma": 0.9,
    "gaussian_width": 0.1, "n_width": 128, "n_layers": 3,
    "nonlinear": "SELU", "grad_clip": 10.0, "rdf_weight": 1.0,
    "vacf_weight": 0.0, "pressure_weight": 0.0, "train_vacf": "False"}
LJ_FIT_SYS = {
    "size": 4, "cutoff": 2.5, "t_range": 50, "n_epochs": 3, "n_sim": 10,
    "data": ["lj_0.7_1"], "val": None, "topology_update_freq": 1,
    "pretrain_iters": 100, "burnin_epochs": 0, "frame_skip": 5,
    "state_reset_every": 0, "eval_every": 0, "eval_eq_epochs": 4,
    "eval_sample_epochs": 8, "capacity_slack": 1.6, "target_nsim": 8,
    "init_pkl": None}
# one more epoch with the VACF and virial-pressure terms on, against a
# self-generated target: lj_0.7_1's state point without its files, the
# ground truth simulated (cut from the fit's 8 runs of 100 steps to 4)
LJ_FIT_PRESSURE = {"vacf_weight": 0.1, "train_vacf": "True",
                   "pressure_weight": 1e-3}
LJ_FIT_PRESSURE_SYS = {**LJ_FIT_SYS, "n_epochs": 1, "target_nsim": 4,
                       "data": ["lj_0.7_1_sim"]}
# fit_rdf at scripts/run_water.py --pair -rdf_backend pallas: 512 sites of
# H20_298K_redd, a PairMLP of 6.0 // 0.15 = 40 Gaussians, width 115, 3
# layers, ELU, cutoff 6.0, 400 bins, 192-step epochs, the ExcludedVolume
# prior, dt 0.5 fs; cut from 700 epochs to 2 (then 1 with --tpair), from
# 1000 pretraining iterations to 100, and from 20 inference rollouts to
# none (the 800-bin RDF of the last training frame)
PAIR_FIT_ASSIGNMENTS = {
    "cutoff": 6.0, "epsilon": 1.8245160642515632, "gaussian_width": 0.15,
    "lr": 0.0006548601438181719, "mse_weight": 0.345, "n_layers": 3,
    "n_width": 115, "nbins": 400, "nonlinear": "ELU", "opt_freq": 192,
    "power": 12, "sigma": 1.68191635809129, "rdf_backend": "pallas"}
PAIR_FIT_SYS = {**FIT_SYS_PARAMS, "n_epochs": 2, "n_sim": 0,
                "pair_flag": True, "pretrain_iters": 100, "ckpt_every": 10}
PAIR_FIT_TPAIR = {"n_epochs": 1, "pair_flag": False, "tpair_flag": True}
RDF_KERNELS = ("rdf_counts", "rdf_counts_bwd")


def pair_fit_call(torch, fn, *args, **kwargs):
    """``fn(*args, log=..., **kwargs)`` (``fit_lj`` or ``fit_rdf``) on the
    card, its launch counts zeroed just before; returns (result, log
    lines, per-epoch marks (time, counts), the unclipped gradient norm of
    each optimizer step, peak memory, wall seconds)."""
    from mdgrad_tpu_torch import ops
    from mdgrad_tpu_torch.train import optim
    msgs, marks, norms = [], [], []

    def log(msg):
        msgs.append(str(msg))
        if " | loss" in str(msg):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), ops.counts()))

    real = optim.FitUpdate.__call__

    def record(self, value=None, step_scale=1.0):
        norm = real(self, value, step_scale)
        if norm is not None:          # the fit's steps, not pretraining's
            norms.append(norm.item())
        return norm

    optim.FitUpdate.__call__ = record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    try:
        out = fn(*args, log=log, **kwargs)
        torch.cuda.synchronize()
    finally:
        optim.FitUpdate.__call__ = real
    wall = time.perf_counter() - t0
    return (out, msgs, [(t - t0, c) for t, c in marks], norms,
            torch.cuda.max_memory_allocated(), wall)


def epoch_rates(marks, n_epochs):
    """(epochs/s from the call, set-up included; seconds an epoch after
    the first, or with one epoch the seconds into the call it ended)."""
    steady = ((marks[-1][0] - marks[0][0]) / (n_epochs - 1)
              if n_epochs > 1 else marks[0][0])
    return n_epochs / marks[-1][0], steady


def pair_phase(mt, torch, dev, records):
    """Phase 4f (see the module docstring): fit_lj at run_lj.py's
    assignments and an epoch with the pressure and VACF terms, fit_rdf's
    pair and T-dependent pair fits through the RDF kernels, and the water
    GNN fit's 'sparse' prior at 1728 sites against the dense one."""
    import numpy as np
    from mdgrad_tpu_torch import ops, units
    from mdgrad_tpu_torch.data.registry import pair_data_dict
    from mdgrad_tpu_torch.ops import gather
    from mdgrad_tpu_torch.train import fit_rdf, fit_rdf_pair
    out = {}

    # (a) fit_lj
    res, msgs, marks, norms, peak, wall = pair_fit_call(
        torch, fit_rdf_pair.fit_lj, LJ_FIT_ASSIGNMENTS, LJ_FIT_SYS,
        rng=np.random.default_rng(SEED), device=dev)
    for msg in msgs:
        line(f"fit_lj: {msg}")
    losses = res["loss_log"]
    n_ep = LJ_FIT_SYS["n_epochs"]
    rate, steady = epoch_rates(marks, n_ep)
    line(f"fit_lj: losses {losses}  gradient norms {norms}  peak memory "
         f"{peak} B  u(r) at r = {res['r_grid'][60]:.3f}: fit "
         f"{res['u_fit'][60]:.4f}, truth {res['u_target'][60]:.4f}")
    require(not res.get("nan_bailout") and len(losses) == n_ep
            and bool(np.isfinite(losses).all()) and min(losses) > 0,
            "fit_lj gives finite nonzero losses")
    require(len(norms) == n_ep and all(np.isfinite(norms))
            and min(norms) > 0, "fit_lj's MLP gradients are finite and "
            "nonzero")
    require(bool(np.isfinite(res["u_fit"]).all()), "a finite u(r)")
    check_no_kernel(ops.counts(), "fit_lj")
    out["lj"] = {"epochs_per_s": rate, "steady_s": steady, "wall": wall,
                 "peak": peak, "losses": losses, "norms": norms}

    entry = dict(pair_data_dict["lj_0.7_1"], rdf_fn=None, vacf_fn=None)
    res, msgs, marks, norms, peak, wall = pair_fit_call(
        torch, fit_rdf_pair.fit_lj, {**LJ_FIT_ASSIGNMENTS, **LJ_FIT_PRESSURE},
        LJ_FIT_PRESSURE_SYS, registry={"lj_0.7_1_sim": entry}, rng=np.random.default_rng(SEED),
        device=dev)
    for msg in msgs:
        line(f"fit_lj pressure+vacf: {msg}")
    p = res["obs_log"]["lj_0.7_1_sim"]["pressure"]
    line(f"fit_lj pressure+vacf: loss {res['loss_log']}  P {p}  gradient "
         f"norm {norms}  peak memory {peak} B  call {wall:.3f} s")
    require(len(res["loss_log"]) == 1 and np.isfinite(res["loss_log"][0])
            and np.isfinite(p[0]) and p[0] != 0.0,
            "the pressure epoch gives a finite loss and pressure")
    require(len(norms) == 1 and np.isfinite(norms[0]) and norms[0] > 0,
            "the pressure epoch's MLP gradient is finite and nonzero")
    check_no_kernel(ops.counts(), "pressure fit_lj")
    out["lj_pressure"] = {"wall": wall, "peak": peak,
                          "first_s": marks[0][0]}

    # (b) fit_rdf's pair and T-dependent pair fits, the pallas RDF
    for tag, extra in (("pair", {}), ("tpair", PAIR_FIT_TPAIR)):
        sys_params = {**PAIR_FIT_SYS, **extra}
        res, msgs, marks, norms, peak, wall = pair_fit_call(
            torch, fit_rdf.fit_rdf, PAIR_FIT_ASSIGNMENTS, sys_params,
            rng=np.random.default_rng(SEED), device=dev)
        for msg in msgs:
            line(f"fit {tag}: {msg}")
        n_ep = sys_params["n_epochs"]
        losses = res["loss_log"]
        per_epoch = {name: marks[-1][1]["launches"][name]
                     - (marks[-2][1]["launches"][name] if n_ep > 1 else 0)
                     for name in RDF_KERNELS}
        total = ops.counts()
        line(f"fit {tag}: losses {losses}  gradient norms {norms}  objective "
             f"{res['objective']!r}  peak memory {peak} B; launches in the "
             f"call {total['launches']}; K3/K4 and K3b/K4b in the last "
             f"epoch {per_epoch}")
        require(not res.get("nan_bailout") and len(losses) == n_ep
                and bool(np.isfinite(losses).all())
                and np.isfinite(res["objective"]),
                f"the {tag} fit gives finite losses")
        require(len(norms) == n_ep and all(np.isfinite(norms))
                and min(norms) > 0, f"the {tag} fit's gradients are finite "
                "and nonzero")
        for name in RDF_KERNELS:
            require(per_epoch[name] > 0,
                    f"kernel {name} launched in each {tag} fit epoch")
        require(res["final"]["H20_298K_redd"]["g_sim"].shape == (800,),
                f"the {tag} fit's inference RDF has 800 bins")
        check_no_kernel(total, f"{tag} fit", allowed=RDF_KERNELS)
        rate, steady = epoch_rates(marks, n_ep)
        for name in RDF_KERNELS:
            records.setdefault(name, {})[f"launches_{tag}_fit_per_epoch"] = \
                per_epoch[name]
        out[tag] = {"epochs_per_s": rate, "steady_s": steady, "wall": wall,
                    "first_s": marks[0][0], "peak": peak,
                    "per_epoch": per_epoch, "launches": total["launches"]}

    # (c) the water GNN fit at 1728 sites: its prior is 'sparse'
    comps = fit_rdf.build_fit(FIT_ASSIGNMENTS, {**FIT_SYS_PARAMS, "size": 6},
                              rng=np.random.default_rng(SEED), device=dev)
    system, sim = comps["systems"][0], comps["sims"][0]
    prior = sim.integrator.model.models["pair"]
    gnn = sim.integrator.model.models["nn"]
    n = system.get_number_of_atoms()
    require(n == 1728 and prior.mode == "sparse",
            "the 1728-site water fit's prior is 'sparse'")
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    with CsrWidths(gather) as widths:
        sim.simulate(steps=21, dt=0.5 * units.fs, frequency=21)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts = ops.counts()
    require(not sim.overflowed and bool(torch.isfinite(sim.state.q).all()),
            "the 1728-site epoch is finite, no overflow")
    dense = mt.PairPotentials(system, comps["prior"], cutoff=6.0,
                              mode="dense", device=dev)
    q = sim.state.q.detach()
    ef = {}
    for label, inter in (("sparse", prior), ("dense", dense)):
        x = q.clone().requires_grad_(True)
        e = inter.energy(x, inter.aux_init(q))
        (g,) = torch.autograd.grad(e, x)
        ef[label] = (e, -g)
    e_rel = abs(ef["sparse"][0].item() - ef["dense"][0].item()) / abs(
        ef["dense"][0].item())
    f_err, _, f_scale = max_errs(ef["sparse"][1], ef["dense"][1])
    line(f"sparse prior (N = {n}, capacity {prior.capacity}, SchNet K = "
         f"{gnn.k_max}): one 20-step sampling epoch {epoch_s:.3f} s; "
         f"launches {counts['launches']}; CSR builds {widths.describe()}; "
         f"prior energy sparse {ef['sparse'][0].item():.7g} vs dense "
         f"{ef['dense'][0].item():.7g} (rel {e_rel:.3e}, tol 1e-5); forces "
         f"max_abs_err {f_err:.3e} (tol {1e-5 * f_scale:.3e})")
    require(e_rel <= 1e-5 and f_err <= 1e-5 * f_scale,
            "the sparse prior's energy and forces equal the dense prior's")
    for name in WATER_KERNELS[:4]:
        require(counts["launches"][name] > 0,
                f"kernel {name} launched in the 1728-site epoch")
    check_no_kernel(counts, "1728-site epoch", allowed=WATER_KERNELS[:4])
    out["sparse"] = {"epoch_s": epoch_s, "capacity": prior.capacity,
                     "k": gnn.k_max, "paths": sorted(widths.paths()),
                     "e_rel": e_rel, "f_err": f_err}
    return out


# ---- the isomerization slice (phase 4g) ---------------------------------
# fit_isomerization as scripts/run_isom_torch.py runs it (the retinal
# operators, D = 716; the Gaussian pulse of 6095 field samples; SGD at lr
# 1e-2; look_back 20000, here every frame), cut from 40 epochs to 2 and
# from 30479 RK4 steps an epoch to 10000 (the field is on throughout; it
# is off from step 15239 on): on an H100 a step took 2.6-3.9 ms from one
# call to another, and two epochs of 30479, 24000, 22000, 18000 and 12000
# steps 169.7, 143.7, 147.4, ~100 and 93.2 s, too much beside the later
# phases (4j-4l) in the smoke's time; then a 2000-step gradient held to
# the CPU port in float64
ISOM_EPOCHS, ISOM_LR, ISOM_STEPS = 2, 1e-2, 10000
ISOM_GRAD_STEPS, ISOM_GRAD_LOOK_BACK = 2000, 1000
# |g_card - g_cpu64| / |g_cpu64| of d(objective)/d(e_field) over 2000 steps
# in float32 on the card: 7.1e-6 in float32 on the CPU
ISOM_GRAD_TOL = 1e-4


class ReplayTimer:
    """Wall seconds spent in the replay adjoint's forward and backward
    (``md/adjoint.py::_Replay``) while entered, each call synchronised."""

    def __init__(self, torch, adjoint):
        self.torch, self.cls = torch, adjoint._Replay
        self.seconds = {"forward": 0.0, "backward": 0.0}

    def _timed(self, key, fn):
        def run(*args):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            self.torch.cuda.synchronize()
            self.seconds[key] += time.perf_counter() - t0
            return out
        return staticmethod(run)

    def __enter__(self):
        self.real = (self.cls.forward, self.cls.backward)
        self.cls.forward = self._timed("forward", self.real[0])
        self.cls.backward = self._timed("backward", self.real[1])
        return self

    def __exit__(self, *exc):
        self.cls.forward = staticmethod(self.real[0])
        self.cls.backward = staticmethod(self.real[1])


def isom_gradient(device, dtype, n_steps=ISOM_GRAD_STEPS,
                  look_back=ISOM_GRAD_LOOK_BACK):
    """(objective, d objective / d e_field as float64 numpy) of the retinal
    run cut to ``n_steps``: yield 4 over the last ``look_back`` frames,
    through the replay adjoint, in ``dtype`` on ``device``."""
    import torch
    from mdgrad_tpu_torch.md.isomerization import Isomerization
    from mdgrad_tpu_torch.train import isom
    q = isom.make_quants()
    t_field, e_t, _ = isom.initialize_Et()
    ode = Isomerization(q["ham"], q["dipole"], t_field, e_t,
                        max_e_t=float(t_field.max()), device=device,
                        dtype=dtype)
    traj, _ = isom.make_epoch(ode, n_steps)([ode.e_field],
                                            ode.initial_state(), (), {})
    ys = isom.calc_yields(traj.psi, *(
        torch.as_tensor(q[k], dtype=dtype, device=device)
        for k in ("prod_op", "reac_op")))
    loss = isom.objective(ys[3], look_back)
    loss.backward()
    return loss.item(), ode.e_field.grad.double().cpu().numpy()


def isom_reference(path):
    """Phase 4g's CPU float64 reference gradient, saved to ``path`` as
    [objective, gradient...]; run in a process of its own beside the
    card's epochs."""
    import numpy as np
    import torch
    torch.set_num_threads(4)     # the card's launching process keeps a core
    loss, g = isom_gradient("cpu", torch.float64)
    np.save(path, np.concatenate([[loss], g]))


def isom_phase(torch, dev):
    """Phase 4g (see the module docstring): returns its numbers."""
    import tempfile
    import numpy as np
    from mdgrad_tpu_torch import ops
    from mdgrad_tpu_torch.md import adjoint
    from mdgrad_tpu_torch.train import isom
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "isom_ref.npy")
        ref = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.isom_reference(sys.argv[1])", ref_path],
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            marks = []

            def log(msg):
                line(f"isom: {msg}")
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_counts()
            with ReplayTimer(torch, adjoint) as timer:
                t0 = time.perf_counter()
                out = isom.fit_isomerization(n_epochs=ISOM_EPOCHS, lr=ISOM_LR,
                                             n_steps=ISOM_STEPS, log=log,
                                             device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            check_no_kernel(ops.counts(), "isomerization fit")
            n_steps = ISOM_STEPS
            epochs = [b - a for a, b in zip([t0] + marks, marks)]
            ys = [y[-1] for y in out["yields_t"]]
            e0 = isom.initialize_Et()[1].astype(np.float32)
            moved = float(np.abs(out["e_field"] - e0).max())
            line(f"isom: {ISOM_EPOCHS} epochs of {n_steps} RK4 steps (D = "
                 f"716): epoch seconds {[round(e, 3) for e in epochs]}; "
                 f"replay forward {timer.seconds['forward']:.3f} s, "
                 f"backward {timer.seconds['backward']:.3f} s in all; peak "
                 f"memory {peak} B; mean yields {out['q_yields']}; the four "
                 f"yields at the last frame {ys}; the field moved by up to "
                 f"{moved:.3e}; launches of csrc/ kernels: 0")
            y4 = out["yields_t"][3]
            require(len(out["q_yields"]) == ISOM_EPOCHS
                    and bool(np.isfinite(out["q_yields"]).all()),
                    "finite mean yields")
            require(np.nanmax(y4) <= 1 + 1e-5 and np.nanmin(y4) >= -1e-5,
                    "yield 4 in [0, 1]")
            require(moved > 0, "the field moved")

            ops.reset_counts()
            t1 = time.perf_counter()
            loss, g = isom_gradient(dev, torch.float32)
            torch.cuda.synchronize()
            grad_s = time.perf_counter() - t1
            check_no_kernel(ops.counts(), "isomerization gradient")
            ref.wait(timeout=900)
            require(ref.returncode == 0, "the CPU float64 reference ran")
            blob = np.load(ref_path)
        except BaseException:
            ref.kill()
            ref.wait()
            raise
    loss_ref, g_ref = blob[0], blob[1:]
    rel = float(np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref))
    line(f"isom gradient: {ISOM_GRAD_STEPS} steps, yield 4 over the last "
         f"{ISOM_GRAD_LOOK_BACK} frames: objective {loss!r} on the card "
         f"(float32) against {loss_ref!r} on the CPU (float64); "
         f"d/d(e_field) |g - g_cpu| / |g_cpu| = {rel:.3e} (tol "
         f"{ISOM_GRAD_TOL:g}); {grad_s:.3f} s on the card")
    require(np.isfinite(g).all() and np.abs(g_ref).max() > 0
            and rel <= ISOM_GRAD_TOL,
            "the card's e_field gradient equals the CPU's float64 one")
    return {"epochs": epochs, "wall": wall, "peak": peak,
            "replay": timer.seconds, "n_steps": n_steps, "grad_rel": rel,
            "grad_s": grad_s, "q_yields": out["q_yields"]}


# ---- the multistate slice (phases 4h and 4i) ------------------------------
def load_script(name):
    """A module of ``scripts/`` by file name."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# scripts/run_water_multi_torch.py's GNN run cut from 500 epochs and 10
# rollouts to 2 and 1; its --tpair run to 1 epoch after 50 pretraining
# iterations (from 1000)
MULTI_GNN_ARGV = ["-nepochs", "2", "-nsim", "1"]
MULTI_TPAIR_ARGV = ["--tpair", "-nepochs", "1", "-nsim", "1",
                    "-pretrain", "50"]


def multistate_phase(torch, dev, records):
    """Phase 4h (see the module docstring): returns its numbers."""
    import numpy as np
    from mdgrad_tpu_torch import ops
    from mdgrad_tpu_torch.train import fit_rdf_multi
    script = load_script("run_water_multi_torch.py")
    out = {}
    for tag, argv in (("gnn", MULTI_GNN_ARGV), ("tpair", MULTI_TPAIR_ARGV)):
        assignments, sys_params, _ = script.build(argv)
        res, msgs, marks, norms, peak, wall = pair_fit_call(
            torch, fit_rdf_multi.fit_rdf_multistate, assignments, sys_params,
            rng=np.random.default_rng(SEED), device=dev)
        for msg in msgs:
            line(f"multistate {tag}: {msg}")
        n_ep = sys_params["n_epochs"]
        losses = res["loss_log"]
        prev = {name: 0 for name in marks[0][1]["launches"]}
        per_epoch = []
        for _, c in marks:
            per_epoch.append({name: c["launches"][name] - prev[name]
                              for name in prev})
            prev = c["launches"]
        total = ops.counts()
        epochs = [b - a for a, b in zip([0.0] + [t for t, _ in marks],
                                        [t for t, _ in marks])]
        line(f"multistate {tag}: {len(sys_params['data'])} states of "
             f"{8 * sys_params['size'] ** 3} sites; losses {losses}  "
             f"gradient norms {norms}  objective {res['objective']!r}; epoch "
             f"seconds {[round(e, 3) for e in epochs]} (the first from the "
             f"call, set-up included); inference {wall - marks[-1][0]:.3f} s;"
             f" peak memory {peak} B; launches per epoch {per_epoch}; in the "
             f"call {total['launches']}")
        require(not res.get("nan_bailout") and len(losses) == n_ep
                and bool(np.isfinite(losses).all())
                and np.isfinite(res["objective"]),
                f"the multistate {tag} fit gives finite losses")
        require(len(norms) == n_ep and all(np.isfinite(norms))
                and min(norms) > 0,
                f"the multistate {tag} fit's gradients are finite and nonzero")
        require(set(res["final"]) == set(sys_params["data"]) and all(
            f["g_sim"].shape == (800,) for f in res["final"].values()),
            f"the multistate {tag} inference gives 800-bin RDFs")
        if tag == "gnn":
            for c in per_epoch:
                for name in WATER_KERNELS[:4]:
                    require(c[name] > 0, f"kernel {name} launched in each "
                            "multistate epoch")
            check_no_kernel(total, "multistate fit",
                            allowed=WATER_KERNELS[:4])
            for name in WATER_KERNELS[:4]:
                records.setdefault(name, {})[
                    "launches_multistate_per_epoch"] = per_epoch[-1][name]
        else:
            # a pair MLP and the plain soft RDF: no kernel of csrc/
            check_no_kernel(total, "multistate tpair fit")
        out[tag] = {"epochs": epochs, "wall": wall, "peak": peak,
                    "per_epoch": per_epoch[-1], "losses": losses}
    return out


# fit_rdf at phase 4c's settings with the multiple-time-step chain (k = 2:
# 26 outer steps of 1.0 fs an epoch, every 10th frame), 2 epochs; then with
# the prior on the SchNet's table, 1 epoch; no rollout (the 800-bin RDF of
# the last training frame)
FIT_MTS = {"n_epochs": 2, "n_sim": 0, "mts_inner": 2}
FIT_SHARE = {"n_epochs": 1, "n_sim": 0, "share_prior_aux": True}


def mts_share_phase(torch, records):
    """Phase 4i (see the module docstring): returns its numbers."""
    import numpy as np
    from mdgrad_tpu_torch import ops
    from mdgrad_tpu_torch.md import integrators
    from mdgrad_tpu_torch.ops import gather
    from mdgrad_tpu_torch.train import fit_rdf
    mts = integrators.MTSNoseHooverChain
    real_step, real_force = mts.step, mts._keys_force
    calls = {"steps": 0, "slow": 0, "fast": 0, "inside": False}

    def step(self, *a, **kw):
        calls["steps"] += 1
        calls["inside"] = True
        try:
            return real_step(self, *a, **kw)
        finally:
            calls["inside"] = False

    def keys_force(self, keys, *a, **kw):
        if calls["inside"]:
            calls["slow" if keys == self.slow_keys else "fast"] += 1
        return real_force(self, keys, *a, **kw)

    built = {}
    real_build = fit_rdf.build_fit

    def build(*a, **kw):
        built.update(real_build(*a, **kw))
        return built

    mts.step, mts._keys_force, fit_rdf.build_fit = step, keys_force, build
    try:
        res, msgs, marks, widths, wall = fit_call(torch, fit_rdf, ops, gather,
                                                  None, **FIT_MTS)
        mts_counts = ops.counts()
        integ = built["sims"][0].integrator
        res2, msgs2, marks2, _, wall2 = fit_call(torch, fit_rdf, ops, gather,
                                                 None, **FIT_SHARE)
        share_counts = ops.counts()
        stack = built["sims"][0].integrator.model
    finally:
        mts.step, mts._keys_force = real_step, real_force
        fit_rdf.build_fit = real_build
    for msg in msgs:
        line(f"fit mts: {msg}")
    for msg in msgs2:
        line(f"fit share: {msg}")
    slow, fast = calls["slow"] / calls["steps"], calls["fast"] / calls["steps"]
    mts_epochs = [b - a for a, b in zip([0.0] + [t for t, _ in marks],
                                        [t for t, _ in marks])]
    per_epoch = {name: marks[-1][1]["launches"][name]
                 - marks[-2][1]["launches"][name] for name in WATER_KERNELS}
    line(f"fit mts: k = {integ.n_inner}, {FIT_ASSIGNMENTS['opt_freq'] // 2} "
         f"frames an epoch (outer dt 1.0 fs); forces per outer step: "
         f"{slow:g} slow (SchNet) + {fast:g} fast (prior) over "
         f"{calls['steps']} step calls (forward and replay); losses "
         f"{res['loss_log']}; epoch seconds "
         f"{[round(e, 3) for e in mts_epochs]} (the first from the call); "
         f"launches in epoch 1 {per_epoch}; call {wall:.3f} s")
    require(isinstance(integ, mts) and integ.n_inner == 2,
            "the mts fit integrates with the MTS chain")
    require(slow == 1 and fast == 3,
            "an outer step takes 1 slow and 3 fast forces")
    require(len(res["loss_log"]) == 2
            and bool(np.isfinite(res["loss_log"]).all())
            and np.isfinite(res["objective"]), "the mts fit's losses are finite")
    check_fit_counts(mts_counts, "mts fit")
    share_s = marks2[0][0]
    line(f"fit share: prior mode {stack.models['pair'].mode}, share_aux "
         f"{stack.share_aux}; loss {res2['loss_log']}; the epoch ended "
         f"{share_s:.3f} s into the call; launches {share_counts['launches']}"
         f"; call {wall2:.3f} s")
    require(stack.share_aux == {"pair": "nn"}
            and stack.models["pair"].mode == "table",
            "the shared fit's prior reads the SchNet's table")
    require(len(res2["loss_log"]) == 1 and np.isfinite(res2["loss_log"][0])
            and np.isfinite(res2["objective"]),
            "the shared fit's loss is finite")
    check_fit_counts(share_counts, "shared-prior fit")
    for name in WATER_KERNELS:
        records.setdefault(name, {})["launches_mts_fit_per_epoch"] = \
            per_epoch[name]
    return {"mts_epochs": mts_epochs, "mts_wall": wall, "slow": slow,
            "fast": fast, "share_s": share_s, "share_wall": wall2}


def bench_loss_steps(torch, fit_rdf, sim, obs, stack, n_epochs):
    """``n_epochs`` optimizer steps of bench.py's loss: one tau = 52 epoch
    through the replay adjoint, the 109-bin g(r) of every 10th frame,
    mean((g - 1)^2), clipped Adam; each epoch restarts from the last
    state.  Returns (losses, wall s, peak bytes of the first epoch)."""
    from mdgrad_tpu_torch import units
    train = fit_rdf.fit_parameters(stack)
    update = fit_rdf.FitUpdate(train, LR, GRAD_CLIP)
    ode = sim.epoch_fn(0.5 * units.fs, 52)
    ctrl = sim.integrator.default_ctrl()
    state, aux = sim.initial_state()
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for epoch in range(n_epochs):
        traj, aux = ode(state, aux, ctrl)
        _, _, g = obs(traj.q[::10])
        loss = ((g - 1.0) ** 2).mean()
        loss.backward()
        if epoch == 0:
            peak = torch.cuda.max_memory_allocated()
        update()
        sim.check_flags()
        state = traj._replace(**{
            k: getattr(traj, k)[-1].detach() for k in traj._fields
            if torch.is_tensor(getattr(traj, k))})
        losses.append(loss.item())
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t0, peak


def dense_bf16_check(torch, layer, x):
    """(outputs that differ, outputs, largest difference over its bound)
    between the bf16 product ``x W^T`` of cuBLAS (as ``nn.schnet.linear``
    computes it, before the bias) and the same bf16 operands multiplied in
    f32 (TF32 off) and rounded once.  The bound: one bf16 ulp, 2^-7 |ref|,
    plus 2^-20 of sum |x_k W_jk|, the f32 sums' order over K terms (a
    reduction in bf16 would differ by ~2^-8 of that sum)."""
    xb = x.detach().to(torch.bfloat16)
    wb = layer.weight.detach().to(torch.bfloat16)
    got = (xb @ wb.T).float()
    ref = (xb.float() @ wb.float().T).to(torch.bfloat16).float()
    terms = xb.float().abs() @ wb.float().abs().T
    diff = (got - ref).abs()
    bound = 2.0 ** -7 * ref.abs() + 2.0 ** -20 * terms
    ratio = (diff / bound.clamp_min(1e-30)).max().item()
    return int((diff > 0).sum()), diff.numel(), ratio


def bf16_phase(mt, torch, dev, records, main):
    """Phase 4d: bench.py:33-69 in bf16 (see the module docstring).  Fills
    ``records[name + '.bf16']`` with the bf16 gather kernels' launches and
    returns the phase's numbers beside the f32 ones of the same loss."""
    import numpy as np
    from mdgrad_tpu_torch import ops, units
    from mdgrad_tpu_torch.nn.layers import gaussian_smearing, shifted_softplus
    from mdgrad_tpu_torch.nn.schnet import linear
    from mdgrad_tpu_torch.train import fit_rdf
    system, stack = build_water(mt, dev, compute_dtype="bf16")
    gnn_pot = stack.models["nn"]
    require(gnn_pot.k_max == 40, f"bench.py's K = 40 at slack 1.25 "
                                 f"({gnn_pot.k_max})")
    _, stack32 = build_water(mt, dev)
    _, stack_cpu = build_water(mt, "cpu", compute_dtype="bf16")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    xyz0 = torch.tensor(system.get_positions(), dtype=torch.float32,
                        device=dev)
    xyz = xyz0 + 0.05 * torch.randn(xyz0.shape, device=dev, generator=gen)

    # the dense layers' bf16 GEMMs on cuBLAS against an f32-accumulated
    # product of the same operands, at the shapes of the first convolution
    conv = gnn_pot.gnn.convs[0]
    aux = stack.aux_init(xyz)
    table = aux["nn"]
    with torch.no_grad():
        d = xyz[:, None, :] - torch.cat([xyz, xyz.new_zeros(1, 3)])[
            table.table.long()]
        cell = gnn_pot.cell
        d = d - torch.round(d / cell) * cell
        e = torch.sqrt((d ** 2).sum(-1) + 1e-20)[..., None]
        ef = gaussian_smearing(e, conv.offsets, conv.widths)
        h = shifted_softplus(
            linear(conv.filter_in, ef.to(torch.bfloat16), torch.bfloat16))
        r = gnn_pot.gnn.embedding(gnn_pot.z)
    for label, layer, x in (("filter_in", conv.filter_in, ef),
                            ("filter_out", conv.filter_out, h),
                            ("node_filter", conv.node_filter, r)):
        n_diff, n_all, ratio = dense_bf16_check(torch, layer,
                                                x.reshape(-1, x.shape[-1]))
        line(f"bf16 dense {label} {tuple(x.shape)}: cuBLAS vs the f32-"
             f"accumulated product: {n_diff} of {n_all} outputs differ, "
             f"largest {ratio:.3f} of the bound (one bf16 ulp + 2^-20 of "
             f"sum |x w|)")
        require(ratio <= 1.0, f"the bf16 {label} GEMM accumulates in f32")

    # the bf16 force on the card against the f32 force of the same weights
    # and against the port's own bf16 force on the CPU (the split=False
    # plain versions and the CPU's GEMMs)
    def force(stk, device, x):
        integ = mt.NoseHooverChain(stk, system, T=298.0, Q=50.0,
                                   num_chains=5, device=device)
        return integ.force(x, stk.aux_init(x))

    f16 = force(stack, dev, xyz)
    f32 = force(stack32, dev, xyz)
    ops.reset_counts()
    f_cpu = force(stack_cpu, "cpu", xyz.cpu())
    cpu_calls = ops.counts()["plain_calls_bf16"]
    err32, _, scale = max_errs(f16, f32)
    err_cpu, _, _ = max_errs(f16.cpu(), f_cpu)
    # bf16's own error: 4.7% of max |F| on an H100 (PERF.md); the card's
    # bf16 against the CPU's, the same roundings in other orders: 0.6%
    # (6.5% while the card subtracted log(2) unrounded)
    line(f"bf16 force (card) vs f32 force: max_abs_err {err32:.3e} (max "
         f"|F| {scale:.3e}, tol {1e-1 * scale:.3e}); vs the bf16 force on "
         f"the CPU through the plain versions ({cpu_calls}): max_abs_err "
         f"{err_cpu:.3e} (tol {err32:.3e}, the bf16 - f32 difference)")
    require(scale > 0 and err32 <= 1e-1 * scale,
            "the bf16 force is within 10% of the f32 force")
    require(err_cpu <= err32, "the card's bf16 force is closer to the "
                              "CPU's bf16 force than bf16 is to f32")
    del stack_cpu, stack32, f_cpu

    # the sampling run: as phase 3's, at bf16, cut from its 1000 steps to
    # 500 (a frame every 20 steps, as there)
    obs = mt.observables.rdf(system, nbins=109, r_range=(1.8, 7.5),
                             backend="pallas", device=dev)
    integ = mt.NoseHooverChain(stack, system, T=298.0, Q=50.0, num_chains=5,
                               adjoint=True, device=dev)
    sim = mt.Simulation(system, integ)
    n_epochs, frequency = 25, 21
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    sim.simulate(steps=n_epochs * frequency, dt=0.5 * units.fs,
                 frequency=frequency)
    frames = torch.stack(sim.log["positions"])
    _, _, g_r = obs(frames)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    sampled = ops.counts()
    n_steps = n_epochs * (frequency - 1)
    line(f"bf16 main: {n_steps} steps + rdf on {frames.shape[0]} frames in "
         f"{sample_s:.3f} s; T_final {system.temperature():.2f} K; g(r) max "
         f"{g_r.max().item():.4f}; launches {sampled['launches']} bf16 "
         f"{sampled['launches_bf16']}")
    require(bool(torch.isfinite(frames).all())
            and bool(torch.isfinite(g_r).all()), "bf16 sampling is finite")
    require(not sim.overflowed and not sim.drifted,
            "no overflow or drift in bf16 sampling")

    # bench.py's training step, in bf16 and in f32 from the same call
    system16, stack16 = build_water(mt, dev, compute_dtype="bf16")
    sim16 = mt.Simulation(system16, mt.NoseHooverChain(
        stack16, system16, T=298.0, Q=50.0, num_chains=5, adjoint=True,
        device=dev))
    ops.reset_counts()
    losses, wall, peak = bench_loss_steps(torch, fit_rdf, sim16, obs,
                                          stack16, 3)
    trained = ops.counts()
    line(f"bf16 train: losses {losses}; 3 x 51 steps in {wall:.3f} s; "
         f"launches {trained['launches']} bf16 {trained['launches_bf16']}")
    require(bool(np.isfinite(losses).all()), "the bf16 losses are finite")
    require(not sim16.overflowed and not sim16.drifted,
            "no overflow or drift in bf16 training")
    system32, stack32 = build_water(mt, dev)
    sim32 = mt.Simulation(system32, mt.NoseHooverChain(
        stack32, system32, T=298.0, Q=50.0, num_chains=5, adjoint=True,
        device=dev))
    losses32, wall32, peak32 = bench_loss_steps(torch, fit_rdf, sim32, obs,
                                                stack32, 3)
    line(f"f32 train (bench.py's loss): losses {losses32}; 3 x 51 steps in "
         f"{wall32:.3f} s")
    for label, c in (("sampling", sampled), ("training", trained)):
        for name in GATHER_KERNELS:
            require(c["launches_bf16"][name] > 0,
                    f"bf16 {name} launched in bf16 {label}")
            require(c["launches"][name] == 0,
                    f"bf16 {label} launches no f32 {name}")
        for name in ("table_index_csr", "rdf_counts"):
            require(c["launches"][name] > 0,
                    f"{name} launched in bf16 {label}")
        for group in ("plain_calls", "plain_calls_bf16"):
            require(sum(c[group].values()) == 0,
                    f"no plain version in bf16 {label} ({c[group]})")
    for name in GATHER_KERNELS:
        records[f"{name}.bf16"] = {
            **records.get(f"{name}.bf16", {}),
            "launches": trained["launches_bf16"][name],
            "launches_per_train_step": trained["launches_bf16"][name] / 3,
            "launches_sampling": sampled["launches_bf16"][name]}
    return {"sample_steps_per_s": n_steps / sample_s,
            "train_steps_per_s": 3 * 51 / wall, "peak": peak,
            "train32_steps_per_s": 3 * 51 / wall32, "peak32": peak32,
            "sample_steps": n_steps,
            "f32_sample_steps_per_s": main["steps_per_s"],
            "err32": err32, "err_cpu": err_cpu}


def gather_phase(torch, dev, gen, gather, time_gather, index, k, compare,
                 records):
    """K1, K2a and f32 K2b against their plain versions on the cases their
    kernels special-case (``time_gather``'s F = 1, 3, 40, 128, 130, 132:
    F % 4 != 0 the scalar path, F > 128 a second pass over the row; K =
    1, 12, 40: 1, 3 and 10 warps a row in K1; four sentinel layouts), 29
    output rows over 37 values; K2b also on a row with no edges and one
    with 300 (``csr_index_cases``' ``empty_rows`` and ``one_row``); then at
    the water shape through views at a 4-byte storage offset (the scalar
    path), K2b's view giving the bits of an aligned copy (both add in
    ascending edge order).  K1 and K2b within 1e-5 of max(|ref|, 1) (f32
    sums in another order), K2a bit-exact (a copy); each gives the same
    bits on a second call."""
    import numpy as np
    rng = np.random.default_rng(SEED + 4)
    n, n_out = 37, 29
    err_k2b = 0.0

    def check_k2b(g, idx_index, what):
        got = gather._launch_table_scatter(g, idx_index)
        ref = gather.table_scatter_plain(g, idx_index.idx, idx_index.n)
        err, _, scale = max_errs(got, ref)
        require(err <= 1e-5 * max(scale, 1.0),
                f"K2b agrees with its plain version at {what}")
        require(torch.equal(got, gather._launch_table_scatter(g, idx_index)),
                f"K2b gives the same bits twice at {what}")
        return err, got

    for f in time_gather.GATHER_F:
        err_k1 = 0.0
        for k_case in time_gather.GATHER_K:
            for layout in time_gather.GATHER_LAYOUTS:
                idx = torch.tensor(time_gather.gather_index(
                    rng, layout, n, n_out, k_case), device=dev)
                v = torch.randn(n, f, device=dev, generator=gen)
                w = torch.randn(n_out * k_case, f, device=dev, generator=gen)
                got = gather._launch_gather_mul_reduce(v, w, idx, k_case)
                err, _, scale = max_errs(
                    got, gather.gather_mul_reduce_plain(v, w, idx, k_case))
                require(err <= 1e-5 * max(scale, 1.0),
                        f"K1 agrees with its plain version at F={f}, "
                        f"K={k_case}, {layout}")
                out = gather._launch_table_gather(v, idx)
                require(torch.equal(out, gather.table_gather_plain(v, idx)),
                        f"K2a is bit-exact at F={f}, K={k_case}, {layout}")
                require(torch.equal(got, gather._launch_gather_mul_reduce(
                    v, w, idx, k_case)) and torch.equal(
                    out, gather._launch_table_gather(v, idx)),
                    "K1 and K2a give the same bits on a second call")
                err_k1 = max(err_k1, err)
                err_k2b = max(err_k2b, check_k2b(
                    w, gather.TableIndex(idx, n),
                    f"F={f}, K={k_case}, {layout}")[0])
        line(f"kernel gather_mul_reduce, table_gather F={f}: K = 1, 12, 40 x "
             f"{len(time_gather.GATHER_LAYOUTS)} sentinel layouts: K1 "
             f"max_abs_err {err_k1:.3e} (tol 1e-5 of max(|ref|, 1)); K2a "
             f"bit-equal; the same bits twice")
        rec = records.setdefault("gather_mul_reduce", {})
        rec["max_abs_err"] = max(err_k1, rec.get("max_abs_err", 0.0))
    cases = {name: (idx_np, n_rows) for name, idx_np, n_rows
             in time_gather.csr_index_cases()}
    for name in ("empty_rows", "one_row"):
        idx_np, n_rows = cases[name]
        idx = torch.tensor(idx_np, device=dev)
        for f in (40, 128):
            g = torch.randn(idx_np.size, f, device=dev, generator=gen)
            err, got = check_k2b(g, gather.TableIndex(idx, n_rows),
                                 f"{name}, F={f}")
            err_k2b = max(err_k2b, err)
            key = np.where((idx_np >= 0) & (idx_np < n_rows), idx_np, n_rows)
            empty = np.bincount(key, minlength=n_rows + 1)[:n_rows] == 0
            require(not got[torch.tensor(empty, device=dev)].any(),
                    f"K2b writes zeros to the rows with no edges ({name})")
    n, f = index.n, 128
    e = index.idx.shape[0]
    buf = torch.randn(1 + n * f + e * f, device=dev, generator=gen)
    v = buf[1:1 + n * f].view(n, f)
    w = buf[1 + n * f:].view(e, f)
    require(v.data_ptr() % 16 != 0 and w.data_ptr() % 16 != 0,
            "the views break 16-byte alignment")
    line("  gather kernels at the water shape, views at a 4-byte offset:")
    compare("gather_mul_reduce", gather._launch_gather_mul_reduce(
        v, w, index.idx, k), gather.gather_mul_reduce_plain(
        v, w, index.idx, k), 1e-5)
    compare("table_gather", gather._launch_table_gather(v, index.idx),
            gather.table_gather_plain(v, index.idx), 0.0)
    err, got = check_k2b(w, index, "the water shape, 4-byte offset")
    err_k2b = max(err_k2b, err)
    require(torch.equal(got, gather._launch_table_scatter(w.clone(), index)),
            "K2b's scalar path gives the vector path's bits")
    line(f"kernel table_scatter (f32): F = "
         f"{', '.join(map(str, time_gather.GATHER_F))} x K = 1, 12, 40 x "
         f"{len(time_gather.GATHER_LAYOUTS)} sentinel layouts, rows of 0 "
         f"and 300 edges, the water shape at a 4-byte offset: max_abs_err "
         f"{err_k2b:.3e} (tol 1e-5 of max(|ref|, 1)); the same bits twice; "
         f"the scalar path's bits are the vector path's")
    rec = records.setdefault("table_scatter", {})
    rec["max_abs_err"] = max(err_k2b, rec.get("max_abs_err", 0.0))


def gather_bf16_phase(torch, dev, gen, gather, time_gather, index, k,
                      records):
    """K1, K2a and K2b's bf16 instantiations (``split=False``) against
    their plain versions on ``time_gather``'s edge cases (K1 takes the
    scalar path at F % 4 != 0, K2a at F % 8 != 0) and at the water shape,
    there also through views at a 2-byte storage offset (the scalar
    path).  K1 (f32 sums of the same products in another order, rounded
    once to bf16) within one bf16 ulp, 2^-7 |ref|, plus 1e-5 of max(|ref|,
    1); K2a bit-exact; K2b (f32 sums of bf16 rows, f32 out) within 1e-5 of
    max(|ref|, 1).  Each gives the same bits on a second call."""
    import numpy as np
    bf16 = torch.bfloat16
    rng = np.random.default_rng(SEED + 5)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(bf16)

    errs = {name: 0.0 for name in GATHER_KERNELS}

    def check(v, w, g, idx, idx_index, kk, what):
        n = v.shape[0]
        got = gather._launch_gather_mul_reduce(v, w, idx, kk, False)
        ref = gather.gather_mul_reduce_plain(v, w, idx, kk, False)
        err, _, scale = max_errs(got, ref)
        require(got.dtype == bf16 and bool(
            ((got.float() - ref.float()).abs()
             <= 2.0 ** -7 * ref.float().abs() + 1e-5 * max(scale, 1.0))
            .all()), f"bf16 K1 agrees with its plain version at {what}")
        out = gather._launch_table_gather(v, idx, False)
        require(out.dtype == bf16 and torch.equal(
            out, gather.table_gather_plain(v, idx, False)),
            f"bf16 K2a is bit-exact at {what}")
        sc = gather._launch_table_scatter(g, idx_index, False)
        ref_sc = gather.table_scatter_plain(g.float(), idx, n, False)
        err_sc, _, scale_sc = max_errs(sc, ref_sc)
        require(sc.dtype == torch.float32
                and err_sc <= 1e-5 * max(scale_sc, 1.0),
                f"bf16 K2b agrees with its plain version at {what}")
        require(torch.equal(got, gather._launch_gather_mul_reduce(
            v, w, idx, kk, False)) and torch.equal(
            out, gather._launch_table_gather(v, idx, False)) and torch.equal(
            sc, gather._launch_table_scatter(g, idx_index, False)),
            f"the bf16 kernels give the same bits twice at {what}")
        for name, e in zip(GATHER_KERNELS, (err, 0.0, err_sc)):
            errs[name] = max(errs[name], e)

    n, n_out = 37, 29
    for f in time_gather.GATHER_F:
        for k_case in time_gather.GATHER_K:
            for layout in time_gather.GATHER_LAYOUTS:
                idx = torch.tensor(time_gather.gather_index(
                    rng, layout, n, n_out, k_case), device=dev)
                check(randn(n, f), randn(n_out * k_case, f),
                      randn(n_out * k_case, f), idx,
                      gather.TableIndex(idx, n), k_case,
                      f"F={f}, K={k_case}, {layout}")
    n, f = index.n, 128
    e = index.idx.shape[0]
    check(randn(n, f), randn(e, f), randn(e, f), index.idx, index, k,
          "the water shape")
    buf = randn(1 + n * f + 2 * e * f)
    v = buf[1:1 + n * f].view(n, f)
    w = buf[1 + n * f:1 + n * f + e * f].view(e, f)
    g = buf[1 + n * f + e * f:].view(e, f)
    require(v.data_ptr() % 16 != 0 and w.data_ptr() % 16 != 0,
            "the bf16 views break 16-byte alignment")
    check(v, w, g, index.idx, index, k, "the water shape, 2-byte offset")
    require(torch.equal(gather._launch_gather_mul_reduce(v, w, index.idx, k,
                                                         False),
                        gather._launch_gather_mul_reduce(
                            v.clone(), w.clone(), index.idx, k, False)),
            "bf16 K1's scalar path gives the 8-byte path's bits")
    line(f"kernel gather bf16 (split=False): F = "
         f"{', '.join(map(str, time_gather.GATHER_F))} x K = 1, 12, 40 x "
         f"{len(time_gather.GATHER_LAYOUTS)} sentinel layouts, the water "
         f"shape and a 2-byte offset: K1 max_abs_err "
         f"{errs['gather_mul_reduce']:.3e} (tol one bf16 ulp + 1e-5 of "
         f"max(|ref|, 1)), K2a bit-equal, K2b max_abs_err "
         f"{errs['table_scatter']:.3e} (tol 1e-5 of max(|ref|, 1)); the same "
         f"bits twice")
    for name, err in errs.items():
        records.setdefault(f"{name}.bf16", {})["max_abs_err"] = err


def gather_lib_outputs(torch, gather, time_gather, lib, s, k):
    """``lib``'s K1, K2a and K2b on set ``s`` (f32 or bf16) against their
    plain versions: K2a bit-exact; in f32 K1 and K2b within 1e-5 of
    max(|ref|, 1); in bf16 K2b likewise (f32 sums) and K1 within one bf16
    ulp of the largest |ref| plus that.  Returns ({kernel: max abs
    error}, {kernel: a copy of the output})."""
    for fn in time_gather.kernel_calls(lib, s, k).values():
        fn()
    torch.cuda.synchronize()
    n = s["values"].shape[0]
    split = s["values"].dtype == torch.float32
    refs = {"gather_mul_reduce": gather.gather_mul_reduce_plain(
                s["values"], s["w"], s["idx"], k, split),
            "table_gather": gather.table_gather_plain(s["values"], s["idx"],
                                                      split),
            "table_scatter": gather.table_scatter_plain(s["g"].float(),
                                                        s["idx"], n)}
    errs = {}
    for name, ref in refs.items():
        err, _, scale = max_errs(s[name], ref)
        tol = 0.0 if name == "table_gather" else 1e-5 * max(scale, 1.0)
        if name == "gather_mul_reduce" and not split:
            tol += 2.0 ** -7 * scale
        require(err <= tol, f"{name} of the library under test agrees with "
                            f"its plain version ({err:.3e} > {tol:.3e})")
        errs[name] = err
    return errs, {name: s[name].clone() for name in refs}


def gather_ab(torch, _build, gather, time_gather, sources, sets, k, bounds,
              csr_inputs, smi):
    """Phase 5b (see the module docstring): K1, K2a and K2b of each other
    ``gather.cu`` in ``sources`` against this build's, in one process on
    the same input sets, in f32 and bf16 (``sets`` {"f32": ..., "bf16":
    ...}, ``bounds`` {dtype: {kernel: bound ms}}); and the CSR build at
    each ``{e: (idx, n)}`` of ``csr_inputs`` (the path each library picks
    and the grid forced), and with K2b after it on the main path's index.
    Prints the largest difference between the libraries' outputs: the CSR
    must be integer-equal."""
    libs = {f"other{i}": _build.library((src,))
            for i, src in enumerate(sources)}
    libs["this"] = _build.library()
    names = dict(zip(libs, [*sources, "csrc/gather.cu"]))
    outs = {}
    for tag, lib in libs.items():
        for dtype, dsets in sets.items():
            errs, outs[tag, dtype] = gather_lib_outputs(
                torch, gather, time_gather, lib, dsets[0], k)
            line(f"gather a/b: {tag} ({names[tag]}) {dtype} max_abs_err "
                 + "  ".join(f"{name} {err:.3e}"
                             for name, err in errs.items()))
        for e, (idx, n) in csr_inputs.items():
            bufs = time_gather.csr_outputs(e, n, idx.device, libs.values())
            time_gather.csr_call(lib, idx, n, bufs)()
            outs[tag, f"csr@{e}"] = bufs[:2]
            ref = gather.table_index_csr_plain(idx, n)
            require(all(torch.equal(a, b) for a, b in zip(bufs[:2], ref)),
                    f"the CSR build of {tag} equals the plain build at "
                    f"E={e}")
    for tag in libs:
        if tag == "this":
            continue
        diffs = {f"{dtype} {name}": (outs[tag, dtype][name].float()
                                     - outs["this", dtype][name].float())
                 .abs().max().item()
                 for dtype in sets for name in time_gather.KERNELS}
        for e in csr_inputs:
            diffs[f"csr@{e}"] = max(
                (a.long() - b.long()).abs().max().item() if a.numel() else 0
                for a, b in zip(outs[tag, f"csr@{e}"],
                                outs["this", f"csr@{e}"]))
            require(diffs[f"csr@{e}"] == 0,
                    f"the CSR builds of {tag} and this build are "
                    f"integer-equal at E={e}")
        line(f"gather a/b: largest |{tag} - this| " + "  ".join(
            f"{name} {d:.3e}" for name, d in diffs.items()))
    order = list(libs)
    turns = (order + order[::-1]) * ROUNDS
    runs = {tag: [] for tag in libs}
    for i, tag in enumerate(turns):
        r = {dtype: time_gather.warm_cold(libs[tag], dsets, k)
             for dtype, dsets in sets.items()}
        r["csr"] = time_gather.csr_times(libs[tag], csr_inputs,
                                         sets["f32"][0], k, libs.values())
        runs[tag].append(r)
        line(f"gather a/b turn {i} {tag}: " + "  ".join(
            f"{name}.{dtype} warm {r[dtype][name]['ms'] * 1e3:.2f} us cold "
            f"{r[dtype][name]['cold_ms'] * 1e3:.2f} us"
            for dtype in sets for name in time_gather.KERNELS)
            + "  launch floor " + "  ".join(
            f"{name}.{dtype} {t * 1e3:.2f} us" for dtype in sets
            for name, t in r[dtype]["launch_floor"].items())
            + "  " + "  ".join(f"{label} {t * 1e3:.2f} us"
                               for label, t in r["csr"].items()))
    median = {}
    for tag, rs in runs.items():
        # K1's and K2a's one-row floors, "{kernel}.{dtype}"
        median[tag] = {"launch_floor": {
            f"{name}.{dtype}": statistics.median(
                r[dtype]["launch_floor"][name] for r in rs)
            for dtype in sets for name in rs[0][dtype]["launch_floor"]}}
        for dtype in sets:
            for name in time_gather.KERNELS:
                warm = statistics.median(r[dtype][name]["ms"] for r in rs)
                cold = statistics.median(r[dtype][name]["cold_ms"]
                                         for r in rs)
                b = bounds[dtype][name]
                median[tag][f"{name}.{dtype}"] = {
                    "ms": warm, "cold_ms": cold,
                    "cold_share_of_bound": b / cold}
                floor = median[tag]["launch_floor"].get(f"{name}.{dtype}")
                line(f"gather a/b median {tag} {name}.{dtype}: warm "
                     f"{warm * 1e3:.2f} us  cold {cold * 1e3:.2f} us  "
                     + ("" if floor is None
                        else f"one-row floor {floor * 1e3:.2f} us  ")
                     + f"bound {b * 1e3:.3f} us (bytes)  cold share of "
                     f"bound {b / cold:.1%}")
        median[tag]["csr"] = {
            label: statistics.median(r["csr"][label] for r in rs)
            for label in rs[0]["csr"]}
        line(f"gather a/b median {tag} launch floor (one row): " + "  ".join(
            f"{name} {t * 1e3:.2f} us"
            for name, t in median[tag]["launch_floor"].items()))
        line(f"gather a/b median {tag} CSR build (warm): " + "  ".join(
            f"{label} {t * 1e3:.2f} us"
            for label, t in median[tag]["csr"].items()))
    paths = {tag: {e: lib_csr_path(lib, e, n)
                   for e, (_, n) in csr_inputs.items()}
             for tag, lib in libs.items()}
    line(f"gather a/b CSR paths: {paths}")
    # each launch of the grid build apart (torch.profiler's card events)
    launches = {tag: {} for tag in libs}
    for e, (idx, n) in csr_inputs.items():
        bufs = time_gather.csr_outputs(e, n, idx.device, libs.values())
        for tag, lib in libs.items():
            launches[tag][f"csr_grid@{e}"] = times = \
                time_gather.csr_launch_times(lib, idx, n, bufs, cluster=False)
            line(f"gather a/b CSR grid build launches {tag} E={e}: "
                 + "  ".join(f"{name} {t * 1e3:.2f} us"
                             for name, t in times.items())
                 + f"  sum {sum(times.values()) * 1e3:.2f} us")
    line(json.dumps({"gather_ab": {
        "sources": names, "csr_paths": paths, "csr_launches": launches,
        "rounds": ROUNDS, "sets": len(sets["f32"]), "bound_ms": bounds,
        "median": median, "runs": runs, "card": smi}}))


def lib_csr_path(lib, e, n):
    """The CSR build a library of ``gather.cu`` takes at (e, n): "cluster"
    or "grid", or, for a library from before the cluster build, "one
    block" or "grid"."""
    for entry, fast in (("mdg_table_index_csr_cluster", "cluster"),
                        ("mdg_table_index_csr_one_block", "one block")):
        if hasattr(lib, entry):
            code = getattr(lib, entry)(e, n)
            require(code >= 0, f"{entry} reads the card's limits")
            return fast if code else "grid"
    return "unknown"


def rdf_phase(torch, dev, gen, rdf_ops, time_rdf, op, op_infer, op_pair,
              frames_test, compare):
    """K3/K4 and K3b/K4b against their plain versions at the water path's
    shapes (1, 3 and 50 frames of 512), the same bits on a second call;
    K3/K4 likewise at the fit's inference shape (``op_infer``: 1 frame, 800
    bins); both at the water pair fits' (``op_pair``: 10 frames, 400 bins);
    then on ``time_rdf.edge_cases``; and the library's reach argument is
    ``ops/rdf.py``'s ``REACH_ARG``."""
    from mdgrad_tpu_torch.ops import _build
    reach_arg = _build.library().mdg_rdf_reach_arg()
    line(f"  rdf reach argument: csrc/rdf.cu {reach_arg!r}, ops/rdf.py "
         f"{rdf_ops.REACH_ARG!r}")
    require(reach_arg == rdf_ops.REACH_ARG,
            "csrc/rdf.cu's kReachArg is ops/rdf.py's REACH_ARG")
    # K3/K4: f32 sums of ~1e4-1e6 exponentials per bin in another order
    # -> ~1e-6 relative; 1e-4 of the largest bin leaves a wide margin.
    # K3b/K4b: f32 sums of ~1e4-1e6 terms per site in another order; held
    # to 1e-4 of the largest |dxyz|, with a random cotangent
    ct_bins = torch.randn(op.mu.shape[0], device=dev, generator=gen)
    args = (op.cell_len, op.mu, op.coeff, op.cutoff)
    for f in (1, 3, 50):
        x = frames_test[:f].contiguous()
        got = rdf_ops._launch(x, *args)
        line(f"  rdf_counts F={f}:")
        compare("rdf_counts", got, rdf_ops.rdf_counts_plain(x, *args), 1e-4)
        require(torch.equal(got, rdf_ops._launch(x, *args)),
                "K3/K4 give the same bits on a second call")
        got = rdf_ops._launch_bwd(x, *args, ct_bins)
        line(f"  rdf_counts_bwd F={f}:")
        compare("rdf_counts_bwd", got,
                rdf_ops.rdf_counts_bwd_plain(x, *args, ct_bins), 1e-4,
                floor=0.0)
        require(torch.equal(got, rdf_ops._launch_bwd(x, *args, ct_bins)),
                "K3b/K4b give the same bits on a second call")
    x = frames_test[:1].contiguous()
    args = (op_infer.cell_len, op_infer.mu, op_infer.coeff, op_infer.cutoff)
    got = rdf_ops._launch(x, *args)
    line(f"  rdf_counts F=1 bins={op_infer.mu.shape[0]} (the fit's "
         f"inference):")
    compare("rdf_counts", got, rdf_ops.rdf_counts_plain(x, *args), 1e-4)
    require(torch.equal(got, rdf_ops._launch(x, *args)),
            "K3/K4 give the same bits on a second call at 800 bins")
    x = frames_test[:10].contiguous()
    args = (op_pair.cell_len, op_pair.mu, op_pair.coeff, op_pair.cutoff)
    ct_pair = torch.randn(op_pair.mu.shape[0], device=dev, generator=gen)
    got = rdf_ops._launch(x, *args)
    line(f"  rdf_counts F=10 bins={op_pair.mu.shape[0]} (the water pair "
         f"fits):")
    compare("rdf_counts", got, rdf_ops.rdf_counts_plain(x, *args), 1e-4)
    require(torch.equal(got, rdf_ops._launch(x, *args)),
            "K3/K4 give the same bits on a second call at 400 bins")
    got = rdf_ops._launch_bwd(x, *args, ct_pair)
    line(f"  rdf_counts_bwd F=10 bins={op_pair.mu.shape[0]} (the water pair "
         f"fits):")
    compare("rdf_counts_bwd", got,
            rdf_ops.rdf_counts_bwd_plain(x, *args, ct_pair), 1e-4, floor=0.0)
    require(torch.equal(got, rdf_ops._launch_bwd(x, *args, ct_pair)),
            "K3b/K4b give the same bits on a second call at 400 bins")
    for name, xyz, cell, mu, widths, cutoff, ct in time_rdf.edge_cases():
        case = rdf_ops.RDFCounts(cell, mu, widths, cutoff, dev)
        x = torch.tensor(xyz, device=dev)
        ct = torch.tensor(ct, device=dev)
        args = (case.cell_len, case.mu, case.coeff, case.cutoff)
        line(f"  rdf edge case {name}: F={x.shape[0]} N={x.shape[1]} "
             f"bins={mu.shape[0]}")
        compare("rdf_counts", rdf_ops._launch(x, *args),
                rdf_ops.rdf_counts_plain(x, *args), 1e-4)
        compare("rdf_counts_bwd", rdf_ops._launch_bwd(x, *args, ct),
                rdf_ops.rdf_counts_bwd_plain(x, *args, ct), 1e-4, floor=0.0)


def reach_phase(time_rdf, paths):
    """torch's float32 exp on the card exactly +0 from each bin's reach on
    (the terms the RDF kernels skip), at the bins of the ops the paths
    built (``paths`` {name: RDFCounts})."""
    for name, op in paths.items():
        top = time_rdf.exp_beyond_reach(op.coeff).abs().max().item()
        line(f"  exp beyond the reach ({name} bins, {op.mu.shape[0]} of "
             f"them, on the card): largest {top!r}")
        require(top == 0.0, "float32 exp on the card is +0 from the reach on")


def rdf_times(torch, rdf_ops, time_rdf, timing, gen, inputs):
    """{kernel: {shape: numbers}}: K3/K4 and K3b/K4b at ``RDF_SHAPES``
    (``inputs`` {shape: (xyz (F, N, 3), RDFCounts)}), device times from
    CUDA graphs, the plain versions' from host loops (they read masks on
    the host), and the bound from ``time_rdf.work`` on these inputs: the
    exponentials inside the reach at the SFU's rate, the f32 operations,
    the bytes."""
    out = {}
    for name, shapes in RDF_SHAPES.items():
        bwd = name == "rdf_counts_bwd"
        for shape in shapes:
            x, op = inputs[shape]
            args = (op.cell_len, op.mu, op.coeff, op.cutoff)
            ct = torch.randn(op.mu.shape[0], device=x.device, generator=gen)
            if bwd:
                ms = timing.time_graph(
                    lambda: rdf_ops._launch_bwd(x, *args, ct), reps=20)
                plain_ms = timing.time_loop(
                    lambda: rdf_ops.rdf_counts_bwd_plain(x, *args, ct),
                    reps=3)
            else:
                ms = timing.time_graph(lambda: rdf_ops._launch(x, *args),
                                       reps=20)
                plain_ms = timing.time_loop(
                    lambda: rdf_ops.rdf_counts_plain(x, *args), reps=3)
            work = time_rdf.work(x, op, bwd)
            b_ms, pipe = bound_pipe(work["bytes"], work["ops"], work["exps"])
            out.setdefault(name, {})[shape] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": "bytes" if pipe == "hbm" else "operations",
                "bound_pipe": pipe, "share_of_bound": b_ms / ms, **work}
            line(f"time {name} {shape}: kernel {ms * 1e3:.2f} us  plain "
                 f"{plain_ms * 1e3:.2f} us  library none  bound "
                 f"{b_ms * 1e3:.3f} us ({pipe}; {work['exps']} exp inside "
                 f"the reach, {work['ops']} ops, {work['bytes']} B; "
                 f"{work['pairs_inside']} i<j pairs inside {op.cutoff}), "
                 f"{b_ms / ms:.1%} of it")
    return out


def rdf_ab(torch, _build, rdf_ops, time_rdf, timing, sources, inputs, gen,
           smi):
    """Phase 5b for ``rdf*.cu`` sources (see the module docstring): K3/K4
    and K3b/K4b of each other ``rdf.cu`` in ``sources`` against this
    build's, in one process on the same inputs (``inputs`` as for
    :func:`rdf_times`), each library through its own C interface."""
    libs = {f"other{i}": _build.library((src,))
            for i, src in enumerate(sources)}
    libs["this"] = _build.library()
    names = dict(zip(libs, [*sources, "csrc/rdf.cu"]))
    cts = {shape: torch.randn(op.mu.shape[0], device=x.device, generator=gen)
           for shape, (x, op) in inputs.items()}
    calls = {tag: {shape: time_rdf.calls(lib, x, op, cts[shape])
                   for shape, (x, op) in inputs.items()}
             for tag, lib in libs.items()}
    for shape, (x, op) in inputs.items():
        args = (op.cell_len, op.mu, op.coeff, op.cutoff)
        refs = {"rdf_counts": rdf_ops.rdf_counts_plain(x, *args),
                "rdf_counts_bwd": rdf_ops.rdf_counts_bwd_plain(
                    x, *args, cts[shape])}
        for tag in libs:
            errs = []
            for name, (fn, out) in calls[tag][shape].items():
                fn()
                torch.cuda.synchronize()
                err, _, scale = max_errs(out, refs[name])
                require(err <= 1e-4 * scale,
                        f"{name} of {names[tag]} agrees with its plain "
                        f"version at {shape} ({err:.3e} > {1e-4 * scale:.3e})")
                errs.append(f"{name} {err:.3e}")
            line(f"rdf a/b: {tag} ({names[tag]}) {shape} max_abs_err "
                 + "  ".join(errs))
    order = list(libs)
    turns = (order + order[::-1]) * ROUNDS
    runs = {tag: [] for tag in libs}
    for i, tag in enumerate(turns):
        r = {name: {shape: timing.time_graph(calls[tag][shape][name][0],
                                             reps=20)
                    for shape in shapes}
             for name, shapes in RDF_SHAPES.items()}
        runs[tag].append(r)
        line(f"rdf a/b turn {i} {tag}: " + "  ".join(
            f"{name} {shape} {t * 1e3:.2f} us"
            for name, by in r.items() for shape, t in by.items()))
    median = {tag: {name: {shape: statistics.median(r[name][shape]
                                                    for r in rs)
                           for shape in shapes}
                    for name, shapes in RDF_SHAPES.items()}
              for tag, rs in runs.items()}
    for tag, by_name in median.items():
        line(f"rdf a/b median {tag}: " + "  ".join(
            f"{name} {shape} {t * 1e3:.2f} us"
            for name, by in by_name.items() for shape, t in by.items()))
    line(json.dumps({"rdf_ab": {
        "sources": names, "rounds": ROUNDS, "median": median, "runs": runs,
        "card": smi}}))


def csr_phase(torch, dev, gather, time_gather, index, g_edges, records):
    """K2b's CSR build against the plain build, integer-equal and the same
    integers twice, through the path the build takes and through the grid
    build forced, on the main path's index and ``time_gather``'s cases:
    the edge cases, the water tables at K = 16 to 72, each side of the
    cluster build's capacity and the grid build's shapes; the library's
    path equal to ``table_index_csr_path``'s; K2b bit-equal through the
    kernel's and the plain CSR on the main path's index and on the grid
    build's tables (``time_gather.CSR_GRID_CASES``, F = 128)."""
    from mdgrad_tpu_torch.ops import _build
    lib = _build.library()
    cases = [("main path", index.idx.cpu().numpy(), index.n),
             *time_gather.csr_index_cases()]
    paths = {}
    for name, idx_np, n in cases:
        idx = torch.tensor(idx_np, device=dev)
        ref = gather.table_index_csr_plain(idx, n)
        path = gather.table_index_csr_path(idx_np.size, n)
        require(path == ("cluster" if lib.mdg_table_index_csr_cluster(
            idx_np.size, n) else "grid"),
            f"the library's CSR path is table_index_csr_path's ({name})")
        for cluster in (True, False):
            got = gather._launch_table_index_csr(idx, n, cluster)
            again = gather._launch_table_index_csr(idx, n, cluster)
            taken = path if cluster else "grid, forced"
            require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                    f"the CSR kernel ({taken}) equals the plain build on "
                    f"case {name}")
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"the CSR kernel ({taken}) gives the same integers "
                    f"twice on case {name}")
        paths[name] = path
        line(f"kernel table_index_csr {name} (E={idx_np.size}, n={n}): "
             f"order and rowptr integer-equal to the plain build, twice "
             f"(the {path} path and the grid path forced)")
    for k_w in time_gather.CSR_WATER_K:
        require(gather.table_index_csr_path(512 * k_w, 512) == "cluster",
                f"the water table at K = {k_w} takes the cluster build")
    records.setdefault("table_index_csr", {})["max_abs_err"] = 0.0
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    k2b_inputs = [("main path", index.idx, index.n, g_edges)] + [
        (name, torch.tensor(idx_np, device=dev), n,
         torch.randn(idx_np.size, 128, device=dev, generator=gen))
        for name, idx_np, n in time_gather.csr_index_cases()
        if name in time_gather.CSR_GRID_CASES]
    for name, idx, n, g in k2b_inputs:
        outs = []
        for csr in (gather._launch_table_index_csr(idx, n),
                    gather.table_index_csr_plain(idx, n)):
            with_csr = gather.TableIndex(idx, n)
            with_csr._csr = csr
            outs.append(gather._launch_table_scatter(g, with_csr))
        require(torch.equal(outs[0], outs[1]),
                f"K2b gives the same bits through the kernel's and the "
                f"plain CSR ({name})")
    line("kernel table_scatter: bit-equal through the CSR kernel's and the "
         "plain build's inverse on " + ", ".join(
             f"{name} (E={idx.numel()}, n={n})"
             for name, idx, n, _ in k2b_inputs))


# ---- the LJ slice --------------------------------------------------------
# FCC at a = 1.679 in reduced units (the LJ liquid's density, 0.845), the
# shapes of benchmarks/bench_pair_kernel.py and bench_large_n.py
LJ_A, LJ_CUTOFF = 1.679, 2.5
LJ_LR = 1e-3
# operations the function needs per i < j pair (u depends on r_ij only, so
# each pair is counted once): 15 for every pair -- 3 subtractions, 3 x
# (division, rint, fma) minimum image, 3 for r^2 -- plus, per pair inside
# the cutoff: 1/r^2, (s/r)^2 = sigma^2 / r^2, its 3rd and 6th powers (5);
# g = u'/r (4); +-g d to both sites (9) -- that is K6's 18; K5 adds u and
# its sum (3); K7 adds the dU/dsigma and U/eps terms and their sums (7);
# K6b takes the powers and g (9), then h (4), W_j - W_i (3), (W_j - W_i) .
# d (3), h (W.d) (1), h (W.d) d + g W (6), +- it to both sites (6),
# dg/dsigma (4) and the two scalar sums (2), as d(W.F)/dsigma sums
# dg/dsigma ((W_j - W_i) . d) over i < j: 38
LJ_OPS_PER_PAIR = 15
LJ_OPS_INSIDE = {"lj_energy_forces": 21, "lj_force": 18,
                 "lj_force_vjp": 38, "lj_force_param": 25}


def lj_system(mt, n_cells, temperature, seed):
    """FCC LJ box of 4 n_cells^3 atoms, Maxwell-Boltzmann velocities at
    ``temperature`` (energy units) and positions perturbed by 0.05, both
    from ``seed``, as benchmarks/bench_large_n.py builds it."""
    import numpy as np
    from mdgrad_tpu_torch import units
    system = mt.System.from_lattice("fcc", n_cells, LJ_A)
    rng = np.random.default_rng(seed)
    system.set_temperature(temperature / units.kB, rng=rng)
    system.positions = system.positions + 0.05 * rng.standard_normal(
        system.positions.shape)
    return system


def lj_pairs_inside(torch, xyz, cell, cutoff, chunk=1024):
    """i < j pairs with r^2 < cutoff^2 under the minimum image."""
    n = xyz.shape[0]
    cut_sq = torch.tensor(cutoff, dtype=torch.float32) ** 2
    cols = torch.arange(n, device=xyz.device)
    total = 0
    for i0 in range(0, n, chunk):
        rows = torch.arange(i0, min(i0 + chunk, n), device=xyz.device)
        d = xyz[rows][:, None, :] - xyz[None, :, :]
        d = d - torch.round(d / cell) * cell
        inside = ((d * d).sum(-1) < cut_sq.item()) & (cols > rows[:, None])
        total += int(inside.sum())
    return total


# each LJ kernel's scalar outputs, in the order it returns them
LJ_SCALARS = {"lj_energy_forces": ("energy",), "lj_force": (),
              "lj_force_vjp": ("d(W.F)/dsigma", "d(W.F)/deps"),
              "lj_force_param": ("dU/dsigma", "U/eps")}
LJ_SCRATCH_N = (1, 2, 63, 64, 65, 100, 1372, 4000, 8788)


def lj_kernel_phase(mt, torch, dev, gen, compare, compare_scalar):
    """K5, K6, K6b and K7, the four modes of the i < j walk, against their
    plain versions on the card: FCC at N = 108, 100 of them (the bounds
    mask), 1372 (not a multiple of the tile) and 4000, powers (12, 6),
    plus (9, 6) and (12, 0) at 108; then at N = 2 and 8788, on positions
    unwrapped by whole cells (the IEEE image, kFar), on pairs at the
    minimum image's edges and on pairs whose r^2 lies within an ulp of
    cutoff^2 (``ops/time_pair.py``).  A seeded cotangent W for K6b; every
    kernel gives the same bits on a second call.  The library's tile and
    scratch sizes are ``ops/pair.py``'s."""
    import numpy as np
    from mdgrad_tpu_torch.ops import _build, pair, time_pair
    lib = _build.library()
    require(lib.mdg_force_tile() == pair.FORCE_TILE,
            "ops/pair.py's FORCE_TILE is csrc/pair.cu's")
    for mode, name in enumerate(LJ_KERNELS):
        for n in LJ_SCRATCH_N:
            got = tuple(lib.mdg_lj_scratch(mode, n, which) for which in (0, 1))
            require(got == pair.lj_scratch(name, n),
                    f"mdg_lj_scratch of {name} at N={n} is ops/pair.py's "
                    f"lj_scratch ({got} != {pair.lj_scratch(name, n)})")
    line(f"  lj scratch: mdg_lj_scratch equals ops/pair.py's lj_scratch for "
         f"the four kernels at N = {LJ_SCRATCH_N}")
    sigma = torch.tensor(0.95, device=dev)
    eps = torch.tensor(1.1, device=dev)

    def check(xyz, w, args, names):
        """``names`` against their plain versions (f32 sums of ~10^2-10^4
        pair terms per row and of ~10^4-10^5 per scalar, in another
        order: ~1e-6 relative), each the same bits twice; the results."""
        out = {}
        for name in names:
            launch, plain = pair._KERNELS[name]
            vec = (xyz, w) if name == "lj_force_vjp" else (xyz,)
            got = time_pair.split(name, launch(*vec, *args))
            ref = time_pair.split(name, plain(*vec, *args))
            again = time_pair.split(name, launch(*vec, *args))
            compare(name, got[0], ref[0], 1e-5)
            for label, a, b in zip(LJ_SCALARS[name], got[1], ref[1]):
                compare_scalar(name, label, a, b, 1e-4)
            require(all(torch.equal(a, b) for a, b in
                        zip((got[0], *got[1]), (again[0], *again[1]))),
                    f"{name} gives the same bits on every call (the replay "
                    f"needs it)")
            out[name] = got[0], ref[0]
        return out

    cases = [(3, None, 12, 6), (3, 100, 12, 6), (3, None, 9, 6),
             (3, None, 12, 0), (7, None, 12, 6), (10, None, 12, 6)]
    for n_cells, n_take, rep, attr in cases:
        system = lj_system(mt, n_cells, 1.2, SEED + n_cells)
        cell = tuple(np.diag(system.cell))
        xyz = torch.tensor(system.positions, dtype=torch.float32,
                           device=dev)[:n_take].contiguous()
        w = torch.randn(xyz.shape, device=dev, generator=gen)
        line(f"  lj kernels: N={xyz.shape[0]} powers ({rep}, {attr})")
        check(xyz, w, (cell, LJ_CUTOFF, sigma, eps, rep, attr), LJ_KERNELS)
    for n_cells, n_take, unwrap in ((3, 2, False), (13, None, False),
                                    (7, None, True)):
        system = lj_system(mt, n_cells, 1.2, SEED + n_cells)
        cell = tuple(np.diag(system.cell))
        xyz_np = system.positions.astype(np.float32)[:n_take]
        if unwrap:
            xyz_np = time_pair.unwrapped(xyz_np, cell, SEED)
        xyz = torch.tensor(xyz_np, device=dev)
        w = torch.randn(xyz.shape, device=dev, generator=gen)
        line(f"  lj i<j walks: N={xyz.shape[0]}"
             + (" unwrapped by -2 to 2 cells" if unwrap else ""))
        check(xyz, w, (cell, LJ_CUTOFF, sigma, eps), LJ_KERNELS)
    for L, axis, xyz_np, cell, cutoff, sig in time_pair.lj_edge_cases():
        xyz = torch.tensor(xyz_np, device=dev)
        args = (cell, cutoff, torch.tensor(sig, dtype=torch.float32,
                                           device=dev), eps)
        line(f"  lj i<j walks, image edges: L={L} axis {axis}")
        check(xyz, time_pair.pair_image_w(xyz, cell), args, LJ_KERNELS)
    xyz_np, cell, n_out = time_pair.cutoff_edge_case(LJ_CUTOFF)
    xyz = torch.tensor(xyz_np, device=dev)
    line(f"  lj i<j walks, cutoff edge: {n_out} pairs with r^2 within an "
         f"ulp of cutoff^2 (out by the stepwise sum, in by a fused one)")
    res = check(xyz, time_pair.pair_image_w(xyz, cell),
                (cell, LJ_CUTOFF, sigma, eps), LJ_KERNELS)
    for name, (got, ref) in res.items():
        require(torch.equal(got.abs().sum(1) > 0, ref.abs().sum(1) > 0)
                and int((ref.abs().sum(1) > 0).sum()) == 2,
                f"{name} leaves out exactly the pairs at the cutoff edge "
                f"that its plain version leaves out")
    try:
        pair._launch_force(xyz.double(), cell, LJ_CUTOFF, sigma.double(),
                           eps.double())
        raised = False
    except TypeError:
        raised = True
    require(raised, "a float64 tensor on the card raises TypeError")
    torch.cuda.synchronize()


def pair_ab(mt, torch, dev, _build, sources, gen, smi):
    """Phase 5b for ``pair*.cu`` sources (see the module docstring): K5,
    K6, K6b and K7 of each other ``pair.cu`` in ``sources`` against this
    build's at N = 1372 and 4000, in one process on the same inputs, each
    library's scratch sized by its own C interface (``time_pair.calls``).
    One line per kernel gives the largest difference between each other
    library's outputs and this build's (vector; scalars relative): 0 where
    the kernel's code is the same, the summation order's where it is
    not."""
    import numpy as np
    from mdgrad_tpu_torch.ops import pair, time_pair, timing
    libs = {f"other{i}": _build.library((src,))
            for i, src in enumerate(sources)}
    libs["this"] = _build.library()
    names = dict(zip(libs, [*sources, "csrc/pair.cu"]))
    sigma = torch.tensor(0.9, device=dev)
    eps = torch.tensor(1.0, device=dev)
    calls = {tag: {} for tag in libs}
    diffs = {name: {} for name in time_pair.AB_KERNELS}
    sizes = []
    for n_cells in (7, 10):
        system = lj_system(mt, n_cells, 1.2, SEED)
        n = system.get_number_of_atoms()
        sizes.append(n)
        cell = tuple(np.diag(system.cell))
        xyz = torch.tensor(system.positions, dtype=torch.float32, device=dev)
        w = torch.randn(xyz.shape, device=dev, generator=gen)
        args = (cell, LJ_CUTOFF, sigma, eps)
        refs = {name: time_pair.split(name, pair._KERNELS[name][1](
                    *((xyz, w) if name == "lj_force_vjp" else (xyz,)), *args))
                for name in time_pair.AB_KERNELS}
        for tag, lib in libs.items():
            calls[tag][n] = time_pair.calls(lib, xyz, w, *args)
            errs = []
            for name, (fn, (vec, scalars)) in calls[tag][n].items():
                fn()
                torch.cuda.synchronize()
                err, _, scale = max_errs(vec, refs[name][0])
                require(err <= 1e-5 * max(scale, 1.0),
                        f"{name} of {names[tag]} agrees with its plain "
                        f"version at N={n} ({err:.3e})")
                for a, b in zip(() if scalars is None else scalars,
                                refs[name][1]):
                    rel = abs(a.item() - b.item()) / abs(b.item())
                    require(rel <= 1e-4, f"{name} of {names[tag]}: a scalar "
                                         f"agrees at N={n} ({rel:.3e})")
                errs.append(f"{name} {err:.3e}")
            line(f"pair a/b: {tag} ({names[tag]}) N={n} max_abs_err "
                 + "  ".join(errs))
        for name in time_pair.AB_KERNELS:
            vec, scalars = calls["this"][n][name][1]
            for tag in (t for t in libs if t != "this"):
                o_vec, o_scalars = calls[tag][n][name][1]
                rel = ([] if scalars is None else
                       [abs(a.item() - b.item()) / abs(b.item())
                        for a, b in zip(o_scalars, scalars)])
                diffs[name][f"{tag} N={n}"] = {
                    "vec": (o_vec - vec).abs().max().item(),
                    "scalars_rel": max(rel, default=None)}
    for name, by in diffs.items():
        line(f"pair a/b diff {name} vs this build: " + "  ".join(
            f"{key} vec {d['vec']:.3e} scalars "
            + ("-" if d["scalars_rel"] is None else f"{d['scalars_rel']:.3e}")
            for key, d in by.items()))
    order = list(libs)
    turns = (order + order[::-1]) * ROUNDS
    runs = {tag: [] for tag in libs}
    for i, tag in enumerate(turns):
        r = {name: {n: timing.time_graph(calls[tag][n][name][0], reps=20)
                    for n in sizes}
             for name in time_pair.AB_KERNELS}
        runs[tag].append(r)
        line(f"pair a/b turn {i} {tag}: " + "  ".join(
            f"{name} N={n} {t * 1e3:.2f} us"
            for name, by in r.items() for n, t in by.items()))
    median = {tag: {name: {n: statistics.median(r[name][n] for r in rs)
                           for n in sizes}
                    for name in time_pair.AB_KERNELS}
              for tag, rs in runs.items()}
    for tag, by_name in median.items():
        line(f"pair a/b median {tag}: " + "  ".join(
            f"{name} N={n} {t * 1e3:.2f} us"
            for name, by in by_name.items() for n, t in by.items()))
    line(json.dumps({"pair_ab": {
        "sources": names, "rounds": ROUNDS, "median": median, "runs": runs,
        "diff_vs_this": diffs, "card": smi}}))


def lj_sampling_phase(mt, torch, dev, records):
    """Large-N LJ NVE sampling (benchmarks/bench_large_n.py's run): N =
    4000, T = 1.2, PallasLJPair(sigma 0.9, eps 1.0, cutoff 2.5), dt 0.002,
    50 epochs of frequency 20 (19 steps each, so 950 steps and 1000
    forces); the total energy from K5 plus the kinetic energy at both
    ends."""
    from mdgrad_tpu_torch import ops
    system = lj_system(mt, 10, 1.2, SEED)
    inter = mt.ops.PallasLJPair(system, LJ_CUTOFF, sigma=0.9, epsilon=1.0,
                                device=dev)
    integ = mt.NVE(inter, system, adjoint=False, device=dev)
    sim = mt.Simulation(system, integ)

    def total_energy(q, v):
        with torch.no_grad():
            return (inter.energy(q, ()) + 0.5 * (integ.masses * v * v).sum())

    n_epochs, frequency = 50, 20
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    state, _ = sim.initial_state()
    e0 = total_energy(state.q, state.v)
    traj = sim.simulate(steps=n_epochs * frequency, dt=0.002,
                        frequency=frequency)
    e1 = total_energy(traj.q[-1], traj.v[-1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.counts()
    n_steps = n_epochs * (frequency - 1)
    e0, e1 = e0.item(), e1.item()
    drift = abs(e1 - e0) / abs(e0)
    line(f"lj sampling: N={system.get_number_of_atoms()} NVE, {n_steps} steps ({n_epochs} epochs of "
         f"{frequency - 1}) in {wall:.3f} s: {n_steps / wall:.2f} steps/s; "
         f"E_0 {e0:.6f}  E_end {e1:.6f}  |dE|/|E_0| {drift:.3e} (tol 1e-2)")
    line(f"lj sampling: launches {counts['launches']}  plain_calls "
         f"{counts['plain_calls']}")
    require(bool(torch.isfinite(traj.q).all())
            and bool(torch.isfinite(traj.v).all()), "LJ trajectory finite")
    require(drift < 1e-2, "LJ NVE conserves energy to 1e-2")
    expected = {"lj_force": n_epochs * frequency, "lj_energy_forces": 2}
    for name, c in counts["launches"].items():
        require(c == expected.get(name, 0),
                f"LJ sampling launches {name} {expected.get(name, 0)} times "
                f"(got {c})")
    require(sum(counts["plain_calls"].values()) == 0,
            "no plain version in LJ sampling")
    for name in LJ_KERNELS:
        records.setdefault(name, {})["launches_lj_sampling"] = \
            counts["launches"][name]
    return {"steps_per_s": n_steps / wall, "drift": drift}


def lj_fit_phase(mt, torch, dev, gen, compare, records):
    """The sigma/epsilon fit chain at N = 1372: one NVE epoch of frequency
    50 (dt 0.002) through the replay adjoint, the loss ((g(r) - 1)^2).mean()
    over every 5th frame with the pallas RDF (100 bins over 0.75-2.5), as
    the README quickstart does.  The RDF kernels K3/K4 and K3b/K4b against
    their plain versions on that epoch's frames (N = 1372 is not a multiple
    of their 64-row tile); d/d(sigma, eps) through the kernels against the
    dense LennardJones path and against direct backprop; then 3
    clipped-Adam steps on (sigma, eps)."""
    import numpy as np
    from mdgrad_tpu_torch import ops, potentials
    from mdgrad_tpu_torch.ops import rdf as rdf_ops
    from mdgrad_tpu_torch.train import fit_rdf
    system = lj_system(mt, 7, 1.0, SEED)
    obs = mt.observables.rdf(system, 100, (0.75, 2.5), backend="pallas",
                             device=dev)
    dt, frequency = 0.002, 50

    def rdf_loss(traj):
        return ((obs(traj.q[::5])[2] - 1.0) ** 2).mean()

    def epoch_grads(inter, params, adjoint):
        sim = mt.Simulation(system, mt.NVE(inter, system, adjoint=adjoint,
                                           device=dev))
        state, aux = sim.initial_state()
        traj, _ = sim.epoch_fn(dt, frequency)(state, aux, {})
        loss = rdf_loss(traj)
        grads = torch.stack(torch.autograd.grad(loss, params))
        return loss.item(), grads, traj.q[::5].detach()

    inter = mt.ops.PallasLJPair(system, LJ_CUTOFF, sigma=0.95, epsilon=1.0,
                                device=dev)
    params = [inter.sigma, inter.epsilon]
    dense = mt.PairPotentials(system, potentials.LennardJones(0.95, 1.0),
                              LJ_CUTOFF, mode="dense", device=dev)
    loss_k, g_k, frames = epoch_grads(inter, params, True)
    loss_d, g_d, _ = epoch_grads(dense, [dense.model.sigma,
                                         dense.model.epsilon], True)
    loss_x, g_x, _ = epoch_grads(inter, params, False)

    # K3/K4 and K3b/K4b at the fit's shapes: the epoch's 10 frames of 1372
    # atoms, 100 bins; tolerances as at the water shapes (1e-4 of the
    # largest bin, of the largest |dxyz| for a seeded cotangent)
    op = obs._counts
    x = frames.contiguous()
    line(f"  rdf_counts lj fit F={x.shape[0]} N={x.shape[1]} "
         f"bins={op.mu.shape[0]}:")
    compare("rdf_counts",
            rdf_ops._launch(x, op.cell_len, op.mu, op.coeff, op.cutoff),
            rdf_ops.rdf_counts_plain(x, op.cell_len, op.mu, op.coeff,
                                     op.cutoff), 1e-4)
    ct_bins = torch.randn(op.mu.shape[0], device=dev, generator=gen)
    line(f"  rdf_counts_bwd lj fit F={x.shape[0]} N={x.shape[1]}:")
    compare("rdf_counts_bwd",
            rdf_ops._launch_bwd(x, op.cell_len, op.mu, op.coeff, op.cutoff,
                                ct_bins),
            rdf_ops.rdf_counts_bwd_plain(x, op.cell_len, op.mu, op.coeff,
                                         op.cutoff, ct_bins), 1e-4,
            floor=0.0)
    del x
    line(f"lj fit: N={system.get_number_of_atoms()}, loss {loss_k:.6f} (dense {loss_d:.6f}); "
         f"d/d(sigma, eps): kernels {g_k.tolist()}  dense {g_d.tolist()}  "
         f"direct {g_x.tolist()}")
    rel_d = ((g_k - g_d).abs() / g_d.abs()).max().item()
    rel_x = ((g_k - g_x).abs() / g_x.abs()).max().item()
    line(f"lj fit: kernels vs dense max rel err {rel_d:.3e} (tol 5e-3); "
         f"replay vs direct {rel_x:.3e} (tol 1e-4)")
    require(bool((g_d.abs() > 0).all()) and rel_d <= 5e-3,
            "d/d(sigma, eps) through the kernels equals the dense path")
    require(rel_x <= 1e-4, "the replay equals direct backprop")

    sim = mt.Simulation(system, mt.NVE(inter, system, adjoint=True,
                                       device=dev))
    ode = sim.epoch_fn(dt, frequency)
    update = fit_rdf.FitUpdate(params, LJ_LR, GRAD_CLIP)
    before = torch.stack([p.detach().clone() for p in params])
    state, aux = sim.initial_state()
    n_epochs, n_steps = 3, frequency - 1
    torch.cuda.synchronize()
    ops.reset_counts()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for epoch in range(n_epochs):
        traj, aux = ode(state, aux, {})
        loss = rdf_loss(traj)
        loss.backward()
        if epoch == 0:
            peak = torch.cuda.max_memory_allocated()
        norm = update()
        state = traj._replace(**{
            k: getattr(traj, k)[-1].detach() for k in traj._fields
            if torch.is_tensor(getattr(traj, k))})
        loss_v, norm_v = loss.item(), norm.item()
        line(f"lj fit: epoch {epoch}: loss {loss_v:.6f}  grad norm "
             f"{norm_v:.6f}  sigma {inter.sigma.item():.6f}  eps "
             f"{inter.epsilon.item():.6f}")
        require(np.isfinite(loss_v) and np.isfinite(norm_v) and norm_v > 0,
                "finite loss and nonzero finite gradient")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.counts()
    moved = (torch.stack([p.detach() for p in params]) - before).abs().max()
    steps_per_s = n_epochs * n_steps / wall
    line(f"lj fit: {n_epochs} optimizer steps x {n_steps} MD steps in "
         f"{wall:.3f} s: {steps_per_s:.2f} fwd+bwd MD steps/s; replay "
         f"peak memory {peak / 2 ** 20:.1f} MiB, of which "
         f"{(peak - resident) / 2 ** 20:.1f} MiB above what the earlier "
         f"phases left allocated; parameters moved by {moved.item():.3e}")
    line(f"lj fit: launches {counts['launches']}  plain_calls "
         f"{counts['plain_calls']}")
    require(moved.item() > 0, "sigma and eps moved")
    # per epoch: the entry prime and every forward step run K6, every
    # replayed step runs K6 again and its K6b, and the primed entry force
    # takes one K6b; one RDF forward and backward
    expected = {"lj_force": n_epochs * (1 + 2 * n_steps),
                "lj_force_vjp": n_epochs * (1 + n_steps),
                "rdf_counts": n_epochs, "rdf_counts_bwd": n_epochs}
    for name, c in counts["launches"].items():
        require(c == expected.get(name, 0),
                f"LJ fit launches {name} {expected.get(name, 0)} times "
                f"(got {c})")
    require(sum(counts["plain_calls"].values()) == 0,
            "no plain version in the LJ fit")
    for name in (*LJ_KERNELS, *RDF_REPLACES):
        records.setdefault(name, {})["launches_lj_fit"] = \
            counts["launches"][name]
    return {"steps_per_s": steps_per_s, "peak": peak, "wall": wall,
            "epoch_peak": peak - resident,
            "rdf_frames": frames.contiguous(), "rdf_op": op}


def lj_times(mt, torch, dev, gen):
    """Each LJ kernel, its plain version and the dense PyTorch yardstick
    at N = 1372, 4000 and 8788 (FCC 7, 10, 13): device times from CUDA
    graphs, and the bound from the data-sheet rates."""
    import numpy as np
    from mdgrad_tpu_torch import potentials
    from mdgrad_tpu_torch.ops import pair, timing
    out = {name: {} for name in LJ_KERNELS}
    for n_cells in (7, 10, 13):
        system = lj_system(mt, n_cells, 1.2, SEED)
        n = system.get_number_of_atoms()
        cell = tuple(np.diag(system.cell))
        cell_t = torch.tensor(cell, dtype=torch.float32, device=dev)
        xyz = torch.tensor(system.positions, dtype=torch.float32, device=dev)
        w = torch.randn(xyz.shape, device=dev, generator=gen)
        sigma = torch.tensor(0.9, device=dev)
        eps = torch.tensor(1.0, device=dev)
        k_args = (cell, LJ_CUTOFF, sigma, eps)
        p_args = (cell_t, LJ_CUTOFF, sigma, eps)   # a device cell: no copy
        pairs_all = n * (n - 1) // 2
        pairs_in = lj_pairs_inside(torch, xyz, cell_t, LJ_CUTOFF)
        dense = mt.PairPotentials(system, potentials.LJFamily(0.9, 1.0),
                                  LJ_CUTOFF, mode="dense", device=dev)
        x_req = xyz.clone().requires_grad_(True)
        wrt = [x_req, dense.model.sigma, dense.model.epsilon]

        def lib_force():
            return torch.autograd.grad(dense.energy(x_req, ()), x_req)

        def lib_vjp():
            (g,) = torch.autograd.grad(dense.energy(x_req, ()), x_req,
                                       create_graph=True)
            return torch.autograd.grad((g * w).sum(), wrt)

        specs = {
            "lj_energy_forces": (
                lambda: pair._launch_energy_forces(xyz, *k_args),
                lambda: pair.lj_energy_forces_plain(xyz, *p_args),
                4 * (6 * n + 3)),
            "lj_force": (lambda: pair._launch_force(xyz, *k_args),
                         lambda: pair.lj_force_plain(xyz, *p_args),
                         4 * (6 * n + 2)),
            "lj_force_vjp": (
                lambda: pair._launch_force_vjp(xyz, w, *k_args),
                lambda: pair.lj_force_vjp_plain(xyz, w, *p_args),
                4 * (9 * n + 4)),
            "lj_force_param": (
                lambda: pair._launch_force_param(xyz, *k_args),
                lambda: pair.lj_force_param_plain(xyz, *p_args),
                4 * (6 * n + 4)),
        }
        big = n > 2000
        reps, groups = (2, 3) if big else (5, 5)
        lib_force_ms = timing.time_graph(lib_force, reps=reps, groups=groups)
        lib_vjp_ms = timing.time_graph(lib_vjp, reps=reps, groups=groups)
        for name, (kernel, plain, n_bytes) in specs.items():
            ms = timing.time_graph(kernel, reps=20)
            plain_ms = timing.time_graph(plain, reps=reps, groups=groups)
            lib_ms = lib_vjp_ms if name == "lj_force_vjp" else lib_force_ms
            n_ops = LJ_OPS_PER_PAIR * pairs_all + LJ_OPS_INSIDE[name] * pairs_in
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            out[name][n] = {"ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib_ms, "bound_ms": b_ms,
                            "bound_by": b_by, "bytes": n_bytes, "ops": n_ops}
            line(f"time {name} N={n}: kernel {ms * 1e3:.2f} us  plain "
                 f"{plain_ms * 1e3:.2f} us  library {lib_ms * 1e3:.2f} us  "
                 f"bound {b_ms * 1e3:.3f} us ({b_by}; {n_bytes} B, {n_ops} "
                 f"ops; {pairs_in} i<j pairs inside {LJ_CUTOFF})")
        del dense, x_req
        torch.cuda.empty_cache()
    return out


# ---- phases 4j-4l: large N, NPT / Langevin / reverse, angles / DiffTRe ---

# the 4096-site water fit of BENCH.md's best water run: run_water.py -size 8
# -nbr_mode cells -rdf_backend pallas -frame_skip 1, SchNet "low", cut to 2
# epochs and one 100-step rollout before the 800-bin RDF
FIT_CELLS = {"n_epochs": 2, "n_sim": 1, "size": 8, "nbr_mode": "cells",
             "frame_skip": 1}
# benchmarks/bench_large_n.py's largest box: FCC 23^3 at a = 1.679
CELL_LJ_CELLS = 23
CELL_LJ_STEPS = 200


def sorted_rows(torch, table):
    """Each row's neighbor set: the masked table sorted along its rows."""
    return torch.sort(torch.where(table.mask, table.table.long(),
                                  table.table.shape[0]), dim=1).values


def large_n_phase(mt, torch, dev, records, timing, compare):
    """Phase 4j (see the module docstring): returns its numbers."""
    import tempfile
    import numpy as np
    from mdgrad_tpu_torch import ops, topology
    from mdgrad_tpu_torch.ops import cells, gather, rdf as rdf_ops
    from mdgrad_tpu_torch.train import fit_rdf
    out = {}
    # (a) the 4096-site water box's table, cells against dense
    system = fit_rdf.get_system("H20_298K_redd", 8,
                                rng=np.random.default_rng(SEED))
    n = system.get_number_of_atoms()
    t0 = time.perf_counter()
    gnn = mt.GNNPotentials(system, fit_rdf._build_net_and_prior(
        FIT_ASSIGNMENTS, device=dev)[0], cutoff=6.0, nbr_mode="cells",
        capacity_slack=1.6, device=dev)
    construct_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    xyz = torch.tensor(system.get_positions(), dtype=torch.float32,
                       device=dev)
    xyz = xyz + 0.1 * torch.randn(xyz.shape, device=dev, generator=gen)
    ops.reset_counts()
    tab = gnn.aux_init(xyz)
    ref = topology.generate_neighbor_table(xyz, 6.0, gnn.cell, gnn.k_max)
    require(not bool(tab.overflow) and not bool(ref.overflow),
            "no overflow in the 4096-site tables")
    require(torch.equal(sorted_rows(torch, tab), sorted_rows(torch, ref)),
            "the cell-list table holds the dense table's neighbors, row by "
            "row")
    check_no_kernel(ops.counts(), "cell-list table build")
    cells_ms = timing.time_loop(lambda: gnn.aux_init(xyz), reps=20)
    dense_ms = timing.time_loop(lambda: topology.generate_neighbor_table(
        xyz, 6.0, gnn.cell, gnn.k_max), reps=20)
    g = gnn.cell_grid
    line(f"large n: water N={n}, K={gnn.k_max} (dense count at "
         f"construction, {construct_s:.3f} s), cells {g.dims} of width "
         f"{g.widths[0]:.4f} A, M={g.M}: the cell-list table equals the "
         f"dense one as row sets; build {cells_ms:.3f} ms against the "
         f"dense {dense_ms:.3f} ms (eager loop)")
    out["table"] = {"k": gnn.k_max, "M": g.M, "dims": g.dims,
                    "cells_ms": cells_ms, "dense_ms": dense_ms,
                    "construct_s": construct_s}
    # (e) the CSR build at that table: the grid path (past 2047 rows)
    idx = torch.where(tab.mask, tab.table, n).reshape(-1).contiguous()
    e = idx.shape[0]
    path = gather.table_index_csr_path(e, n)
    require(path == "grid", f"the 4096-site table's CSR build takes the "
            f"grid path (got {path})")
    csr = {"e": e, "n": n, "path": path,
           "ms": timing.time_graph(
               lambda: gather._launch_table_index_csr(idx, n), reps=20),
           "plain_ms": timing.time_graph(
               lambda: gather.table_index_csr_plain(idx, n), reps=5),
           "bound_ms": bound_ms(4 * (2 * e + n + 1), 0)[0]}
    c_k = gather._launch_table_index_csr(idx, n)
    c_p = gather.table_index_csr_plain(idx, n)
    require(all(torch.equal(a, b) for a, b in zip(c_k, c_p)),
            "the grid-path CSR build equals the plain build at 4096 rows")
    line(f"large n: CSR build at E={e}, n={n} ({path} path): "
         f"{csr['ms'] * 1e3:.2f} us, plain {csr['plain_ms'] * 1e3:.2f} us, "
         f"bound {csr['bound_ms'] * 1e3:.3f} us")
    out["csr"] = csr
    # the water kernels at the 4096-site fit's shapes against their plain
    # versions: K1, K2a, K2b on this table (128 features); K3/K4 and
    # K3b/K4b on an epoch's 52 frames (frame_skip 1), K3/K4 at the
    # inference's 800 bins
    index = gather.TableIndex(idx, n)
    k, f = gnn.k_max, 128
    values = torch.randn(n, f, device=dev, generator=gen)
    w = torch.randn(e, f, device=dev, generator=gen)
    g_edges = torch.randn(e, f, device=dev, generator=gen)
    line(f"  gather kernels at N={n}, K={k}, F={f}:")
    compare("gather_mul_reduce", gather._launch_gather_mul_reduce(
        values, w, index.idx, k), gather.gather_mul_reduce_plain(
        values, w, index.idx, k), 1e-5)
    compare("table_gather", gather._launch_table_gather(values, index.idx),
            gather.table_gather_plain(values, index.idx), 0.0)
    compare("table_scatter", gather._launch_table_scatter(g_edges, index),
            gather.table_scatter_plain(g_edges, index.idx, n), 1e-5)
    del values, w, g_edges, index
    frames = xyz + 0.1 * torch.randn((FIT_ASSIGNMENTS["opt_freq"], n, 3),
                                     device=dev, generator=gen)
    for nbins in (FIT_ASSIGNMENTS["nbins"], 800):
        op = mt.observables.rdf(system, nbins, (1.8, 7.5), backend="pallas",
                                device=dev)._counts
        x = frames if nbins != 800 else frames[:1].contiguous()
        line(f"  rdf_counts at F={x.shape[0]} N={n} bins={nbins}:")
        compare("rdf_counts",
                rdf_ops._launch(x, op.cell_len, op.mu, op.coeff, op.cutoff),
                rdf_ops.rdf_counts_plain(x, op.cell_len, op.mu, op.coeff,
                                         op.cutoff), 1e-4)
        if nbins != 800:
            ct = torch.randn(nbins, device=dev, generator=gen)
            line(f"  rdf_counts_bwd at F={x.shape[0]} N={n}:")
            compare("rdf_counts_bwd",
                    rdf_ops._launch_bwd(x, op.cell_len, op.mu, op.coeff,
                                        op.cutoff, ct),
                    rdf_ops.rdf_counts_bwd_plain(x, op.cell_len, op.mu,
                                                 op.coeff, op.cutoff, ct),
                    1e-4, floor=0.0)
    del frames, x
    del gnn, tab, ref

    # (b) CellLJPair at 48,668 atoms against K5 on the same positions
    lj = lj_system(mt, CELL_LJ_CELLS, 1.2, SEED)
    n_lj = lj.get_number_of_atoms()
    cell_pot = cells.CellLJPair(lj, LJ_CUTOFF, sigma=0.9, epsilon=1.0,
                                device=dev)
    pallas = mt.ops.PallasLJPair(lj, LJ_CUTOFF, sigma=0.9, epsilon=1.0,
                                 device=dev)
    x = torch.tensor(lj.get_positions(), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    with torch.no_grad():
        ops.reset_counts()
        aux = cell_pot.aux_init(x)
        u_c, f_c = cell_pot.energy_forces(x, aux)
        check_no_kernel(ops.counts(), "CellLJPair")
        cell_peak = torch.cuda.max_memory_allocated() - resident
        u_k, f_k = mt.ops.lj_energy_forces(
            x, pallas.static[0], LJ_CUTOFF, 0.9, 1.0)
    err, rel, scale = max_errs(f_c, f_k)
    rel_u = abs(u_c.item() - u_k.item()) / abs(u_k.item())
    line(f"large n: CellLJPair N={n_lj} ({cell_pot.dims} cells, M="
         f"{cell_pot.M}): U {u_c.item():.6f} against K5's {u_k.item():.6f} "
         f"(rel {rel_u:.3e}, tol 1e-5); forces max_abs_err {err:.3e} (tol "
         f"{1e-4 * scale:.3e}); overflow {bool(aux.overflow)}; peak "
         f"{cell_peak} B above the resident")
    require(not bool(aux.overflow), "no cell overflow at 48,668 atoms")
    require(rel_u <= 1e-5 and err <= 1e-4 * scale,
            "CellLJPair agrees with K5 at 48,668 atoms")
    cell_ms = timing.time_loop(lambda: cell_pot.energy_forces(
        x, cell_pot.aux_init(x)), reps=10)
    k5_ms = timing.time_loop(lambda: mt.ops.lj_energy_forces(
        x, pallas.static[0], LJ_CUTOFF, 0.9, 1.0), reps=10)
    # (c) 200 NVE steps through the cell list
    integ = mt.NVE(cell_pot, lj, adjoint=False, device=dev)
    sim = mt.Simulation(lj, integ)
    state, _ = sim.initial_state()

    def total_energy(q, v):
        with torch.no_grad():
            return (cell_pot.energy(q, cell_pot.aux_init(q))
                    + 0.5 * (integ.masses * v * v).sum()).item()

    e0 = total_energy(state.q, state.v)
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    traj = sim.simulate(steps=CELL_LJ_STEPS, dt=0.002,
                        frequency=CELL_LJ_STEPS + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_no_kernel(ops.counts(), "CellLJPair NVE")
    e1 = total_energy(traj.q[-1], traj.v[-1])
    drift = abs(e1 - e0) / abs(e0)
    line(f"large n: CellLJPair NVE N={n_lj}, {CELL_LJ_STEPS} steps at dt "
         f"0.002 in {wall:.3f} s: {CELL_LJ_STEPS / wall:.2f} steps/s; E_0 "
         f"{e0:.6f} E_end {e1:.6f} |dE|/|E_0| {drift:.3e} (tol 1e-2); one "
         f"cell-list force {cell_ms:.3f} ms against K5's {k5_ms:.3f} ms "
         f"(eager)")
    require(bool(torch.isfinite(traj.q).all()) and drift < 1e-2,
            "the 48,668-atom cell-list NVE run is finite and conserves "
            "energy to 1e-2")
    out["cell_lj"] = {"n": n_lj, "steps_per_s": CELL_LJ_STEPS / wall,
                      "drift": drift, "peak": cell_peak, "ms": cell_ms,
                      "k5_ms": k5_ms}
    del cell_pot, pallas, integ, sim, traj, x, f_c, f_k, aux

    # (d) the 4096-site water fit
    with tempfile.TemporaryDirectory() as model_path:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, msgs, marks, widths, wall = fit_call(
            torch, fit_rdf, ops, gather, model_path, **FIT_CELLS)
        peak = torch.cuda.max_memory_allocated()
    for msg in msgs:
        line(f"large n fit: {msg}")
    counts = ops.counts()
    losses = res["loss_log"]
    require(not res.get("nan_bailout") and len(losses) == 2
            and bool(np.isfinite(losses).all())
            and np.isfinite(res["objective"]),
            "the 4096-site fit gives finite losses and objective")
    require(res["final"]["H20_298K_redd"]["g_sim"].shape == (800,),
            "the 4096-site inference RDF has 800 bins")
    require(not any("overflow" in m for m in msgs),
            "no neighbor overflow in the 4096-site fit")
    require(widths.paths() == {"grid"},
            "every CSR build of the 4096-site fit takes the grid path")
    check_fit_counts(counts, "4096-site fit")
    prev = {name: 0 for name in counts["launches"]}
    per_epoch = []
    for _, c in marks:
        per_epoch.append({name: c["launches"][name] - prev[name]
                          for name in prev})
        prev = c["launches"]
    inference = {name: counts["launches"][name] - prev[name]
                 for name in prev}
    for c in per_epoch:
        for name in WATER_KERNELS:
            require(c[name] > 0, f"kernel {name} launched in each "
                    "4096-site epoch")
    epochs = [b - a for a, b in zip([0.0] + [t for t, _ in marks],
                                    [t for t, _ in marks])]
    line(f"large n fit: N=4096, losses {losses}, objective "
         f"{res['objective']!r}; epoch seconds "
         f"{[round(s, 3) for s in epochs]} (the first from the call, set-up "
         f"included); inference {wall - marks[-1][0]:.3f} s; call "
         f"{wall:.3f} s; peak memory {peak} B; CSR builds "
         f"{widths.describe()}")
    line(f"large n fit: launches per epoch {per_epoch[-1]}; inference "
         f"{inference}")
    for name in WATER_KERNELS:
        records.setdefault(name, {})["launches_cells_fit_per_epoch"] = \
            per_epoch[-1][name]
        records[name]["launches_cells_fit_inference"] = inference[name]
    out["fit"] = {"epochs": epochs, "wall": wall, "peak": peak,
                  "per_epoch": per_epoch[-1], "losses": losses,
                  "infer_s": wall - marks[-1][0]}
    return out


def run_script(name, argv):
    """``scripts/<name>``'s ``main(argv)``, its printed lines returned."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        load_script(name).main(argv)
    return buf.getvalue().splitlines()


# run_npt_fit_torch.py's reduced LJ mode at its defaults, cut from 150
# epochs to 2 and from 16 evaluation epochs to 4
NPT_LJ_ARGV = ["-nepochs", "2", "-eval_epochs", "4"]


def npt_langevin_reverse_phase(mt, torch, dev, records):
    """Phase 4k (see the module docstring): returns its numbers."""
    import json
    import tempfile
    import numpy as np
    from mdgrad_tpu_torch import ops, thermo
    out = {}
    # (a) run_npt_fit_torch.py's reduced LJ mode, 2 epochs at its defaults
    with tempfile.TemporaryDirectory() as logdir:
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        msgs = run_script("run_npt_fit_torch.py", NPT_LJ_ARGV + [
            "-logdir", logdir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = json.loads(open(os.path.join(logdir, "result.json")).read())
    for msg in msgs:
        line(f"npt lj: {msg}")
    check_no_kernel(ops.counts(), "NPT LJ fit")
    rho, tgt = res["rho_log"], res["rho_target"]
    toward = abs(rho[-1] - tgt) < abs(rho[0] - tgt)
    line(f"npt lj: losses {res['loss_log']}, densities {rho} against "
         f"{tgt:.4f} ({'toward' if toward else 'away from'} the target), "
         f"evaluated {res['rho_best_eval']:.4f}; P0 {res['P0']:.4f}; call "
         f"{wall:.3f} s")
    require(len(res["loss_log"]) == 2 and np.isfinite(res["loss_log"]).all()
            and np.isfinite(res["rho_best_eval"]),
            "the NPT LJ fit gives finite losses and densities")
    out["lj"] = {"wall": wall, "rho": rho, "target": tgt,
                 "losses": res["loss_log"], "toward": toward}
    # (b) its water mode at 512 sites, SchNet 128/128 in bf16, 1 epoch
    with tempfile.TemporaryDirectory() as logdir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        t0 = time.perf_counter()
        msgs = run_script("run_npt_fit_torch.py",
                          ["-data", "H20_298K_redd", "-size", "4",
                           "-nepochs", "1", "-eval_epochs", "1", "-logdir",
                           logdir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        res = json.loads(open(os.path.join(logdir, "result.json")).read())
    for msg in msgs:
        line(f"npt water: {msg}")
    counts = ops.counts()
    line(f"npt water: launches {counts['launches']}  bf16 "
         f"{counts['launches_bf16']}; call {wall:.3f} s; peak {peak} B")
    for name in GATHER_KERNELS:
        require(counts["launches_bf16"][name] > 0,
                f"bf16 {name} launched in the NPT water fit")
    require(counts["launches"]["table_index_csr"] > 0,
            "the CSR build launched in the NPT water fit")
    for name, c in counts["launches"].items():
        require(c == 0 or name == "table_index_csr",
                f"the NPT water fit launches no f32 {name}")
    require(sum(counts["plain_calls"].values()) == 0
            and sum(counts["plain_calls_bf16"].values()) == 0,
            "no plain version in the NPT water fit")
    require(np.isfinite(res["loss_log"]).all(),
            "the NPT water fit gives a finite loss")
    for name in GATHER_KERNELS:
        records.setdefault(f"{name}.bf16", {})["launches_npt_water"] = \
            counts["launches_bf16"][name]
    records.setdefault("table_index_csr", {})["launches_npt_water"] = \
        counts["launches"]["table_index_csr"]
    out["water"] = {"wall": wall, "peak": peak, "loss": res["loss_log"],
                    "rho": res["rho_log"]}

    # (c) the reverse-time adjoint on phase 4b's 1372-atom epoch
    system = lj_system(mt, 7, 1.0, SEED)
    obs = mt.observables.rdf(system, 100, (0.75, 2.5), backend="pallas",
                             device=dev)
    grads, counts_by = {}, {}
    for adjoint in ("reverse", True):
        inter = mt.ops.PallasLJPair(system, LJ_CUTOFF, sigma=0.95,
                                    epsilon=1.0, device=dev)
        sim = mt.Simulation(system, mt.NVE(inter, system, adjoint=adjoint,
                                           device=dev))
        state, aux = sim.initial_state()
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        traj, _ = sim.epoch_fn(0.002, 50)(state, aux, {})
        loss = ((obs(traj.q[-1]) [2] - 1.0) ** 2).mean()
        grads[adjoint] = torch.stack(torch.autograd.grad(
            loss, [inter.sigma, inter.epsilon]))
        torch.cuda.synchronize()
        counts_by[adjoint] = (ops.counts(), time.perf_counter() - t0,
                              traj.q.shape[0])
    rel = ((grads["reverse"] - grads[True]).abs()
           / grads[True].abs()).max().item()
    for adjoint in ("reverse", True):
        c, wall, frames = counts_by[adjoint]
        line(f"reverse adjoint: {'reverse' if adjoint == 'reverse' else 'replay'}"
             f" d/d(sigma, eps) {grads[adjoint].tolist()} in {wall:.3f} s, "
             f"{frames} frames kept; launches {c['launches']}")
        for name in ("lj_force", "lj_force_vjp", "rdf_counts",
                     "rdf_counts_bwd"):
            require(c["launches"][name] > 0, f"{name} launched in the "
                    f"{adjoint} epoch")
        require(sum(c["plain_calls"].values()) == 0,
                "no plain version in the reverse-adjoint check")
    line(f"reverse adjoint: N=1372, 49 steps, loss on the last frame's "
         f"g(r): reverse vs replay max rel err {rel:.3e} (tol 2e-3)")
    require(rel <= 2e-3, "the reverse-time adjoint matches the replay")
    for name in ("lj_force", "lj_force_vjp"):
        records.setdefault(name, {})["launches_reverse"] = \
            counts_by["reverse"][0]["launches"][name]
    out["reverse"] = {"rel": rel, "grads": grads["reverse"].tolist()}

    # (d) Langevin on 4000-atom PallasLJPair
    target = 1.2
    system = lj_system(mt, 10, target, SEED)
    inter = mt.ops.PallasLJPair(system, LJ_CUTOFF, sigma=0.9, epsilon=1.0,
                                device=dev)
    integ = mt.Langevin(inter, system, T=target / mt.units.kB,
                        friction=5.0, adjoint=False, seed=SEED, device=dev)
    sim = mt.Simulation(system, integ)
    sim.simulate(steps=200, dt=0.002, frequency=201)
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    traj = sim.simulate(steps=500, dt=0.002, frequency=501)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.counts()
    with torch.no_grad():
        temps = torch.stack([thermo.temperature(v, system.get_masses())
                             for v in traj.v[1:]])
    t_mean = temps.mean().item()
    line(f"langevin: N=4000, friction 5, 500 steps after 200 in {wall:.3f} "
         f"s ({500 / wall:.2f} steps/s): mean kT {t_mean:.5f} against "
         f"{target} ({abs(t_mean - target) / target:.2%}, tol 5%); "
         f"launches {counts['launches']}")
    require(abs(t_mean - target) / target < 0.05,
            "Langevin holds the temperature within 5%")
    # the epoch's entry force and one force a step
    require(counts["launches"]["lj_force"] == 501
            and counts["launches"]["lj_energy_forces"] == 0,
            "Langevin runs one K6 force a step")
    check_no_kernel(counts, "Langevin run", allowed=("lj_force",))
    records.setdefault("lj_force", {})["launches_langevin"] = \
        counts["launches"]["lj_force"]
    out["langevin"] = {"t_mean": t_mean, "steps_per_s": 500 / wall}
    return out


# fit_rdf at phase 4c's settings with the water angle target (3.7 A,
# run_water.py --angle), 1 epoch, no rollout
FIT_ANGLE = {"n_epochs": 1, "n_sim": 0, "angle_flag": True,
             "angle_k_max": 24}
FIT_ANGLE_ASSIGNMENTS = {"angle_weight": 1.0, "angle_cutoff": 3.7,
                         "angle_nbins": 64, "angle_start": 0.5}
# run_difftre_torch.py at its full size (500 atoms), 2 outers of 5 inner
# steps, cut in depth: 16 frames every 30 steps (from 48 every 60) after
# 300 steps (from 1200), 500 BI iterations (from 2000)
DIFFTRE_ARGV = ["-n_outer", "2", "-inner_steps", "5", "-n_frames", "16",
                "-steps_between", "30", "-equil_steps", "300",
                "-pretrain", "500"]


def angle_difftre_phase(torch, records):
    """Phase 4l (see the module docstring): returns its numbers."""
    import json
    import tempfile
    import numpy as np
    from mdgrad_tpu_torch import ops
    from mdgrad_tpu_torch.ops import gather
    from mdgrad_tpu_torch.train import fit_rdf
    out = {}
    res, msgs, marks, _, wall = fit_call(torch, fit_rdf, ops, gather, None,
                                         FIT_ANGLE_ASSIGNMENTS, **FIT_ANGLE)
    for msg in msgs:
        line(f"angle fit: {msg}")
    counts = ops.counts()
    fin = res["final"]["H20_298K_redd"]
    line(f"angle fit: loss {res['loss_log']}, angle_mse {fin['angle_mse']!r}"
         f", objective {res['objective']!r}; epoch {marks[0][0]:.3f} s "
         f"from the call; launches {counts['launches']}")
    require(len(res["loss_log"]) == 1 and np.isfinite(res["loss_log"][0])
            and np.isfinite(fin["angle_mse"])
            and fin["angle_sim"].shape == (64,),
            "the angle fit gives a finite loss and angle_mse")
    check_fit_counts(counts, "angle fit")
    for name in WATER_KERNELS:
        records.setdefault(name, {})["launches_angle_fit"] = \
            counts["launches"][name]
    out["angle"] = {"epoch_s": marks[0][0], "wall": wall,
                    "angle_mse": fin["angle_mse"]}
    with tempfile.TemporaryDirectory() as logdir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        t0 = time.perf_counter()
        msgs = run_script("run_difftre_torch.py",
                          DIFFTRE_ARGV + ["-logdir", logdir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        hist = json.loads(open(os.path.join(logdir,
                                            "history.json")).read())
    for msg in msgs:
        line(f"difftre: {msg}")
    check_no_kernel(ops.counts(), "DiffTRE fit")
    line(f"difftre: N=500, {len(hist)} outers: losses "
         f"{[h['loss'] for h in hist]}, reweighted "
         f"{[h['loss_rw'] for h in hist]}, min ESS/F "
         f"{[h['ess'] for h in hist]}, inner steps "
         f"{[h['inner'] for h in hist]}; call {wall:.3f} s; peak {peak} B")
    require(len(hist) == 2 and all(np.isfinite(h["loss"]) and 0 < h["ess"]
                                   <= 1 for h in hist),
            "DiffTRE gives 2 outers of finite loss and ESS")
    out["difftre"] = {"wall": wall, "peak": peak, "hist": hist}
    return out


# run_fold_torch.py at its defaults (50 atoms, SchNet 64/64, 32 Gaussians,
# 3 convolutions, cutoff 4.0, tau 49, dt 0.02), cut from 500 epochs to the
# warm-up and 2 trained ones; the replay check at tau 11
FOLD_EPOCHS, FOLD_CHECK_TAU = 3, 11
FOLD_KERNELS = WATER_KERNELS[:4]      # K1, K2a, K2b and the CSR build
# run_salt.py's box (216 ions, a = 6.2 A, 2500 K, r_cut 9.114 A, 618
# k-vectors); the targets cut from 6 burn-in and 16 sampling epochs of 80
# steps to 1 and 2 (fit_salt's own targets: 6 and 2); 2 of 200 epochs
SALT_BURN, SALT_NSIM, SALT_EPOCHS, SALT_TAU = 1, 2, 2, 60
# float32 on the card against float64 on the CPU: the card's float32
# lies 2.1e-8 of |U| and 8.7e-7 of max |F| away at the melt, with TF32 on
# 1.5e-5 and 4.5e-3 (H100, 700 W); the phase checks that TF32 misses
EWALD_U_TOL, EWALD_F_TOL = 1e-6, 1e-4
# fit_mix at its defaults (size 3, 108 atoms; 3 epochs at tau 21; 4 target
# epochs of 40 steps)
MIX = {"size": 3, "n_epochs": 3, "tau": 21, "n_target_epochs": 4,
       "target_steps": 40}


def table_kernel_checks(torch, dev, compare, gather, tab, f, what, seed):
    """K1, K2a and K2b against their plain versions and the CSR build
    integer-equal to the plain build on the (N, K) table ``tab`` with
    F = ``f`` features, random values from ``seed``; returns (N, K, the
    CSR path)."""
    n, k = tab.table.shape
    idx = torch.where(tab.mask, tab.table, n).reshape(-1).contiguous()
    require(bool((idx == n).any()) and not bool(tab.overflow),
            f"the {what} table has sentinel entries and no overflow")
    index = gather.TableIndex(idx, n)
    gen = torch.Generator(device=dev).manual_seed(seed)
    values = torch.randn(n, f, device=dev, generator=gen)
    w = torch.randn(idx.shape[0], f, device=dev, generator=gen)
    g_edges = torch.randn(idx.shape[0], f, device=dev, generator=gen)
    line(f"  {what} gather kernels at N={n}, K={k}, F={f}:")
    compare("gather_mul_reduce", gather._launch_gather_mul_reduce(
        values, w, index.idx, k), gather.gather_mul_reduce_plain(
        values, w, index.idx, k), 1e-5)
    compare("table_gather", gather._launch_table_gather(values, index.idx),
            gather.table_gather_plain(values, index.idx), 0.0)
    compare("table_scatter", gather._launch_table_scatter(g_edges, index),
            gather.table_scatter_plain(g_edges, index.idx, n), 1e-5)
    path = gather.table_index_csr_path(idx.shape[0], n)
    require(all(torch.equal(a, b) for a, b in zip(
        gather._launch_table_index_csr(idx, n),
        gather.table_index_csr_plain(idx, n))),
        f"the CSR build equals the plain build at the {what} table ({path} "
        "path)")
    return n, k, path


def fold_salt_mix_phase(mt, torch, dev, records, compare):
    """Phase 4m (see the module docstring): returns its numbers."""
    import copy
    import numpy as np
    from mdgrad_tpu_torch import ops, units
    from mdgrad_tpu_torch.ops import gather, timing
    from mdgrad_tpu_torch.train import fit_mix, fit_salt, fold
    out = {}

    # (a) the fold: the warm-up epoch alone first, whose launches split
    # epoch 1's from the call's
    params = dict(load_script("run_fold_torch.py").PARAMS)
    torch.cuda.synchronize()
    ops.reset_counts()
    fold.train_fold({**params, "n_epochs": 1}, log=line, device=dev)
    warm = ops.counts()
    check_no_kernel(warm, "fold warm-up", allowed=FOLD_KERNELS)
    marks = []

    def log(msg):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), ops.counts()))
        line(f"fold: {msg}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    with CsrWidths(gather) as widths:
        res = fold.train_fold({**params, "n_epochs": FOLD_EPOCHS}, log=log,
                              device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    require(len(res["loss_log"]) == FOLD_EPOCHS - 1 and not res.get(
        "nan_bailout") and all(np.isfinite(res["loss_log"])),
        "the fold's trained epochs give finite losses")
    check_no_kernel(marks[-1][1], "fold", allowed=FOLD_KERNELS)
    # each trained epoch's launches: the first less the warm-up's
    epochs = [{k: b["launches"][k] - a["launches"][k] for k in b["launches"]}
              for a, b in zip([warm] + [c for _, c in marks],
                              [c for _, c in marks])]
    for i, launched in enumerate(epochs):
        for name in FOLD_KERNELS:
            require(launched[name] > 0,
                    f"kernel {name} launched in trained fold epoch {i + 1}")
    for name in FOLD_KERNELS:
        records.setdefault(name, {})["launches_fold"] = epochs[-1][name]
    epoch_s = marks[1][0] - marks[0][0]
    line(f"fold: N = 50, losses {res['loss_log']}; the call {wall:.3f} s "
         f"(warm-up and 2 trained epochs), trained epoch 2 {epoch_s:.3f} "
         f"s; launches per trained epoch "
         f"{[{k: e[k] for k in FOLD_KERNELS} for e in epochs]}; CSR builds "
         f"{widths.describe()}; peak {peak} B")
    out["fold"] = {"wall": wall, "epoch_s": epoch_s,
                   "launches": {k: epochs[-1][k] for k in FOLD_KERNELS},
                   "peak": peak, "losses": res["loss_log"]}
    # K1, K2a, K2b and the CSR build at the fold's shapes against their
    # plain versions, on the straight chain perturbed
    pieces = fold.build_fold({**params, "tau": FOLD_CHECK_TAU},
                             device=dev)
    gnn = pieces["stack"].models["gnn"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    xyz = torch.tensor(pieces["system"].get_positions(),
                       dtype=torch.float32, device=dev)
    xyz = xyz + 0.1 * torch.randn(xyz.shape, device=dev, generator=gen)
    tab = gnn.aux_init(xyz)
    table_kernel_checks(torch, dev, compare, gather, tab,
                        params["n_filters"], "fold", SEED + 19)
    # the fold SchNet's force, and its vector-Jacobian product in q and
    # the SchNet's parameters (the replay's grad-of-grad), through the
    # kernels against the plain gather path with the same weights
    gnn_plain = copy.deepcopy(gnn)
    gnn_plain.gnn.gather_mode = "gather"
    cot = torch.randn(xyz.shape, device=dev, generator=gen)
    got = {}
    for label, pot in (("kernels", gnn), ("plain", gnn_plain)):
        x = xyz.clone().requires_grad_(True)
        ps = list(pot.parameters())
        ops.reset_counts()
        (f_x,) = torch.autograd.grad(-pot.energy(x, tab), x,
                                     create_graph=True)
        grads = torch.autograd.grad((f_x * cot).sum(), [x, *ps],
                                    allow_unused=True,
                                    materialize_grads=True)
        got[label] = (f_x.detach(),
                      torch.cat([g.reshape(-1) for g in grads]),
                      ops.counts())
    f_err, _, f_scale = max_errs(got["kernels"][0], got["plain"][0])
    v_err, _, v_scale = max_errs(got["kernels"][1], got["plain"][1])
    fold_counts = got["kernels"][2]
    line(f"fold: SchNet force kernels vs plain gather: max_abs_err "
         f"{f_err:.3e} (tol {1e-4 * f_scale:.3e}, max |F| {f_scale:.3e}); "
         f"its vjp: max_abs_err {v_err:.3e} (tol {1e-4 * v_scale:.3e}, "
         f"largest entry {v_scale:.3e}); launches "
         f"{fold_counts['launches']}")
    require(f_scale > 0 and f_err <= 1e-4 * f_scale,
            "the fold SchNet's force through the kernels equals the plain "
            "gather path's")
    require(v_scale > 0 and v_err <= 1e-4 * v_scale,
            "the fold SchNet force's vjp through the kernels equals the "
            "plain gather path's")
    check_no_kernel(fold_counts, "fold force and vjp", allowed=FOLD_KERNELS)
    require(all(fold_counts["launches"][name] > 0 for name in FOLD_KERNELS),
            "the fold force and its vjp launch K1, K2a, K2b and the CSR "
            "build")
    out["fold"]["force_err"] = f_err / f_scale
    out["fold"]["vjp_err"] = v_err / v_scale
    del gnn_plain, got, x, f_x, grads
    # the replay adjoint against direct backprop at tau 11
    sim, integ = pieces["sim"], pieces["integrator"]
    train = list(pieces["stack"].models["gnn"].parameters())
    grads = {}
    for adjoint in (True, False):
        integ.adjoint = adjoint
        loss_fn = fold.make_fold_epoch_loss(
            sim, pieces["targets"], {**params, "tau": FOLD_CHECK_TAU})
        state, aux = sim.initial_state()
        loss, _ = loss_fn(state, aux, integ.default_ctrl())
        # the last readout bias moves no force: no gradient
        grads[adjoint] = torch.cat([(torch.zeros_like(p) if p.grad is None
                                     else p.grad).reshape(-1)
                                    for p in train])
        for p in pieces["stack"].parameters():
            p.grad = None
    err, _, scale = max_errs(grads[True], grads[False])
    line(f"fold: replay vs direct at tau={FOLD_CHECK_TAU} (K = "
         f"{pieces['stack'].models['gnn'].k_max}): max_abs_err {err:.3e} "
         f"(tol {5e-3 * scale:.3e}, largest entry {scale:.3e}; loss "
         f"{loss.item():.6f})")
    require(scale > 0 and np.isfinite(scale) and err <= 5e-3 * scale,
            "the fold's replay gradient equals direct backprop")
    out["fold"]["replay_err"] = err / scale

    # (b) the molten salt
    torch.cuda.synchronize()
    ops.reset_counts()
    dt = 1.0 * units.fs
    system = fit_salt.rocksalt_melt(rng=np.random.default_rng(0))
    t0 = time.perf_counter()
    g_l, g_u, melt = fit_salt.generate_targets(
        system, 0.8, n_sim=SALT_NSIM, burn=SALT_BURN, dt=dt,
        log=lambda m: line(f"salt: {m}"), device=dev)
    torch.cuda.synchronize()
    t_targets = time.perf_counter() - t0
    sim, integ = fit_salt.build_sim(system, 0.4, device=dev)
    stack = integ.model
    coul = stack.models["coul"]
    require(coul.nvecs.shape[0] == 618 and abs(coul.r_cut - 9.114) < 1e-3,
            "the salt box has r_cut 9.114 A and 618 k-vectors")
    aux = integ.aux_init(melt.q)
    # an MD step (no gradient) and each force as a step takes it
    # (autograd of the energy), all timed back to back, host launches
    # included
    with torch.no_grad():
        primed, aux_p = integ.prime_state(melt, aux)
        ctrl = integ.default_ctrl()
        step_ms = timing.time_loop(lambda: integ.step(
            primed, aux_p, ctrl, dt, method=sim.method), reps=20)

    def force_of(model):
        def force():
            x = melt.q.detach().requires_grad_(True)
            return torch.autograd.grad(model.energy(x, aux), x)[0]
        return force

    ms = {"stack": timing.time_loop(force_of(stack), reps=20),
          "ewald": timing.time_loop(force_of(coul), reps=20),
          "core": timing.time_loop(force_of(stack.models["core"]), reps=20)}
    # float32 on the card against float64 on the CPU, at the melt
    x64 = melt.q.detach().double().cpu().requires_grad_(True)
    ref = fit_salt.ScaledChargeEwald(
        system, np.where(system.get_atomic_numbers() == 11, 1.0, -1.0), 0.4,
        r_cut=coul.r_cut, device="cpu").double()
    u64 = ref.energy(x64, ())
    (f64,) = torch.autograd.grad(u64, x64)
    x32 = melt.q.detach().requires_grad_(True)
    u32 = coul.energy(x32, ())
    (f32,) = torch.autograd.grad(u32, x32)
    u_err = abs(u32.item() - u64.item()) / abs(u64.item())
    f_err = (f32.double().cpu() - f64).abs().max().item() / \
        f64.abs().max().item()
    line(f"salt: Ewald f32 on the card vs f64 on the CPU at the melt: U "
         f"{u64.item():.6f} eV, rel err {u_err:.3e} (tol {EWALD_U_TOL:.0e}),"
         f" max force err {f_err:.3e} of max |F| {f64.abs().max().item():.4f}"
         f" (tol {EWALD_F_TOL:.0e})")
    require(u_err <= EWALD_U_TOL and f_err <= EWALD_F_TOL,
            "the card's float32 Ewald matches the CPU's float64")
    # the same with TF32 switched on: the check must catch it
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x_t = melt.q.detach().requires_grad_(True)
        u_t = coul.energy(x_t, ())
        (f_t,) = torch.autograd.grad(u_t, x_t)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    u_err_t = abs(u_t.item() - u64.item()) / abs(u64.item())
    f_err_t = (f_t.double().cpu() - f64).abs().max().item() / \
        f64.abs().max().item()
    line(f"salt: the same with TF32 on: U rel err {u_err_t:.3e}, max force "
         f"err {f_err_t:.3e} of max |F|")
    require(u_err_t > EWALD_U_TOL and f_err_t > EWALD_F_TOL,
            "each Ewald tolerance catches TF32 in the phase product")
    # one epoch's d(loss)/d(qscale) through the replay adjoint
    stack.models["core"].requires_grad_(False)
    loss_fn = fit_salt.make_salt_epoch_loss(
        sim, fit_salt.partial_rdf_observers(system, device=dev), (g_l, g_u),
        dt, SALT_TAU)
    loss, _ = loss_fn(melt, sim.initial_state()[1], integ.default_ctrl())
    gq = coul.qscale.grad.item()
    line(f"salt: epoch loss {loss.item():.6f}, d/d(qscale) {gq:.6e}")
    require(np.isfinite(loss.item()) and np.isfinite(gq) and gq != 0.0,
            "the salt loss and d/d(qscale) are finite, the gradient "
            "nonzero")
    salt_marks = []

    def salt_log(msg):
        torch.cuda.synchronize()
        salt_marks.append(time.perf_counter())
        line(f"salt fit: {msg}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fit_salt.fit_salt(n_epochs=SALT_EPOCHS, tau=SALT_TAU,
                            target_nsim=SALT_NSIM, log=salt_log, device=dev)
    torch.cuda.synchronize()
    salt_wall = time.perf_counter() - t0
    salt_peak = torch.cuda.max_memory_allocated()
    hist = res["history"]
    require(len(hist) == SALT_EPOCHS and all(
        np.isfinite(h["loss"]) and np.isfinite(h["qscale"]) for h in hist),
        "fit_salt gives finite losses")
    check_no_kernel(ops.counts(), "salt phase")
    # salt_marks: the targets line, then epochs 0 and 1
    salt_epoch = salt_marks[-1] - salt_marks[-2]
    line(f"salt: targets {t_targets:.3f} s for {SALT_BURN + SALT_NSIM} "
         f"epochs of 79 steps and their RDFs; back to back, an MD step "
         f"{step_ms:.3f} ms and a force: the stack's {ms['stack']:.3f} ms, "
         f"the Ewald's {ms['ewald']:.3f} ms, the core's {ms['core']:.3f} "
         f"ms (the Ewald force {ms['ewald'] / step_ms:.1%} of the step's "
         f"time, the stack's {ms['stack'] / step_ms:.1%}); fit_salt call {salt_wall:.3f} s, epoch 1 {salt_epoch:.3f} "
         f"s at tau {SALT_TAU}; peak {salt_peak} B; qscale "
         f"{[h['qscale'] for h in hist]}")
    out["salt"] = {"targets_s": t_targets, "step_ms": step_ms, "ms": ms,
                   "wall": salt_wall, "epoch_s": salt_epoch,
                   "peak": salt_peak, "u_err": u_err, "f_err": f_err,
                   "u_err_tf32": u_err_t, "f_err_tf32": f_err_t, "gq": gq}

    # (c) the binary mixture
    mix_marks = []

    def mix_log(msg):
        torch.cuda.synchronize()
        mix_marks.append(time.perf_counter())
        line(f"mix: {msg}")

    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    res = fit_mix.fit_mix(log=mix_log, device=dev, **MIX)
    torch.cuda.synchronize()
    mix_wall = time.perf_counter() - t0
    require(len(res["loss_log"]) == MIX["n_epochs"] and not res.get(
        "nan_bailout") and all(np.isfinite(res["loss_log"])),
        "fit_mix gives finite losses")
    require(all(np.isfinite(u).all() for u in res["recovered"].values()),
            "fit_mix's recovered potentials are finite")
    check_no_kernel(ops.counts(), "mixture fit")
    mix_epoch = (mix_marks[-1] - mix_marks[0]) / (len(mix_marks) - 1)
    line(f"mix: N = 108, losses {res['loss_log']}; call {mix_wall:.3f} s, "
         f"{mix_epoch:.3f} s an epoch over epochs 1-2")
    out["mix"] = {"wall": mix_wall, "epoch_s": mix_epoch}
    return out


# run_supervised.py's defaults (lj_0.845_1.2 at size 3, 108 atoms; 20
# burn-in epochs, 400 frames every 20 steps; batch 16, lr 1e-3; SchNet
# 64/64, 2.5 // 0.1 = 24 Gaussians, 2 convolutions, cutoff 2.5; 12
# validation epochs)
# cut from 150 training epochs to 3
SUPERVISED_ARGV = ["-max_epochs", "3"]
# TI on the trained model: the last atom switched off over 200 steps,
# the lambda moved every 20 (10 segments), dt and T the script's
TI_STEPS, TI_FREQ = 200, 20
# the card's float32 against the CPU, each relative to its largest entry:
# batched_predict against the CPU's float32 (the card's index_add adds in
# no fixed order; an energy sums 108 atomic terms of ~5 to a shifted ~30,
# and lay 5.3e-06 off in the first run, the forces 1.1e-06; H100, 700 W),
# dU/dlambda against the CPU in float64 (1.3e-05)
SUP_PREDICT_TOL = {"energy": 1e-4, "energy_grad": 1e-5}
TI_DU_TOL = 1e-4


def _epoch_deltas(marks, tag):
    """The launch counts of each ``[tag] epoch i`` line's epoch: the
    difference of the counts read at it and at the line before."""
    out = []
    for (_, prev), (msg, cur) in zip(marks, marks[1:]):
        if msg.startswith(f"  [{tag}] epoch"):
            out.append({g: {k: cur[g][k] - prev[g][k] for k in cur[g]}
                        for g in cur})
    return out


def supervised_ti_phase(mt, torch, dev, records, compare):
    """Phase 4n (see the module docstring): returns its numbers."""
    import copy
    import tempfile
    import numpy as np
    from mdgrad_tpu_torch import ops
    from mdgrad_tpu_torch.data.dataset import Dataset
    from mdgrad_tpu_torch.ops import gather
    from mdgrad_tpu_torch.data.loader import DataLoader
    from mdgrad_tpu_torch.data.registry import pair_data_dict
    from mdgrad_tpu_torch.md.ti import TI
    from mdgrad_tpu_torch.nn.models import GraphConvIntegration
    from mdgrad_tpu_torch.train.builders import load_model
    from mdgrad_tpu_torch.train.fit_rdf import get_system, registry_T_kelvin
    from mdgrad_tpu_torch.train.supervised import batch_to_tensors
    script = load_script("run_supervised_torch.py")
    out = {}
    marks = []

    def log(msg):
        torch.cuda.synchronize()
        marks.append((msg, ops.counts()))
        line(f"supervised: {msg}")

    with tempfile.TemporaryDirectory() as logdir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        marks.append(("start", ops.counts()))
        t0 = time.perf_counter()
        res = script.main(["-logdir", logdir, *SUPERVISED_ARGV], log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        sec = res["seconds"]
        msgs = [m for m, _ in marks]
        i_data = next(i for i, m in enumerate(msgs)
                      if m.startswith("dataset:"))
        i_train = next(i for i, m in enumerate(msgs)
                       if m.startswith("training:"))
        i_test = next(i for i, m in enumerate(msgs)
                      if m.startswith("test metrics"))
        check_no_kernel(marks[i_data][1], "label MD and labels")
        # the trainer and evaluate: nothing launched between the dataset
        # line and the test metrics
        between = {g: {k: marks[i_test][1][g][k] - marks[i_data][1][g][k]
                       for k in marks[i_test][1][g]}
                   for g in marks[i_test][1]}
        check_no_kernel(between, "supervised trainer and evaluate")
        for i, launched in enumerate(_epoch_deltas(marks, "truth")):
            check_no_kernel(launched, f"ground-truth validation epoch {i}")
        val = _epoch_deltas(marks, "gnn")
        require(len(val) == 12, "12 validation MD epochs of the GNN")
        for i, launched in enumerate(val):
            check_no_kernel(launched, f"GNN validation epoch {i}",
                            allowed=FOLD_KERNELS)
            for name in FOLD_KERNELS:
                require(launched["launches"][name] > 0,
                        f"kernel {name} launched in GNN validation epoch {i}")
        for name in FOLD_KERNELS:
            records.setdefault(name, {})["launches_supervised_val"] = \
                val[-1]["launches"][name]
        metrics = res["test_metrics"]
        require(all(np.isfinite(v) for d in metrics.values()
                    for v in d.values()) and np.isfinite(
                        res["rdf_mse_vs_truth"]),
                "finite test metrics and RDF MSE")
        steps_per_s = res["train_steps"] / sec["train"]
        line(f"supervised: N = {res['n_atoms']}, {res['n_frames']} frames; "
             f"labels {sec['labels']:.3f} s (20 burn-in and "
             f"{-(-res['n_frames'] * 20 // 120)} sampling epochs of 120 "
             f"steps and the labels); training {res['train_epochs']} "
             f"epochs, {res['train_steps']} steps of 16 frames in "
             f"{sec['train']:.3f} s ({steps_per_s:.2f} steps/s, "
             f"{sec['train'] / res['train_epochs']:.3f} s an epoch with "
             f"its validation); test MAE energy "
             f"{metrics['energy']['mae']:.5f}, energy_grad "
             f"{metrics['energy_grad']['mae']:.5f}; validation MD "
             f"{sec['validation_md']:.3f} s for 12 epochs of 120 steps; RDF "
             f"MSE vs truth {res['rdf_mse_vs_truth']:.5f}; the call "
             f"{wall:.3f} s, peak {peak} B; launches a GNN validation epoch "
             f"{ {k: val[-1]['launches'][k] for k in FOLD_KERNELS} }")
        out.update(wall=wall, peak=peak, seconds=sec,
                   steps_per_s=steps_per_s, metrics=metrics,
                   rdf_mse=res["rdf_mse_vs_truth"],
                   val_launches={k: val[-1]["launches"][k]
                                 for k in FOLD_KERNELS})

        # batched_predict on the card against the port on the CPU
        model, mp = load_model(os.path.join(logdir, "model.pt"), device=dev)
        ds = Dataset.load(os.path.join(logdir, "dataset.npz"))
        batch = next(iter(DataLoader(ds, batch_size=16, shuffle=False)))
        cpu_model = copy.deepcopy(model).cpu()
        ops.reset_counts()
        with torch.no_grad():
            got = model.batched_predict(batch_to_tensors(batch, dev))
            ref = cpu_model.batched_predict(batch_to_tensors(batch, "cpu"))
        check_no_kernel(ops.counts(), "batched_predict on the card")
        errs = {}
        for key in ("energy", "energy_grad"):
            err, rel, scale = max_errs(got[key].cpu(), ref[key])
            errs[key] = rel
            require(rel <= SUP_PREDICT_TOL[key],
                    f"batched_predict {key} on the card equals the CPU's "
                    f"({rel:.3e} of its largest entry, tol "
                    f"{SUP_PREDICT_TOL[key]})")
        line(f"supervised: batched_predict card vs CPU on 16 frames: energy "
             f"{errs['energy']:.3e}, energy_grad {errs['energy_grad']:.3e} "
             f"of the largest entry (tol {SUP_PREDICT_TOL}); no kernel")
        out["predict_err"] = errs

    # TI with the trained weights as a GraphConvIntegration on the box
    entry = pair_data_dict["lj_0.845_1.2"]
    T = registry_T_kelvin(entry)
    system = get_system("lj_0.845_1.2", 3, pair_data_dict,
                        rng=np.random.default_rng(0))
    n = system.get_number_of_atoms()
    gci = GraphConvIntegration(mp)
    gci.load_state_dict(model.state_dict())
    init, final = np.ones(n), np.ones(n)
    final[-1] = 0.0
    ti_marks = []

    def ti_log(msg):
        torch.cuda.synchronize()
        ti_marks.append((time.perf_counter(), ops.counts()))
        line(f"ti: {msg}")

    ti = TI(system, gci.to(dev), init, final, T_init=T, dt=0.005,
            cutoff=mp["cutoff"], steps=TI_STEPS,
            nbr_list_update_freq=TI_FREQ, device=dev)
    torch.cuda.synchronize()
    ops.reset_counts()
    ti_marks.append((time.perf_counter(), ops.counts()))
    ti_out = ti.run(log=ti_log)
    require(len(ti_out["du_dlambda"]) == TI_STEPS // TI_FREQ
            and np.isfinite(ti_out["du_dlambda"]).all()
            and np.isfinite(ti_out["delta_f"]),
            "TI gives a finite dU/dlambda and delta_f")
    for i, ((_, a), (_, b)) in enumerate(zip(ti_marks, ti_marks[1:])):
        launched = {g: {k: b[g][k] - a[g][k] for k in b[g]} for g in b}
        check_no_kernel(launched, f"TI epoch {i}", allowed=FOLD_KERNELS)
        for name in FOLD_KERNELS:
            require(launched["launches"][name] > 0,
                    f"kernel {name} launched in TI epoch {i}")
        if i == len(ti_marks) - 2:
            for name in FOLD_KERNELS:
                records.setdefault(name, {})["launches_ti"] = \
                    launched["launches"][name]
            ti_launches = {k: launched["launches"][k] for k in FOLD_KERNELS}
    ti_epoch = (ti_marks[-1][0] - ti_marks[1][0]) / (len(ti_marks) - 2)
    # dU/dlambda at the final configuration: the card against the CPU in
    # float64
    q = ti_out["final_state"].q
    aggr = ti.init_aggr + 0.5 * (ti.final_aggr - ti.init_aggr)
    direction = ti.final_aggr - ti.init_aggr
    aux = ti.interaction.aux_init(q)
    du = float(ti.du_dlambda(q, aux, aggr, direction))
    ti_cpu = TI(system, copy.deepcopy(gci).cpu().double(), init, final,
                T_init=T, dt=0.005, cutoff=mp["cutoff"], steps=TI_STEPS,
                nbr_list_update_freq=TI_FREQ, device="cpu",
                dtype=torch.float64)
    q64 = q.detach().cpu().double()
    du_ref = float(ti_cpu.du_dlambda(q64, ti_cpu.interaction.aux_init(q64),
                                     aggr.cpu().double(),
                                     direction.cpu().double()))
    du_err = abs(du - du_ref) / max(abs(du_ref), 1e-30)
    require(du_err <= TI_DU_TOL,
            f"dU/dlambda on the card equals the CPU's float64 ({du_err:.3e}"
            f", tol {TI_DU_TOL})")
    line(f"ti: N = {n}, {TI_STEPS} steps, lambda moved every {TI_FREQ}: "
         f"delta_f {ti_out['delta_f']:.6f}, dU/dlambda "
         f"{np.round(ti_out['du_dlambda'], 5).tolist()}; "
         f"{ti_epoch:.3f} s a segment; launches a segment {ti_launches}; "
         f"dU/dlambda at lambda 0.5 on the final state: card {du:.6f}, "
         f"CPU f64 {du_ref:.6f} (relative {du_err:.3e}, tol {TI_DU_TOL})")
    out["ti"] = {"delta_f": ti_out["delta_f"], "epoch_s": ti_epoch,
                 "launches": ti_launches, "du_err": du_err}
    out["ti"].update(ti_kernel_checks(torch, dev, compare, gather, ops,
                                      ti.interaction, q, aux, aggr,
                                      mp["n_filters"]))
    return out


def ti_kernel_checks(torch, dev, compare, gather, ops, inter, q, aux, aggr,
                     f):
    """Phase 4n's kernels at TI's shapes: K1, K2a and K2b against their
    plain versions and the CSR build against the plain build on ``aux``,
    the table at ``q``; then TI's force -dU/dq at ``aggr`` (the per-atom
    ``aggr_wgt``), its vjp in q, in ``aggr_wgt`` and in the weights, and
    dU/d(aggr_wgt), through the kernels against a copy of ``inter`` on
    the plain gather path.  Returns each error relative to its largest
    entry."""
    import copy
    table_kernel_checks(torch, dev, compare, gather, aux, f, "TI",
                        SEED + 20)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    plain = copy.deepcopy(inter)
    plain.gnn.gather_mode = "gather"
    cot = torch.randn(q.shape, device=dev, generator=gen)
    parts = ("force", "vjp q", "vjp aggr_wgt", "vjp weights",
             "dU/d(aggr_wgt)")
    got = {}
    for label, pot in (("kernels", inter), ("plain", plain)):
        x = q.detach().clone().requires_grad_(True)
        a = aggr.detach().clone().requires_grad_(True)
        ps = list(pot.parameters())
        ops.reset_counts()
        u = pot.energy(x, aux, aggr_wgt=a)
        g_x, g_a = torch.autograd.grad(u, [x, a], create_graph=True)
        grads = torch.autograd.grad((-g_x * cot).sum(), [x, a, *ps],
                                    allow_unused=True,
                                    materialize_grads=True)
        got[label] = ([-g_x.detach(), grads[0], grads[1],
                       torch.cat([g.reshape(-1) for g in grads[2:]]),
                       g_a.detach()], ops.counts())
    errs = {}
    for part, a, b in zip(parts, got["kernels"][0], got["plain"][0]):
        err, rel, scale = max_errs(a, b)
        line(f"ti: {part} kernels vs plain gather: max_abs_err {err:.3e} "
             f"(tol {1e-4 * scale:.3e}, largest entry {scale:.3e})")
        require(scale > 0 and rel <= 1e-4,
                f"TI's {part} through the kernels equals the plain gather "
                f"path's")
        errs[part] = rel
    counts = got["kernels"][1]
    check_no_kernel(counts, "TI force and vjp", allowed=FOLD_KERNELS)
    require(all(counts["launches"][name] > 0 for name in FOLD_KERNELS),
            "TI's force and its vjp launch K1, K2a, K2b and the CSR build")
    line(f"ti: force and vjp launches {counts['launches']}")
    return {"kernel_vs_plain": errs}


# ---- the a-Si fit, its transfer, the sharded paths (phase 4o) -------------

# scripts/run_si_torch.py at its defaults cut from 1000 epochs to 2, with
# the pallas RDF backend (K3/K4 and K3b/K4b); its configuration then set
# to write a checkpoint each epoch (the fit driver's default: every 10th)
SI_ARGV = ["-nepochs", "2", "-rdf_backend", "pallas"]
# scripts/si_transfer_torch.py at 4096 sites from the checkpoint of the
# 2-epoch fit above, cut from 500 + 60 + 40 epochs to 1 + 1 + 1, its MTK
# chain's time constant from 50 dt to 500 dt: a SchNet trained for 2
# epochs heats the lattice by ~1000 K in 40 steps, and at 50 dt the chain
# then diverges at 4096 sites (NaN within 40-100 steps, from 1500 K or
# from 100 K, on the card and on the CPU, in the cells and the table
# modes; 216 sites hold); 200 and 500 dt hold (H100 80GB HBM3, 700 W).
# The cut is this model's alone: from the trained model the JAX
# diagnostic held at 50 dt (results/r3_logs/diag_si4k.log, a TPU run of
# scripts/diag_si4k.py: every position finite through 300 steps, T_kin
# 1469.8-1523.7 K over steps 210-300), and from that model phase 4p's
# melt held at 50 dt on the card (T_kin 1472.8-1522.9 K over steps
# 210-300; H100 80GB HBM3, 700 W); the 1 + 1 + 1 cut's one-epoch quench
# from 1500 K diverges at 4096 sites from the trained model too, in the
# JAX package as in the port (see SI_TRAINED_TRANSFER_ARGV)
SI_TRANSFER_ARGV = ["-anneal_epochs", "1", "-equil_epochs", "1",
                    "-sample_epochs", "1", "-nhc_tau", "500"]
# the sharded paths as NCCL worlds of one against their unsharded
# counterparts, relative to each quantity's largest entry: the same
# kernels on the same inputs, only the collectives and the row slicing
# between them
SHARD_TOL = 1e-5
# the water sampling run under the profiler: 2 epochs of 20 steps (a
# trace of 100 steps is ~66 MB)
PROFILE_EPOCHS, PROFILE_FREQ = 2, 21


def _deltas(marks, start):
    """Each epoch's launch counts from the counts read at its log line
    (``marks``) and at the line before (the first against ``start``)."""
    out, prev = [], start
    for _, cur in marks:
        out.append({g: {k: cur[g][k] - prev[g][k] for k in cur[g]}
                    for g in cur})
        prev = cur
    return out


def rdf_shapes_checks(torch, dev, compare, gen, op, frames, what,
                      backward=False):
    """K3/K4 (and with ``backward`` K3b/K4b, for a cotangent drawn from
    ``gen``) against their plain versions on the RDF op ``op`` and the
    (F, N, 3) ``frames``, at 1e-4 of the largest bin (of the largest
    |dxyz|)."""
    from mdgrad_tpu_torch.ops import rdf as rdf_ops
    args = (op.cell_len, op.mu, op.coeff, op.cutoff)
    f, n = frames.shape[:2]
    line(f"  rdf_counts {what} F={f} N={n} bins={op.mu.shape[0]}:")
    compare("rdf_counts", rdf_ops._launch(frames, *args),
            rdf_ops.rdf_counts_plain(frames, *args), 1e-4)
    if backward:
        ct = torch.randn(op.mu.shape[0], device=dev, generator=gen)
        line(f"  rdf_counts_bwd {what} F={f} N={n}:")
        compare("rdf_counts_bwd", rdf_ops._launch_bwd(frames, *args, ct),
                rdf_ops.rdf_counts_bwd_plain(frames, *args, ct), 1e-4,
                floor=0.0)


def si_fit_and_transfer(mt, torch, dev, records, compare, tmp):
    """Phase 4o's first half: the a-Si fit, the kernels on its table, the
    4096-site transfer from its checkpoint."""
    import glob
    import numpy as np
    from mdgrad_tpu_torch import ops, units
    from mdgrad_tpu_torch.ops import gather, timing
    from mdgrad_tpu_torch.train import fit_rdf
    si = load_script("run_si_torch.py")
    transfer = load_script("si_transfer_torch.py")
    out = {}
    marks = []

    def log(msg):
        if " | loss" in str(msg):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), ops.counts()))
        line(f"si: {msg}")

    logdir = os.path.join(tmp, "si")
    args = si.parse_args(SI_ARGV)
    assignments, sys_params = si.fit_config(args)
    torch.cuda.synchronize()
    ops.reset_counts()
    start = ops.counts()
    t0 = time.perf_counter()
    with CsrWidths(gather) as widths:
        res = fit_rdf.fit_rdf(assignments, {**sys_params, "ckpt_every": 1},
                              model_path=os.path.join(logdir, "0"), log=log,
                              device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = ops.counts()
    per_epoch = _deltas(marks, start)
    losses = res["loss_log"]
    require(not res.get("nan_bailout") and len(losses) == 2
            and bool(np.isfinite(losses).all())
            and np.isfinite(res["objective"]),
            "the a-Si fit gives finite losses and a finite objective")
    for i, c in enumerate(per_epoch):
        for name in WATER_KERNELS:
            require(c["launches"][name] > 0,
                    f"kernel {name} launched in a-Si fit epoch {i}")
    check_fit_counts(total, "a-Si fit")
    require(widths.paths() == {"cluster"},
            f"the a-Si fit's CSR builds take the cluster kernel "
            f"({widths.describe()})")
    infer = {k: total["launches"][k] - marks[-1][1]["launches"][k]
             for k in total["launches"]}
    for name in WATER_KERNELS:
        rec = records.setdefault(name, {})
        rec["launches_si_fit_per_epoch"] = per_epoch[-1]["launches"][name]
        rec["launches_si_fit_inference"] = infer[name]
    epochs = [b - a for a, b in zip([t0] + [t for t, _ in marks],
                                    [t for t, _ in marks])]
    line(f"si: 512 sites, losses {losses}, objective {res['objective']:.5f};"
         f" epochs {[round(e, 3) for e in epochs]} s (the first from the "
         f"call), the call {wall:.3f} s; CSR {widths.describe()}; launches "
         f"an epoch {per_epoch[-1]['launches']}, inference {infer}")
    out["fit"] = {"wall": wall, "epochs": epochs, "losses": losses,
                  "objective": res["objective"]}

    # K1, K2a, K2b and the CSR build on the a-Si table's own shapes: the
    # fit's stack at the diamond lattice, perturbed
    built = fit_rdf.build_fit(assignments, sys_params,
                              rng=np.random.default_rng(SEED), device=dev)
    system, sim = built["systems"][0], built["sims"][0]
    inter = sim.integrator.model.models["nn"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    xyz = torch.tensor(system.get_positions(), dtype=torch.float32,
                       device=dev)
    xyz = xyz + 0.05 * torch.randn(xyz.shape, device=dev, generator=gen)
    n, k, path = table_kernel_checks(
        torch, dev, compare, gather, inter.aux_init(xyz),
        inter.gnn.convs[0].node_filter.out_features, "a-Si", SEED + 21)
    require(path == "cluster", "the a-Si table's CSR build is the cluster "
            "kernel's")
    out["table"] = {"n": n, "k": k}

    # K3/K4 and K3b/K4b on the fit's own RDF and frames: the fit's first
    # epoch of MD (tau steps of dt, the thermostat at the anneal's 1500 K
    # start), every frame_skip-th frame, a seeded cotangent; K3/K4 also
    # at the inference's 800 bins on one frame; tolerances as at the
    # water shapes (1e-4 of the largest bin, of the largest |dxyz|)
    tau = assignments["opt_freq"]
    sim.integrator.update_T(assignments["start_T"])
    traj = sim.simulate(steps=tau, dt=sys_params["dt"] * units.fs,
                        frequency=tau)
    frames = traj.q[::sys_params.get("frame_skip", 20)].contiguous()
    require(bool(torch.isfinite(frames).all()), "the a-Si MD is finite")
    op = built["observers"][0]._counts
    _, _, op_infer = fit_rdf.get_observer(
        system, args.data[0], 800, backend="pallas", device=dev)
    rdf_shapes_checks(torch, dev, compare, gen, op, frames, "a-Si fit",
                      backward=True)
    rdf_shapes_checks(torch, dev, compare, gen, op_infer._counts,
                      frames[-1:].contiguous(), "a-Si inference")
    out["table"]["rdf_frames"] = frames.shape[0]
    del built, inter, sim, traj, frames

    # the 4096-site transfer from the checkpoint just written
    ckpt = max(glob.glob(os.path.join(logdir, "0", "fit-ckpt-*.pt")),
               key=lambda p: int(p.rsplit("-", 1)[-1].split(".")[0]))
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    tr = transfer.main(["-ckpt", ckpt, "-logdir", os.path.join(tmp, "4k"),
                        *SI_TRANSFER_ARGV],
                       log=lambda m: line(f"si transfer: {m}"))
    torch.cuda.synchronize()
    tr_wall = time.perf_counter() - t0
    counts = ops.counts()
    require(np.isfinite(tr["mse"]) and tr["n_atoms"] == 4096
            and tr["frames"] == 25,
            "the transfer samples 25 frames of the 4096-site box, finite")
    transfer_kernels = WATER_KERNELS[:5]    # no RDF gradient
    for name in transfer_kernels:
        require(counts["launches"][name] > 0,
                f"kernel {name} launched in the 4096-site transfer")
        records.setdefault(name, {})["launches_si_transfer"] = \
            counts["launches"][name]
    check_no_kernel(counts, "4096-site transfer", allowed=transfer_kernels)
    # K3/K4 on the transfer's own RDF (800 bins) and its last sampling
    # epoch's 25 frames, as the sampling calls it (one frame) and all 25
    frames = tr["last_frames"].contiguous()
    op4 = tr["obs"]._counts
    rdf_shapes_checks(torch, dev, compare, None, op4, frames[-1:],
                      "4096-site transfer")
    rdf_shapes_checks(torch, dev, compare, None, op4, frames,
                      "4096-site transfer")
    del frames
    tab = tr["sim"].aux["nn"]
    n4 = tab.table.shape[0]
    idx = torch.where(tab.mask, tab.table, n4).reshape(-1).contiguous()
    e4 = idx.shape[0]
    path4 = gather.table_index_csr_path(e4, n4)
    require(path4 == "grid", "the 4096-site table takes the CSR grid path")
    require(all(torch.equal(a, b) for a, b in zip(
        gather._launch_table_index_csr(idx, n4),
        gather.table_index_csr_plain(idx, n4))),
        "the CSR build equals the plain build at the 4096-site table")
    csr_ms = timing.time_graph(
        lambda: gather._launch_table_index_csr(idx, n4), reps=20)
    csr_plain_ms = timing.time_graph(
        lambda: gather.table_index_csr_plain(idx, n4), reps=20)
    csr_bound = bound_ms(4 * (2 * e4 + n4 + 1), 0)[0]
    sec = tr["seconds"]
    line(f"si transfer: N = {n4}, K = {tab.table.shape[1]}, {tr['frames']} "
         f"frames, 800-bin MSE {tr['mse']:.5f}; build {sec['build']:.3f} s, "
         f"anneal {sec['anneal']:.3f} s, equilibration {sec['equil']:.3f} "
         f"s, sampling {sec['sample']:.3f} s (40, 40 and 100 steps), the "
         f"call {tr_wall:.3f} s; launches {counts['launches']}; the CSR "
         f"build (E = {e4}, {path4} path) {csr_ms * 1e3:.2f} us, plain "
         f"{csr_plain_ms * 1e3:.2f} us, bound {csr_bound * 1e3:.3f} us")
    out["transfer"] = {"wall": tr_wall, "seconds": sec, "mse": tr["mse"],
                       "k": tab.table.shape[1], "csr": {
                           "e": e4, "path": path4, "ms": csr_ms,
                           "plain_ms": csr_plain_ms, "bound_ms": csr_bound}}
    records["table_index_csr"]["si_transfer_csr"] = out["transfer"]["csr"]
    return out


def _rel(got, ref):
    """(largest |got - ref|, relative to the largest |ref|)."""
    err, rel, _ = max_errs(got, ref)
    return err, rel


def sharded_paths(mt, torch, dev, records):
    """Phase 4o's second half, inside an NCCL world of one: the replica
    fit step, the row-sharded SchNet epoch and the multistate train step,
    each against its unsharded counterpart."""
    import copy
    import numpy as np
    import torch.distributed as dist
    from mdgrad_tpu_torch import ops, units
    from mdgrad_tpu_torch.parallel import (ShardedGNNPotentials, dryrun,
                                           make_mesh, make_sharded_epoch,
                                           make_sharded_fit_step,
                                           make_stack_multistate_train_step)
    from mdgrad_tpu_torch.parallel.mesh import all_reduce_grads
    from mdgrad_tpu_torch.train import fit_rdf, fit_rdf_multi
    out = {}
    mesh = make_mesh({"dp": 1, "sp": 1})
    require(str(dist.get_backend()) == "nccl", "the world runs NCCL")

    # (a) the replica fit step in dryrun_multichip's configuration: the
    # dense pair sum, no kernel and no plain version
    got = {}
    for label, m in (("sharded", mesh), ("unsharded", None)):
        torch.cuda.synchronize()
        ops.reset_counts()
        lj, cfg, system = dryrun.dryrun_config(dev)
        _, loss_fn = make_sharded_epoch(lj, cfg, m, rdf_range=(0.75, 1.9),
                                        nbins=32)
        states = dryrun.dryrun_states(system, 2, dev)
        loss, finals = loss_fn(states, system.get_masses(),
                               torch.ones(32, device=dev))
        loss.backward()
        if m is not None:
            all_reduce_grads(lj.parameters(), dist.group.WORLD)
        grads = torch.stack([lj.sigma.grad, lj.epsilon.grad])
        step = make_sharded_fit_step(lj, cfg, m, np.ones(32),
                                     rdf_range=(0.75, 1.9), nbins=32,
                                     lr=1e-4)
        step_loss, _ = step(states, system.get_masses())
        torch.cuda.synchronize()
        check_no_kernel(ops.counts(), f"{label} replica fit step")
        got[label] = (loss.detach(), grads, finals.q,
                      torch.stack([lj.sigma, lj.epsilon]).detach())
    errs = {part: _rel(a, b) for part, a, b in zip(
        ("loss", "grads", "finals", "params"), got["sharded"],
        got["unsharded"])}
    line(f"sharded fit step (108 atoms, dp 1 x sp 1, 2 replicas, 3 steps): "
         f"loss {got['sharded'][0].item():.6f}, d/d(sigma, eps) "
         f"{got['sharded'][1].tolist()}; against unsharded: "
         + ", ".join(f"{p} {e:.3e} ({r:.3e} rel)" for p, (e, r) in
                     errs.items()) + f" (tol {SHARD_TOL})")
    require(all(r <= SHARD_TOL for _, r in errs.values())
            and bool(torch.isfinite(got["sharded"][2]).all()),
            "the sharded fit step equals the unsharded one")
    out["replica"] = {p: r for p, (_, r) in errs.items()}

    # (b) the row-sharded SchNet epoch: bench.py's water SchNet (512
    # sites, 128/128, K = 40), tau 52, the RDF loss through the replay
    system, stack = build_water(mt, dev)
    base = stack.models["nn"]
    require(base.k_max == 40, "the water SchNet's table has K = 40")
    sharded = ShardedGNNPotentials(base, mesh)
    stack_s = mt.Stack({"nn": sharded, "prior": stack.models["prior"]})
    train = fit_rdf.fit_parameters(stack)
    _, g_target, obs = fit_rdf.get_observer(system, TARGET, 109,
                                            backend="pallas", device=dev)
    got = {}
    # the unsharded epoch once first, untimed: this process's first water
    # SchNet epoch pays the card's one-time costs
    for label, stk in (("warm-up", stack), ("sharded", stack_s),
                       ("unsharded", stack)):
        integ = mt.NoseHooverChain(stk, system, T=298.0, Q=50.0,
                                   num_chains=5, adjoint=True, device=dev)
        sim = mt.Simulation(system, integ)
        loss_fn = fit_rdf.make_epoch_loss(sim, obs, g_target, system, 52,
                                          0.5 * units.fs, frame_skip=20)
        for p in train:
            p.grad = None
        state, aux = sim.initial_state()
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        loss, _ = loss_fn(state, aux, integ.default_ctrl())
        if stk is stack_s:
            sharded.reduce_grads()
        torch.cuda.synchronize()
        got[label] = (loss.reshape(1), torch.cat([
            (torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
            for p in train]), time.perf_counter() - t0, ops.counts())
    counts = got["sharded"][3]
    for name in WATER_KERNELS:
        require(counts["launches"][name] > 0,
                f"kernel {name} launched in the sharded SchNet epoch")
        records.setdefault(name, {})["launches_sharded_schnet_epoch"] = \
            counts["launches"][name]
    check_no_kernel(counts, "sharded SchNet epoch", allowed=WATER_KERNELS)
    l_err, l_rel = _rel(got["sharded"][0], got["unsharded"][0])
    g_err, g_rel = _rel(got["sharded"][1], got["unsharded"][1])
    line(f"sharded schnet epoch (512 sites, sp 1, K = 40, tau 52): loss "
         f"{got['sharded'][0].item():.6f} against {got['unsharded'][0].item():.6f}"
         f" ({l_rel:.3e} rel); gradient max_abs_err {g_err:.3e} ({g_rel:.3e}"
         f" of the largest entry, tol {SHARD_TOL}); epoch "
         f"{got['sharded'][2]:.3f} s against {got['unsharded'][2]:.3f} s; "
         f"launches {counts['launches']}")
    require(l_rel <= SHARD_TOL and g_rel <= SHARD_TOL
            and got["sharded"][1].abs().max() > 0,
            "the row-sharded SchNet epoch equals the unsharded one")
    out["schnet"] = {"loss_rel": l_rel, "grad_rel": g_rel,
                     "epoch_s": got["sharded"][2],
                     "unsharded_s": got["unsharded"][2]}
    for p in train:
        p.grad = None
    del stack, stack_s, sharded, base

    # (c) the multistate train step over phase 4h's three states, the
    # states split over the world (dp = 1) against group None
    script = load_script("run_water_multi_torch.py")
    assignments, sys_params, _ = script.build(MULTI_GNN_ARGV)
    comps = fit_rdf_multi.build_multistate(
        assignments, sys_params, rng=np.random.default_rng(SEED), device=dev)
    init = copy.deepcopy(comps["stack"].state_dict())
    integ = comps["integ"]
    dt = sys_params["dt"] * fit_rdf._dt_scale(
        comps["registry"][comps["train_list"][0]])
    proto = integ.initial_state()
    got = {}
    for label, group in (("unsharded", None), ("sharded", dist.group.WORLD)):
        comps["stack"].load_state_dict(init)
        opt = torch.optim.Adam(comps["params"], lr=assignments["lr"])
        step = make_stack_multistate_train_step(
            integ, dt=dt, n_steps=assignments["opt_freq"] - 1,
            nbins=assignments["nbins"], rdf_range=comps["rdf_range"],
            opt=opt, group=group, frame_skip=sys_params["frame_skip"],
            loss_type="shell")
        kw = {"dtype": proto.q.dtype, "device": proto.q.device}
        states = [proto._replace(q=torch.as_tensor(s.get_positions(), **kw),
                                 v=torch.as_tensor(s.get_velocities(), **kw))
                  for s in comps["systems"]]
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        loss, (losses, gs, finals, overflow) = step(
            states, comps["cell_lens"], comps["kTs"], comps["targets"],
            comps["rhos"])
        torch.cuda.synchronize()
        counts = ops.counts()
        for name in FOLD_KERNELS:
            require(counts["launches"][name] > 0,
                    f"kernel {name} launched in the {label} multistate "
                    "train step")
        check_no_kernel(counts, f"{label} multistate train step",
                        allowed=WATER_KERNELS)
        got[label] = (losses, torch.cat([p.grad.reshape(-1)
                                         for p in comps["params"]]),
                      torch.cat([p.detach().reshape(-1)
                                 for p in comps["params"]]),
                      time.perf_counter() - t0, counts)
    for name in FOLD_KERNELS:
        records.setdefault(name, {})["launches_sharded_multistate"] = \
            got["sharded"][4]["launches"][name]
    errs = {part: _rel(a, b) for part, a, b in zip(
        ("losses", "grads", "params"), got["sharded"][:3],
        got["unsharded"][:3])}
    line(f"sharded multistate train step (3 x 512 sites, tau "
         f"{assignments['opt_freq']}, Adam): losses "
         f"{got['sharded'][0].tolist()}; against unsharded: "
         + ", ".join(f"{p} {e:.3e} ({r:.3e} rel)" for p, (e, r) in
                     errs.items())
         + f" (tol {SHARD_TOL}); step {got['sharded'][3]:.3f} s against "
         f"{got['unsharded'][3]:.3f} s (the unsharded step ran first); "
         f"launches {got['sharded'][4]['launches']}")
    require(all(r <= SHARD_TOL for _, r in errs.values())
            and bool(torch.isfinite(got["sharded"][0]).all()),
            "the sharded multistate train step equals the unsharded one")
    out["multistate"] = {p: r for p, (_, r) in errs.items()}
    out["multistate"]["step_s"] = got["sharded"][3]
    return out


def water_profile(mt, torch, dev, tmp):
    """One ``profiling.trace`` of the water SchNet sampling run (phase 3's
    model): the device-busy share of its steps."""
    from mdgrad_tpu_torch import profiling, units
    system, stack = build_water(mt, dev)
    integ = mt.NoseHooverChain(stack, system, T=298.0, Q=50.0, num_chains=5,
                               device=dev)
    sim = mt.Simulation(system, integ)
    n_steps = PROFILE_EPOCHS * (PROFILE_FREQ - 1)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.simulate(steps=PROFILE_EPOCHS * PROFILE_FREQ,
                     dt=0.5 * units.fs, frequency=PROFILE_FREQ)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()
    wall = run()
    with profiling.trace(os.path.join(tmp, "trace")) as prof:
        wall_prof = run()
    busy, n_events = profiling.busy_us(prof.events(),
                                       torch.autograd.DeviceType.CUDA)
    size = os.path.getsize(os.path.join(tmp, "trace", "trace.json"))
    require(n_events > 0 and busy > 0, "the trace records the card")
    out = {"steps": n_steps, "wall_s": wall, "profiled_wall_s": wall_prof,
           "ms_a_step": 1e3 * wall / n_steps, "busy_s": busy * 1e-6,
           "events_a_step": n_events / n_steps,
           "busy_share": busy * 1e-6 / wall,
           "busy_share_profiled": busy * 1e-6 / wall_prof}
    line(f"profile: water sampling ({n_steps} steps, 512 sites): "
         f"{out['ms_a_step']:.3f} ms a step, {out['events_a_step']:.1f} "
         f"device events a step, busy {out['busy_s']:.4f} s: "
         f"{out['busy_share']:.1%} of the unprofiled run, "
         f"{out['busy_share_profiled']:.1%} of the profiled one; trace "
         f"{size} B")
    return out


def si_sharded_phase(mt, torch, dev, records, compare):
    """Phase 4o (see the module docstring): returns its numbers."""
    import tempfile
    import torch.distributed as dist
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(si_fit_and_transfer(mt, torch, dev, records, compare,
                                       tmp))
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, device_id=dev)
        try:
            out["sharded"] = sharded_paths(mt, torch, dev, records)
        finally:
            dist.destroy_process_group()
        out["profile"] = water_profile(mt, torch, dev, tmp)
    return out


# ---- the trained a-Si model: kernels, the melt, the transfer (4p) ---------

# the JAX package's trained a-Si SchNet (scripts/run_si.py; 64/128, 3
# convolutions, 40 Gaussians, epoch 5699), read by read_jax_pickle
SI_TRAINED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "results", "si_r2", "0", "fit-ckpt-5699.pkl")
# scripts/diag_si4k_torch.py at the JAX run's settings, its defaults (size
# 8: 4096 sites on the cell list, 1500 K, hot start, the MTK chain at 50
# dt) with its chunking stated: 30 chunks of 10 steps, an epoch of 9
# steps each (results/r3_logs/diag_si4k.log)
SI_DIAG_ARGV = ["-ckpt", SI_TRAINED, "-chunk", "10", "-nchunks", "30"]
# the reference's band: on the TPU every chunk of steps 210-300 read
# 1469.8-1523.7 K; the port must hold 1350-1650 K there, every position
# finite, no table overflow
SI_DIAG_BAND, SI_DIAG_BAND_FROM = (1350.0, 1650.0), 210
# scripts/si_transfer_torch.py from the trained model at its own tau 50
# dt, cut from 500 + 60 + 40 epochs to 1 + 1 + 1 as phase 4o cuts it: a
# quench from 1500 K to 100 K in one 40-step epoch.  At 4096 sites that
# cut quench diverges in the JAX package too: scripts/si_transfer.py on
# the CPU overflows its neighbor table and goes NaN in its first sampling
# epoch, as the port does there and on the card (logs/si_transfer_cut/:
# jax_size8.log, torch_size8.log; the JAX script's full 500-epoch anneal
# held on a TPU, results/si_4k_r3/transfer.json).  So the smoke runs the
# cut quench at 1728 sites (-size 6, the cell list, the CSR cluster
# build), where both packages hold on the CPU with the same 800-bin MSE
# (jax_size6.log, torch_size6.log), and holds the card's MSE to the JAX
# script's within SI_TRAINED_TRANSFER_TOL: trajectories part
# chaotically, the MSE of 25 frames' g(r) is a statistic of them
SI_TRAINED_TRANSFER_ARGV = ["-ckpt", SI_TRAINED, "-size", "6",
                            "-anneal_epochs", "1", "-equil_epochs", "1",
                            "-sample_epochs", "1"]
SI_TRAINED_TRANSFER_MSE, SI_TRAINED_TRANSFER_TOL = 0.14040, 0.02


def trained_si_kernel_checks(torch, dev, compare, gather, ops, fit_rdf):
    """Phase 4p (a): the trained SchNet in ``run_si_torch.py``'s 512-site
    stack, the lattice displaced by 0.05 A (a seeded draw): K1, K2a, K2b
    and the CSR build against their plain versions on its table; the
    energy (to 1e-5 of |U|), the force and the force's vjp in q and the
    SchNet's weights (to 1e-4 of the largest entry) through the kernels
    against a copy on the plain gather path.  Returns the errors."""
    import copy
    import numpy as np
    si = load_script("run_si_torch.py")
    assignments, sys_params = si.fit_config(si.parse_args([]))
    built = fit_rdf.build_fit(assignments, sys_params,
                              rng=np.random.default_rng(SEED), device=dev)
    from mdgrad_tpu_torch.train.checkpoint import load_schnet_checkpoint
    epoch = load_schnet_checkpoint(built["net"], SI_TRAINED)
    require(epoch == 5699, "the trained a-Si checkpoint is epoch 5699")
    stack = built["sims"][0].integrator.model
    inter = stack.models["nn"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    xyz = torch.tensor(built["systems"][0].get_positions(),
                       dtype=torch.float32, device=dev)
    xyz = xyz + 0.05 * torch.randn(xyz.shape, device=dev, generator=gen)
    n, k, path = table_kernel_checks(
        torch, dev, compare, gather, inter.aux_init(xyz),
        inter.gnn.convs[0].node_filter.out_features, "trained a-Si",
        SEED + 25)
    require(path == "cluster", "the 512-site table's CSR build is the "
            "cluster kernel's")
    plain = copy.deepcopy(stack)
    plain.models["nn"].gnn.gather_mode = "gather"
    cot = torch.randn(xyz.shape, device=dev, generator=gen)
    got = {}
    for label, stk in (("kernels", stack), ("plain", plain)):
        x = xyz.clone().requires_grad_(True)
        ps = list(stk.models["nn"].parameters())
        ops.reset_counts()
        u = stk.energy(x, stk.aux_init(xyz))
        (g,) = torch.autograd.grad(u, x, create_graph=True)
        grads = torch.autograd.grad((-g * cot).sum(), [x, *ps],
                                    allow_unused=True,
                                    materialize_grads=True)
        got[label] = ([u.detach().reshape(1), -g.detach(), grads[0],
                       torch.cat([gr.reshape(-1) for gr in grads[1:]])],
                      ops.counts())
    errs = {}
    for part, a, b, tol in zip(("energy", "force", "vjp q", "vjp weights"),
                               got["kernels"][0], got["plain"][0],
                               (1e-5, 1e-4, 1e-4, 1e-4)):
        err, rel, scale = max_errs(a, b)
        line(f"trained si: {part} kernels vs plain gather: max_abs_err "
             f"{err:.3e} (tol {tol * scale:.3e}, largest entry "
             f"{scale:.3e})")
        require(scale > 0 and rel <= tol and bool(torch.isfinite(a).all()),
                f"the trained a-Si {part} through the kernels equals the "
                f"plain gather path's")
        errs[part] = rel
    counts = got["kernels"][1]
    check_no_kernel(counts, "trained a-Si energy, force and vjp",
                    allowed=FOLD_KERNELS)
    require(all(counts["launches"][name] > 0 for name in FOLD_KERNELS),
            "the trained a-Si energy, force and vjp launch K1, K2a, K2b "
            "and the CSR build")
    energy = got["kernels"][0][0].item()
    line(f"trained si: N = {n}, K = {k}; energy {energy:.6f} eV; launches "
         f"{counts['launches']}")
    return {"n": n, "k": k, "kernel_vs_plain": errs}


def si_trained_phase(mt, torch, dev, records, compare):
    """Phase 4p (see the module docstring): returns its numbers."""
    import tempfile
    import numpy as np
    from mdgrad_tpu_torch import ops
    from mdgrad_tpu_torch.ops import gather, timing
    from mdgrad_tpu_torch.train import fit_rdf
    require(os.path.exists(SI_TRAINED), f"{SI_TRAINED} is in the checkout")
    diag = load_script("diag_si4k_torch.py")
    transfer = load_script("si_transfer_torch.py")
    out = {"table": trained_si_kernel_checks(torch, dev, compare, gather,
                                             ops, fit_rdf)}

    # (b) the 4096-site melt from the trained model, as the JAX run
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    with CsrWidths(gather) as widths:
        recs = diag.main(SI_DIAG_ARGV, log=lambda m: line(f"si diag: {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.counts()
    dargs = diag.parse_args(SI_DIAG_ARGV)
    last = dargs.chunk * dargs.nchunks
    require(len(recs) == dargs.nchunks and all(r["finite"] for r in recs),
            f"the 4096-site melt keeps every position finite through "
            f"{dargs.nchunks} chunks")
    require(not any(r["overflow"] for r in recs),
            "no neighbor table of the melt overflows")
    band = [r["T_kin"] for r in recs if r["step"] >= SI_DIAG_BAND_FROM]
    lo, hi = SI_DIAG_BAND
    n_band = (last - SI_DIAG_BAND_FROM) // dargs.chunk + 1
    require(len(band) == n_band and all(lo <= t <= hi for t in band),
            f"T_kin over steps {SI_DIAG_BAND_FROM}-{last} stays in "
            f"{lo}-{hi} K (got {min(band):.1f}-{max(band):.1f} K)")
    check_no_kernel(counts, "a-Si diagnostic", allowed=FOLD_KERNELS)
    for name in FOLD_KERNELS:
        require(counts["launches"][name] > 0,
                f"kernel {name} launched in the a-Si diagnostic")
        records.setdefault(name, {})["launches_si_diag"] = \
            counts["launches"][name]
    require(widths.paths() == {"grid"},
            f"the diagnostic's CSR builds take the grid path "
            f"({widths.describe()})")
    idx, n4 = widths.last
    require(all(torch.equal(a, b) for a, b in zip(
        gather._launch_table_index_csr(idx, n4),
        gather.table_index_csr_plain(idx, n4))),
        "the CSR build equals the plain build at the diagnostic's table")
    csr_ms = timing.time_graph(
        lambda: gather._launch_table_index_csr(idx, n4), reps=20)
    csr_plain_ms = timing.time_graph(
        lambda: gather.table_index_csr_plain(idx, n4), reps=20)
    steps = [r["seconds"] for r in recs[1:]]
    ms_step = 1e3 * statistics.median(steps) / (dargs.chunk - 1)
    line(f"si diag: 4096 sites, {len(recs)} chunks of {dargs.chunk - 1} "
         f"steps in {wall:.3f} s (the first chunk {recs[0]['seconds']:.3f} "
         f"s); {ms_step:.3f} ms a step (median chunk); T_kin "
         f"{min(band):.1f}-{max(band):.1f} K over steps "
         f"{SI_DIAG_BAND_FROM}-{last}; CSR {widths.describe()}; "
         f"launches {counts['launches']}; the CSR build (E = {idx.shape[0]},"
         f" grid path) {csr_ms * 1e3:.2f} us, plain {csr_plain_ms * 1e3:.2f}"
         f" us")
    out["diag"] = {"wall": wall, "ms_a_step": ms_step, "last": last,
                   "T_band": (min(band), max(band)),
                   "T_min": min(r["T_kin"] for r in recs),
                   "csr": {"e": idx.shape[0], "path": "grid", "ms": csr_ms,
                           "plain_ms": csr_plain_ms, "bound_ms": bound_ms(
                               4 * (2 * idx.shape[0] + n4 + 1), 0)[0]}}

    # (c) the cut quench from the trained model at tau 50 dt, 1728 sites
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        tr = transfer.main(SI_TRAINED_TRANSFER_ARGV + ["-logdir", tmp],
                           log=lambda m: line(f"trained si transfer: {m}"))
        torch.cuda.synchronize()
        tr_wall = time.perf_counter() - t0
    counts = ops.counts()
    ref, tol = SI_TRAINED_TRANSFER_MSE, SI_TRAINED_TRANSFER_TOL
    require(tr["n_atoms"] == 1728 and tr["frames"] == 25,
            "the trained transfer samples 25 frames of the 1728-site box")
    require(np.isfinite(tr["mse"]) and abs(tr["mse"] - ref) <= tol * ref,
            f"the trained transfer's 800-bin MSE {tr['mse']:.5f} is the "
            f"JAX script's {ref} within {tol:.0%}")
    transfer_kernels = WATER_KERNELS[:5]    # no RDF gradient
    for name in transfer_kernels:
        require(counts["launches"][name] > 0,
                f"kernel {name} launched in the trained 1728-site transfer")
        records.setdefault(name, {})["launches_si_trained_transfer"] = \
            counts["launches"][name]
    check_no_kernel(counts, "trained 1728-site transfer",
                    allowed=transfer_kernels)
    sec = tr["seconds"]
    line(f"trained si transfer: 1728 sites, tau 50 dt, 1500 K -> 100 K, "
         f"800-bin MSE {tr['mse']:.5f} (JAX {ref}, relative "
         f"{abs(tr['mse'] - ref) / ref:.2e}); "
         f"build {sec['build']:.3f} s, anneal {sec['anneal']:.3f} s, "
         f"equilibration {sec['equil']:.3f} s, sampling {sec['sample']:.3f}"
         f" s, the call {tr_wall:.3f} s; launches {counts['launches']}")
    out["transfer"] = {"wall": tr_wall, "seconds": sec, "mse": tr["mse"]}
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", action="append", default=[],
                        metavar="OTHER.cu",
                        help="time the kernels of this other version of "
                             "csrc/gather.cu (a file named gather*.cu: K1, "
                             "K2a, K2b), csrc/rdf.cu (rdf*.cu: K3/K4, "
                             "K3b/K4b) or csrc/pair.cu (pair*.cu: K5-K7) "
                             "against this build's (may be repeated)")
    args = parser.parse_args()
    against = {"gather": [], "rdf": [], "pair": []}
    for src in args.against:
        kind = next((k for k in against
                     if os.path.basename(src).startswith(k)), None)
        if kind is None:
            parser.error(f"--against {src}: the file name must start with "
                         f"'gather', 'rdf' or 'pair'")
        against[kind].append(src)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np
    import mdgrad_tpu_torch as mt
    from mdgrad_tpu_torch import ops, units
    from mdgrad_tpu_torch.data.registry import exp_rdf_data_dict
    from mdgrad_tpu_torch.ops import (_build, gather, rdf as rdf_ops,
                                      time_gather, time_rdf, timing)
    dev = torch.device("cuda", 0)
    line(f"device: {torch.cuda.get_device_name(0)}  torch {torch.__version__}"
         f"  cuda {torch.version.cuda}")
    phase_ends = [("start", t_start)]

    def phase_done(name):
        torch.cuda.synchronize()
        phase_ends.append((name, time.perf_counter()))

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_wall = time.perf_counter() - t0
    if _build.build_seconds is not None:
        log = _build.library_path().with_suffix(".log").read_text()
        log = log.splitlines()
        for ln in log:
            if "Function properties" in ln or "registers" in ln \
                    or "spill" in ln or "Compiling entry" in ln:
                line("  ptxas: " + ln.split("ptxas info    :")[-1].strip())
    line(f"build: {build_wall:.3f} s (nvcc {_build.build_seconds} s; "
         f"{_build.library_path().name})")
    phase_done("build")

    # ---- 2. kernels against their plain versions --------------------------
    system, stack = build_water(mt, dev)
    gnn_pot = stack.models["nn"]
    n, k = 512, gnn_pot.k_max
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xyz0 = torch.tensor(system.get_positions(), dtype=torch.float32,
                        device=dev)
    xyz = xyz0 + 0.05 * torch.randn(xyz0.shape, device=dev, generator=gen)
    table = gnn_pot.aux_init(xyz)
    idx_m = torch.where(table.mask, table.table, n).reshape(-1)
    index = gather.TableIndex(idx_m, n)
    n_edges = idx_m.shape[0]
    n_real = int((idx_m < n).sum())
    require(n_real < n_edges, "the main-path table has sentinel entries")
    f = 128
    values = torch.randn(n, f, device=dev, generator=gen)
    w = torch.randn(n_edges, f, device=dev, generator=gen)
    g_edges = torch.randn(n_edges, f, device=dev, generator=gen)

    records = {}

    def compare(name, got, ref, tol, floor=1.0):
        """err <= tol * max(largest |ref|, floor)."""
        err, rel, scale = max_errs(got, ref)
        bound = tol * max(scale, floor)
        line(f"kernel {name}: max_abs_err {err:.3e} (tol {bound:.3e})"
             f"  max_rel_err {rel:.3e} (tol {tol:.1e})  shape {tuple(got.shape)}")
        require(np.isfinite(err) and err <= bound,
                f"{name} disagrees with its plain version")
        records.setdefault(name, {})["max_abs_err"] = max(
            err, records.get(name, {}).get("max_abs_err", 0.0))

    # K1 / K2a / K2b: f32 sums of at most K products in another order than
    # the plain version's -> ~1e-6 relative; the gather is exact
    compare("gather_mul_reduce", gather._launch_gather_mul_reduce(
        values, w, index.idx, k), gather.gather_mul_reduce_plain(
        values, w, index.idx, k), 1e-5)
    compare("table_gather", gather._launch_table_gather(values, index.idx),
            gather.table_gather_plain(values, index.idx), 0.0)
    compare("table_scatter", gather._launch_table_scatter(g_edges, index),
            gather.table_scatter_plain(g_edges, index.idx, n), 1e-5)
    require(torch.equal(
        gather._launch_gather_mul_reduce(values, w, index.idx, k),
        gather._launch_gather_mul_reduce(values, w, index.idx, k)),
        "K1 gives the same bits on every call (the replay needs it)")
    gather_phase(torch, dev, gen, gather, time_gather, index, k, compare,
                 records)
    csr_phase(torch, dev, gather, time_gather, index, g_edges, records)
    gather_bf16_phase(torch, dev, gen, gather, time_gather, index, k,
                      records)

    obs = mt.observables.rdf(system, nbins=109, r_range=(1.8, 7.5),
                             backend="pallas", device=dev)
    op = obs._counts
    # the fit's inference RDF: 800 bins over the same range
    op_infer = mt.observables.rdf(system, nbins=800, r_range=(1.8, 7.5),
                                  backend="pallas", device=dev)._counts
    # the water pair fits' RDF: 400 bins over H20_298K_redd's range
    pair_entry = exp_rdf_data_dict["H20_298K_redd"]
    op_pair = mt.observables.rdf(
        system, nbins=PAIR_FIT_ASSIGNMENTS["nbins"],
        r_range=(pair_entry["start"], pair_entry["end"]), backend="pallas",
        device=dev)._counts
    frames_test = xyz0 + 0.1 * torch.randn((50, n, 3), device=dev,
                                           generator=gen)
    rdf_phase(torch, dev, gen, rdf_ops, time_rdf, op, op_infer, op_pair,
              frames_test, compare)

    # the SchNet force through the kernels vs the plain gather path, same
    # seeded weights: f32 through two convolutions in another order
    _, stack_plain = build_water(mt, dev, gather_mode="gather")
    aux = stack.aux_init(xyz)
    integ_k = mt.NoseHooverChain(stack, system, T=298.0, Q=50.0,
                                 num_chains=5, device=dev)
    integ_p = mt.NoseHooverChain(stack_plain, system, T=298.0, Q=50.0,
                                 num_chains=5, device=dev)
    f_k = integ_k.force(xyz, aux)
    f_p = integ_p.force(xyz, aux)
    err, rel, scale = max_errs(f_k, f_p)
    line(f"schnet force kernels vs plain gather: max_abs_err {err:.3e} "
         f"(tol {1e-4 * scale:.3e}, max |F| {scale:.3e})")
    require(err <= 1e-4 * scale, "SchNet force through the kernels disagrees")

    # the force's vector-Jacobian product in q and the SchNet parameters --
    # the replay adjoint's inner product, K1/K2a/K2b at second order --
    # against the plain gather path, for a random cotangent
    u = torch.randn((n, 3), device=dev, generator=gen)
    vjps = {}
    for label, integ_x, stk in (("kernels", integ_k, stack),
                                ("plain", integ_p, stack_plain)):
        x = xyz.clone().requires_grad_(True)
        params = list(stk.models["nn"].parameters())
        f_x = integ_x.force(x, aux, create_graph=True)
        ops.reset_counts()
        grads = torch.autograd.grad((f_x * u).sum(), [x, *params],
                                    allow_unused=True,
                                    materialize_grads=True)
        vjps[label] = torch.cat([g.reshape(-1) for g in grads])
        if label == "kernels":
            vjp_counts = ops.counts()
    err, rel, scale = max_errs(vjps["kernels"], vjps["plain"])
    line(f"schnet force vjp (grad-of-grad) kernels vs plain gather: "
         f"max_abs_err {err:.3e} (tol {1e-4 * scale:.3e}, largest entry "
         f"{scale:.3e}); launches {vjp_counts['launches']}")
    require(scale > 0 and err <= 1e-4 * scale,
            "the force's grad-of-grad through the kernels disagrees")
    require(vjp_counts["launches"]["table_gather"] > 0
            and vjp_counts["launches"]["table_scatter"] > 0
            and sum(vjp_counts["plain_calls"].values()) == 0,
            "the force's grad-of-grad runs K2a and K2b, no plain version")
    del vjps, grads, f_x
    torch.cuda.synchronize()

    def compare_scalar(name, label, got, ref, rtol):
        """|got - ref| <= rtol |ref| for a scalar output."""
        got, ref = got.item(), ref.item()
        rel = abs(got - ref) / max(abs(ref), 1e-30)
        line(f"kernel {name} {label}: {got:.7g} vs {ref:.7g}  rel_err "
             f"{rel:.3e} (tol {rtol:.0e})")
        require(np.isfinite(got) and rel <= rtol,
                f"{name} {label} disagrees with its plain version")
        rec = records.setdefault(name, {})
        rec["max_rel_err_scalars"] = max(rel,
                                         rec.get("max_rel_err_scalars", 0.0))

    lj_kernel_phase(mt, torch, dev, gen, compare, compare_scalar)
    phase_done("checks")

    # ---- 3. the main path -------------------------------------------------
    integ = mt.NoseHooverChain(stack, system, T=298.0, Q=50.0, num_chains=5,
                               device=dev)
    sim = mt.Simulation(system, integ)
    dt = 0.5 * units.fs
    n_epochs, frequency = 50, 21          # 50 x 20 steps, a frame every 20
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    sim.simulate(steps=n_epochs * frequency, dt=dt, frequency=frequency)
    frames = torch.stack(sim.log["positions"])
    count, bins, g_r = obs(frames)
    q_last = frames[-1]
    with torch.no_grad():
        energy = stack.energy(q_last, stack.aux_init(q_last))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = ops.counts()
    n_steps = n_epochs * (frequency - 1)
    line(f"main: {n_steps} steps + rdf on {frames.shape[0]} frames in "
         f"{main_s:.3f} s; T_final {system.temperature():.2f} K; "
         f"U_final {energy.item():.6f} eV; g(r) max {g_r.max().item():.4f} "
         f"at r={obs.r_axis[int(g_r.argmax())]:.3f} A")
    line(f"main: launches {counts['launches']}  plain_calls "
         f"{counts['plain_calls']}")
    require(bool(torch.isfinite(frames).all()), "positions are finite")
    require(bool(torch.isfinite(energy)), "the energy is finite")
    require(not sim.overflowed, "no neighbor-table overflow")
    require(not sim.drifted, "no minimum-image drift")
    require(g_r.shape == (109,) and bool(torch.isfinite(g_r).all()),
            "g(r) is finite with 109 bins")
    for name, c in counts["launches"].items():
        if name in LJ_KERNELS:
            require(c == 0, f"water sampling launches no {name}")
            continue
        if name == "rdf_counts_bwd":
            require(c == 0, "sampling takes no RDF gradient")
        else:
            require(c > 0, f"kernel {name} launched on the main path")
        records.setdefault(name, {})["launches_sampling"] = c
    for name, c in counts["plain_calls"].items():
        require(c == 0, f"plain version of {name} not used on the main path")
    c_plain = rdf_ops.rdf_counts_plain(frames, op.cell_len, op.mu, op.coeff,
                                       op.cutoff)
    g_plain = (c_plain / c_plain.sum()) / (obs.vol_bins / obs.V)
    err, rel, scale = max_errs(g_r, g_plain)
    line(f"main: rdf kernel vs plain on the trajectory: max_abs_err "
         f"{err:.3e} (tol {1e-4 * scale:.3e})")
    require(err <= 1e-4 * scale, "trajectory RDF from the kernel matches")
    require(gather.table_index_csr_path(n_edges, n) == "cluster",
            "the main path's CSR builds take the cluster kernel")
    steps_per_s = n_steps / main_s
    del integ_k, integ_p, stack_plain, aux
    phase_done("main")

    # ---- 3b. the LJ sampling path ---------------------------------------
    lj_sampled = lj_sampling_phase(mt, torch, dev, records)
    phase_done("lj sampling")

    # ---- 4. train ---------------------------------------------------------
    trained = train_phase(mt, torch, dev, records)
    phase_done("train")

    # ---- 4b. the LJ differentiation path ---------------------------------
    lj_fitted = lj_fit_phase(mt, torch, dev, gen, compare, records)
    phase_done("lj fit")

    # ---- 4c. the fit driver -------------------------------------------------
    fitted = fit_phase(mt, torch, dev, records)
    phase_done("fit")

    # ---- 4d. bench.py's bf16 configuration --------------------------------
    bf16_run = bf16_phase(mt, torch, dev, records,
                          {"steps_per_s": steps_per_s})
    phase_done("bf16")

    # ---- 4e. 'mixed' and the Verlet skin through the fit driver -----------
    skinned = mixed_and_skin_phase(torch, records, fitted)
    phase_done("mixed and skin")

    # ---- 4f. the pair slice: fit_lj, the water pair fits, 'sparse' ---------
    paired = pair_phase(mt, torch, dev, records)
    reach_phase(time_rdf, {"water": op, "water fit": trained["rdf_op"],
                           "lj fit": lj_fitted["rdf_op"],
                           "fit inference": op_infer,
                           "water pair fit": op_pair})
    phase_done("pair")

    # ---- 4g. the isomerization slice --------------------------------------
    isomed = isom_phase(torch, dev)
    phase_done("isom")

    # ---- 4h. the multistate fits ------------------------------------------
    multi = multistate_phase(torch, dev, records)
    phase_done("multistate")

    # ---- 4i. fit_rdf with multiple time steps and the shared prior table ---
    mts_share = mts_share_phase(torch, records)
    phase_done("mts and share")

    # ---- 4j. large N: the cell list, 48,668 LJ atoms, the 4096-site fit -
    large = large_n_phase(mt, torch, dev, records, timing, compare)
    phase_done("large n")

    # ---- 4k. NPT fits, the reverse-time adjoint, Langevin ----------------
    npt = npt_langevin_reverse_phase(mt, torch, dev, records)
    phase_done("npt, reverse and langevin")

    # ---- 4l. the angle target and DiffTRE ---------------------------------
    angled = angle_difftre_phase(torch, records)
    phase_done("angle and difftre")

    # ---- 4m. the fold, the molten salt and the mixture ------------------
    fsm = fold_salt_mix_phase(mt, torch, dev, records, compare)
    phase_done("fold, salt and mix")

    # ---- 4n. supervised force matching and TI -----------------------------
    sup = supervised_ti_phase(mt, torch, dev, records, compare)
    phase_done("supervised and ti")

    # ---- 4o. the a-Si fit and transfer, the sharded paths, a profile ------
    si_run = si_sharded_phase(mt, torch, dev, records, compare)
    phase_done("si, sharded and profile")

    # ---- 4p. the trained a-Si model: its kernels, the melt, the transfer --
    si_trained = si_trained_phase(mt, torch, dev, records, compare)
    phase_done("trained si")

    # ---- 5. times ---------------------------------------------------------
    e_real = n_real
    pad_values = torch.cat([values, values.new_zeros(1, f)])
    key = index.key()
    zero_table = torch.zeros(n + 1, f, device=dev)
    # K1, K2a and K2b warm (one input set, resident in the L2 as on the MD
    # path) and cold (cycling over sets that together exceed the L2)
    gather_sets = time_gather.make_sets(index, k, time_gather.N_SETS, gen, f)
    gather_times = time_gather.warm_cold(_build.library(), gather_sets, k)
    gather_bytes = time_gather.bound_bytes(n, f, n_edges, e_real)
    specs = {
        "gather_mul_reduce": dict(
            source="mdgrad_tpu_torch/csrc/gather.cu",
            replaces="mdgrad_tpu/ops/pallas_gather.py:266",
            plain=lambda: gather.gather_mul_reduce_plain(
                values, w, index.idx, k),
            library=None, bytes=gather_bytes["gather_mul_reduce"],
            ops=2 * e_real * f),
        "table_gather": dict(
            source="mdgrad_tpu_torch/csrc/gather.cu",
            replaces="mdgrad_tpu/ops/pallas_gather.py:170",
            plain=lambda: gather.table_gather_plain(values, index.idx),
            library=lambda: torch.index_select(pad_values, 0, key),
            bytes=gather_bytes["table_gather"], ops=0),
        "table_scatter": dict(
            source="mdgrad_tpu_torch/csrc/gather.cu",
            replaces="mdgrad_tpu/ops/pallas_gather.py:193",
            plain=lambda: gather.table_scatter_plain(g_edges, index.idx, n),
            library=lambda: zero_table.index_add_(0, key, g_edges),
            bytes=gather_bytes["table_scatter"], ops=e_real * f),
    }
    kernels_json = []
    for name, s in specs.items():
        warm_cold = gather_times[name]
        ms = warm_cold["ms"]
        plain_ms = timing.time_graph(s["plain"], reps=20)
        lib_ms = (None if s["library"] is None
                  else timing.time_graph(s["library"], reps=100))
        b_ms, b_by = bound_ms(s["bytes"], s["ops"])
        rec = records[name]
        kernels_json.append({
            "name": name, "route": "cuda", "source": s["source"],
            "replaces": s["replaces"], "launches": rec["launches"],
            "launches_per_train_step": rec["launches_per_train_step"],
            "launches_sampling": rec["launches_sampling"],
            "launches_fit_per_epoch": rec["launches_fit_per_epoch"],
            "launches_fit_inference": rec["launches_fit_inference"],
            "max_abs_err": rec["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        cold = warm_cold["cold_ms"]
        kernels_json[-1].update(cold_ms=cold, cold_share_of_bound=b_ms / cold)
        floor = gather_times["launch_floor"].get(name)
        if floor is not None:
            kernels_json[-1]["launch_floor_ms"] = floor
        line(f"time {name}: kernel {ms * 1e3:.2f} us warm, {cold * 1e3:.2f} "
             f"us cold ({b_ms / cold:.1%} of the bound)"
             + ("" if floor is None
                else f", one-row floor {floor * 1e3:.2f} us") + "  plain "
             f"{plain_ms * 1e3:.2f} us  library "
             f"{'none' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}  "
             f"bound {b_ms * 1e3:.3f} us ({b_by}; {s['bytes']} B, "
             f"{s['ops']} ops)")
    # the bf16 instantiations (split=False), timed the same way on bf16
    # sets; their bound moves 2 bytes a feature (K2b writes f32 sums)
    bf16 = torch.bfloat16
    values16, w16, g16 = values.to(bf16), w.to(bf16), g_edges.to(bf16)
    pad16 = torch.cat([values16, values16.new_zeros(1, f)])
    zero16 = torch.zeros(n + 1, f, device=dev, dtype=bf16)
    sets16 = time_gather.make_sets(index, k, time_gather.N_SETS, gen, f,
                                   bf16)
    times16 = time_gather.warm_cold(_build.library(), sets16, k)
    bytes16 = time_gather.bound_bytes(n, f, n_edges, e_real, elem=2)
    if not against["gather"]:
        del sets16
    specs16 = {
        "gather_mul_reduce": dict(
            plain=lambda: gather.gather_mul_reduce_plain(
                values16, w16, index.idx, k, False),
            library=None, ops=2 * e_real * f),
        "table_gather": dict(
            plain=lambda: gather.table_gather_plain(values16, index.idx,
                                                    False),
            library=lambda: torch.index_select(pad16, 0, key), ops=0),
        # the library call sums in bf16 (one call, not the same rounding)
        "table_scatter": dict(
            plain=lambda: gather.table_scatter_plain(g16, index.idx, n,
                                                     False),
            library=lambda: zero16.index_add_(0, key, g16), ops=e_real * f),
    }
    for name, s16 in specs16.items():
        ms, cold = times16[name]["ms"], times16[name]["cold_ms"]
        plain_ms = timing.time_graph(s16["plain"], reps=20)
        lib_ms = (None if s16["library"] is None
                  else timing.time_graph(s16["library"], reps=100))
        b_ms, b_by = bound_ms(bytes16[name], s16["ops"])
        rec = records[f"{name}.bf16"]
        kernels_json.append({
            "name": f"{name}.bf16", "route": "cuda",
            "source": "mdgrad_tpu_torch/csrc/gather.cu",
            "replaces": specs[name]["replaces"] + " (split=False)",
            "launches": rec["launches"],
            "launches_per_train_step": rec["launches_per_train_step"],
            "launches_sampling": rec["launches_sampling"],
            "max_abs_err": rec["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "cold_ms": cold, "cold_share_of_bound": b_ms / cold})
        floor = times16["launch_floor"].get(name)
        if floor is not None:
            kernels_json[-1]["launch_floor_ms"] = floor
        line(f"time {name}.bf16: kernel {ms * 1e3:.2f} us warm, "
             f"{cold * 1e3:.2f} us cold ({b_ms / cold:.1%} of the bound)"
             + ("" if floor is None
                else f", one-row floor {floor * 1e3:.2f} us") + "  "
             f"plain {plain_ms * 1e3:.2f} us  library "
             f"{'none' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}  "
             f"bound {b_ms * 1e3:.3f} us ({b_by}; {bytes16[name]} B, "
             f"{s16['ops']} ops)")
    # K2b's CSR inverse, rebuilt with each new TableIndex (once per SchNet
    # energy): the kernel on the path it takes and on the grid build
    # forced, and the plain build, at every table width a water path runs
    # (the main path's own table at K = 40, water-shaped tables of
    # time_gather elsewhere); at K = 40 also K2b with each build and both
    # builds called eagerly back to back (host launches included); bound:
    # 4E bytes in, 4E + 4(n + 1) out
    def scatter_with(build):
        with_csr = gather.TableIndex(idx_m, n)
        with_csr._csr = build(idx_m, n)
        return gather._launch_table_scatter(g_edges, with_csr)

    csr_kernel = gather._launch_table_index_csr
    csr_plain = gather.table_index_csr_plain
    rng_csr = np.random.default_rng(SEED + 6)
    csr_idx = {}
    by_e = {}
    for k_w in time_gather.CSR_WATER_K:
        e_w = n * k_w
        idx_w = idx_m if e_w == n_edges else torch.tensor(
            time_gather.water_table(rng_csr, k_w, n), dtype=torch.int32,
            device=dev)
        csr_idx[e_w] = (idx_w, n)
        by_e[str(e_w)] = {
            "k": k_w, "path": gather.table_index_csr_path(e_w, n),
            "ms": timing.time_graph(lambda: csr_kernel(idx_w, n), reps=20),
            "grid_ms": timing.time_graph(
                lambda: csr_kernel(idx_w, n, False), reps=20),
            "plain_ms": timing.time_graph(lambda: csr_plain(idx_w, n),
                                          reps=20),
            "bound_ms": bound_ms(4 * (2 * e_w + n + 1), 0)[0]}
    # the grid build (past the cluster's capacity) at the tables of the
    # paths that take it, from time_gather's cases
    grid_by_e = {}
    for name, idx_np, n_g in time_gather.csr_index_cases():
        if name not in time_gather.CSR_GRID_CASES:
            continue
        e_g = idx_np.size
        idx_g = torch.tensor(idx_np, device=dev)
        require(gather.table_index_csr_path(e_g, n_g) == "grid",
                f"the {name} table takes the CSR grid build")
        csr_idx[e_g] = (idx_g, n_g)
        grid_by_e[str(e_g)] = {
            "case": name, "n": n_g,
            "ms": timing.time_graph(lambda: csr_kernel(idx_g, n_g), reps=20),
            "plain_ms": timing.time_graph(lambda: csr_plain(idx_g, n_g),
                                          reps=20),
            "bound_ms": bound_ms(4 * (2 * e_g + n_g + 1), 0)[0]}
    csr_b_ms, csr_b_by = bound_ms(4 * (2 * n_edges + n + 1), 0)
    main_csr = by_e[str(n_edges)]
    csr = {
        "path": main_csr["path"], "grid_ms": main_csr["grid_ms"],
        "with_scatter_ms": timing.time_graph(
            lambda: scatter_with(csr_kernel), reps=20),
        "plain_with_scatter_ms": timing.time_graph(
            lambda: scatter_with(csr_plain), reps=20),
        "eager_ms": timing.time_loop(lambda: csr_kernel(idx_m, n), reps=50),
        "plain_eager_ms": timing.time_loop(lambda: csr_plain(idx_m, n),
                                           reps=50),
        "launches_sampling": records["table_index_csr"]["launches_sampling"],
        "launches_per_train_step":
            records["table_index_csr"]["launches_per_train_step"],
        "launches_fit_per_epoch":
            records["table_index_csr"]["launches_fit_per_epoch"],
        "launches_fit_inference":
            records["table_index_csr"]["launches_fit_inference"],
        "by_e": by_e, "grid_by_e": grid_by_e}
    k2b = next(r for r in kernels_json if r["name"] == "table_scatter")
    k2b["with_csr_ms"] = csr["with_scatter_ms"]
    rec = records["table_index_csr"]
    kernels_json.append({
        "name": "table_index_csr", "route": "cuda",
        "source": "mdgrad_tpu_torch/csrc/gather.cu",
        "replaces": "mdgrad_tpu/ops/pallas_gather.py:193 (table_scatter's "
                    "CSR inverse, the port's own: the TPU kernel needs none)",
        "launches": rec["launches"], "max_abs_err": rec["max_abs_err"],
        "ms": main_csr["ms"], "plain_ms": main_csr["plain_ms"],
        "bound_ms": csr_b_ms, "bound_by": csr_b_by, "library_ms": None,
        "si_transfer_csr": si_run["transfer"]["csr"],
        "si_diag_csr": si_trained["diag"]["csr"], **csr})
    lj_timed = lj_times(mt, torch, dev, gen)
    lj_specs = {
        "lj_energy_forces": ("mdgrad_tpu/ops/pallas_pair.py:112", 4000),
        "lj_force": ("mdgrad_tpu/ops/pallas_pair.py:444", 4000),
        "lj_force_vjp": ("mdgrad_tpu/ops/pallas_pair.py:452", 1372),
        "lj_force_param": ("mdgrad_tpu/ops/pallas_pair.py:210", 4000),
    }
    for name, (replaces, n_path) in lj_specs.items():
        rec = records[name]
        t = lj_timed[name][n_path]
        # launches: the LJ path that runs the kernel (K7 has none)
        launches = (rec["launches_lj_fit"] if name == "lj_force_vjp"
                    else rec["launches_lj_sampling"])
        kernels_json.append({
            "name": name, "route": "cuda",
            "source": "mdgrad_tpu_torch/csrc/pair.cu", "replaces": replaces,
            "launches": launches,
            "launches_lj_sampling": rec["launches_lj_sampling"],
            "launches_lj_fit": rec["launches_lj_fit"],
            "max_abs_err": rec["max_abs_err"],
            "max_rel_err_scalars": rec.get("max_rel_err_scalars"),
            "n": n_path,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "by_n": {str(k): v for k, v in lj_timed[name].items()}})
    line(f"time table_index_csr (K2b's CSR build, E={n_edges}, n={n}): "
         f"kernel {main_csr['ms'] * 1e3:.2f} us ({csr['path']} path; grid "
         f"path forced {csr['grid_ms'] * 1e3:.2f} us)  plain "
         f"{main_csr['plain_ms'] * 1e3:.2f} us  bound {csr_b_ms * 1e3:.3f} "
         f"us ({csr_b_by}); K2b with it {csr['with_scatter_ms'] * 1e3:.2f} "
         f"us, with the plain build "
         f"{csr['plain_with_scatter_ms'] * 1e3:.2f} us (graph); eager loop "
         f"{csr['eager_ms'] * 1e3:.2f} us, plain "
         f"{csr['plain_eager_ms'] * 1e3:.2f} us")
    line("time table_index_csr at every water table width (n = 512): "
         + "  ".join(f"K={r['k']} E={e} {r['path']} {r['ms'] * 1e3:.2f} us"
                     f" (grid forced {r['grid_ms'] * 1e3:.2f}, plain "
                     f"{r['plain_ms'] * 1e3:.2f}, bound "
                     f"{r['bound_ms'] * 1e3:.3f})"
                     for e, r in by_e.items()))
    line("time table_index_csr on the grid build: " + "  ".join(
        f"{r['case']} E={e} n={r['n']} {r['ms'] * 1e3:.2f} us (plain "
        f"{r['plain_ms'] * 1e3:.2f}, bound {r['bound_ms'] * 1e3:.3f})"
        for e, r in grid_by_e.items()))
    # K3/K4 and K3b/K4b at every shape a path launches them
    rdf_inputs = {"50x512": (frames.contiguous(), op),
                  "3x512": (frames[-3:].contiguous(), op),
                  "10x1372": (lj_fitted["rdf_frames"], lj_fitted["rdf_op"]),
                  "1x512x800": (frames[-1:].contiguous(), op_infer),
                  "10x512x400": (frames[-10:].contiguous(), op_pair)}
    for name, timed in rdf_times(torch, rdf_ops, time_rdf, timing, gen,
                                 rdf_inputs).items():
        rec = records[name]
        kernels_json.append({
            "name": name, "route": "cuda",
            "source": "mdgrad_tpu_torch/csrc/rdf.cu",
            "replaces": RDF_REPLACES[name], "launches": rec["launches"],
            "launches_per_train_step": rec["launches_per_train_step"],
            "launches_sampling": rec["launches_sampling"],
            "launches_lj_fit": rec["launches_lj_fit"],
            "launches_fit_per_epoch": rec["launches_fit_per_epoch"],
            "launches_fit_inference": rec["launches_fit_inference"],
            "launches_pair_fit_per_epoch": rec["launches_pair_fit_per_epoch"],
            "launches_tpair_fit_per_epoch":
                rec["launches_tpair_fit_per_epoch"],
            "max_abs_err": rec["max_abs_err"], "shape": RDF_ROW_SHAPE[name],
            **{key: timed[RDF_ROW_SHAPE[name]][key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "bound_pipe")},
            "library_ms": None, "by_shape": timed})
    line(f"time md: {steps_per_s:.2f} steps/s (main phase wall clock, "
         f"{n_steps} steps + rdf)")
    line(f"time train: {trained['steps_per_s']:.2f} training steps/s (3 x "
         f"51 MD steps, forward and replay adjoint, in "
         f"{trained['wall']:.3f} s); replay epoch peak memory "
         f"{trained['peak']} B")

    line(f"time fit: {fitted['epochs_per_s']:.4f} fit epochs/s, "
         f"{fitted['steps_per_s']:.2f} training MD steps/s (3 x 51 steps in "
         f"{fitted['epochs_s']:.3f} s from the call, build included; "
         f"{fitted['steady_s']:.3f} s an epoch over epochs 1-2); inference "
         f"(1 rollout of 100 steps, 800-bin RDF of 2 frames) "
         f"{fitted['infer_s']:.3f} s; call {fitted['wall']:.3f} s; peak "
         f"memory {fitted['peak']} B; resume call {fitted['resume_s']:.3f} "
         f"s, regrow call {fitted['regrow_s']:.3f} s")
    line(f"time bf16 (bench.py's configuration, K = 40): sampling "
         f"{bf16_run['sample_steps_per_s']:.2f} steps/s ("
         f"{bf16_run['sample_steps']} steps + rdf) against f32 "
         f"{bf16_run['f32_sample_steps_per_s']:.2f} ({n_steps} steps + rdf); "
         f"training {bf16_run['train_steps_per_s']:.2f} steps/s against f32 "
         f"{bf16_run['train32_steps_per_s']:.2f} (3 x 51 steps of bench.py's "
         f"loss each); replay epoch peak memory {bf16_run['peak']} B against "
         f"f32 {bf16_run['peak32']} B")
    line(f"time skin fit: K = {skinned['k']}, {skinned['epochs_per_s']:.4f} "
         f"fit epochs/s from the call, epoch 1 {skinned['steady_s']:.3f} s, "
         f"{skinned['tables']} neighbor-table builds in 2 epochs; without "
         f"the skin K = {fitted['k']}, {fitted['epochs_per_s']:.4f} "
         f"epochs/s, {fitted['steady_s']:.3f} s an epoch, a table every "
         f"step")
    lj, lj_p = paired["lj"], paired["lj_pressure"]
    line(f"time fit_lj: {lj['epochs_per_s']:.4f} fit epochs/s from the call "
         f"(3 x 119 steps, N = 256; the call's set-up and 100 pretraining "
         f"iterations included), {lj['steady_s']:.3f} s an epoch over epochs "
         f"1-2; peak memory {lj['peak']} B; call {lj['wall']:.3f} s; the "
         f"pressure+VACF call (target simulated, 1 epoch) {lj_p['wall']:.3f} "
         f"s, its epoch ended {lj_p['first_s']:.3f} s into it, peak memory "
         f"{lj_p['peak']} B")
    for tag in ("pair", "tpair"):
        r = paired[tag]
        line(f"time {tag} fit: {r['epochs_per_s']:.4f} fit epochs/s from the "
             f"call (N = 512, 191 steps an epoch, 100 pretraining iterations "
             f"included), "
             + f"epoch 0 ended {r['first_s']:.3f} s into the call"
             + (f", {r['steady_s']:.3f} s an epoch over epoch 1"
                if tag == "pair" else "")
             + f"; peak memory {r['peak']} B; call {r['wall']:.3f} s")
    line(f"time isom: {isomed['n_steps']} RK4 steps an epoch (D = 716), "
         f"epochs {[round(e, 3) for e in isomed['epochs']]} s, replay "
         f"forward {isomed['replay']['forward']:.3f} s and backward "
         f"{isomed['replay']['backward']:.3f} s over the {ISOM_EPOCHS} "
         f"epochs; peak memory {isomed['peak']} B; the {ISOM_GRAD_STEPS}-"
         f"step gradient {isomed['grad_s']:.3f} s")
    for tag in ("gnn", "tpair"):
        r = multi[tag]
        line(f"time multistate {tag}: 3 x 512 sites, epochs "
             f"{[round(e, 3) for e in r['epochs']]} s (the first from the "
             f"call); call {r['wall']:.3f} s; peak memory {r['peak']} B")
    line(f"time mts fit: epochs "
         f"{[round(e, 3) for e in mts_share['mts_epochs']]} s (the first "
         f"from the call, 25 outer steps each); the shared-prior epoch "
         f"ended {mts_share['share_s']:.3f} s into its call")
    lf, lc = large["fit"], large["cell_lj"]
    line(f"time large n fit: N = 4096 (K = {large['table']['k']}, cells "
         f"{large['table']['dims']}, M = {large['table']['M']}), epochs "
         f"{[round(e, 3) for e in lf['epochs']]} s (the first from the "
         f"call), inference {lf['infer_s']:.3f} s, peak memory {lf['peak']}"
         f" B; the table build {large['table']['cells_ms']:.3f} ms against "
         f"the dense {large['table']['dense_ms']:.3f} ms; the CSR build "
         f"({large['csr']['path']} path, E = {large['csr']['e']}) "
         f"{large['csr']['ms'] * 1e3:.2f} us")
    line(f"time cell lj: N = {lc['n']}, {lc['steps_per_s']:.2f} NVE steps/s"
         f", energy drift {lc['drift']:.3e}, one force {lc['ms']:.3f} ms "
         f"against K5's {lc['k5_ms']:.3f} ms, peak {lc['peak']} B above the "
         f"resident")
    line(f"time npt: the LJ fit call {npt['lj']['wall']:.3f} s (2 epochs + "
         f"4 evaluation epochs), the water fit call (512 sites, bf16) "
         f"{npt['water']['wall']:.3f} s, peak {npt['water']['peak']} B; "
         f"reverse vs replay {npt['reverse']['rel']:.3e}; Langevin "
         f"{npt['langevin']['steps_per_s']:.2f} steps/s at N = 4000, mean "
         f"kT {npt['langevin']['t_mean']:.5f}")
    line(f"time angle fit: epoch {angled['angle']['epoch_s']:.3f} s from "
         f"the call; difftre call {angled['difftre']['wall']:.3f} s (2 "
         f"outers at N = 500), peak {angled['difftre']['peak']} B")
    fo, sa = fsm["fold"], fsm["salt"]
    line(f"time fold: trained epoch {fo['epoch_s']:.3f} s (N = 50, tau 49),"
         f" the call {fo['wall']:.3f} s, peak {fo['peak']} B, launches an "
         f"epoch {fo['launches']}; salt: {sa['step_ms']:.3f} ms an MD step, "
         f"the Ewald force {sa['ms']['ewald']:.3f} ms "
         f"({sa['ms']['ewald'] / sa['step_ms']:.1%} of it, both back to "
         f"back), Ewald f32 vs f64 U {sa['u_err']:.3e} F {sa['f_err']:.3e}, "
         f"with TF32 U {sa['u_err_tf32']:.3e} F {sa['f_err_tf32']:.3e}; fit "
         f"epoch "
         f"{sa['epoch_s']:.3f} s (tau 60); mix {fsm['mix']['epoch_s']:.3f} s "
         f"an epoch (N = 108, tau 21)")
    line(f"time supervised: labels {sup['seconds']['labels']:.3f} s, "
         f"training {sup['steps_per_s']:.2f} steps/s of 16 frames "
         f"({sup['seconds']['train']:.3f} s for 3 epochs), validation MD "
         f"{sup['seconds']['validation_md']:.3f} s (12 x 120 steps, N = "
         f"108), the call {sup['wall']:.3f} s, peak {sup['peak']} B; TI "
         f"{sup['ti']['epoch_s']:.3f} s a 20-step segment")
    sf, tf, sh, pr = (si_run["fit"], si_run["transfer"], si_run["sharded"],
                      si_run["profile"])
    line(f"time si: the a-Si fit (512 sites, K = {si_run['table']['k']}) "
         f"epochs {[round(e, 3) for e in sf['epochs']]} s (the first from "
         f"the call), the call {sf['wall']:.3f} s; the 4096-site transfer "
         f"(K = {tf['k']}) anneal {tf['seconds']['anneal']:.3f} s, "
         f"equilibration {tf['seconds']['equil']:.3f} s, sampling "
         f"{tf['seconds']['sample']:.3f} s, the call {tf['wall']:.3f} s; its "
         f"CSR build (E = {tf['csr']['e']}, {tf['csr']['path']} path) "
         f"{tf['csr']['ms'] * 1e3:.2f} us against the plain "
         f"{tf['csr']['plain_ms'] * 1e3:.2f} us")
    tt, td, ttr = (si_trained["table"], si_trained["diag"],
                   si_trained["transfer"])
    line(f"time trained si: kernels vs plain on its 512-site table (K = "
         f"{tt['k']}) {tt['kernel_vs_plain']}; the 4096-site melt "
         f"{td['ms_a_step']:.3f} ms a step, the call {td['wall']:.3f} s, "
         f"T_kin {td['T_band'][0]:.1f}-{td['T_band'][1]:.1f} K over steps "
         f"{SI_DIAG_BAND_FROM}-{td['last']} (lowest {td['T_min']:.1f} K), "
         f"its CSR build (E = {td['csr']['e']}) "
         f"{td['csr']['ms'] * 1e3:.2f} us "
         f"against the plain {td['csr']['plain_ms'] * 1e3:.2f} us; the "
         f"1728-site quench at tau 50 dt MSE {ttr['mse']:.5f}, the call "
         f"{ttr['wall']:.3f} s")
    line(f"time sharded: SchNet epoch (NCCL world of one) "
         f"{sh['schnet']['epoch_s']:.3f} s against unsharded "
         f"{sh['schnet']['unsharded_s']:.3f} s; multistate train step "
         f"{sh['multistate']['step_s']:.3f} s; water sampling "
         f"{pr['ms_a_step']:.3f} ms a step, device busy "
         f"{pr['busy_share']:.1%}")
    sp = paired["sparse"]
    line(f"time sparse prior: N = 1728, capacity {sp['capacity']}, SchNet "
         f"K = {sp['k']} (CSR {'/'.join(sp['paths'])} path); one 20-step "
         f"sampling epoch {sp['epoch_s']:.3f} s")
    line(f"time lj sampling: {lj_sampled['steps_per_s']:.2f} steps/s (N=4000 "
         f"NVE, 950 steps, energy drift {lj_sampled['drift']:.3e})")
    line(f"time lj fit: {lj_fitted['steps_per_s']:.2f} fwd+bwd MD steps/s "
         f"(N=1372, 3 x 49 steps, in {lj_fitted['wall']:.3f} s); replay "
         f"epoch peak memory {lj_fitted['peak']} B, "
         f"{lj_fitted['epoch_peak']} B above the resident")
    phase_done("times")
    line("time phases: " + ", ".join(
        f"{name} {t - t_prev:.3f} s" for (_, t_prev), (name, t)
        in zip(phase_ends, phase_ends[1:])))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if against["gather"]:
        gather_ab(torch, _build, gather, time_gather, against["gather"],
                  {"f32": gather_sets, "bf16": sets16}, k,
                  {"f32": {name: bound_ms(b, 0)[0]
                           for name, b in gather_bytes.items()},
                   "bf16": {name: bound_ms(b, 0)[0]
                            for name, b in bytes16.items()}},
                  {e: csr_idx[e] for e in (n * 40, n * 72,
                                           *map(int, grid_by_e))}, smi)
    if against["rdf"]:
        rdf_ab(torch, _build, rdf_ops, time_rdf, timing, against["rdf"],
               rdf_inputs, gen, smi)
    if against["pair"]:
        pair_ab(mt, torch, dev, _build, against["pair"], gen, smi)
    # every path's launch counts beside each kernel's row
    for row in kernels_json:
        for key, value in records.get(row["name"], {}).items():
            if key.startswith("launches_"):
                row.setdefault(key, value)
    line(f"total: {time.perf_counter() - t_start:.3f} s")
    line(f"nvidia-smi: {smi}")
    line(json.dumps({"kernels": kernels_json}))
    line(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
