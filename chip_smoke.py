#!/usr/bin/env python3
"""Smoke run of mdgrad_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--against OTHER.cu ...]

Builds the port's CUDA kernels from ``mdgrad_tpu_torch/csrc`` and runs
its phases, printing one line as each check ends:

1. build   -- one nvcc process per source, in parallel, and one link into
   one shared library; its wall time.
2. kernels -- each kernel against its plain PyTorch version on the card at
   the shapes of the main paths (sentinel indices included); K1 and K2a
   also at F = 1, 3, 40, 128, 130, K = 1, 12, 40 and four sentinel layouts,
   and through views at a 4-byte offset (their scalar path); the SchNet
   force through the kernels against the plain gather path, and the force's
   vector-Jacobian product (its grad-of-grad) likewise; K2b's CSR build
   (one-block and grid paths) integer-equal to the plain build on the main
   path's index and on edge cases, and K2b bit-equal through either CSR;
   then the LJ pair kernels (K5 energy and forces, K6 force, K6b its vjp,
   K7 force and parameter sums) on perturbed FCC boxes of 108, 100 (the
   bounds mask), 1372 and 4000 atoms, powers (12, 6), (9, 6) and (12, 0),
   and K5, K6 and K6b (the i < j walks) at 2 and 8788 atoms, on positions
   unwrapped by whole cells, on pairs at the minimum image's edges (d =
   +-L/2 and one ulp around it, past a box length) and on pairs whose r^2
   lies within an ulp of cutoff^2, each giving the same bits twice, with
   the library's scratch sizes equal to ``ops/pair.py``'s; K3/K4 and
   K3b/K4b at 1, 3 and 50 frames of the water box and K3/K4 at the fit's
   inference shape (1 frame, 800 bins), each giving the same bits twice,
   and on ``ops/time_rdf.py``'s edge cases (N = 2-1372, F =
   1-10, 1500 bins, unsorted centres, an unbounded bin, pairs at the
   cutoff and the image's edges); the library's reach argument equal to
   ``ops/rdf.py``'s; then the bf16 instantiations of K1, K2a and K2b
   (``split=False``) against their plain versions on the same edge cases
   (F % 8 != 0 their scalar path), at the water shape and through views at
   a 2-byte offset, each giving the same bits twice.
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
   epoch 0 and regrows to K = 72, whose CSR build takes the grid kernel.
   Each call launches K1, K2a, K2b, the CSR build, K3/K4 and K3b/K4b, no
   LJ kernel and no plain version.
4d. bf16  -- ``bench.py:33-69`` as it is: phase 3's model with SchNet
   ``compute_dtype="bf16"`` at ``capacity_slack=1.25`` (K = 40).  The
   dense layers' bf16 GEMMs on cuBLAS against an f32-accumulated product
   (one bf16 ulp at most); the bf16 force against the f32 force of the same
   weights and against the port's bf16 force on the CPU (the plain
   versions); then phase 3's sampling run (1000 steps and the RDF) and 3
   optimizer steps of ``bench.py``'s loss (a tau = 52 epoch through the
   replay adjoint, mean((g - 1)^2) of the 109-bin g(r) of every 10th frame,
   here through K3/K4; clipped Adam), and the same 3 steps in f32.  The bf16
   runs launch the bf16 K1, K2a and K2b, no f32 gather kernel, and no plain
   version.
4e. mixed and skin -- ``fit_rdf`` at phase 4c's settings in ``'mixed'``
   (the f32 gather kernels, a bf16 node filter) for one epoch, then with
   ``gnn_skin`` 0.5 and ``topology_update_freq`` 3 for two; K, the
   launches an epoch and epochs/s beside 4c's skinless fit.
5. times   -- each kernel, its plain version and its library yardstick with
   CUDA events (the LJ kernels at 1372, 4000 and 8788 atoms; K3/K4 at 50
   and 3 frames of 512 sites, at 10 of 1372 and at 1 of 512 with 800
   bins, K3b/K4b at 3 x 512 and 10 x 1372,
   with bounds that count the exponentials inside the reach on these
   frames at the SFU's rate; K2b's CSR
   build against the plain build, K2b beside each; K1, K2a and K2b warm,
   their inputs in the L2 as on the MD path, and cold, cycling over input
   sets larger than the L2, with the cold share of the bound, in f32 and
   in bf16), MD, training and fit steps/s, bf16 against f32 from phase
   4d, the skinned fit against the skinless, and the card's name and power
   limit.
5b. a/b    -- only with ``--against``: each OTHER.cu, another version of
   ``csrc/gather.cu`` (a file named ``gather*.cu``), ``csrc/rdf.cu``
   (``rdf*.cu``) or ``csrc/pair.cu`` (``pair*.cu``), built alone into a
   library of its own, held against the plain versions, and timed with
   this build's kernels on the same inputs in turns -- the others, this,
   this, the others in reverse (A B B A for one other) -- ``ROUNDS``
   times.  Gather: K1, K2a and K2b warm, cold and on one row, the medians
   and the cold share of the bound, one JSON line ``{"gather_ab": ...}``.
   RDF: K3/K4 and K3b/K4b at phase 5's shapes, an older ``rdf.cu`` called
   through its own C interface (``ops/time_rdf.py``), one JSON line
   ``{"rdf_ab": ...}``.  Pair: K5, K6, K6b and K7 at N = 1372 and 4000, an
   older ``pair.cu`` with scratch sized by its own rule
   (``ops/time_pair.py``), one JSON line ``{"pair_ab": ...}``.

Launch counts are zeroed just before phases 3, 3b, 4 and 4b, each call
of 4c and 4e and each run of 4d, and read just after each: phases 3, 4,
4c and 4e must launch every water kernel, the CSR build included, 4d the
bf16 gather kernels in their place, and none may call a plain version.  The line before the last is a JSON object with one record per
kernel; the last line is ``{"ok": true, "device": {...}}``.  Any failed
check raises and the script exits non-zero.  Without a CUDA device it exits
1 and prints no result.
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
# and the fit's inference, one frame at 800 bins (K3/K4 only)
RDF_SHAPES = {"rdf_counts": ("50x512", "3x512", "10x1372", "1x512x800"),
              "rdf_counts_bwd": ("3x512", "10x1372")}
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
# neighbors) overflows at once and regrows to K = 72 (36864 edges), past
# the one-block CSR build's 32768
FIT_REGROW = {"n_epochs": 2, "n_sim": 0, "capacity_slack": 0.5,
              "overflow_policy": "regrow", "regrow_factor": 4.5}
WATER_KERNELS = ("gather_mul_reduce", "table_gather", "table_scatter",
                 "table_index_csr", "rdf_counts", "rdf_counts_bwd")
GATHER_KERNELS = WATER_KERNELS[:3]    # K1, K2a, K2b: f32 and bf16


class CsrWidths:
    """Records the (edges, rows) of every CSR build while it is entered:
    wraps ``gather._launch_table_index_csr``, which ``TableIndex.csr``
    calls, and puts it back on exit."""

    def __init__(self, gather):
        self.gather = gather
        self.seen = {}

    def __enter__(self):
        self.real = self.gather._launch_table_index_csr

        def record(idx, n, one_block=True):
            key = (idx.shape[0], n)
            self.seen[key] = self.seen.get(key, 0) + 1
            return self.real(idx, n, one_block)

        self.gather._launch_table_index_csr = record
        return self

    def __exit__(self, *exc):
        self.gather._launch_table_index_csr = self.real

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


def check_fit_counts(counts, what):
    """Every water kernel launched (the f32 gather kernels: the fits run
    float32 or 'mixed'), no bf16 instantiation, no LJ kernel, no plain
    version."""
    for name in WATER_KERNELS:
        require(counts["launches"][name] > 0,
                f"kernel {name} launched in the {what}")
    for name in LJ_KERNELS:
        require(counts["launches"][name] == 0,
                f"the {what} launches no {name}")
    for name, c in counts["launches_bf16"].items():
        require(c == 0, f"the {what} launches no bf16 {name}")
    for group in ("plain_calls", "plain_calls_bf16"):
        for name, c in counts[group].items():
            require(c == 0, f"plain version of {name} not used in the {what}")


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
    require(gather.table_index_csr_path(72 * 512, 512) == "grid",
            "the regrown table's CSR build takes the grid kernel")
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

    # the sampling run: as phase 3's, at bf16
    obs = mt.observables.rdf(system, nbins=109, r_range=(1.8, 7.5),
                             backend="pallas", device=dev)
    integ = mt.NoseHooverChain(stack, system, T=298.0, Q=50.0, num_chains=5,
                               adjoint=True, device=dev)
    sim = mt.Simulation(system, integ)
    n_epochs, frequency = 50, 21
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
            "f32_sample_steps_per_s": main["steps_per_s"],
            "err32": err32, "err_cpu": err_cpu}


def gather_phase(torch, dev, gen, gather, time_gather, index, k, compare,
                 records):
    """K1 and K2a against their plain versions on the cases their kernels
    special-case (``time_gather``'s F = 1, 3, 40, 128, 130: F % 4 != 0 the
    scalar path, F > 128 a second pass over the row; K = 1, 12, 40: 1, 3
    and 10 warps a row in K1; four sentinel layouts), 29 output rows over
    37 values; then at the water shape through views at a 4-byte storage
    offset (the scalar path).  K1 within 1e-5 of max(|ref|, 1) (f32 sums
    of at most K products in another order), K2a bit-exact (a copy); each
    gives the same bits on a second call."""
    import numpy as np
    rng = np.random.default_rng(SEED + 4)
    n, n_out = 37, 29
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
        line(f"kernel gather_mul_reduce, table_gather F={f}: K = 1, 12, 40 x "
             f"{len(time_gather.GATHER_LAYOUTS)} sentinel layouts: K1 "
             f"max_abs_err {err_k1:.3e} (tol 1e-5 of max(|ref|, 1)); K2a "
             f"bit-equal; the same bits twice")
        rec = records.setdefault("gather_mul_reduce", {})
        rec["max_abs_err"] = max(err_k1, rec.get("max_abs_err", 0.0))
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


def gather_bf16_phase(torch, dev, gen, gather, time_gather, index, k,
                      records):
    """K1, K2a and K2b's bf16 instantiations (``split=False``) against
    their plain versions on ``time_gather``'s edge cases (F % 8 != 0 takes
    the scalar path) and at the water shape, there also through views at a
    2-byte storage offset (the scalar path).  K1 (f32 sums of the same
    products in another order, rounded once to bf16) within one bf16 ulp,
    2^-7 |ref|, plus 1e-5 of max(|ref|, 1); K2a bit-exact; K2b (f32 sums
    of bf16 rows, f32 out) within 1e-5 of max(|ref|, 1).  Each gives the
    same bits on a second call."""
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
            "bf16 K1's scalar path gives the 16-byte path's bits")
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


def gather_lib_errs(torch, gather, time_gather, lib, s, k):
    """Max abs error of ``lib``'s K1, K2a and K2b on set ``s`` against
    their plain versions: K2a bit-exact, K1 and K2b within 1e-5 of
    max(|ref|, 1)."""
    for fn in time_gather.kernel_calls(lib, s, k).values():
        fn()
    torch.cuda.synchronize()
    n = s["values"].shape[0]
    refs = {"gather_mul_reduce": gather.gather_mul_reduce_plain(
                s["values"], s["w"], s["idx"], k),
            "table_gather": gather.table_gather_plain(s["values"], s["idx"]),
            "table_scatter": gather.table_scatter_plain(s["g"], s["idx"], n)}
    errs = {}
    for name, ref in refs.items():
        err, _, scale = max_errs(s[name], ref)
        tol = 0.0 if name == "table_gather" else 1e-5 * max(scale, 1.0)
        require(err <= tol, f"{name} of the library under test agrees with "
                            f"its plain version ({err:.3e} > {tol:.3e})")
        errs[name] = err
    return errs


def gather_ab(torch, _build, gather, time_gather, sources, sets, k, bounds,
              smi):
    """Phase 5b (see the module docstring): K1, K2a and K2b of each other
    ``gather.cu`` in ``sources`` against this build's, in one process on
    the same input sets; ``bounds`` {kernel: bound ms}."""
    libs = {f"other{i}": _build.library((src,))
            for i, src in enumerate(sources)}
    libs["this"] = _build.library()
    names = dict(zip(libs, [*sources, "csrc/gather.cu"]))
    for tag, lib in libs.items():
        errs = gather_lib_errs(torch, gather, time_gather, lib, sets[0], k)
        line(f"gather a/b: {tag} ({names[tag]}) max_abs_err " + "  ".join(
            f"{name} {err:.3e}" for name, err in errs.items()))
    order = list(libs)
    turns = (order + order[::-1]) * ROUNDS
    runs = {tag: [] for tag in libs}
    for i, tag in enumerate(turns):
        r = time_gather.warm_cold(libs[tag], sets, k)
        runs[tag].append(r)
        line(f"gather a/b turn {i} {tag}: " + "  ".join(
            f"{name} warm {r[name]['ms'] * 1e3:.2f} us cold "
            f"{r[name]['cold_ms'] * 1e3:.2f} us"
            for name in time_gather.KERNELS) + "  launch floor " + "  ".join(
            f"{name} {t * 1e3:.2f} us"
            for name, t in r["launch_floor"].items()))
    median = {}
    for tag, rs in runs.items():
        median[tag] = {"launch_floor": {
            name: statistics.median(r["launch_floor"][name] for r in rs)
            for name in rs[0]["launch_floor"]}}
        for name in time_gather.KERNELS:
            warm = statistics.median(r[name]["ms"] for r in rs)
            cold = statistics.median(r[name]["cold_ms"] for r in rs)
            median[tag][name] = {"ms": warm, "cold_ms": cold,
                                 "cold_share_of_bound": bounds[name] / cold}
            line(f"gather a/b median {tag} {name}: warm {warm * 1e3:.2f} us"
                 f"  cold {cold * 1e3:.2f} us  bound "
                 f"{bounds[name] * 1e3:.3f} us (bytes)  cold share of bound "
                 f"{bounds[name] / cold:.1%}")
        line(f"gather a/b median {tag} launch floor (one row): " + "  ".join(
            f"{name} {t * 1e3:.2f} us"
            for name, t in median[tag]["launch_floor"].items()))
    line(json.dumps({"gather_ab": {
        "sources": names,
        "rounds": ROUNDS, "sets": len(sets), "bound_ms": bounds,
        "median": median, "runs": runs, "card": smi}}))


def rdf_phase(torch, dev, gen, rdf_ops, time_rdf, op, op_infer, frames_test,
              compare):
    """K3/K4 and K3b/K4b against their plain versions at the water path's
    shapes (1, 3 and 50 frames of 512), the same bits on a second call;
    K3/K4 likewise at the fit's inference shape (``op_infer``: 1 frame, 800
    bins); then on ``time_rdf.edge_cases``; and the library's reach
    argument is ``ops/rdf.py``'s ``REACH_ARG``."""
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


def csr_cases(np, index):
    """[(name, idx (E,) int32 numpy, n)]: the main path's table index and
    the CSR build's edge cases (sentinels < 0, == n and > n, empty rows,
    one row with every edge, all sentinels, no edges), from a seed."""
    rng = np.random.default_rng(SEED + 3)
    cases = [("water", index.idx.cpu().numpy(), index.n),
             ("sentinels", rng.integers(-3, 12, size=50), 9),
             ("empty_rows", rng.choice([2, 5, 11], size=40), 20),
             ("one_row", np.full(300, 3), 5),
             ("all_sentinel", np.full(70, -1), 4),
             ("no_edges", np.zeros(0), 6)]
    return [(name, idx.astype(np.int32), n) for name, idx, n in cases]


def csr_phase(torch, dev, gather, index, g_edges):
    """K2b's CSR build (one-block and grid paths) against the plain build,
    integer-equal, on the main path's index and the edge cases; K2b's
    output bit-equal through either CSR at the water shape."""
    import numpy as np
    for name, idx_np, n in csr_cases(np, index):
        idx = torch.tensor(idx_np, device=dev)
        ref = gather.table_index_csr_plain(idx, n)
        for one_block in (True, False):
            got = gather._launch_table_index_csr(idx, n, one_block)
            require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                    f"the CSR kernel ({'one block' if one_block else 'grid'})"
                    f" equals the plain build on case {name}")
        line(f"kernel table_index_csr {name} (E={idx_np.size}, n={n}): "
             f"order and rowptr integer-equal to the plain build (one-block "
             f"and grid paths)")
    outs = []
    for csr in (gather._launch_table_index_csr(index.idx, index.n),
                gather.table_index_csr_plain(index.idx, index.n)):
        with_csr = gather.TableIndex(index.idx, index.n)
        with_csr._csr = csr
        outs.append(gather._launch_table_scatter(g_edges, with_csr))
    require(torch.equal(outs[0], outs[1]),
            "K2b gives the same bits through the kernel's and the plain CSR")
    line("kernel table_scatter: bit-equal through the CSR kernel's and the "
         "plain build's inverse")


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
    """K5, K6, K6b and K7 against their plain versions on the card: FCC at
    N = 108 (less than one 128 tile), 100 of them (the bounds mask), 1372
    (not a multiple of the tile) and 4000, powers (12, 6), plus (9, 6) and
    (12, 0) at 108; then K5, K6 and K6b, the i < j walks, at N = 2 and
    8788, on positions unwrapped by whole cells (the IEEE image, kFar),
    on pairs at the minimum image's edges and on pairs whose r^2 lies
    within an ulp of cutoff^2 (``ops/time_pair.py``).  A seeded cotangent
    W for K6b; every kernel gives the same bits on a second call.  The
    library's tiles and scratch sizes are ``ops/pair.py``'s."""
    import numpy as np
    from mdgrad_tpu_torch.ops import _build, pair, time_pair
    lib = _build.library()
    require(lib.mdg_pair_tile() == pair.PAIR_TILE
            and lib.mdg_force_tile() == pair.FORCE_TILE,
            "ops/pair.py's PAIR_TILE and FORCE_TILE are csrc/pair.cu's")
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
    half = LJ_KERNELS[:3]   # K5, K6, K6b: the i < j walks
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
        check(xyz, w, (cell, LJ_CUTOFF, sigma, eps), half)
    for L, axis, xyz_np, cell, cutoff, sig in time_pair.lj_edge_cases():
        xyz = torch.tensor(xyz_np, device=dev)
        args = (cell, cutoff, torch.tensor(sig, dtype=torch.float32,
                                           device=dev), eps)
        line(f"  lj i<j walks, image edges: L={L} axis {axis}")
        check(xyz, time_pair.pair_image_w(xyz, cell), args, half)
    xyz_np, cell, n_out = time_pair.cutoff_edge_case(LJ_CUTOFF)
    xyz = torch.tensor(xyz_np, device=dev)
    line(f"  lj i<j walks, cutoff edge: {n_out} pairs with r^2 within an "
         f"ulp of cutoff^2 (out by the stepwise sum, in by a fused one)")
    res = check(xyz, time_pair.pair_image_w(xyz, cell),
                (cell, LJ_CUTOFF, sigma, eps), half)
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
    Against a parent whose K6 differs only in how r^2 rounds, K6 is the
    control."""
    import numpy as np
    from mdgrad_tpu_torch.ops import pair, time_pair, timing
    libs = {f"other{i}": _build.library((src,))
            for i, src in enumerate(sources)}
    libs["this"] = _build.library()
    names = dict(zip(libs, [*sources, "csrc/pair.cu"]))
    sigma = torch.tensor(0.9, device=dev)
    eps = torch.tensor(1.0, device=dev)
    calls = {tag: {} for tag in libs}
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
        "card": smi}}))


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
    from mdgrad_tpu_torch.ops import (_build, gather, rdf as rdf_ops,
                                      time_gather, time_rdf, timing)
    dev = torch.device("cuda", 0)
    line(f"device: {torch.cuda.get_device_name(0)}  torch {torch.__version__}"
         f"  cuda {torch.version.cuda}")

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
    csr_phase(torch, dev, gather, index, g_edges)
    gather_bf16_phase(torch, dev, gen, gather, time_gather, index, k,
                      records)

    obs = mt.observables.rdf(system, nbins=109, r_range=(1.8, 7.5),
                             backend="pallas", device=dev)
    op = obs._counts
    # the fit's inference RDF: 800 bins over the same range
    op_infer = mt.observables.rdf(system, nbins=800, r_range=(1.8, 7.5),
                                  backend="pallas", device=dev)._counts
    frames_test = xyz0 + 0.1 * torch.randn((50, n, 3), device=dev,
                                           generator=gen)
    rdf_phase(torch, dev, gen, rdf_ops, time_rdf, op, op_infer, frames_test,
              compare)

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
    steps_per_s = n_steps / main_s
    del integ_k, integ_p, stack_plain, aux

    # ---- 3b. the LJ sampling path ---------------------------------------
    lj_sampled = lj_sampling_phase(mt, torch, dev, records)

    # ---- 4. train ---------------------------------------------------------
    trained = train_phase(mt, torch, dev, records)

    # ---- 4b. the LJ differentiation path ---------------------------------
    lj_fitted = lj_fit_phase(mt, torch, dev, gen, compare, records)

    # ---- 4c. the fit driver -------------------------------------------------
    fitted = fit_phase(mt, torch, dev, records)

    # ---- 4d. bench.py's bf16 configuration --------------------------------
    bf16_run = bf16_phase(mt, torch, dev, records,
                          {"steps_per_s": steps_per_s})

    # ---- 4e. 'mixed' and the Verlet skin through the fit driver -----------
    skinned = mixed_and_skin_phase(torch, records, fitted)
    reach_phase(time_rdf, {"water": op, "water fit": trained["rdf_op"],
                           "lj fit": lj_fitted["rdf_op"],
                           "fit inference": op_infer})

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
        line(f"time {name}: kernel {ms * 1e3:.2f} us warm, {cold * 1e3:.2f} "
             f"us cold ({b_ms / cold:.1%} of the bound)  plain "
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
        line(f"time {name}.bf16: kernel {ms * 1e3:.2f} us warm, "
             f"{cold * 1e3:.2f} us cold ({b_ms / cold:.1%} of the bound)  "
             f"plain {plain_ms * 1e3:.2f} us  library "
             f"{'none' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}  "
             f"bound {b_ms * 1e3:.3f} us ({b_by}; {bytes16[name]} B, "
             f"{s16['ops']} ops)")
    # K2b's CSR inverse, rebuilt with each new TableIndex (once per SchNet
    # energy): the kernel (one-block and grid builds) and the plain build,
    # K2b with each, and both builds called eagerly back to back (host
    # launches included); bound: 4E bytes in, 4E + 4(n + 1) out
    def scatter_with(build):
        with_csr = gather.TableIndex(idx_m, n)
        with_csr._csr = build(idx_m, n)
        return gather._launch_table_scatter(g_edges, with_csr)

    csr_kernel = gather._launch_table_index_csr
    csr_plain = gather.table_index_csr_plain
    csr_b_ms, csr_b_by = bound_ms(4 * (2 * n_edges + n + 1), 0)
    csr = {
        "ms": timing.time_graph(lambda: csr_kernel(idx_m, n), reps=20),
        "grid_ms": timing.time_graph(lambda: csr_kernel(idx_m, n, False),
                                     reps=20),
        "plain_ms": timing.time_graph(lambda: csr_plain(idx_m, n), reps=20),
        "with_scatter_ms": timing.time_graph(
            lambda: scatter_with(csr_kernel), reps=20),
        "plain_with_scatter_ms": timing.time_graph(
            lambda: scatter_with(csr_plain), reps=20),
        "eager_ms": timing.time_loop(lambda: csr_kernel(idx_m, n), reps=50),
        "plain_eager_ms": timing.time_loop(lambda: csr_plain(idx_m, n),
                                           reps=50),
        "bound_ms": csr_b_ms, "bound_by": csr_b_by,
        "launches_sampling": records["table_index_csr"]["launches_sampling"],
        "launches_per_train_step":
            records["table_index_csr"]["launches_per_train_step"],
        "launches_fit_per_epoch":
            records["table_index_csr"]["launches_fit_per_epoch"]}
    k2b = next(r for r in kernels_json if r["name"] == "table_scatter")
    k2b.update({f"csr_{key}": v for key, v in csr.items()})
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
         f"kernel {csr['ms'] * 1e3:.2f} us (grid path "
         f"{csr['grid_ms'] * 1e3:.2f} us)  plain {csr['plain_ms'] * 1e3:.2f}"
         f" us  bound {csr_b_ms * 1e3:.3f} us ({csr_b_by}); K2b with it "
         f"{csr['with_scatter_ms'] * 1e3:.2f} us, with the plain build "
         f"{csr['plain_with_scatter_ms'] * 1e3:.2f} us (graph); eager loop "
         f"{csr['eager_ms'] * 1e3:.2f} us, plain "
         f"{csr['plain_eager_ms'] * 1e3:.2f} us")
    # K3/K4 and K3b/K4b at every shape a path launches them
    rdf_inputs = {"50x512": (frames.contiguous(), op),
                  "3x512": (frames[-3:].contiguous(), op),
                  "10x1372": (lj_fitted["rdf_frames"], lj_fitted["rdf_op"]),
                  "1x512x800": (frames[-1:].contiguous(), op_infer)}
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
         f"{bf16_run['sample_steps_per_s']:.2f} steps/s against f32 "
         f"{bf16_run['f32_sample_steps_per_s']:.2f} (1000 steps + rdf each); "
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
    line(f"time lj sampling: {lj_sampled['steps_per_s']:.2f} steps/s (N=4000 "
         f"NVE, 950 steps, energy drift {lj_sampled['drift']:.3e})")
    line(f"time lj fit: {lj_fitted['steps_per_s']:.2f} fwd+bwd MD steps/s "
         f"(N=1372, 3 x 49 steps, in {lj_fitted['wall']:.3f} s); replay "
         f"epoch peak memory {lj_fitted['peak']} B, "
         f"{lj_fitted['epoch_peak']} B above the resident")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if against["gather"]:
        gather_ab(torch, _build, gather, time_gather, against["gather"],
                  gather_sets, k, {name: bound_ms(b, 0)[0]
                                   for name, b in gather_bytes.items()}, smi)
    if against["rdf"]:
        rdf_ab(torch, _build, rdf_ops, time_rdf, timing, against["rdf"],
               rdf_inputs, gen, smi)
    if against["pair"]:
        pair_ab(mt, torch, dev, _build, against["pair"], gen, smi)
    line(f"total: {time.perf_counter() - t_start:.3f} s")
    line(f"nvidia-smi: {smi}")
    line(json.dumps({"kernels": kernels_json}))
    line(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
