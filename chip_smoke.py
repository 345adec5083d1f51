#!/usr/bin/env python3
"""Smoke run of mdgrad_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mdgrad_tpu_torch/csrc`` and runs five
phases, printing one line as each ends:

1. build   -- one nvcc process per source, in parallel, and one link into
   one shared library; its wall time.
2. kernels -- each kernel against its plain PyTorch version on the card at
   the shapes of the main paths (sentinel indices included), the SchNet
   force through the kernels against the plain gather path, and the force's
   vector-Jacobian product (its grad-of-grad) likewise.
3. main    -- the water SchNet NVT sampling path at full width: 512 O sites
   on a diamond lattice at 0.99749 g/cm^3, Stack{SchNet(128/128/40, 2 convs,
   cutoff 6.0, (N, K) table), ExcludedVolume prior}, Nose-Hoover chain at
   298 K (Q=50, 5 chains), dt = 0.5 fs, 1000 steps with a frame every 20,
   then the 109-bin RDF over (1.8, 7.5) A on those frames.  Weights come
   from a seeded init.
4. train   -- the water SchNet RDF fit on the same model: first, at tau =
   11, the replay adjoint's parameter gradient against direct backprop;
   then 3 optimizer steps at tau = 52 (51 MD steps, the RDF of frames 0, 20
   and 40, compute_D against the H20_0.997_298K target, the replay adjoint
   into the SchNet parameters, clip_by_global_norm(10), Adam(1.839e-4)),
   each epoch restarting from the last state.
5. times   -- each kernel, its plain version and its library yardstick with
   CUDA events, MD and training steps/s, and the card's name and power
   limit.

Launch counts are zeroed just before phases 3 and 4 and read just after
each.  The line before the last is a JSON object with one record per
kernel; the last line is ``{"ok": true, "device": {...}}``.  Any failed
check raises and the script exits non-zero.  Without a CUDA device it exits
1 and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, f32 outside tensor cores
SEED = 0
TARGET = "H20_0.997_298K"     # the fit's experimental O-O RDF
LR, GRAD_CLIP = 1.839e-4, 10.0


def line(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_graph(torch, fn, reps=100, groups=7):
    """Median device time (ms) of one ``fn()`` replayed from a CUDA graph
    of ``reps`` calls: the launch cost of the host is not in it."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_events(torch, graph.replay, groups) / reps


def time_loop(torch, fn, reps, groups=5):
    """Median time (ms) of one ``fn()`` called back to back, host launch
    cost included (for code that reads the device, e.g. masks)."""
    fn()
    torch.cuda.synchronize()
    return _median_events(torch, lambda: [fn() for _ in range(reps)],
                          groups) / reps


def _median_events(torch, run, groups):
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_errs(got, ref):
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return err, err / max(scale, 1e-30), scale


def build_water(mt, device, gather_mode="auto"):
    import numpy as np
    from mdgrad_tpu_torch import potentials
    from mdgrad_tpu_torch.data.registry import get_unit_len
    L = get_unit_len(0.99749, 18.01528, 8)
    system = mt.System.from_lattice("diamond", 4, L, symbol="O")
    system.masses = np.full(512, 18.01528)
    system.set_temperature(298.0, rng=np.random.default_rng(SEED))
    gnn = mt.SchNet({"n_atom_basis": 128, "n_filters": 128,
                     "n_gaussians": 40, "n_convolutions": 2, "cutoff": 6.0,
                     "compute_dtype": "float32", "gather_mode": gather_mode},
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
        require(c > 0, f"kernel {name} launched in the train phase")
        records.setdefault(name, {})["launches"] = c
        records[name]["launches_per_train_step"] = c / n_epochs
    for name, c in counts["plain_calls"].items():
        require(c == 0, f"plain version of {name} not used in training")
    return {"steps_per_s": steps_per_s, "wall": wall, "peak": peak,
            "fwd_s": fwd}


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np
    import mdgrad_tpu_torch as mt
    from mdgrad_tpu_torch import ops, units
    from mdgrad_tpu_torch.ops import _build, gather, rdf as rdf_ops
    dev = torch.device("cuda", 0)
    line(f"device: {torch.cuda.get_device_name(0)}  torch {torch.__version__}"
         f"  cuda {torch.version.cuda}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_wall = time.perf_counter() - t0
    if _build.build_seconds is not None:
        log = (_build.BUILD_DIR / "build.log").read_text().splitlines()
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

    obs = mt.observables.rdf(system, nbins=109, r_range=(1.8, 7.5),
                             backend="pallas", device=dev)
    op = obs._counts
    frames_test = xyz0 + 0.1 * torch.randn((50, n, 3), device=dev,
                                           generator=gen)
    # K3/K4: f32 sums of ~1e4-1e6 exponentials per bin in another order
    # -> ~1e-6 relative; 1e-4 of the largest bin leaves a wide margin
    for label, x in (("F=1", frames_test[:1]), ("F=50", frames_test)):
        got = rdf_ops._launch(x.contiguous(), op.cell_len, op.mu, op.coeff,
                              op.cutoff)
        ref = rdf_ops.rdf_counts_plain(x, op.cell_len, op.mu, op.coeff,
                                       op.cutoff)
        line(f"  rdf_counts {label}:")
        compare("rdf_counts", got, ref, 1e-4)
    # K3b/K4b: f32 sums of ~1e4-1e6 terms per site in another order; held
    # to 1e-4 of the largest |dxyz|, with a random cotangent
    ct_bins = torch.randn(op.mu.shape[0], device=dev, generator=gen)
    for label, x in (("F=1", frames_test[:1]), ("F=3", frames_test[:3]),
                     ("F=50", frames_test)):
        got = rdf_ops._launch_bwd(x.contiguous(), op.cell_len, op.mu,
                                  op.coeff, op.cutoff, ct_bins)
        ref = rdf_ops.rdf_counts_bwd_plain(x, op.cell_len, op.mu, op.coeff,
                                           op.cutoff, ct_bins)
        line(f"  rdf_counts_bwd {label}:")
        compare("rdf_counts_bwd", got, ref, 1e-4, floor=0.0)

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

    # ---- 4. train ---------------------------------------------------------
    trained = train_phase(mt, torch, dev, records)

    # ---- 5. times ---------------------------------------------------------
    e_real = n_real
    pad_values = torch.cat([values, values.new_zeros(1, f)])
    key = index.key()
    zero_table = torch.zeros(n + 1, f, device=dev)
    xyz_f = frames.contiguous()
    n_frames = xyz_f.shape[0]
    cut_sq = torch.tensor(op.cutoff, dtype=torch.float32) ** 2
    iu = torch.triu_indices(n, n, 1, device=dev)
    L = torch.tensor(op.cell_len, device=dev)

    def pairs_inside(xs):
        """i < j pairs inside the RDF cutoff, summed over the frames."""
        total = 0
        for x in xs:
            d = x[iu[1]] - x[iu[0]]
            d = d - torch.round(d / L) * L
            total += int(((d * d).sum(-1) < cut_sq.to(dev)).sum())
        return total

    pairs_in = pairs_inside(xyz_f)
    n_bins = op.mu.shape[0]
    # the backward at the training shapes: 3 frames of the trajectory
    xyz_t = xyz_f[-3:].contiguous()
    pairs_in_t = pairs_inside(xyz_t)
    ct_t = torch.randn(n_bins, device=dev, generator=gen)
    specs = {
        "gather_mul_reduce": dict(
            source="mdgrad_tpu_torch/csrc/gather.cu",
            replaces="mdgrad_tpu/ops/pallas_gather.py:266",
            kernel=lambda: gather._launch_gather_mul_reduce(
                values, w, index.idx, k),
            plain=lambda: gather.gather_mul_reduce_plain(
                values, w, index.idx, k),
            library=None,
            # w is read only at the real edges; idx at every slot
            bytes=4 * (n * f + e_real * f + n_edges + n * f),
            ops=2 * e_real * f),
        "table_gather": dict(
            source="mdgrad_tpu_torch/csrc/gather.cu",
            replaces="mdgrad_tpu/ops/pallas_gather.py:170",
            kernel=lambda: gather._launch_table_gather(values, index.idx),
            plain=lambda: gather.table_gather_plain(values, index.idx),
            library=lambda: torch.index_select(pad_values, 0, key),
            bytes=4 * (n * f + n_edges + n_edges * f), ops=0),
        "table_scatter": dict(
            source="mdgrad_tpu_torch/csrc/gather.cu",
            replaces="mdgrad_tpu/ops/pallas_gather.py:193",
            kernel=lambda: gather._launch_table_scatter(g_edges, index),
            plain=lambda: gather.table_scatter_plain(g_edges, index.idx, n),
            library=lambda: zero_table.index_add_(0, key, g_edges),
            # the CSR walk reads only the real edges' rows of g and order
            bytes=4 * (e_real * f + e_real + (n + 1) + n * f),
            ops=e_real * f),
        "rdf_counts": dict(
            source="mdgrad_tpu_torch/csrc/rdf.cu",
            replaces="mdgrad_tpu/ops/pallas_rdf.py:194 (counts) + :267 "
                     "(counts.frames)",
            kernel=lambda: rdf_ops._launch(xyz_f, op.cell_len, op.mu,
                                           op.coeff, op.cutoff),
            plain=lambda: rdf_ops.rdf_counts_plain(
                xyz_f, op.cell_len, op.mu, op.coeff, op.cutoff),
            library=None,
            bytes=4 * (n_frames * n * 3 + 2 * n_bins + n_bins),
            # per i<j pair: 3 sub, 3 x (div, rint, fma) min image, 3 for
            # r^2; per (pair inside the cutoff, bin): sub, 2 mul, exp, add
            ops=15 * n_frames * n * (n - 1) // 2 + 5 * pairs_in * n_bins),
        "rdf_counts_bwd": dict(
            source="mdgrad_tpu_torch/csrc/rdf.cu",
            replaces="mdgrad_tpu/ops/pallas_rdf.py:200 (counts_bwd) + :273 "
                     "(counts_frames_bwd)",
            kernel=lambda: rdf_ops._launch_bwd(xyz_t, op.cell_len, op.mu,
                                               op.coeff, op.cutoff, ct_t),
            plain=lambda: rdf_ops.rdf_counts_bwd_plain(
                xyz_t, op.cell_len, op.mu, op.coeff, op.cutoff, ct_t),
            library=None,
            bytes=4 * (2 * 3 * n * 3 + 3 * n_bins),
            # w(r_ij) = w(r_ji): per i<j pair the 15 distance operations; per
            # (i<j pair inside the cutoff, bin): sub, mul, mul, exp, mul,
            # fma; per i<j pair inside: w / r and +-w/r d to both sites (the
            # kernel does the ordered pairs, twice this)
            ops=15 * 3 * n * (n - 1) // 2 + (6 * n_bins + 10) * pairs_in_t),
    }
    kernels_json = []
    for name, s in specs.items():
        rdf = name.startswith("rdf_counts")
        ms = time_graph(torch, s["kernel"], reps=20 if rdf else 100)
        # the plain RDF versions read masks on the host: a loop, no graph
        plain_ms = (time_loop(torch, s["plain"], reps=3) if rdf
                    else time_graph(torch, s["plain"], reps=20))
        lib_ms = (None if s["library"] is None
                  else time_graph(torch, s["library"], reps=100))
        b_ms, b_by = bound_ms(s["bytes"], s["ops"])
        rec = records[name]
        kernels_json.append({
            "name": name, "route": "cuda", "source": s["source"],
            "replaces": s["replaces"], "launches": rec["launches"],
            "launches_per_train_step": rec["launches_per_train_step"],
            "launches_sampling": rec["launches_sampling"],
            "max_abs_err": rec["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        line(f"time {name}: kernel {ms * 1e3:.2f} us  plain "
             f"{plain_ms * 1e3:.2f} us  library "
             f"{'none' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}  "
             f"bound {b_ms * 1e3:.3f} us ({b_by}; {s['bytes']} B, "
             f"{s['ops']} ops)")
    # K2b's CSR inverse is plain torch, rebuilt with each new TableIndex
    # (once per energy on the MD path): its device time, K2b with it, and
    # the CSR build called eagerly back to back (host launches included)
    csr_ms = time_graph(torch, lambda: gather.TableIndex(idx_m, n).csr(),
                        reps=20)
    scatter_csr_ms = time_graph(torch, lambda: gather._launch_table_scatter(
        g_edges, gather.TableIndex(idx_m, n)), reps=20)
    csr_eager_ms = time_loop(torch, lambda: gather.TableIndex(idx_m, n).csr(),
                             reps=50)
    line(f"time table_scatter CSR build: {csr_ms * 1e3:.2f} us (graph), "
         f"{csr_eager_ms * 1e3:.2f} us (eager loop); kernel with the CSR "
         f"build {scatter_csr_ms * 1e3:.2f} us (graph)")
    line(f"time rdf_counts: {n_frames} frames, {pairs_in} pairs inside "
         f"{op.cutoff} A")
    line(f"time rdf_counts_bwd: 3 frames, {pairs_in_t} pairs inside "
         f"{op.cutoff} A")
    line(f"time md: {steps_per_s:.2f} steps/s (main phase wall clock, "
         f"{n_steps} steps + rdf)")
    line(f"time train: {trained['steps_per_s']:.2f} training steps/s (3 x "
         f"51 MD steps, forward and replay adjoint, in "
         f"{trained['wall']:.3f} s); replay epoch peak memory "
         f"{trained['peak']} B")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    line(f"total: {time.perf_counter() - t_start:.3f} s")
    line(f"nvidia-smi: {smi}")
    line(json.dumps({"kernels": kernels_json}))
    line(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
