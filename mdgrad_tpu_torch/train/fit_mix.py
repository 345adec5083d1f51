"""Binary-mixture fitting: learn three partial pair potentials from three
partial RDFs (port of ``mdgrad_tpu/train/fit_mix.py``).

Species are assigned at random (:func:`mix_system`); the ground truth is
three LJ ``PairPotentials`` restricted by ``index_tuple`` to the 11, 12
and 22 pairs (:func:`build_mixture`), and its targets the partial g(r)
of the last frames of a few Nose-Hoover epochs.  The model is three
``PairMLP``s, one a species pair, over a frozen LJ-family soft core on
every pair, trained through the replay adjoint with Adam on the MLPs.
The RDFs are the dense ``'xla'`` ones (``index_tuple``); no kernel of
``csrc/`` runs on this path.

As in the JAX ``build_mixture``, the truth's ``LennardJones(1.0, s)``
takes each entry of ``sigmas`` as its second argument, epsilon; sigma is
1.0.
"""

import os

import numpy as np
import torch

from .. import potentials as pot_zoo, units
from .._device import resolve_device
from ..data.registry import number_density_unit_len
from ..interface import PairPotentials, Stack
from ..md import NoseHooverChain, Simulation
from ..nn import PairMLP
from ..observables import rdf as rdf_obs_cls
from ..system import System
from .optim import FitUpdate


def mix_system(system, type1_composition=0.5, rng=None):
    """Give a random ``type1_composition`` of the atoms species 1 and the
    rest species 2 (``numbers`` 2), all of mass 1; returns (system,
    idx1, idx2)."""
    rng = np.random.default_rng() if rng is None else rng
    n = system.get_number_of_atoms()
    n1 = int(n * type1_composition)
    all_idx = rng.permutation(n)
    idx1, idx2 = np.sort(all_idx[:n1]), np.sort(all_idx[n1:])
    z = system.get_atomic_numbers().copy()
    z[idx2] = 2
    system.numbers = z
    system.masses = np.ones(n)
    return system, idx1, idx2


def build_mixture(size=4, rho=0.845, T=1.2, x=0.5, cutoff=2.5,
                  sigmas=(0.9, 1.0, 1.1), rng=None, device="cuda",
                  dtype=torch.float32):
    """(system, the ground-truth Stack of three species-restricted LJ
    ``PairPotentials``, idx1, idx2): an FCC box of ``size``^3 cells at
    number density ``rho``, velocities at the reduced ``T``."""
    device = resolve_device(device)
    L = number_density_unit_len(rho, 4)
    system = System.from_lattice("fcc", size, L)
    system.set_temperature(T / units.kB, rng=rng)
    system, idx1, idx2 = mix_system(system, x, rng=rng)
    pairs = {
        "pot11": (pot_zoo.LennardJones(1.0, sigmas[0]), (idx1, idx1)),
        "pot12": (pot_zoo.LennardJones(1.0, sigmas[1]), (idx1, idx2)),
        "pot22": (pot_zoo.LennardJones(1.0, sigmas[2]), (idx2, idx2)),
    }
    target = Stack({k: PairPotentials(system, m, cutoff=cutoff,
                                      index_tuple=it, device=device)
                    for k, (m, it) in pairs.items()}).to(dtype)
    return system, target, idx1, idx2


def partial_rdfs(system, idx1, idx2, nbins=100, rdf_range=(0.6, 3.3),
                 device="cuda"):
    """The 11, 12 and 22 soft-histogram RDFs, keyed so."""
    return {k: rdf_obs_cls(system, nbins, rdf_range, index_tuple=it,
                           device=device)
            for k, it in (("11", (idx1, idx1)), ("12", (idx1, idx2)),
                          ("22", (idx2, idx2)))}


def fit_mix(size=3, rho=0.845, T=1.2, x=0.5, n_epochs=3, tau=21, dt=0.005,
            nbins=64, rdf_range=(0.6, 2.5), lr=3e-3, n_target_epochs=4,
            target_steps=40, mlp=None, sigma_prior=0.9, model_path=None,
            log=print, rng=None, device="cuda", dtype=torch.float32):
    """End-to-end mixture fit; returns the losses, the targets, the
    recovered potentials u(r) - u(cutoff) on 200 points from 0.5 to the
    cutoff (also ``model_path/pot{11,12,22}.csv``) and the parameters (the
    model's state_dict).  A non-finite frame ends the fit with objective
    5 (1 - epoch / n_epochs)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0) if rng is None else rng
    cutoff = 2.5
    system, target_stack, idx1, idx2 = build_mixture(
        size, rho, T, x, cutoff, rng=rng, device=device, dtype=dtype)

    # --- ground-truth targets ------------------------------------------
    integ = NoseHooverChain(target_stack, system, T=T / units.kB, Q=50.0,
                            num_chains=5, adjoint=False,
                            topology_update_freq=10, device=device,
                            dtype=dtype)
    sim = Simulation(system, integ)
    robs = partial_rdfs(system, idx1, idx2, nbins, rdf_range, device=device)
    frames = []
    for _ in range(n_target_epochs):
        traj = sim.simulate(steps=target_steps, dt=dt,
                            frequency=target_steps)
        frames.append(traj.q[-1])
    skip = len(frames) // 3
    with torch.no_grad():
        targets = {k: torch.stack([o(f)[2] for f in frames[skip:]]).mean(0)
                   for k, o in robs.items()}

    # --- learnable model ------------------------------------------------
    mlp = mlp or dict(n_gauss=int(cutoff // 0.1), r_start=0.0,
                      r_end=cutoff, n_width=32, n_layers=1,
                      nonlinear="SELU")
    nets = {k: PairMLP(**mlp, device=device) for k in ("11", "12", "22")}
    prior = pot_zoo.LJFamily(epsilon=2.0, sigma=sigma_prior, rep_pow=6,
                             attr_pow=3)
    model = Stack({
        "mlppot11": PairPotentials(system, nets["11"], cutoff=cutoff,
                                   index_tuple=(idx1, idx1), device=device),
        "mlppot12": PairPotentials(system, nets["12"], cutoff=cutoff,
                                   index_tuple=(idx1, idx2), device=device),
        "mlppot22": PairPotentials(system, nets["22"], cutoff=cutoff,
                                   index_tuple=(idx2, idx2), device=device),
        "prior": PairPotentials(system, prior, cutoff=cutoff, device=device),
    }).to(dtype)
    model.models["prior"].requires_grad_(False)
    fit_system = System(system.get_positions(), system.get_cell(),
                        numbers=system.numbers, masses=system.masses)
    fit_system.set_temperature(T / units.kB, rng=rng)
    integ2 = NoseHooverChain(model, fit_system, T=T / units.kB, Q=50.0,
                             num_chains=5, adjoint=True,
                             topology_update_freq=10, device=device,
                             dtype=dtype)
    sim2 = Simulation(fit_system, integ2)
    ode = sim2.epoch_fn(dt, tau)
    ctrl = integ2.default_ctrl()
    update = FitUpdate([p for k in ("11", "12", "22")
                        for p in nets[k].parameters()], lr, grad_clip=None)

    state, aux = sim2.initial_state()
    loss_log = []
    for epoch in range(n_epochs):
        traj, aux_new = ode(state, aux, ctrl)
        fr = traj.q[::5]
        loss = sum(((torch.stack([o(q)[2] for q in fr]).mean(0)
                     - targets[k]) ** 2).mean() for k, o in robs.items())
        loss.backward()
        last = traj._replace(**{k: getattr(traj, k)[-1].detach()
                                for k in traj._fields
                                if torch.is_tensor(getattr(traj, k))})
        if not bool(torch.isfinite(last.q).all()):
            log(f"NaN bailout at epoch {epoch}")
            update.zero_grad()
            return {"objective": 5 - (epoch / n_epochs) * 5,
                    "nan_bailout": True, "loss_log": loss_log}
        state, aux = last, aux_new
        update()
        loss_log.append(loss.item())
        log(f"epoch {epoch} | mixture loss {loss_log[-1]:.6f}")

    # recovered potentials
    like = next(model.parameters())
    r_grid = torch.linspace(0.5, cutoff, 200, dtype=like.dtype,
                            device=like.device)[:, None]
    recovered = {}
    with torch.no_grad():
        u_prior = prior(r_grid).squeeze(-1)
        for k in ("11", "12", "22"):
            u = nets[k](r_grid).squeeze(-1) + u_prior
            recovered[k] = (u - u[-1]).cpu().numpy()
    out = {"loss_log": loss_log,
           "targets": {k: v.cpu().numpy() for k, v in targets.items()},
           "recovered": recovered, "params": model.state_dict(),
           "r_grid": r_grid.squeeze(-1).cpu().numpy(),
           "objective": loss_log[-1] if loss_log else float("nan")}
    if model_path:
        os.makedirs(model_path, exist_ok=True)
        for k, v in recovered.items():
            np.savetxt(os.path.join(model_path, f"pot{k}.csv"),
                       np.vstack([out["r_grid"], v]), delimiter=",")
    return out
