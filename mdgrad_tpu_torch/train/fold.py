"""Differentiable polymer folding: train a SchNet so that a straight chain
folds toward a helix (port of ``mdgrad_tpu/train/fold.py``).

The targets are the helix's internal coordinates (bond lengths, angles,
signed dihedrals, :func:`compute_intcoord`) and the distances of its
pairs within ``loss_cutoff`` (:func:`get_dis_list`).  The simulated
chain starts straight, under Stack{``gnn``: a SchNet, ``prior``: harmonic
bonds, ``pair``: an ExcludedVolume(power 10) with the bonded pairs
excluded}; each trained epoch backpropagates the internal-coordinate
losses through the trajectory (the replay adjoint) into the SchNet, whose
parameters alone Adam moves.  The first epoch is simulated and not
trained: the straight chain's dihedrals are degenerate.

On the card the SchNet's aggregation is the K1 kernel, its backward K2a
and K2b with the CSR build (``gather_mode='auto'``), and the force's
grad-of-grad in the replay runs them again.
"""

import numpy as np
import torch

from .. import potentials as pot_zoo, units
from .._device import resolve_device
from ..interface import BondPotentials, GNNPotentials, PairPotentials, Stack
from ..lattice import helix, straight_chain
from ..md import NVE, NoseHooverChain, Simulation
from ..nn import SchNet
from ..system import System
from .optim import FitUpdate


def compute_bond(xyz, bonds):
    """(F, B) lengths of the ``bonds`` (B, 2) in each frame of ``xyz``
    (F, N, 3)."""
    d = xyz[:, bonds[:, 0], :] - xyz[:, bonds[:, 1], :]
    return torch.sqrt((d ** 2).sum(-1))


def compute_intcoord(xyz):
    """(bond lengths, angles, signed dihedrals) of a chain, per frame of
    ``xyz`` (F, N, 3).  The cosines are clipped to +-0.99; the lengths
    and the normals are guarded by 1e-12, so a straight segment's zero
    normal gives a dihedral of 0 with finite gradients."""
    vec = xyz[:, :-1] - xyz[:, 1:]
    u_norm = torch.sqrt((vec ** 2).sum(-1) + 1e-12)
    u_i = vec / u_norm[..., None]
    cos_a = torch.clamp((u_i[:, :-1] * u_i[:, 1:]).sum(-1), -0.99, 0.99)
    a = torch.arccos(cos_a)
    n_unorm = torch.linalg.cross(u_i[:, :-1], u_i[:, 1:], dim=-1)
    n_i = n_unorm / torch.sqrt((n_unorm ** 2).sum(-1) + 1e-12)[..., None]
    cos_d = torch.clamp((n_i[:, :-1] * n_i[:, 1:]).sum(-1), -0.99, 0.99)
    sign = torch.sign((u_i[:, :-2] * n_i[:, 1:]).sum(-1))
    d_i = torch.arccos(cos_d) * sign
    return u_norm, a, d_i


def get_dis_list(xyz, cutoff):
    """(distances (F, P), pairs (P, 2)): every ordered pair (i, j), i != j,
    of the first frame of ``xyz`` (F, N, 3) closer than ``cutoff``, and
    its distance in each frame; in ``xyz``'s dtype, on the host."""
    xyz = torch.as_tensor(xyz).cpu()
    n = xyz.shape[1]
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    sel = ii != jj
    adj = torch.from_numpy(np.stack([ii[sel], jj[sel]], axis=-1))
    d = compute_bond(xyz, adj)
    keep = d[0] < cutoff
    return d[:, keep], adj[keep]


def build_fold(params, rng=None, device="cuda", dtype=torch.float32):
    """The pieces of :func:`train_fold` for ``params`` (its keys): a dict
    of ``system``, ``stack``, ``integrator``, ``sim`` (``wrap=False``,
    ``method=params['method']``) and ``targets`` (bond lengths, angles,
    dihedrals, the pair distances, and the pairs)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0) if rng is None else rng
    n_atoms = params["n_atoms"]
    target_xyz = torch.as_tensor(
        helix(params["n_spiral"], n_atoms, params["a_spiral"],
              params["dz_spiral"])[None], dtype=dtype)
    bond_top = np.stack([np.arange(n_atoms - 1), np.arange(1, n_atoms)],
                        axis=-1)
    dis_targ, adj = get_dis_list(target_xyz, params["loss_cutoff"])
    b_targ, a_targ, d_targ = compute_intcoord(target_xyz)
    bond_len = float(b_targ[0, 0])

    positions, cell = straight_chain(n_atoms, bond_len)
    system = System(positions, cell)
    # params['T'] is in energy units, as the reference's
    T_kelvin = params["T"] / units.kB
    system.set_temperature(T_kelvin, rng=rng)

    gnn = SchNet({"n_atom_basis": params["n_atom_basis"],
                  "n_filters": params["n_filters"],
                  "n_gaussians": params["n_gaussians"],
                  "n_convolutions": params["n_convolutions"],
                  "cutoff": params["cutoff"]})
    # BondPotentials penalizes (r^2 - ro)^2, so ro = bond_len is the
    # reference's own call shape, not a squared length
    stack = Stack({
        "gnn": GNNPotentials(system, gnn, cutoff=params["cutoff"],
                             device=device),
        "prior": BondPotentials(system, bond_top, params["k0"], bond_len,
                                device=device),
        "pair": PairPotentials(system, pot_zoo.ExcludedVolume(
            epsilon=params["epsilon"], sigma=params["sigma"], power=10),
            cutoff=2.5, ex_pairs=bond_top, device=device),
    }).to(dtype)
    if params["method"] in ("NH_verlet", "rk4"):
        integ = NoseHooverChain(stack, system, T=T_kelvin, Q=50.0,
                                num_chains=5, adjoint=True, device=device,
                                dtype=dtype)
    else:
        integ = NVE(stack, system, adjoint=True, device=device, dtype=dtype)
    sim = Simulation(system, integ, wrap=False, method=params["method"])
    targets = tuple(t.to(device) for t in (
        b_targ[0], a_targ[0], d_targ[0], dis_targ, adj))
    return {"system": system, "stack": stack, "integrator": integ,
            "sim": sim, "targets": targets, "target_xyz": target_xyz}


def make_fold_epoch_loss(sim, targets, params):
    """``loss_fn(state, aux, ctrl, backward) -> (loss, (last,
    final_aux))``: one epoch of ``params['tau'] - 1`` steps and the
    weighted MSEs of the bond lengths, angles, dihedrals and pair
    distances of every frame against ``targets``; with ``backward`` the
    loss is backpropagated into ``.grad``.  The returned values are
    detached."""
    ode = sim.epoch_fn(params["dt"], params["tau"])
    b_targ, a_targ, d_targ, dis_targ, adj = targets

    def loss_fn(state, aux, ctrl, backward=True):
        with torch.set_grad_enabled(backward):
            traj, final_aux = ode(state, aux, ctrl)
            b, a, d = compute_intcoord(traj.q)
            dis = compute_bond(traj.q, adj)
            loss = (params["l_b"] * ((b - b_targ) ** 2).mean()
                    + params["l_a"] * ((a - a_targ) ** 2).mean()
                    + params["l_d"] * ((d - d_targ) ** 2).mean()
                    + params["l_dis"] * ((dis - dis_targ) ** 2).mean())
            if backward:
                loss.backward()
        last = traj._replace(**{k: getattr(traj, k)[-1].detach()
                                for k in traj._fields
                                if torch.is_tensor(getattr(traj, k))})
        return loss.detach(), (last, final_aux)

    return loss_fn


def train_fold(params, model_path=None, log=print, rng=None, device="cuda",
               dtype=torch.float32):
    """Fold a chain toward the helix; returns the loss history, the
    parameters (the stack's state_dict), the final frame and the target.

    ``params`` keys follow the reference's demo: n_atoms, n_spiral,
    a_spiral, dz_spiral, loss_cutoff, k0, epsilon, sigma, the SchNet's
    n_atom_basis / n_filters / n_gaussians / n_convolutions / cutoff, T
    (energy units), method ('NH_verlet' | 'verlet' | 'rk4'), dt, tau, lr,
    l_b / l_a / l_d / l_dis and n_epochs.  A non-finite frame ends the fit
    with objective 55.0.  ``model_path`` is accepted and unused, as in
    the JAX ``train_fold``.
    """
    fold = build_fold(params, rng=rng, device=device, dtype=dtype)
    sim, integ, stack = fold["sim"], fold["integrator"], fold["stack"]
    # train the SchNet only; the prior's and the pair's constants stay
    for key in ("prior", "pair"):
        stack.models[key].requires_grad_(False)
    loss_fn = make_fold_epoch_loss(sim, fold["targets"], params)
    update = FitUpdate(stack.models["gnn"].parameters(), params["lr"],
                       grad_clip=None)
    ctrl = integ.default_ctrl()
    state, aux = sim.initial_state()
    loss_log = []
    for epoch in range(params["n_epochs"]):
        if epoch == 0:
            # simulated, not trained: the straight chain's internal
            # coordinates are degenerate (the reference skips it too)
            _, (state, aux) = loss_fn(state, aux, ctrl, backward=False)
            continue
        loss, (last, aux_new) = loss_fn(state, aux, ctrl)
        if not bool(torch.isfinite(last.q).all()):
            log(f"NaN bailout at epoch {epoch}")
            update.zero_grad()
            return {"objective": 55.0, "nan_bailout": True,
                    "loss_log": loss_log}
        state, aux = last, aux_new
        update()
        loss_log.append(float(loss))
        log(f"epoch {epoch} | fold loss {float(loss):.6f}")

    return {"loss_log": loss_log, "params": stack.state_dict(),
            "final_frame": state.q.cpu().numpy(),
            "target": fold["target_xyz"][0].numpy(),
            "objective": loss_log[-1] if loss_log else float("nan")}

