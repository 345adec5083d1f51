"""The supervised force-matching workload's pieces, shared by
``scripts/run_supervised_torch.py`` (which runs it) and
``scripts/profile_supervised_torch.py`` (which profiles its loops).

``scripts/run_supervised.py``'s flags and defaults (:func:`parse_args`,
plus ``-device`` and ``-seed``), the system, the labelled frames of the
ground-truth LJ fluid (:func:`make_labels`, with minimum-image pair lists
from :func:`pbc_pairs`), the loaders, the SchNet's hyperparameters and
the ``Trainer``.
"""

import argparse

import numpy as np

EPOCH_STEPS = 120        # MD steps a simulate() call, labels and validation


def pbc_pairs(xyz, cell_len, cutoff):
    """Min-image pair list for a diagonal cell: (P,2) int32 indices and
    (P,3) real-space offsets such that edge = xyz[i]-xyz[j]-offset."""
    disp = xyz[:, None] - xyz[None, :]
    shift = np.round(disp / cell_len)
    off = shift * cell_len
    dis = np.linalg.norm(disp - off, axis=-1)
    n = len(xyz)
    iu = np.triu(np.ones((n, n), dtype=bool), k=1)
    i, j = np.nonzero(iu & (dis < cutoff))
    return (np.stack([i, j], axis=-1).astype(np.int32),
            off[i, j].astype(np.float32))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-logdir", type=str, default="outputs/supervised")
    p.add_argument("-data", type=str, default="lj_0.845_1.2")
    p.add_argument("-size", type=int, default=3)
    p.add_argument("-cutoff", type=float, default=2.5)
    p.add_argument("-dt", type=float, default=0.005)
    p.add_argument("-burnin", type=int, default=20,
                   help="equilibration epochs (discarded)")
    p.add_argument("-n_frames", type=int, default=400)
    p.add_argument("-frame_stride", type=int, default=20,
                   help="MD steps between kept frames (decorrelation)")
    p.add_argument("-batch_size", type=int, default=16)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-max_epochs", type=int, default=150)
    p.add_argument("-patience", type=int, default=30)
    p.add_argument("-n_atom_basis", type=int, default=64)
    p.add_argument("-n_filters", type=int, default=64)
    p.add_argument("-n_convolutions", type=int, default=2)
    p.add_argument("-val_sim", type=int, default=12,
                   help="validation MD epochs (120 steps each)")
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    p.add_argument("-seed", type=int, default=0,
                   help="seed of the SchNet's initial weights")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)
    if args.dry_run:
        args.n_frames, args.burnin, args.max_epochs = 24, 2, 4
        args.val_sim, args.frame_stride = 4, 5
    return args


def sync(device):
    """Wait for ``device`` when it is a card."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_system(args):
    """(registry entry, System, cell length, T in Kelvin) of ``-data`` at
    ``-size``."""
    from mdgrad_tpu_torch.data.registry import pair_data_dict
    from mdgrad_tpu_torch.train.fit_rdf import get_system, registry_T_kelvin
    entry = pair_data_dict[args.data]
    system = get_system(args.data, args.size, pair_data_dict,
                        rng=np.random.default_rng(0))
    cell = np.asarray(system.get_cell())
    cell_len = float(cell[0, 0] if cell.ndim == 2 else cell[0])
    return entry, system, cell_len, registry_T_kelvin(entry)


def make_labels(system, entry, cell_len, T, args, device):
    """The ground-truth LJ (dense ``PairPotentials``), its Nose-Hoover
    ``Simulation`` after ``-burnin`` epochs, and ``-n_frames`` frames, one
    every ``-frame_stride`` steps, wrapped into the box and labelled by
    autograd: ``(pot, sim, props)``."""
    import torch
    from mdgrad_tpu_torch.interface import PairPotentials
    from mdgrad_tpu_torch.md import NoseHooverChain, Simulation
    from mdgrad_tpu_torch.train.fit_rdf_pair import resolve_target_pot
    pot = PairPotentials(system, resolve_target_pot(entry["target_pot"]),
                         cutoff=args.cutoff, device=device)
    sim = Simulation(system, NoseHooverChain(pot, system, T=T, Q=50.0,
                                             num_chains=5, adjoint=False,
                                             device=device))

    def label(q):
        x = torch.as_tensor(q, device=device).requires_grad_(True)
        u = pot.energy(x, pot.aux_init(x))
        (g,) = torch.autograd.grad(u, x)
        return u.item(), g.cpu().numpy()

    for _ in range(args.burnin):
        sim.simulate(EPOCH_STEPS, dt=args.dt, frequency=EPOCH_STEPS)

    z = np.asarray(system.get_atomic_numbers(), dtype=np.float32)
    props = {"nxyz": [], "energy": [], "energy_grad": [],
             "nbr_list": [], "offsets": []}
    while len(props["nxyz"]) < args.n_frames:
        traj = sim.simulate(EPOCH_STEPS, dt=args.dt, frequency=EPOCH_STEPS)
        frames = traj.q.cpu().numpy()[::args.frame_stride]
        for q in frames:
            if len(props["nxyz"]) >= args.n_frames:
                break
            q = q - cell_len * np.floor(q / cell_len)  # wrap into box
            u, g = label(q)
            nbrs, offs = pbc_pairs(q, cell_len, args.cutoff)
            props["nxyz"].append(np.concatenate(
                [z[:, None], q.astype(np.float32)], axis=1))
            props["energy"].append(np.float32(u))
            props["energy_grad"].append(np.asarray(g, dtype=np.float32))
            props["nbr_list"].append(nbrs)
            props["offsets"].append(offs)
    return pot, sim, props


def make_loaders(ds, args):
    """Split ``ds`` 70/15/15 and shift every energy by the training
    split's mean: ``(train, val, test loaders, the shift)``."""
    from mdgrad_tpu_torch.data.dataset import split_train_validation_test
    from mdgrad_tpu_torch.data.loader import DataLoader
    train, val, test = split_train_validation_test(ds, 0.15, 0.15, seed=1)
    # forces do not see the energy origin and the energy weight is small,
    # so train against labels shifted by the training split's mean; a
    # prediction in use is pred + e_shift
    e_shift = float(np.mean([float(e) for e in train.props["energy"]]))
    for subset in (train, val, test):
        subset.props["energy"] = [np.float32(float(e) - e_shift)
                                  for e in subset.props["energy"]]
    return (DataLoader(train, batch_size=args.batch_size, seed=1),
            DataLoader(val, batch_size=args.batch_size, shuffle=False),
            DataLoader(test, batch_size=args.batch_size, shuffle=False),
            e_shift)


def model_params(args):
    """The SchNet's hyperparameters, as ``run_supervised.py`` sets them
    (``int(cutoff // 0.1)`` Gaussians: 24 at cutoff 2.5)."""
    return {"n_atom_basis": args.n_atom_basis,
            "n_filters": args.n_filters,
            "n_gaussians": int(args.cutoff // 0.1),
            "n_convolutions": args.n_convolutions,
            "cutoff": args.cutoff}


def make_trainer(model, train_loader, val_loader, args, log=print):
    """The workload's ``Trainer``: energy weight 0.01, forces 1."""
    from mdgrad_tpu_torch.train.builders import get_trainer
    return get_trainer(model, train_loader, val_loader, args.logdir,
                       lr=args.lr,
                       loss_coef={"energy": 0.01, "energy_grad": 1.0},
                       max_epochs=args.max_epochs, patience=args.patience,
                       log=log)
