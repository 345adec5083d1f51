"""One sharded training step on n ranks: the port's multi-chip dry run.

The counterpart of the JAX package's ``dryrun_multichip`` (which jits
the step on a virtual n-device CPU mesh when the machine has fewer
chips): :func:`dryrun_multichip` starts ``n_devices`` ranks with
``torch.multiprocessing.spawn``, joined by a ``FileStore`` in a
temporary directory -- NCCL ranks, one card each, by default (fewer
cards than ranks raise), gloo ranks on the CPU with ``device='cpu'`` --
and each runs :func:`make_sharded_fit_step` on the JAX dry run's
configuration: 108-atom FCC LJ (a = 1.679, sigma 0.9, eps 1.0, cutoff
2.4), the mesh factored as dp x sp with sp dividing the atom count,
max(dp, 2) replicas, 3 NHC steps of 0.005, a 32-bin RDF over (0.75,
1.9), lr 1e-4.  The loss and the final positions must be finite.

    python -m mdgrad_tpu_torch.parallel.dryrun 4 -device cpu   # 4 gloo ranks
    python -m mdgrad_tpu_torch.parallel.dryrun 4               # 4 cards
"""

import json
import os
import tempfile

import numpy as np
import torch

from .._device import resolve_device

FCC_CELLS = 3            # 3^3 FCC cells of 4 atoms: 108 atoms


def factor(n_devices, n_atoms):
    """(dp, sp): the largest sp dividing both, dp the rest."""
    sp = next(c for c in range(n_devices, 0, -1)
              if n_devices % c == 0 and n_atoms % c == 0)
    return n_devices // sp, sp


def dryrun_config(device, dtype=torch.float32):
    """(pair model, ShardedMDConfig, system) of the dry run."""
    from .. import potentials, units
    from ..system import System
    from .replica import ShardedMDConfig
    system = System.from_lattice("fcc", FCC_CELLS, 1.679)
    system.set_temperature(1.0 / units.kB, rng=np.random.default_rng(0))
    n = system.get_number_of_atoms()
    cfg = ShardedMDConfig(cell=system.get_cell(), cutoff=2.4,
                          masses=system.get_masses(), dt=0.005, n_steps=3,
                          kT=1.0, Q=np.array([50.0, 50.0 / n, 50.0 / n]),
                          n_dof=3 * n)
    lj = potentials.LennardJones(0.9, 1.0).to(device=device, dtype=dtype)
    return lj, cfg, system


def dryrun_states(system, replicas, device, dtype=torch.float32):
    """The dry run's ``replicas`` states, made from a numpy seed (the same
    on every rank): lattice positions, velocities N(0, 0.5^2)."""
    from ..md.integrators import NVTState
    n = system.get_number_of_atoms()
    rng = np.random.default_rng(0)
    kw = {"dtype": dtype, "device": device}
    return NVTState(
        v=torch.tensor(rng.standard_normal((replicas, n, 3)) * 0.5, **kw),
        q=torch.tensor(np.stack([system.get_positions()] * replicas), **kw),
        pv=torch.zeros(replicas, 3, **kw))


def _rank_main(rank, world, store_path, out_path, backend):
    import torch.distributed as dist
    from .mesh import make_mesh
    from .replica import make_sharded_fit_step
    torch.set_num_threads(1)
    device_type = "cuda" if backend == "nccl" else "cpu"
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        device = torch.device(device_type, rank if backend == "nccl" else 0)
        lj, cfg, system = dryrun_config(device)
        n = system.get_number_of_atoms()
        dp, sp = factor(world, n)
        mesh = make_mesh({"dp": dp, "sp": sp}, device_type=device_type)
        step = make_sharded_fit_step(lj, cfg, mesh, np.ones(32),
                                     rdf_range=(0.75, 1.9), nbins=32,
                                     lr=1e-4)
        replicas = max(dp, 2)
        states = dryrun_states(system, replicas, device)
        loss, finals = step(states, system.get_masses())
        loss = float(loss)
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss}")
        if not bool(torch.isfinite(finals.q).all()):
            raise FloatingPointError("non-finite final positions")
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({"loss": loss, "dp": dp, "sp": sp,
                           "replicas": replicas, "n_atoms": n,
                           "backend": backend,
                           "sigma": lj.sigma.item(),
                           "epsilon": lj.epsilon.item()}, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices, device="cuda"):
    """Run one dp x sp sharded training step on ``n_devices`` ranks (see
    the module docstring); returns rank 0's report: the loss, dp, sp,
    the replica and atom counts, the backend and the updated sigma and
    epsilon.  Raises if any rank fails, and on ``device='cuda'`` when
    the machine has fewer than ``n_devices`` cards."""
    import torch.multiprocessing as mp
    if resolve_device(device).type == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) on the cards needs "
                f"{n_devices} of them, have {torch.cuda.device_count()}; "
                "pass device='cpu' for gloo ranks on the CPU")
        backend = "nccl"
    else:
        backend = "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        mp.spawn(_rank_main, args=(n_devices, os.path.join(tmp, "store"),
                                   out, backend),
                 nprocs=n_devices, join=True)
        with open(out) as f:
            res = json.load(f)
    print(f"dryrun_multichip OK: mesh dp={res['dp']} x sp={res['sp']}, "
          f"{res['replicas']} replicas x {res['n_atoms']} atoms, "
          f"loss={res['loss']:.4f} ({res['backend']})")
    return res


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_devices", type=int, nargs="?", default=4)
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' (NCCL, one card a rank) or 'cpu' (gloo)")
    args = p.parse_args()
    dryrun_multichip(args.n_devices, args.device)
