"""MD logging and trajectory export utilities.

Port of ``mdgrad_tpu/md/utils.py``: multi-frame ``.xyz`` writing and
reading (no ASE), ``save_traj`` and the per-step thermodynamic log
``NeuralMDLogger``.  Positions and velocities may be numpy arrays or
tensors on any device.
"""

import numpy as np
import torch

from ..thermo import kinetic_energy, temperature_kelvin


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


_Z_TO_SYMBOL = {1: "H", 2: "He", 6: "C", 7: "N", 8: "O", 14: "Si",
                18: "Ar", 29: "Cu", 32: "Ge"}


def write_xyz(filename, frames, numbers=None, comment="", append=False):
    """Write (F, N, 3) frames as a multi-frame .xyz file."""
    frames = _np(frames)
    if frames.ndim == 2:
        frames = frames[None]
    n = frames.shape[1]
    if numbers is None:
        numbers = np.ones(n, dtype=int)
    symbols = [_Z_TO_SYMBOL.get(int(z), "X") for z in numbers]
    mode = "a" if append else "w"
    with open(filename, mode) as f:
        for frame in frames:
            f.write(f"{n}\n{comment}\n")
            for s, (x, y, z) in zip(symbols, frame):
                f.write(f"{s} {x:.8f} {y:.8f} {z:.8f}\n")


def read_xyz(filename):
    """Read a (multi-frame) .xyz file -> (frames (F,N,3), symbols)."""
    frames, symbols = [], None
    with open(filename) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        n = int(lines[i].strip())
        block = lines[i + 2:i + 2 + n]
        symbols = [l.split()[0] for l in block]
        frames.append([[float(v) for v in l.split()[1:4]]
                       for l in block])
        i += 2 + n
    return np.asarray(frames), symbols


def save_traj(system, traj, fname, skip=10):
    """Dump every ``skip``-th frame of ``traj`` (F, N, 3)."""
    frames = _np(traj)[::skip]
    write_xyz(fname, frames, numbers=system.get_atomic_numbers())


class NeuralMDLogger:
    """Per-step thermodynamic log.

    Call with (time in fs, velocities, potential energy) each time you
    want a row; rows are kept in memory and optionally streamed to a
    file.  Kinetic energy and temperature are computed in float64 on the
    CPU.
    """

    HEADER = ("Time[fs]", "Etot[eV]", "Epot[eV]", "Ekin[eV]", "T[K]")

    def __init__(self, system, logfile=None, header=True, verbose=False):
        self.system = system
        self.masses = np.asarray(system.get_masses())
        self.dim = system.dim
        self.rows = []
        self.logfile = logfile
        self.verbose = verbose
        if logfile and header:
            with open(logfile, "w") as f:
                f.write(" ".join(f"{h:>12s}" for h in self.HEADER) + "\n")

    def __call__(self, time_fs, velocities, potential_energy):
        v = torch.as_tensor(_np(velocities), dtype=torch.float64)
        ekin = float(kinetic_energy(v, self.masses))
        T = float(temperature_kelvin(v, self.masses, self.dim))
        epot = float(potential_energy)
        row = (time_fs, epot + ekin, epot, ekin, T)
        self.rows.append(row)
        if self.logfile:
            with open(self.logfile, "a") as f:
                f.write(" ".join(f"{v:12.4f}" for v in row) + "\n")
        if self.verbose:
            print(row)
        return row
