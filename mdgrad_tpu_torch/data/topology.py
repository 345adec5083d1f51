"""Bonded-topology generation: angles, dihedrals, impropers and pairs
from a bond list.

Port of ``mdgrad_tpu/data/topology.py``, numpy only and kept as a copy:
angles by joins of bond pairs, dihedrals over central bonds, impropers at
atoms with three or more bonded neighbours, non-bonded pairs without the
1-2, 1-3 (and 1-4) pairs; bonds from distance thresholds (per species
pair with ``species``), the connected components of the bond graph and
the unwrapping of molecules split by the periodic boundary.
"""

import itertools

import numpy as np


def _adjacency(bonds, n_atoms):
    adj = [[] for _ in range(n_atoms)]
    for i, j in np.asarray(bonds):
        adj[int(i)].append(int(j))
        adj[int(j)].append(int(i))
    return [sorted(set(a)) for a in adj]


def generate_angles(bonds, n_atoms):
    """(i, j, k) with j the apex, i < k."""
    adj = _adjacency(bonds, n_atoms)
    out = []
    for j in range(n_atoms):
        for i, k in itertools.combinations(adj[j], 2):
            out.append((i, j, k))
    return np.asarray(out, dtype=np.int32).reshape(-1, 3)


def generate_dihedrals(bonds, n_atoms):
    """(i, j, k, l) over central bonds (j, k)"""
    adj = _adjacency(bonds, n_atoms)
    out = []
    for j, k in np.asarray(bonds):
        j, k = int(j), int(k)
        for i in adj[j]:
            if i == k:
                continue
            for l in adj[k]:
                if l == j or l == i:
                    continue
                out.append((i, j, k, l))
    return np.asarray(out, dtype=np.int32).reshape(-1, 4)


def generate_impropers(bonds, n_atoms):
    """(center, n1, n2, n3) for atoms with >= 3 bonded neighbors"""
    adj = _adjacency(bonds, n_atoms)
    out = []
    for c in range(n_atoms):
        if len(adj[c]) < 3:
            continue
        for combo in itertools.combinations(adj[c], 3):
            out.append((c,) + combo)
    return np.asarray(out, dtype=np.int32).reshape(-1, 4)


def generate_pairs(bonds, n_atoms, exclude_14=True):
    """Non-bonded pairs: all (i < j) minus 1-2 and 1-3 (and 1-4 when
    ``exclude_14``)."""
    adj = _adjacency(bonds, n_atoms)
    excluded = set()
    for i, j in np.asarray(bonds):
        excluded.add((min(i, j), max(i, j)))
    for i, j, k in generate_angles(bonds, n_atoms):
        excluded.add((min(i, k), max(i, k)))
    if exclude_14:
        for i, j, k, l in generate_dihedrals(bonds, n_atoms):
            excluded.add((min(i, l), max(i, l)))
    out = [(i, j) for i in range(n_atoms) for j in range(i + 1, n_atoms)
           if (i, j) not in excluded]
    return np.asarray(out, dtype=np.int32).reshape(-1, 2)


def generate_topologies(bonds, n_atoms, exclude_14=True):
    """All bonded-topology arrays of one geometry in one dict."""
    return {
        "bonds": np.asarray(bonds, dtype=np.int32).reshape(-1, 2),
        "angles": generate_angles(bonds, n_atoms),
        "dihedrals": generate_dihedrals(bonds, n_atoms),
        "impropers": generate_impropers(bonds, n_atoms),
        "pairs": generate_pairs(bonds, n_atoms, exclude_14),
    }


# Per-species-pair covalent bond-length thresholds in Angstrom, keyed by
# (Z_min, Z_max).  Entries of 0.0 forbid bonding (e.g. Li+ counter-ions).
COVALENT_CUTOFFS_Z = {
    (1, 1): 1.00, (1, 3): 1.30, (1, 5): 1.50, (1, 6): 1.30, (1, 7): 1.30,
    (1, 8): 1.30, (1, 9): 1.30, (1, 11): 1.65, (1, 12): 1.40, (1, 14): 1.65,
    (1, 16): 1.50, (1, 17): 1.60, (1, 35): 1.60,
    (3, 6): 0.0, (3, 7): 0.0, (3, 8): 0.0, (3, 9): 0.0, (3, 12): 0.0,
    (5, 6): 1.70, (5, 7): 1.70, (5, 8): 1.70, (5, 9): 1.70, (5, 11): 1.80,
    (5, 12): 1.80, (5, 17): 2.10, (5, 35): 2.10,
    (6, 6): 1.70, (6, 7): 1.80, (6, 8): 1.70, (6, 9): 1.65, (6, 11): 1.80,
    (6, 12): 1.70, (6, 14): 2.10, (6, 16): 2.20,
    (7, 8): 1.55, (7, 11): 1.70, (7, 16): 2.00,
    (8, 8): 1.70, (8, 9): 1.50, (8, 11): 1.70, (8, 12): 1.35, (8, 14): 1.85,
    (8, 16): 2.00, (8, 17): 1.80, (8, 35): 1.70,
    (9, 12): 1.35,
}


def pair_cutoff_matrix(species, default=1.8):
    """(N, N) per-pair bond thresholds from :data:`COVALENT_CUTOFFS_Z`;
    pairs absent from the table fall back to ``default``."""
    z = np.asarray(species, dtype=int)
    n = len(z)
    thr = np.full((n, n), float(default))
    for (za, zb), c in COVALENT_CUTOFFS_Z.items():
        ma, mb = z == za, z == zb
        thr[np.ix_(ma, mb)] = c
        thr[np.ix_(mb, ma)] = c
    return thr


def bonds_from_distances(xyz, cutoff=1.8, species=None):
    """Infer bonds by distance thresholds.  With ``species`` (atomic
    numbers), per-pair covalent tables are used; otherwise one scalar
    ``cutoff`` covers the coarse-grained in-repo systems."""
    xyz = np.asarray(xyz)
    d = np.linalg.norm(xyz[:, None] - xyz[None, :], axis=-1)
    thr = cutoff if species is None else pair_cutoff_matrix(
        species, default=cutoff)
    iu = np.triu(np.ones_like(d, dtype=bool), k=1)
    i, j = np.nonzero(iu & (d < thr))
    return np.stack([i, j], axis=-1).astype(np.int32)


def molecular_subgraphs(bonds, n_atoms):
    """Connected components of the bond graph."""
    adj = _adjacency(bonds, n_atoms)
    seen = np.zeros(n_atoms, dtype=bool)
    comps = []
    for start in range(n_atoms):
        if seen[start]:
            continue
        stack, comp = [start], []
        seen[start] = True
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in adj[u]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
        comps.append(sorted(comp))
    return comps


def reconstruct_atoms(xyz, subgraphs, cell_len):
    """Unwrap molecules split across periodic boundaries: make every atom
    contiguous with its subgraph anchor."""
    xyz = np.array(xyz, dtype=np.float64)
    cell_len = np.asarray(cell_len)
    for comp in subgraphs:
        anchor = xyz[comp[0]]
        for a in comp[1:]:
            d = xyz[a] - anchor
            xyz[a] -= np.round(d / cell_len) * cell_len
    return xyz
