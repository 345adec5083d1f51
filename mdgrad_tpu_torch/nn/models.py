"""GNN force fields beyond plain SchNet.

Port of ``mdgrad_tpu/nn/models.py``:

* :class:`GraphAttention`: self-attention-weighted message passing;
* :class:`SchNetEdgeUpdate`: an edge state from the two end nodes'
  features, e'_ij = MLP(cat(r_i, r_j));
* :class:`HybridGraphConv`: two ``SchNetConv`` stacks, one over the
  system's pair list and one over the molecular (bonded) list, sharing
  one embedding, read out from the sum of both node states, with an
  optional learnable excluded-volume term ``V_ex``;
* :class:`GraphConvIntegration`: SchNet with per-atom ``aggr_wgt``, the
  lambda of thermodynamic integration (``md/ti.py``).

All take padded (P, 2) edge lists whose padded rows hold N, and a mask;
the sums over edges are ``index_add`` into a dropped row N, where the
JAX package uses ``segment_sum``.  Weights are drawn from
``torch.Generator().manual_seed(seed)``; ``nn/convert.py`` carries the
JAX package's flax trees across.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import pad_rows, segment_sum, shifted_softplus
from .schnet import SchNet, SchNetConv, _dense, _edge_aggregate


class GraphAttention(nn.Module):
    """Self-attention pooling layer; ``weight`` (1, 2 n_atom_basis) drawn
    uniformly from [0, 1), as flax's ``uniform(1.0)``."""

    def __init__(self, n_atom_basis, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.weight = nn.Parameter(torch.rand(1, 2 * n_atom_basis,
                                              generator=gen))

    def forward(self, r, idx, mask, n_atoms):
        i, j = idx[:, 0].long(), idx[:, 1].long()
        ext = pad_rows(r)
        ri, rj = ext[i], ext[j]
        m = mask.to(r.dtype)

        def score(a, b):
            return torch.exp(F.leaky_relu(torch.cat([a, b], -1)
                                          * self.weight).sum(-1))

        w_ij = score(ri, rj) * m
        w_ji = score(rj, ri) * m
        w_ii = score(r, r)
        norm = (segment_sum(w_ij, i, n_atoms)
                + segment_sum(w_ji, j, n_atoms) + w_ii)
        ext_norm = torch.cat([norm, norm.new_ones(1)])
        a_ij = w_ij / ext_norm[i]
        a_ji = w_ji / ext_norm[j]
        out = r * (w_ii / norm)[:, None]
        out = out + segment_sum(ri * a_ij[:, None], j, n_atoms)
        return out + segment_sum(rj * a_ji[:, None], i, n_atoms)


class SchNetEdgeUpdate(nn.Module):
    """e'_ij = Dense(1)(relu(Dense(relu(Dense(cat(r_i, r_j)))))), zero on
    padded edges; its layers are the flax ``Dense_0 .. Dense_2``."""

    def __init__(self, n_atom_basis, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dense = nn.ModuleList([
            _dense(2 * n_atom_basis, n_atom_basis, gen),
            _dense(n_atom_basis, n_atom_basis, gen),
            _dense(n_atom_basis, 1, gen)])

    def forward(self, r, idx, mask):
        ext = pad_rows(r)
        x = torch.cat([ext[idx[:, 0].long()], ext[idx[:, 1].long()]], -1)
        x = F.relu(self.dense[0](x))
        x = F.relu(self.dense[1](x))
        e = self.dense[2](x)
        return e * mask[:, None].to(e.dtype)


class HybridGraphConv(nn.Module):
    """Dual-graph SchNet; ``modelparams`` is the JAX package's dict
    (n_atom_basis, n_filters, n_gaussians, mol_n_convolutions,
    mol_cutoff, sys_n_convolutions, sys_cutoff, V_ex_power, V_ex_sigma,
    use_v_ex, trainable_gauss).

    ``V_ex`` adds sum over system pairs of (sigma / r)^power to the first
    atom's energy.  The JAX package raises a padded row's r = 1e-10 to the
    power, inf in float32, and multiplies it by the zero mask: NaN in the
    dropped row, and a NaN gradient in sigma whenever the list is padded.
    Here a padded row's distance is 1 before the power (the same energy
    and forces, a finite gradient in sigma).
    """

    def __init__(self, modelparams, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        f = modelparams["n_atom_basis"]
        self.embedding = nn.Embedding(100, f)
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, f ** -0.5, generator=gen)

        def convs(n, cutoff):
            return nn.ModuleList([
                SchNetConv(f, modelparams["n_filters"],
                           modelparams["n_gaussians"], cutoff, gen,
                           modelparams.get("trainable_gauss", False))
                for _ in range(n)])

        self.sys_convs = convs(modelparams["sys_n_convolutions"],
                               modelparams["sys_cutoff"])
        self.mol_convs = convs(modelparams["mol_n_convolutions"],
                               modelparams["mol_cutoff"])
        self.d0 = _dense(f, f // 2, gen)
        self.d1 = _dense(f // 2, 1, gen)
        self.V_ex_power = modelparams.get("V_ex_power", 10)
        self.use_v_ex = modelparams.get("use_v_ex", False)
        if self.use_v_ex:
            self.v_ex_sigma = nn.Parameter(torch.tensor(
                float(modelparams.get("V_ex_sigma", 1.0))))

    def atomwise_energy(self, z, xyz, sys_idx, sys_off, sys_mask, mol_idx,
                        mol_mask):
        n = z.shape[0]
        ext = pad_rows(xyz)

        def edge_len(idx, off):
            d = ext[idx[:, 0].long()] - ext[idx[:, 1].long()] - off
            return torch.sqrt((d ** 2).sum(-1) + 1e-20)[:, None]

        r0 = self.embedding(z.long())
        e_sys = edge_len(sys_idx, sys_off)
        agg = _edge_aggregate(sys_idx, n, False)
        r_sys = r0
        for conv in self.sys_convs:
            r_sys = r_sys + conv(r_sys, e_sys, sys_mask, agg)
        e_mol = edge_len(mol_idx, 0.0)
        agg = _edge_aggregate(mol_idx, n, False)
        r_mol = r0
        for conv in self.mol_convs:
            r_mol = r_mol + conv(r_mol, e_mol, mol_mask, agg)
        energy = self.d1(shifted_softplus(self.d0(r_sys + r_mol))
                         ).squeeze(-1)
        if self.use_v_ex:
            dist = torch.where(sys_mask, e_sys.squeeze(-1),
                               torch.ones_like(e_sys[:, 0]))
            pot = (self.v_ex_sigma / dist) ** self.V_ex_power \
                * sys_mask.to(dist.dtype)
            energy = energy + segment_sum(pot, sys_idx[:, 0].long(), n)
        return energy

    def energy(self, z, xyz, sys_idx, sys_off, sys_mask, mol_idx, mol_mask):
        return self.atomwise_energy(z, xyz, sys_idx, sys_off, sys_mask,
                                    mol_idx, mol_mask).sum()


class GraphConvIntegration(SchNet):
    """SchNet whose messages are scaled by per-atom ``aggr_wgt``, the
    lambda coupling of thermodynamic integration: ``energy(...,
    aggr_wgt=w)``, ``w`` interpolating between the end states."""
