"""AuTopology: classical force-field terms with GNN-predicted parameters.

Port of ``mdgrad_tpu/nn/autopology.py``.  A ``ParameterPredictor`` (a
tanh MLP; when not trainable, constant zeros and no parameters) maps
atomic convolution features to per-term parameters, and the term nets
evaluate classical energies on explicit topologies:

* ``BondNet``: harmonic / morse / cubic / quartic in the bond length,
  the harmonic with priors r0 ~ sqrt(1.5)^2 and k ~ 100;
* ``AngleNet``: harmonic / cubic / quartic in the clipped angle, theta0
  prior 109.5 degrees, k prior 10;
* ``DihedralNet``: the OPLS cosine series / multiharmonic in cos(phi);
* ``ImproperNet``: harmonic in phi;
* ``PairNet``: LJ with geometric-mean mixing, sigma = 4 + 10 s^2,
  epsilon = 0.1 e^2;

over the bonded-graph convolutions ``_SingleNodeConv`` /
``_DoubleNodeConv``.  Topologies come padded with masks
(:meth:`AuTopology.prepare_topologies`); one molecule per call.

Submodule names follow the flax tree so that ``nn/convert.py`` maps it
key for key: ``embedding`` (``Embed_0``), ``convs.i``
(``_SingleNodeConv_i`` / ``_DoubleNodeConv_i``), ``nets[<key>_<top>]``
and ``offsets[<key>_offset]``; inside a net each predictor under its flax
name (``r0_harmonic``, ``k_harmonic``, ``nonlinear``, ``OPLS``, ...), and
inside a predictor ``dense.k`` (``Dense_k``).
"""

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from .layers import pad_rows, segment_sum
from .schnet import _dense


class ParameterPredictor(nn.Module):
    """tanh MLP ``n_in -> L_hidden... -> L_out``; not ``trainable``:
    constant zeros."""

    def __init__(self, n_in, L_hidden, L_out, trainable, generator):
        super().__init__()
        self.L_out = L_out
        self.trainable = trainable
        widths = [n_in, *L_hidden, L_out] if trainable else []
        self.dense = nn.ModuleList([_dense(a, b, generator) for a, b
                                    in zip(widths[:-1], widths[1:])])

    def forward(self, x):
        if not self.trainable:
            return x.new_zeros(x.shape[:-1] + (self.L_out,))
        for layer in self.dense[:-1]:
            x = torch.tanh(layer(x))
        return self.dense[-1](x)


class _TermNet(nn.Module):
    """A term net's one-output predictors, by name, each from ``n_in``
    features."""

    def __init__(self, names, n_in, L_hidden, trainable, generator):
        super().__init__()
        self.pp = nn.ModuleDict({
            name: ParameterPredictor(n_in, L_hidden, 1, trainable, generator)
            for name in names})


_BOND_PP = {"harmonic": ("r0_harmonic", "k_harmonic"),
            "morse": ("r0_morse", "a_morse", "De_morse"),
            "cubic": ("r0_cubic", "k_cubic"),
            "quartic": ("r0_quartic", "k_quartic")}
_ANGLE_PP = {"harmonic": ("theta0_harmonic", "k_harmonic"),
             "cubic": ("theta0_cubic", "k_cubic"),
             "quartic": ("theta0_quartic", "k_quartic")}


class BondNet(_TermNet):
    def __init__(self, Fr, terms, L_hidden, trainable, generator):
        super().__init__([n for t in _BOND_PP if t in terms
                          for n in _BOND_PP[t]], Fr, L_hidden, trainable,
                         generator)
        self.terms = tuple(terms)

    def forward(self, r, xyz, bonds, mask):
        bonds = bonds.long()
        ext_x = pad_rows(xyz)
        d = ext_x[bonds[:, 0]] - ext_x[bonds[:, 1]]
        D = torch.sqrt((d ** 2).sum(-1) + 1e-12)[:, None]
        x = pad_rows(r)[bonds].sum(1)
        pp = {name: net(x) for name, net in self.pp.items()}
        E = 0.0
        if "harmonic" in self.terms:
            r0 = (1.5 ** 0.5 + 0.1 * pp["r0_harmonic"]) ** 2
            k = (100 ** 0.5 + pp["k_harmonic"]) ** 2
            E = E + (k / 2) * (D - r0) ** 2
        if "morse" in self.terms:
            r0, a, De = (pp[n] ** 2 for n in _BOND_PP["morse"])
            E = E + De * (1 - torch.exp(-a * (D - r0))) ** 2
        if "cubic" in self.terms:
            r0, k = (pp[n] ** 2 for n in _BOND_PP["cubic"])
            E = E + (k / 2) * (D - r0) ** 3
        if "quartic" in self.terms:
            r0, k = (pp[n] ** 2 for n in _BOND_PP["quartic"])
            E = E + (k / 2) * (D - r0) ** 4
        return (E.squeeze(-1) * mask).sum()


class AngleNet(_TermNet):
    def __init__(self, Fr, terms, L_hidden, trainable, generator):
        super().__init__([n for t in _ANGLE_PP if t in terms
                          for n in _ANGLE_PP[t]], 2 * Fr, L_hidden,
                         trainable, generator)
        self.terms = tuple(terms)

    def forward(self, r, xyz, angles, mask):
        angles = angles.long()
        ext_x = pad_rows(xyz)
        v1 = ext_x[angles[:, 0]] - ext_x[angles[:, 1]]
        v2 = ext_x[angles[:, 2]] - ext_x[angles[:, 1]]
        dot = (v1 * v2).sum(-1)
        norm = torch.sqrt((v1 ** 2).sum(-1) * (v2 ** 2).sum(-1) + 1e-12)
        cos = (dot / norm) / 1.000001
        theta = torch.arccos(torch.clamp(cos, -0.999999, 0.999999))[:, None]
        ext_r = pad_rows(r)
        x = torch.cat([ext_r[angles[:, [0, 2]]].sum(1), ext_r[angles[:, 1]]],
                      -1)
        pp = {name: net(x) for name, net in self.pp.items()}
        E = 0.0
        if "harmonic" in self.terms:
            th0 = ((109.5 * np.pi / 180) ** 0.5
                   + pp["theta0_harmonic"]) ** 2
            k = (10 ** 0.5 + pp["k_harmonic"]) ** 2
            E = E + (k / 2) * (theta - th0) ** 2
        if "cubic" in self.terms:
            th0, k = (pp[n] ** 2 for n in _ANGLE_PP["cubic"])
            E = E + (k / 2) * (theta - th0) ** 3
        if "quartic" in self.terms:
            th0, k = (pp[n] ** 2 for n in _ANGLE_PP["quartic"])
            E = E + (k / 2) * (theta - th0) ** 4
        return (E.squeeze(-1) * mask).sum()


def _dihedral_phi(xyz, quads):
    """(P, 1) cos(phi), clipped, of the (i, j, k, l) quadruples."""
    ext_x = pad_rows(xyz)
    vec1 = ext_x[quads[:, 0]] - ext_x[quads[:, 1]]
    vec2 = ext_x[quads[:, 2]] - ext_x[quads[:, 1]]
    vec3 = ext_x[quads[:, 1]] - ext_x[quads[:, 2]]
    vec4 = ext_x[quads[:, 3]] - ext_x[quads[:, 2]]
    c1 = torch.linalg.cross(vec1, vec2, dim=-1)
    c2 = torch.linalg.cross(vec3, vec4, dim=-1)
    norm = torch.sqrt((c1 ** 2).sum(-1) * (c2 ** 2).sum(-1) + 1e-12)
    cos_phi = ((c1 * c2).sum(-1) / norm) / 1.000001
    return torch.clamp(cos_phi, -0.999999, 0.999999)[:, None]


class DihedralNet(_TermNet):
    def __init__(self, Fr, terms, L_hidden, trainable, generator):
        super().__init__([], 0, L_hidden, trainable, generator)
        h = L_hidden[-1]
        self.pp["nonlinear"] = ParameterPredictor(2 * Fr, L_hidden, h,
                                                  trainable, generator)
        for name, n_out in (("multiharmonic", 5), ("OPLS", 4)):
            if name in terms:
                self.pp[name] = ParameterPredictor(h, L_hidden, n_out,
                                                   trainable, generator)
        self.terms = tuple(terms)

    def forward(self, r, xyz, dihedrals, mask):
        dihedrals = dihedrals.long()
        cos_phi = _dihedral_phi(xyz, dihedrals)
        ext_r = pad_rows(r)
        nonlinear = self.pp["nonlinear"]
        x = (nonlinear(torch.cat([ext_r[dihedrals[:, 1]],
                                  ext_r[dihedrals[:, 0]]], -1))
             + nonlinear(torch.cat([ext_r[dihedrals[:, 2]],
                                    ext_r[dihedrals[:, 3]]], -1)))
        E = 0.0
        if "multiharmonic" in self.terms:
            A = self.pp["multiharmonic"](x)
            for m in range(5):
                E = E + A[:, m:m + 1] * cos_phi ** m
        if "OPLS" in self.terms:
            V = self.pp["OPLS"](x)
            phi = torch.arccos(cos_phi)
            for m in range(4):
                E = E + (V[:, m:m + 1] / 2) * (
                    1 + ((-1) ** m) * torch.cos((m + 1) * phi))
        return (E.squeeze(-1) * mask).sum()


class ImproperNet(_TermNet):
    def __init__(self, Fr, terms, L_hidden, trainable, generator):
        super().__init__([], 0, L_hidden, trainable, generator)
        h = L_hidden[-1]
        self.pp["nonlinear"] = ParameterPredictor(2 * Fr, L_hidden, h,
                                                  trainable, generator)
        if "harmonic" in terms:
            self.pp["k_harmonic"] = ParameterPredictor(
                h, L_hidden, 1, trainable, generator)
        self.terms = tuple(terms)

    def forward(self, r, xyz, impropers, mask):
        impropers = impropers.long()
        phi = torch.arccos(_dihedral_phi(xyz, impropers))
        ext_r = pad_rows(r)
        nonlinear = self.pp["nonlinear"]
        x = sum(nonlinear(torch.cat([ext_r[impropers[:, 0]],
                                     ext_r[impropers[:, j]]], -1))
                for j in (1, 2, 3))
        E = 0.0
        if "harmonic" in self.terms:
            k = self.pp["k_harmonic"](x) ** 2
            E = E + (k / 2) * phi ** 2
        return (E.squeeze(-1) * mask).sum()


class PairNet(_TermNet):
    """LJ with geometric mixing; padded pairs gather a sentinel position
    1e3 away, sigma 1 and epsilon 0."""

    def __init__(self, Fr, terms, L_hidden, trainable, generator):
        super().__init__(["sigma", "epsilon"] if "LJ" in terms else [], Fr,
                         L_hidden, trainable, generator)
        self.terms = tuple(terms)

    def forward(self, r, xyz, pairs, mask):
        pairs = pairs.long()
        ext_x = torch.cat([xyz, torch.zeros_like(xyz[:1]) + 1e3])
        d = ext_x[pairs[:, 0]] - ext_x[pairs[:, 1]]
        inv_d = 1.0 / torch.sqrt((d ** 2).sum(-1) + 1e-12)[:, None]
        E = 0.0
        if "LJ" in self.terms:
            sigma = 4.0 + 10 * self.pp["sigma"](r) ** 2
            eps = 0.1 * self.pp["epsilon"](r) ** 2
            ext_s = pad_rows(sigma, 1.0)
            ext_e = pad_rows(eps)
            s_mix = torch.sqrt(ext_s[pairs].prod(1))
            e_mix = torch.sqrt(ext_e[pairs].prod(1))
            x = s_mix * inv_d
            E = E + 4 * e_mix * (x ** 12 - x ** 6)
        return (E.squeeze(-1) * mask).sum()


TOPOLOGY_NETS = {"bond": BondNet, "angle": AngleNet,
                 "dihedral": DihedralNet, "improper": ImproperNet,
                 "pair": PairNet}


class _SingleNodeConv(nn.Module):
    """Bonded-graph convolution: the sum of the bonded neighbours'
    features, then tanh(Dense)."""

    def __init__(self, width, generator, n_in=None):
        super().__init__()
        self.dense = _dense(n_in or width, width, generator)

    def _bonded(self, r, bonds, mask):
        ext = pad_rows(r)
        m = mask[:, None].to(r.dtype)
        n = r.shape[0]
        b0, b1 = bonds[:, 0].long(), bonds[:, 1].long()
        return (segment_sum(ext[b0] * m, b1, n)
                + segment_sum(ext[b1] * m, b0, n)), ext, m, b0, b1

    def forward(self, r, bonds, mask):
        agg = self._bonded(r, bonds, mask)[0]
        return torch.tanh(self.dense(agg))


class _DoubleNodeConv(_SingleNodeConv):
    """The bonded sum beside each atom's own bonds' sum, concatenated,
    then tanh(Dense)."""

    def __init__(self, width, generator):
        super().__init__(width, generator, n_in=2 * width)

    def forward(self, r, bonds, mask):
        bonded, ext, m, b0, b1 = self._bonded(r, bonds, mask)
        n = r.shape[0]
        self_sum = (segment_sum(ext[b0] * m, b0, n)
                    + segment_sum(ext[b1] * m, b1, n))
        return torch.tanh(self.dense(torch.cat([bonded, self_sum], -1)))


_TERM_DEFAULTS = {"bond": ("morse",), "angle": ("harmonic",),
                  "dihedral": ("OPLS",), "improper": ("harmonic",),
                  "pair": ("LJ",)}
_TOPOLOGY_KEYS = {"bonds": "bonds", "angles": "angle",
                  "dihedrals": "dihedral", "impropers": "improper",
                  "pairs": "pair"}


class AuTopology(nn.Module):
    """AuTopology model; ``modelparams`` is the JAX package's dict (Fr,
    Lh, <top>_terms for each topology used, n_convolutions, conv_type,
    trainable_prior, output_keys).

    Topologies are a dict of padded index tensors (keys 'bonds', 'angle',
    'dihedral', 'improper', 'pair' as configured) and a parallel dict of
    masks: :meth:`prepare_topologies` of
    ``data.topology.generate_topologies``'s arrays.
    """

    def __init__(self, modelparams, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        fr, lh = modelparams["Fr"], tuple(modelparams["Lh"])
        self.terms = {top: tuple(modelparams[f"{top}_terms"])
                      for top in _TERM_DEFAULTS
                      if f"{top}_terms" in modelparams}
        self.output_keys = tuple(modelparams.get("output_keys",
                                                 ("energy",)))
        trainable = modelparams.get("trainable_prior", True)
        self.embedding = nn.Embedding(100, fr)
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, fr ** -0.5, generator=gen)
        conv = (_SingleNodeConv if modelparams.get(
            "conv_type", "single_node") == "single_node"
            else _DoubleNodeConv)
        self.convs = nn.ModuleList([
            conv(fr, gen) for _ in range(modelparams.get("n_convolutions",
                                                         2))])
        self.nets = nn.ModuleDict({
            f"{key}_{top}": TOPOLOGY_NETS[top](fr, terms, lh, trainable,
                                               gen)
            for key in self.output_keys
            for top, terms in self.terms.items()})
        self.offsets = nn.ModuleDict({
            f"{key}_offset": ParameterPredictor(fr, lh, 1, True, gen)
            for key in self.output_keys})

    @staticmethod
    def prepare_topologies(top_dict, device="cuda"):
        """numpy topology dict -> (padded index dict, mask dict) of
        tensors on ``device`` (the card unless ``device="cpu"``); an empty
        topology becomes one masked row of zeros."""
        device = resolve_device(device)
        tops, masks = {}, {}
        for np_key, key in _TOPOLOGY_KEYS.items():
            arr = np.asarray(top_dict.get(np_key,
                                          np.zeros((0, 2), np.int32)))
            if len(arr) == 0:
                arr = np.zeros((1, arr.shape[1] if arr.ndim == 2
                                and arr.shape[1] else 2), np.int32)
                mask = np.zeros(1, dtype=bool)
            else:
                mask = np.ones(len(arr), dtype=bool)
            tops[key] = torch.as_tensor(arr, dtype=torch.long,
                                        device=device)
            masks[key] = torch.as_tensor(mask, device=device)
        return tops, masks

    def atomwise(self, z, xyz, tops, masks):
        """{output key: the molecule's energy (scalar)}."""
        r = self.embedding(z.long())
        for conv in self.convs:
            r = r + conv(r, tops["bonds"], masks["bonds"])
        out = {}
        for key in self.output_keys:
            E = 0.0
            for top in self.terms:
                tkey = "bonds" if top == "bond" else top
                E = E + self.nets[f"{key}_{top}"](r, xyz, tops[tkey],
                                                  masks[tkey])
            out[key] = E + self.offsets[f"{key}_offset"](r).sum()
        return out

    def energy(self, z, xyz, tops, masks, key="energy"):
        return self.atomwise(z, xyz, tops, masks)[key]

    def energy_and_forces(self, z, xyz, tops, masks, key="energy"):
        """(U, F = -dU/dxyz); F keeps its graph when gradients are on."""
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            x = xyz.detach().requires_grad_(True)
            u = self.energy(z, x, tops, masks, key)
            (g,) = torch.autograd.grad(u, x, create_graph=create_graph)
        return u, -g
