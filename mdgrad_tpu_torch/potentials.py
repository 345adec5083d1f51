"""Pair potentials as ``nn.Module``s (port of ``mdgrad_tpu/potentials.py``).

A potential maps distances ``r`` of any shape to per-pair energies; its
learnable constants are ``nn.Parameter``s (float32, as the JAX package's
``init_params`` makes them) where the JAX package keeps them in the
params pytree.  Fixed arrays (a spline's knots and coefficients, the
cubic ``PairTab``'s solve matrix) are float64 buffers cast to the
input's dtype at each call: float32 gives the JAX package's float32
values, float64 the exact ones.  The interaction that holds a potential
moves it to its device.

``Toy2d`` and ``LEPS`` are functions of 2-D points ``xy`` (..., 2), not of
distances.
"""

import numpy as np
import torch
from torch import nn


def _scalar(value):
    return nn.Parameter(torch.tensor(value, dtype=torch.float32))


class PairPotentialBase(nn.Module):
    """Per-pair energy ``forward(r) -> u`` broadcasting over ``r``."""

    def forward(self, r):
        raise NotImplementedError


class ExcludedVolume(PairPotentialBase):
    """Purely repulsive prior 4 eps (sigma / r)^power; the short-range
    prior under SchNet in the water RDF fit."""

    def __init__(self, sigma=1.0, epsilon=1.0, power=12):
        super().__init__()
        self.sigma, self.epsilon = _scalar(sigma), _scalar(epsilon)
        self.power = power

    def forward(self, r):
        return 4 * self.epsilon * (self.sigma / r) ** self.power


class LJFamily(PairPotentialBase):
    """Generalised Mie / LJ 4 eps ((sigma / r)^rep_pow - (sigma /
    r)^attr_pow) with fixed integer powers."""

    def __init__(self, sigma=1.0, epsilon=1.0, attr_pow=6, rep_pow=12):
        super().__init__()
        self.sigma, self.epsilon = _scalar(sigma), _scalar(epsilon)
        self.attr_pow, self.rep_pow = attr_pow, rep_pow

    def forward(self, r):
        sr = self.sigma / r
        return 4 * self.epsilon * (sr ** self.rep_pow - sr ** self.attr_pow)


class LennardJones(LJFamily):
    """4 eps ((sigma / r)^12 - (sigma / r)^6)."""

    def __init__(self, sigma=1.0, epsilon=1.0):
        super().__init__(sigma, epsilon, attr_pow=6, rep_pow=12)


class LennardJones69(LJFamily):
    """4 eps ((sigma / r)^9 - (sigma / r)^6)."""

    def __init__(self, sigma=1.0, epsilon=1.0):
        super().__init__(sigma, epsilon, attr_pow=6, rep_pow=9)


class GaussianCore(PairPotentialBase):
    """Bounded soft core eps exp(-(r / sigma)^2): a prior for targets that
    are themselves bounded at r = 0 (the 2-D stripe systems)."""

    def __init__(self, sigma=0.5, epsilon=2.0):
        super().__init__()
        self.sigma, self.epsilon = _scalar(sigma), _scalar(epsilon)

    def forward(self, r):
        return self.epsilon * torch.exp(-(r / self.sigma) ** 2)


class Buck(PairPotentialBase):
    """Buckingham A exp(-B r) - C r^-6."""

    def __init__(self, A=1.0, B=1.0, C=1.0):
        super().__init__()
        self.A, self.B, self.C = _scalar(A), _scalar(B), _scalar(C)

    def forward(self, r):
        return self.A * torch.exp(-self.B * r) - self.C / r ** 6


class Yukawa(PairPotentialBase):
    """Screened Coulomb eps sigma / r exp(-kappa r)."""

    def __init__(self, epsilon=1.0, kappa=1.0, sigma=1.0):
        super().__init__()
        self.epsilon, self.kappa = _scalar(epsilon), _scalar(kappa)
        self.sigma = _scalar(sigma)

    def forward(self, r):
        return self.epsilon * self.sigma / r * torch.exp(-self.kappa * r)


class Morse(PairPotentialBase):
    """D (1 - exp(-a (r - r0)))^2 - D."""

    def __init__(self, D=1.0, a=1.0, r0=1.0):
        super().__init__()
        self.D, self.a, self.r0 = _scalar(D), _scalar(a), _scalar(r0)

    def forward(self, r):
        x = torch.exp(-self.a * (r - self.r0))
        return self.D * (1.0 - x) ** 2 - self.D


class ModifiedMorse(PairPotentialBase):
    """Modified Morse with fixed ``a`` and ``phi`` (no parameters):
    (exp(2 s) - 2 exp(s) - A) / (1 + A), s = a (1 - r^phi) / phi."""

    def __init__(self, a, phi):
        super().__init__()
        self.a, self.phi = a, phi
        self.A = 0.0 if phi >= 0 else float(np.exp(2 * a / phi)
                                            - 2 * np.exp(a / phi))

    def forward(self, r):
        s = self.a * (1 - r ** self.phi) / self.phi
        return (torch.exp(2 * s) - 2 * torch.exp(s) - self.A) / (1 + self.A)


class PairTab(PairPotentialBase):
    """Learnable table ``tab`` (nbins,) on the uniform grid 0..rc,
    interpolated linearly (``kind='linear'``) or by a natural cubic spline
    (``'cubic'``): the knots' second derivatives are ``M = B @ tab``, with
    the grid's tridiagonal solve folded into the dense ``B`` at init, so a
    call is one (nbins, nbins) product (full precision: TF32 is off) and a
    cubic segment; dU/dr is continuous across knots.  Distances are
    clipped to [0, rc]."""

    def __init__(self, nbins=1000, rc=2.5, kind="cubic"):
        super().__init__()
        if kind not in ("cubic", "linear"):
            raise ValueError(f"unknown interpolation kind {kind!r}")
        self.nbins, self.rc, self.kind = nbins, rc, kind
        self.h = rc / (nbins - 1)
        # float32 knots, as the JAX package's jnp.linspace gives them
        self.register_buffer("x", torch.tensor(
            np.linspace(0.0, rc, nbins), dtype=torch.float32),
            persistent=False)
        self.tab = nn.Parameter(torch.zeros(nbins))
        if kind == "cubic":
            h = self.h
            m = nbins - 2  # interior knots; natural ends M_0 = M_{n-1} = 0
            T = (np.diag(np.full(m, 2 * h / 3))
                 + np.diag(np.full(m - 1, h / 6), 1)
                 + np.diag(np.full(m - 1, h / 6), -1))
            D = np.zeros((m, nbins))
            for i in range(m):
                D[i, i:i + 3] = [1.0 / h, -2.0 / h, 1.0 / h]
            B = np.zeros((nbins, nbins))
            B[1:-1] = np.linalg.solve(T, D)
            # float32, as the JAX package keeps it
            self.register_buffer("B", torch.tensor(B, dtype=torch.float32),
                                 persistent=False)

    def forward(self, r):
        shape = r.shape
        y = self.tab.to(r.dtype)
        x = self.x.to(r.dtype)
        rf = torch.clamp(r.reshape(-1), 0.0, self.rc)
        i = torch.clamp((rf / self.h).to(torch.int64), 0, self.nbins - 2)
        yi, yj = y[i], y[i + 1]
        t = rf - x[i]
        if self.kind == "linear":
            u = yi + (yj - yi) * t / (x[i + 1] - x[i])
            return u.reshape(shape)
        M = self.B.to(r.dtype) @ y
        h = self.h
        Mi, Mj = M[i], M[i + 1]
        u = (yi
             + t * ((yj - yi) / h - h / 6.0 * (2.0 * Mi + Mj))
             + t ** 2 * Mi / 2.0
             + t ** 3 * (Mj - Mi) / (6.0 * h))
        return u.reshape(shape)


class Harmonic(PairPotentialBase):
    """0.5 k x^2 (the toy potential of adjoint-gradient checks)."""

    def __init__(self, k=1.0):
        super().__init__()
        self.k = _scalar(k)

    def forward(self, x):
        return 0.5 * self.k * x ** 2


# ---- natural cubic splines: coefficients fit on the host ------------------

def _natural_cubic_coeffs(x, y):
    """(knots, a, b, c, d) of the natural cubic spline through (x, y), in
    float64 numpy: on [x_i, x_i+1], u = a_i + b_i t + c_i t^2 + d_i t^3."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x) - 1
    h = np.diff(x)
    # second derivatives with natural ends (M_0 = M_n = 0)
    a = np.zeros((n + 1, n + 1))
    b = np.zeros(n + 1)
    a[0, 0] = a[n, n] = 1.0
    for i in range(1, n):
        a[i, i - 1] = h[i - 1]
        a[i, i] = 2 * (h[i - 1] + h[i])
        a[i, i + 1] = h[i]
        b[i] = 3 * ((y[i + 1] - y[i]) / h[i] - (y[i] - y[i - 1]) / h[i - 1])
    c = np.linalg.solve(a, b)
    b_coef = (y[1:] - y[:-1]) / h - h * (2 * c[:-1] + c[1:]) / 3
    d_coef = (c[1:] - c[:-1]) / (3 * h)
    return x, y[:-1], b_coef, c[:-1], d_coef


class CubicSpline(PairPotentialBase):
    """Fixed natural cubic spline u(r) through (x, y); no parameters."""

    def __init__(self, x, y):
        super().__init__()
        knots, *coef = _natural_cubic_coeffs(x, y)
        self.register_buffer("knots", torch.tensor(knots), persistent=False)
        self.register_buffer("coef", torch.tensor(np.stack(coef)),
                             persistent=False)

    def forward(self, r):
        shape = r.shape
        r = r.reshape(-1)
        knots = self.knots.to(r.dtype)
        i = torch.clamp(torch.searchsorted(knots, r.detach()) - 1, 0,
                        len(knots) - 2)
        a, b, c, d = self.coef.to(r.dtype)[:, i]
        t = r - knots[i]
        u = a + b * t + c * t ** 2 + d * t ** 3
        return u.reshape(shape)


def boltzmann_inversion_spline(rdf_range, rdf, kT=1.0, eps=1e-30):
    """The spline of -kT log g(r), the Boltzmann-inverted pair potential;
    log(0) is clamped to the largest finite value."""
    g = np.asarray(rdf, dtype=np.float64)
    u = -kT * np.log(np.maximum(g, eps))
    u = np.nan_to_num(u, posinf=u[np.isfinite(u)].max() if
                      np.isfinite(u).any() else 0.0)
    return CubicSpline(np.asarray(rdf_range), u)


def spline_overlap(K, V0, n_splines=600, rmax=15.0, rmin=1e-3):
    """The stripe-phase overlap potential V0 / (pi (K x)^2) J1(K x / 2)^2
    as a cubic spline on ``n_splines`` knots from ``rmin`` to ``rmax``."""
    from scipy import special
    x = np.linspace(rmin, rmax, n_splines)
    y = V0 * (1.0 / (np.pi * (K * x) ** 2)) * special.jv(1, (K * x) / 2) ** 2
    return CubicSpline(x, y)


# ---- toy 2-D surfaces: functions of (x, y) ------------------------------

def _atleast_2d(xy):
    return xy.reshape(1, -1) if xy.dim() < 2 else xy


class Toy2d(PairPotentialBase):
    """Double-well 2-D surface."""

    def forward(self, xy):
        xy = _atleast_2d(xy)
        x, y = xy[:, 0], xy[:, 1]
        return ((x ** 2 + y ** 2) ** 2
                - 10 * torch.exp(-30 * (x - 0.2) ** 2 - 3 * (y - 0.4) ** 2)
                - 10 * torch.exp(-30 * (x + 0.2) ** 2 - 3 * (y + 0.4) ** 2))


class LEPS(PairPotentialBase):
    """The LEPS surface of a collinear A-B-C system, in (r_AB, r_BC)."""

    @staticmethod
    def _Q(d, r):
        alpha, r0 = 1.942, 0.742
        return d * (3 * torch.exp(-2 * alpha * (r - r0)) / 2
                    - torch.exp(-alpha * (r - r0))) / 2

    @staticmethod
    def _J(d, r):
        alpha, r0 = 1.942, 0.742
        return d * (torch.exp(-2 * alpha * (r - r0))
                    - 6 * torch.exp(-alpha * (r - r0))) / 4

    def forward(self, xy):
        xy = _atleast_2d(xy)
        a, b, c = 0.05, 0.3, 0.05
        dAB = dBC = 4.746
        dAC = 3.445
        rAB, rBC = xy[:, 0], xy[:, 1]
        rAC = rAB + rBC
        JAB = self._J(dAB, rAB) / (1 + a)
        JBC = self._J(dBC, rBC) / (1 + b)
        JAC = self._J(dAC, rAC) / (1 + c)
        return (self._Q(dAB, rAB) / (1 + a)
                + self._Q(dBC, rBC) / (1 + b)
                + self._Q(dAC, rAC) / (1 + c)
                - torch.sqrt(JAB ** 2 + JBC ** 2 + JAC ** 2
                             - JAB * JBC - JBC * JAC - JAB * JAC))
