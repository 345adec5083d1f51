"""NVE, Langevin, Nose-Hoover chain NVT and NPT integration with a cached
force.

Port of ``mdgrad_tpu/md/integrators.py``: the ``_MDIntegrator`` force
dispatch, ``prime_state``, the cached symplectic step and the RK4 "3/8
rule" step (``method="rk4"``, :func:`rk4_step`), ``NVE``, the BAOAB
``Langevin``, ``NoseHooverChain`` with ``update_T``, the multiple-time-step
``MTSNoseHooverChain``, the barostats ``NPTBerendsenNHC`` and
``NPTMTKNHC`` (the diagonal cell a state variable, on the autograd graph)
and ``rethermalize``.  An
interaction with a ``force`` method (the fused
pair kernels' :class:`~mdgrad_tpu_torch.ops.pair.PallasLJPair`) supplies
the force itself; for any other, forces are ``-dU/dq`` from
``torch.autograd.grad``.  With ``create_graph=False`` (the sampling path)
either comes without a graph; with ``create_graph=True``, where a loss
differentiates through the trajectory, it stays on the graph to ``q`` and
to the potential's parameters -- differentiable to any order through
autograd of the energy, as ``-jax.grad`` of the energy is in the JAX
package, and to first order through a ``force`` method's own backward,
as its JAX ``custom_vjp`` is.

The end-of-step force equals the next step's start force, so each step
evaluates the potential once; ``prime_state`` fills the cache at epoch
entry.  ``fv`` (force valid) is a Python bool here, so checking it never
waits for the device.  An integrator whose ``default_method`` is "rk4"
starts from the state without the cache (``NVEState`` / ``NVTState``).
"""

import math
import typing

import numpy as np
import torch

from .. import thermo, units
from .._device import resolve_device
from ..system import check_system, maxwell_boltzmann_velocities
from .tinydiffeq import rk4_step


class NVEState(typing.NamedTuple):
    v: torch.Tensor
    q: torch.Tensor


class NVTState(typing.NamedTuple):
    v: torch.Tensor
    q: torch.Tensor
    pv: torch.Tensor   # Nose-Hoover chain bath momenta


class NVEStateF(typing.NamedTuple):
    v: torch.Tensor
    q: torch.Tensor
    f: torch.Tensor    # cached force at q
    fv: bool           # the cached force is valid


class NVTStateF(typing.NamedTuple):
    v: torch.Tensor
    q: torch.Tensor
    pv: torch.Tensor   # Nose-Hoover chain bath momenta
    f: torch.Tensor    # cached force at q
    fv: bool           # the cached force is valid


class NPTStateF(typing.NamedTuple):
    v: torch.Tensor
    q: torch.Tensor
    pv: torch.Tensor   # Nose-Hoover chain bath momenta
    cell: torch.Tensor  # (3,) diagonal cell lengths, a state variable
    f: torch.Tensor    # cached force at q
    fv: bool           # the cached force is valid


class NPTMTKStateF(typing.NamedTuple):
    v: torch.Tensor
    q: torch.Tensor
    pv: torch.Tensor   # Nose-Hoover chain bath momenta
    cell: torch.Tensor  # (3,) diagonal cell lengths, a state variable
    peps: torch.Tensor  # () barostat momentum, conjugate to log-volume
    f: torch.Tensor    # cached force at q
    fv: bool           # the cached force is valid


class _MDIntegrator:
    """Force evaluation and the cached velocity-Verlet-family step."""

    def __init__(self, potentials, system, adjoint=True,
                 topology_update_freq=1, device="cuda", dtype=torch.float32):
        check_system(system)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.model = potentials
        self.system = system
        self.masses = torch.as_tensor(system.get_masses(), dtype=dtype,
                                      device=self.device)[:, None]
        self.dim = system.dim
        self.n_dof = system.get_number_of_atoms() * system.dim
        # True: epochs differentiate through the replay adjoint (per-step
        # states stored, steps re-run in reverse); False: plain autograd
        # through the step loop (see md/adjoint.py)
        self.adjoint = adjoint
        self.topology_update_freq = topology_update_freq

    def aux_init(self, q):
        return self.model.aux_init(q)

    def aux_update(self, q, aux):
        return self.model.aux_update(q, aux)

    def default_ctrl(self):
        return {}

    def force(self, q, aux, create_graph=False):
        """The force at ``q``: the interaction's own ``force`` when it has
        one, else -dU/dq.  ``create_graph=False``: no graph kept.
        ``create_graph=True``: on the graph to ``q`` (when ``q`` requires
        grad) and to the potential's parameters."""
        if hasattr(self.model, "force"):
            if create_graph:
                return self.model.force(q, aux)
            with torch.no_grad():
                return self.model.force(q.detach(), aux)
        with torch.enable_grad():
            if not (create_graph and q.requires_grad):
                q = q.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.model.energy(q, aux), q,
                                       create_graph=create_graph)
        return -g

    def prime_state(self, state, aux, create_graph=False, fresh_aux=False):
        """Refresh ``aux`` at ``state.q`` (unless ``fresh_aux``: the caller
        just built it there) and fill the force cache (a state without one
        is returned as it is); returns ``(state, aux)``."""
        if not fresh_aux:
            aux = self.model.aux_update(state.q.detach(), aux)
        if not hasattr(state, "fv"):
            return state, aux
        f = self.force(state.q, aux, create_graph)
        return state._replace(f=f, fv=True), aux

    def derivs(self, state, aux, ctrl, t, create_graph=False):
        """d(state)/dt at ``state``: the force's acceleration (with the
        chain coupling for an integrator with a bath), the velocity, and
        a zero derivative for the cached force."""
        f = self.force(state.q, aux, create_graph)
        dv, dbath = self.derivs_from_force(state, ctrl, f)
        d = state._replace(v=dv, q=state.v)
        if dbath is not None:
            d = d._replace(pv=dbath)
        if hasattr(state, "f"):
            d = d._replace(f=torch.zeros_like(state.f))
        return d

    def step(self, state, aux, ctrl, dt, create_graph=False, method=None,
             t=0.0):
        """One step of ``method`` (default ``default_method``) at time
        ``t``.  "rk4": the 3/8 rule on :meth:`derivs`, four forces.
        "verlet" / "NH_verlet": ONE potential evaluation, the start-of-step
        force being the cached end-of-step force of the previous step (a
        state without the cache evaluates it); the bath half-kicks run only
        for an integrator with a bath (``derivs_from_force`` returns its
        derivative, not None)."""
        method = method or self.default_method
        if method == "rk4":
            return rk4_step(
                lambda s, tt: self.derivs(s, aux, ctrl, tt, create_graph),
                state, t, dt)
        if method not in ("verlet", "NH_verlet"):
            raise ValueError(f"unknown method {method!r}")
        cached = hasattr(state, "fv")
        f0 = state.f if cached and state.fv else self.force(
            state.q, aux, create_graph)
        dv0, dbath0 = self.derivs_from_force(state, ctrl, f0)
        v_half = state.v + 0.5 * dt * dv0
        q_new = state.q + v_half * dt
        mid = state._replace(v=v_half, q=q_new)
        if dbath0 is not None:
            mid = mid._replace(pv=state.pv + 0.5 * dt * dbath0)
        f1 = self.force(q_new, aux, create_graph)
        dv1, dbath1 = self.derivs_from_force(mid, ctrl, f1)
        new = mid._replace(v=v_half + 0.5 * dt * dv1)
        if cached:
            new = new._replace(f=f1, fv=True)
        if dbath1 is not None:
            new = new._replace(pv=mid.pv + 0.5 * dt * dbath1)
        return new


class NVE(_MDIntegrator):
    """Constant-energy velocity Verlet with the cached force."""

    state_keys = ["velocities", "positions"]
    default_method = "verlet"

    def initial_state(self, wrap=True):
        kw = {"dtype": self.dtype, "device": self.device}
        q = torch.as_tensor(self.system.get_positions(wrap=wrap), **kw)
        v = torch.as_tensor(self.system.get_velocities(), **kw)
        if self.default_method == "rk4":
            return NVEState(v=v, q=q)
        return NVEStateF(v=v, q=q, f=torch.zeros_like(q), fv=False)

    def derivs_from_force(self, state, ctrl, f):
        """(dv/dt, None): no bath."""
        return f / self.masses, None


def _mix64(x):
    """splitmix64 of ``x``, to 63 bits: a generator seed whose low 32 bits
    (all that the CPU generator keeps) already depend on every bit of
    ``x``."""
    m = (1 << 64) - 1
    x = (x + 0x9E3779B97F4A7C15) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return (x ^ (x >> 31)) >> 1


class Langevin(_MDIntegrator):
    """BAOAB Langevin dynamics at ``T`` (Kelvin) with ``friction``:
    half kick, half drift, the Ornstein-Uhlenbeck velocity refresh, half
    drift, half kick, with the cached force.

    The noise of step i is a pure function of the global step index
    ``noise_step0 + i`` (mod 2^32), so the replay adjoint redraws the
    same noise when it re-runs a step: ``noise_fn(index, shape)`` returns
    it, by default standard normals from a ``torch.Generator`` on the
    integrator's device seeded with a hash of (``seed``, index) at every
    step --
    not the JAX package's threefry draws, which a test passes in through
    ``noise_fn``.  ``ctrl`` carries ``kT`` and ``noise_step0``, a host
    integer (seeding costs no device sync); :meth:`advance_ctrl` moves it
    on by an epoch's steps, so a later epoch draws fresh noise.
    Gradients flow through the deterministic map; the noise is data.
    """

    state_keys = ["velocities", "positions"]
    default_method = "langevin"

    def __init__(self, potentials, system, T, friction=0.01, adjoint=True,
                 topology_update_freq=1, seed=0, noise_fn=None,
                 device="cuda", dtype=torch.float32):
        super().__init__(potentials, system, adjoint, topology_update_freq,
                         device=device, dtype=dtype)
        self.T = T
        self.friction = friction
        self.seed = int(seed)
        self.noise_fn = noise_fn or self._noise
        self._gen = torch.Generator(device=self.device)

    def _noise(self, index, shape):
        self._gen.manual_seed(_mix64((self.seed << 32) | index))
        return torch.randn(shape, generator=self._gen, device=self.device,
                           dtype=self.dtype)

    def default_ctrl(self):
        return {"kT": torch.tensor(self.T * units.kB, dtype=self.dtype,
                                   device=self.device),
                "noise_step0": 0}

    def advance_ctrl(self, ctrl, n_steps):
        return {**ctrl, "noise_step0": ctrl["noise_step0"] + int(n_steps)}

    def update_T(self, T):
        self.T = T
        return self.default_ctrl()

    def initial_state(self, wrap=True):
        kw = {"dtype": self.dtype, "device": self.device}
        q = torch.as_tensor(self.system.get_positions(wrap=wrap), **kw)
        v = torch.as_tensor(self.system.get_velocities(), **kw)
        return NVEStateF(v=v, q=q, f=torch.zeros_like(q), fv=False)

    def step(self, state, aux, ctrl, dt, create_graph=False, method=None,
             t=0.0):
        if method not in (None, "langevin"):
            raise ValueError(f"Langevin has no method {method!r}")
        m, v, q = self.masses, state.v, state.q
        # round, don't truncate: t = i dt can land just below the integer
        i = int(round(t / dt))
        index = (ctrl["noise_step0"] + i) % (1 << 32)
        f0 = state.f if state.fv else self.force(q, aux, create_graph)
        v = v + 0.5 * dt * f0 / m                      # B
        q = q + 0.5 * dt * v                           # A
        c1 = math.exp(-self.friction * dt)             # O
        c2 = torch.sqrt(ctrl["kT"] * (1 - c1 ** 2) / m)
        noise = self.noise_fn(index, tuple(v.shape)).to(v)
        v = c1 * v + c2 * noise
        q = q + 0.5 * dt * v                           # A
        f1 = self.force(q, aux, create_graph)
        v = v + 0.5 * dt * f1 / m                      # B
        return NVEStateF(v=v, q=q, f=f1, fv=True)


class NoseHooverChain(_MDIntegrator):
    """NVT through a Nose-Hoover chain; T in Kelvin, bath masses
    [Q, Q/N, ..., Q/N], or the Martyna-Tuckerman-Klein masses from ``tau``.
    """

    state_keys = ["velocities", "positions", "baths"]
    default_method = "NH_verlet"

    def __init__(self, potentials, system, T, num_chains=2, Q=1.0,
                 adjoint=True, topology_update_freq=1, tau=None,
                 device="cuda", dtype=torch.float32):
        super().__init__(potentials, system, adjoint, topology_update_freq,
                         device=device, dtype=dtype)
        if num_chains < 2:
            raise ValueError("NoseHooverChain needs num_chains >= 2")
        self.T = T
        self.num_chains = num_chains
        n = system.get_number_of_atoms()
        if tau is not None:
            kT0 = T * units.kB
            q = [self.n_dof * kT0 * tau ** 2] + [kT0 * tau ** 2] * (
                num_chains - 1)
        else:
            q = [Q] + [Q / n] * (num_chains - 1)
        self.Q = torch.tensor(q, dtype=dtype, device=self.device)

    def update_T(self, T):
        """Set the bath temperature ``T`` (Kelvin) and return the new
        ``default_ctrl()``, for annealing; the chain masses keep their
        construction temperature."""
        self.T = T
        return self.default_ctrl()

    def default_ctrl(self):
        return {"kT": torch.tensor(self.T * units.kB, dtype=self.dtype,
                                   device=self.device)}

    def initial_state(self, wrap=True):
        kw = {"dtype": self.dtype, "device": self.device}
        q = torch.as_tensor(self.system.get_positions(wrap=wrap), **kw)
        v = torch.as_tensor(self.system.get_velocities(), **kw)
        pv = torch.zeros(self.num_chains, **kw)
        if self.default_method == "rk4":
            return NVTState(v=v, q=q, pv=pv)
        return NVTStateF(v=v, q=q, pv=pv, f=torch.zeros_like(q), fv=False)

    def derivs_from_force(self, state, ctrl, f):
        """Chain equations of motion given the force: (dv/dt, dpv/dt)."""
        kT = ctrl["kT"]
        v, pv, m, Q = state.v, state.pv, self.masses, self.Q
        p = v * m
        sys_ke = 0.5 * (p ** 2 / m).sum()
        dvdt = (f - pv[0] * p / Q[0]) / m
        dpv0 = 2 * (sys_ke - kT * self.n_dof * 0.5) - pv[0] * pv[1] / Q[1]
        dpv_mid = ((pv[:-2] ** 2 / Q[:-2] - kT)
                   - pv[2:] * pv[1:-1] / Q[2:])
        dpv_last = pv[-2] ** 2 / Q[-2] - kT
        return dvdt, torch.cat([dpv0[None], dpv_mid, dpv_last[None]])


class MTSNoseHooverChain(NoseHooverChain):
    """Multiple-time-step (XI-RESPA) Nose-Hoover chain over a ``Stack``.

    The stack's ``fast_keys`` interactions (a cheap prior) are the fast
    force, the others the slow one (the SchNet).  One outer step of ``dt``
    is: the bath and the slow force's half impulse at the outer scale,
    ``n_inner`` velocity-Verlet steps of ``dt / n_inner`` on the fast force
    alone, then the slow force at the new positions and the closing half
    impulse.  The slow force is evaluated once a step: the cache
    ``state.f`` holds it (never the fast one), and :meth:`prime_state`
    fills it; the fast force ``n_inner + 1`` times.  One outer step is one
    step of the epoch, so the replay adjoint re-runs the whole outer step,
    inner loop included, and the topology refresh keeps the outer cadence.
    """

    def __init__(self, stack, system, T, fast_keys=("pair",), n_inner=2,
                 **kw):
        if not hasattr(stack, "models"):
            raise TypeError("MTSNoseHooverChain needs a Stack (the "
                            "slow/fast split is by stack key)")
        super().__init__(stack, system, T, **kw)
        self.fast_keys = tuple(fast_keys)
        self.slow_keys = tuple(k for k in stack.models
                               if k not in self.fast_keys)
        missing = [k for k in self.fast_keys if k not in stack.models]
        if missing or not self.slow_keys:
            raise ValueError(f"bad fast_keys {fast_keys} for stack keys "
                             f"{list(stack.models)}")
        self.n_inner = int(n_inner)

    def _keys_force(self, keys, q, aux, create_graph):
        """-d/dq of the energies of the stack's ``keys`` only."""
        with torch.enable_grad():
            if not (create_graph and q.requires_grad):
                q = q.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.model.energy(q, aux, keys=keys),
                                       q, create_graph=create_graph)
        return -g

    def prime_state(self, state, aux, create_graph=False, fresh_aux=False):
        """Refresh ``aux`` (unless ``fresh_aux``) and cache the SLOW force
        only."""
        if not fresh_aux:
            aux = self.model.aux_update(state.q.detach(), aux)
        f = self._keys_force(self.slow_keys, state.q, aux, create_graph)
        return state._replace(f=f, fv=True), aux

    def step(self, state, aux, ctrl, dt, create_graph=False, method=None,
             t=0.0):
        if not hasattr(state, "fv"):
            raise ValueError("the MTS step needs the cached (*F) state "
                             "from initial_state()")
        fs0 = state.f if state.fv else self._keys_force(
            self.slow_keys, state.q, aux, create_graph)
        # outer half: slow impulse and chain coupling on v, bath half-kick
        dv0, dbath0 = self.derivs_from_force(state, ctrl, fs0)
        v = state.v + 0.5 * dt * dv0
        pv = state.pv + 0.5 * dt * dbath0
        # inner loop: velocity Verlet on the fast force at dt / n_inner
        dti, m, q = dt / self.n_inner, self.masses, state.q
        ff = self._keys_force(self.fast_keys, q, aux, create_graph)
        for _ in range(self.n_inner):
            v1 = v + 0.5 * dti * ff / m
            q = q + dti * v1
            ff = self._keys_force(self.fast_keys, q, aux, create_graph)
            v = v1 + 0.5 * dti * ff / m
        # closing half: a fresh slow force at the new positions
        fs1 = self._keys_force(self.slow_keys, q, aux, create_graph)
        dv1, dbath1 = self.derivs_from_force(
            state._replace(v=v, q=q, pv=pv), ctrl, fs1)
        return NVTStateF(v=v + 0.5 * dt * dv1, q=q,
                         pv=pv + 0.5 * dt * dbath1, f=fs1, fv=True)


class _Barostat(NoseHooverChain):
    """What the two barostats share: the dynamic cell carried in the
    state, the ``P0`` control, the cell-aware topology refresh and force
    cache.  ``potentials`` is wrapped in ``WithDynamicCell`` at the
    system's diagonal cell unless it is one."""

    def __init__(self, potentials, system, T, P, tau_p=None, **kw):
        from ..interface import WithDynamicCell
        cell = np.asarray(system.get_cell(), dtype=np.float64)
        cell_len = np.diag(cell) if cell.ndim == 2 else cell
        if not isinstance(potentials, WithDynamicCell):
            potentials = WithDynamicCell(potentials, cell_len)
        super().__init__(potentials, system, T, **kw)
        self.P = P
        # None -> 1000 dt at step time
        self.tau_p = None if tau_p is None else float(tau_p)
        self.cell_len0 = torch.tensor(cell_len, dtype=self.dtype,
                                      device=self.device)
        # 2-D systems barostat the first `dim` axes only
        self._scale_mask = torch.tensor(
            [1.0] * self.dim + [0.0] * (3 - self.dim), dtype=self.dtype,
            device=self.device)

    def default_ctrl(self):
        kw = {"dtype": self.dtype, "device": self.device}
        return {"kT": torch.tensor(self.T * units.kB, **kw),
                "P0": torch.tensor(self.P, **kw)}

    def update_P(self, P):
        """Set the target pressure and return the new ``default_ctrl()``
        (the pressure schedule's entry point, as ``update_T``)."""
        self.P = P
        return self.default_ctrl()

    def aux_update_state(self, state, aux):
        """The topology refresh against the state's own cell
        (``Simulation.epoch_fn`` prefers this hook)."""
        return self.model.aux_update(state.q.detach(), aux,
                                     cell=state.cell.detach())

    def prime_state(self, state, aux, create_graph=False, fresh_aux=False):
        if not fresh_aux:
            aux = self.aux_update_state(state, aux)
        f = self.force(state.q, (state.cell, aux[1]), create_graph)
        return state._replace(f=f, fv=True), aux

    def _tau_p(self, dt):
        return 1000.0 * dt if self.tau_p is None else self.tau_p

    def _check(self, method):
        if method not in (None, "verlet", "NH_verlet"):
            raise ValueError(f"{type(self).__name__} supports the NH_verlet "
                             "stepper only")


class NPTBerendsenNHC(_Barostat):
    """Constant pressure: the Nose-Hoover chain thermostat and Berendsen
    weak coupling of the diagonal cell toward ``P`` (isotropic).  Weak
    coupling holds the mean density but suppresses the volume
    fluctuations; :class:`NPTMTKNHC` samples the isothermal-isobaric
    ensemble.

    A step: one NH-verlet step at the state's cell (the cell reaches the
    interaction through ``WithDynamicCell``'s aux, ``(state.cell,
    inner)``), the virial pressure there (``thermo.pressure``, one more
    gradient of the energy, differentiable again in the replay), then
    ``q`` and ``cell`` scaled by ``mu = (1 - dt beta / tau_p (P0 -
    P))^(1 / dim)`` clipped to 1 +- ``max_rescale``.  The cached force is
    kept across the rescale, the usual weak-coupling approximation.  The
    cell is a state field on the autograd graph, so the barostatted
    trajectory, its density included, is differentiable in the
    potential's parameters.
    """

    state_keys = ["velocities", "positions", "baths", "cell"]

    def __init__(self, potentials, system, T, P, tau_p=None, beta=1.0,
                 max_rescale=0.002, **kw):
        super().__init__(potentials, system, T, P, tau_p=tau_p, **kw)
        self.beta = float(beta)
        self.max_rescale = float(max_rescale)

    def initial_state(self, wrap=True):
        kw = {"dtype": self.dtype, "device": self.device}
        q = torch.as_tensor(self.system.get_positions(wrap=wrap), **kw)
        v = torch.as_tensor(self.system.get_velocities(), **kw)
        return NPTStateF(v=v, q=q, pv=torch.zeros(self.num_chains, **kw),
                         cell=self.cell_len0.clone(), f=torch.zeros_like(q),
                         fv=False)

    def step(self, state, aux, ctrl, dt, create_graph=False, method=None,
             t=0.0):
        self._check(method)
        aux_eff = (state.cell, aux[1])
        new = super().step(state, aux_eff, ctrl, dt, create_graph, t=t)
        p_inst = thermo.pressure(self.model, new.q, aux_eff, new.v,
                                 self.masses, state.cell, dim=self.dim)
        mu = (1.0 - dt * self.beta / self._tau_p(dt)
              * (ctrl["P0"] - p_inst)) ** (1.0 / self.dim)
        mu = torch.clamp(mu, 1.0 - self.max_rescale, 1.0 + self.max_rescale)
        scale = 1.0 + self._scale_mask * (mu - 1.0)
        return new._replace(q=new.q * scale, cell=state.cell * scale)


class NPTMTKNHC(_Barostat):
    """Constant pressure in the isothermal-isobaric ensemble: the
    Martyna-Tobias-Klein barostat (isotropic) on the Nose-Hoover chain.
    The barostat momentum ``peps`` is conjugate to the log-volume, its
    mass W = (N_dof + dim) kT0 tau_p^2 (tau_p default 1000 dt);
    alpha = 1 + dim / N_dof:

        dq/dt    = v + (peps / W) q
        dcell/dt = (peps / W) cell
        dv/dt    = f / m - (alpha peps / W + pv0 / Q0) v
        dpeps/dt = dim V (P_int - P0) + (dim / N_dof) 2 KE - (pv0 / Q0) peps
        dpv0/dt  = (2 KE - N_dof kT) + (peps^2 / W - kT) - pv0 pv1 / Q1

    with the other chain links as the plain chain's.  P_int is the virial
    pressure (``thermo.pressure``, at each half kick); the step is half
    kick, the volume drift exp((peps / W) dt) on q and cell with the
    position drift, the force at the new point, half kick.  The cell stays
    on the autograd graph, so the barostatted trajectory is
    differentiable in the potential's parameters.
    """

    state_keys = ["velocities", "positions", "baths", "cell", "peps"]

    def __init__(self, potentials, system, T, P, tau_p=None, **kw):
        super().__init__(potentials, system, T, P, tau_p=tau_p, **kw)
        self._kT0 = T * units.kB

    def initial_state(self, wrap=True):
        kw = {"dtype": self.dtype, "device": self.device}
        q = torch.as_tensor(self.system.get_positions(wrap=wrap), **kw)
        v = torch.as_tensor(self.system.get_velocities(), **kw)
        return NPTMTKStateF(v=v, q=q, pv=torch.zeros(self.num_chains, **kw),
                            cell=self.cell_len0.clone(),
                            peps=torch.zeros((), **kw),
                            f=torch.zeros_like(q), fv=False)

    def _W(self, dt):
        return (self.n_dof + self.dim) * self._kT0 * self._tau_p(dt) ** 2

    def step(self, state, aux, ctrl, dt, create_graph=False, method=None,
             t=0.0):
        self._check(method)
        kT, P0 = ctrl["kT"], ctrl["P0"]
        m, d, Q = self.masses, self.dim, self.Q
        W = self._W(dt)
        alpha = 1.0 + d / self.n_dof
        aux_in = aux[1]

        def derivs(s, f):
            ke2 = (s.v ** 2 * m).sum()
            vol = torch.abs(torch.prod(torch.where(
                self._scale_mask > 0, s.cell, torch.ones_like(s.cell))))
            p_int = thermo.pressure(self.model, s.q, (s.cell, aux_in), s.v,
                                    m, s.cell, dim=d)
            dv = f / m - (alpha * s.peps / W + s.pv[0] / Q[0]) * s.v
            dpeps = (d * vol * (p_int - P0) + (d / self.n_dof) * ke2
                     - s.pv[0] / Q[0] * s.peps)
            pv = s.pv
            dpv0 = ((ke2 - self.n_dof * kT) + (s.peps ** 2 / W - kT)
                    - pv[0] * pv[1] / Q[1])
            dpv_mid = ((pv[:-2] ** 2 / Q[:-2] - kT)
                       - pv[2:] * pv[1:-1] / Q[2:])
            dpv_last = pv[-2] ** 2 / Q[-2] - kT
            return dv, torch.cat([dpv0[None], dpv_mid, dpv_last[None]]), \
                dpeps

        f0 = state.f if state.fv else self.force(
            state.q, (state.cell, aux_in), create_graph)
        dv0, dpv0, dpeps0 = derivs(state, f0)
        v_half = state.v + 0.5 * dt * dv0
        pv_half = state.pv + 0.5 * dt * dpv0
        peps_half = state.peps + 0.5 * dt * dpeps0
        # exponential volume drift with the position drift
        scale = 1.0 + self._scale_mask * (torch.exp((peps_half / W) * dt)
                                          - 1.0)
        q_new = state.q * scale + v_half * dt
        cell_new = state.cell * scale
        mid = state._replace(v=v_half, q=q_new, pv=pv_half, peps=peps_half,
                             cell=cell_new)
        f1 = self.force(q_new, (cell_new, aux_in), create_graph)
        dv1, dpv1, dpeps1 = derivs(mid, f1)
        return NPTMTKStateF(v=v_half + 0.5 * dt * dv1, q=q_new,
                            pv=pv_half + 0.5 * dt * dpv1, cell=cell_new,
                            peps=peps_half + 0.5 * dt * dpeps1, f=f1,
                            fv=True)


def rethermalize(state, kT, masses, rng=None, dim=3):
    """``state`` with fresh Maxwell-Boltzmann velocities at ``kT`` (energy
    units) drawn from the numpy Generator ``rng``, the bath momenta and
    the barostat momentum ``peps`` zeroed and the force cache marked
    stale; positions (and the cell) are kept.

    The fit's NaN recovery restores a finite snapshot and retries: a Nose-
    Hoover trajectory is deterministic, so a blowup driven by the state
    would otherwise recur on every retry.  The draws are the JAX
    package's, so the same ``rng`` gives the same velocities.
    """
    v = maxwell_boltzmann_velocities(np.asarray(masses), float(kT), rng=rng)
    if dim < 3:
        v[:, dim:] = 0.0
    upd = {"v": torch.as_tensor(v, dtype=state.v.dtype,
                                device=state.v.device)}
    if hasattr(state, "pv"):
        upd["pv"] = torch.zeros_like(state.pv)
    if hasattr(state, "fv"):
        upd["fv"] = False    # prime_state refills the cache
    if hasattr(state, "peps"):
        upd["peps"] = torch.zeros_like(state.peps)
    return state._replace(**upd)
