"""Plots of the fitting drivers (port of ``plot_rdfs``, ``plot_pair``,
``plot_vacf`` and ``plot_loss`` from ``mdgrad_tpu/train/plots.py``): headless matplotlib, and nothing at
all where matplotlib is not installed."""

import numpy as np


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def plot_rdfs(bins, g_target, g_sim, fname, path, pname=None):
    """``path/fname.jpg``: the simulated g(r) over the target."""
    plt = _plt()
    if plt is None:
        return
    plt.figure()
    plt.title(f"epoch {pname}")
    plt.plot(bins, np.asarray(g_sim), linewidth=4, alpha=0.6, label="sim.")
    plt.plot(bins, np.asarray(g_target), linewidth=2, linestyle="--",
             c="black", label="target")
    plt.xlabel("r [A]")
    plt.ylabel("g(r)")
    plt.legend()
    plt.savefig(f"{path}/{fname}.jpg", bbox_inches="tight")
    plt.close()


def plot_pair(r_grid, u_fit, u_target, fname, path, ylim=(-2, 4)):
    """``path/potential_fname.jpg``: the recovered u(r) over the truth."""
    plt = _plt()
    if plt is None:
        return
    plt.figure()
    plt.plot(r_grid, np.asarray(u_fit), label="fit", linewidth=4,
             alpha=0.6)
    if u_target is not None:
        plt.plot(r_grid, np.asarray(u_target), label="truth", linewidth=2,
                 linestyle="--", c="black")
    plt.ylim(*ylim)
    plt.xlabel("r")
    plt.ylabel("u(r)")
    plt.legend()
    plt.savefig(f"{path}/potential_{fname}.jpg", bbox_inches="tight")
    plt.close()


def plot_vacf(vacf_sim, vacf_target, fname, path, dt=0.01):
    """``path/vacf_fname.jpg``: the simulated velocity autocorrelation
    over the target's, against t = step * ``dt``."""
    plt = _plt()
    if plt is None:
        return
    plt.figure()
    t = np.arange(len(np.asarray(vacf_sim))) * dt
    plt.plot(t, np.asarray(vacf_sim), label="sim.", linewidth=4, alpha=0.6)
    if vacf_target is not None:
        plt.plot(t[:len(np.asarray(vacf_target))], np.asarray(vacf_target),
                 label="target", linewidth=2, linestyle="--", c="black")
    plt.xlabel("t")
    plt.ylabel("VACF")
    plt.legend()
    plt.savefig(f"{path}/vacf_{fname}.jpg", bbox_inches="tight")
    plt.close()


def plot_loss(loss_log, path, fname="loss"):
    """``path/fname.jpg``: the loss per epoch on a log scale."""
    plt = _plt()
    if plt is None:
        return
    plt.figure()
    plt.semilogy(np.asarray(loss_log))
    plt.xlabel("epoch")
    plt.ylabel("loss")
    plt.savefig(f"{path}/{fname}.jpg", bbox_inches="tight")
    plt.close()
