#!/usr/bin/env python
"""Stripe-fit degeneracy analysis with the PyTorch/CUDA port:
``scripts/analyze_stripe.py``'s arguments, lines and files, plus
``-device``.

Overlays the recovered pair potential (``potential_best.txt`` of the run
where it exists, else ``potential.txt``) against the ground-truth
SplineOverlap of ``data_tag`` and reports where g(r) constrains it: the
bands of r where the target g(r) < 0.05 are invisible to an RDF-only
loss, so a u(r) discrepancy there is the soft-core degeneracy, not a
fitting failure.  Prints the blind bands and the mean and largest
|u_fit - u_truth| inside and outside them; writes
``potential_overlay.csv`` (rows r, u_fit, u_truth, g_target(r)) and
``potential_overlay.jpg`` into ``-out``.

Host work only: the truth through the port's ``potentials`` in float32
(as the JAX script evaluates it), the target g(r) through
``data.registry.get_exp_rdf``; ``-device`` (default ``cpu``, as the JAX
script pins its platform to the CPU) places the truth's evaluation.
One deviation: the JAX script writes into the run directory when no
``-out`` is given; here the output directory, ``-out`` or the run
directory, must lie outside the repository's ``results/``, which holds
the JAX package's records and stays as they are.

    python scripts/analyze_stripe_torch.py results/stripe_r3/0 \\
        overlap_0.9766_T0.07_cut12 -out outputs/stripe_r3
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


def _inside(path, root):
    path, root = os.path.realpath(path), os.path.realpath(root)
    return os.path.commonpath([path, root]) == root


def main(argv=None, log=print):
    """Run the analysis; ``argv`` the arguments (default
    ``sys.argv[1:]``), ``log`` takes each line.  Returns a dict: ``which``
    (the potential file), ``r``, ``u_fit``, ``u_truth``, ``g`` (the target
    on r), ``blind_share``, ``bands`` ((start, end) pairs), ``seen_mean``,
    ``seen_max``, ``blind_mean``, ``blind_max`` and ``out``."""
    p = argparse.ArgumentParser()
    p.add_argument("run_dir")
    p.add_argument("data_tag")
    p.add_argument("-out", default=None)
    p.add_argument("-device", type=str, default="cpu",
                   help="where the truth is evaluated ('cpu' or 'cuda')")
    args = p.parse_args(argv)
    out = args.out or args.run_dir
    if _inside(out, os.path.join(REPO, "results")):
        p.error(f"{out} lies inside results/, which holds the JAX "
                "package's records: pass -out outside it")

    import torch
    from mdgrad_tpu_torch.data.registry import get_exp_rdf, pair_data_dict
    from mdgrad_tpu_torch.train.fit_rdf_pair import resolve_target_pot

    entry = pair_data_dict[args.data_tag]
    pot = resolve_target_pot(entry["target_pot"]).to(args.device)

    which = ("potential_best.txt"
             if os.path.exists(os.path.join(args.run_dir,
                                            "potential_best.txt"))
             else "potential.txt")
    r, u_fit = np.loadtxt(os.path.join(args.run_dir, which))
    with torch.no_grad():
        u_t = pot(torch.tensor(r, dtype=torch.float32,
                               device=args.device)[:, None])
    u_t = u_t.squeeze(-1).cpu().numpy()
    u_t = u_t - u_t[-1]
    u_fit = u_fit - u_fit[-1]

    # target g(r) on the same grid
    start, end = entry.get("start", 0.5), entry["end"]
    data = np.loadtxt(entry.get("rdf_fn") or entry["fn"], delimiter=",") \
        if (entry.get("rdf_fn") or entry.get("fn")) else None
    if data is not None:
        x, g = get_exp_rdf(data, 256, (start, end),
                           dim=entry.get("dim", 3))
        g_on_r = np.interp(r, x, g, left=0.0, right=1.0)
    else:
        g_on_r = np.ones_like(r)

    dev = np.abs(u_fit - u_t)
    # g(r)-weighted (what the RDF loss can see) vs unweighted deviation
    blind = g_on_r < 0.05
    seen_dev = dev[~blind]
    blind_dev = dev[blind] if blind.any() else np.zeros(1)

    log(f"potential: {which}")
    log(f"r range: [{r[0]:.2f}, {r[-1]:.2f}]  "
        f"(g<0.05 'blind' bands: {blind.mean() * 100:.0f}% of grid)")
    bands = []
    if blind.any():
        edges = np.flatnonzero(np.diff(blind.astype(int)))
        idx = np.concatenate([[0], edges + 1, [len(r)]])
        for a, b in zip(idx[:-1], idx[1:]):
            if blind[a]:
                bands.append((r[a], r[b - 1]))
        log("blind bands (g(r) < 0.05, invisible to the RDF loss):")
        for a, b in bands:
            log(f"  r in [{a:.2f}, {b:.2f}]")
    log(f"|u_fit - u_truth| where g(r) SEES the potential: "
        f"mean {seen_dev.mean():.4f}, max {seen_dev.max():.4f}")
    log(f"|u_fit - u_truth| in the blind bands:           "
        f"mean {blind_dev.mean():.4f}, max {blind_dev.max():.4f}")

    os.makedirs(out, exist_ok=True)
    np.savetxt(os.path.join(out, "potential_overlay.csv"),
               np.vstack([r, u_fit, u_t, g_on_r]), delimiter=",",
               header="rows: r, u_fit, u_truth, g_target(r)")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(7, 4.5))
        ax.plot(r, u_t, "k-", lw=2, label="SplineOverlap truth")
        ax.plot(r, u_fit, "r--", lw=2, label=f"recovered ({which})")
        for a, b in bands:
            ax.axvspan(a, b, color="0.85", zorder=0)
        ax.set_xlabel("r")
        ax.set_ylabel("u(r)")
        ax.set_ylim(min(u_t.min(), 0) - 0.5,
                    min(u_t.max(), 25.0) * 1.05)
        ax2 = ax.twinx()
        ax2.plot(r, g_on_r, "b:", lw=1, label="target g(r)")
        ax2.set_ylabel("g(r)", color="b")
        ax.legend(loc="upper right")
        ax.set_title("shaded: g(r)<0.05 -- bands the RDF loss cannot see")
        fig.tight_layout()
        fig.savefig(os.path.join(out, "potential_overlay.jpg"), dpi=130)
        plt.close(fig)
        log(f"wrote {out}/potential_overlay.jpg")
    except Exception as e:  # pragma: no cover
        log(f"plot skipped: {e}")
    return {"which": which, "r": r, "u_fit": u_fit, "u_truth": u_t,
            "g": g_on_r, "blind_share": float(blind.mean()), "bands": bands,
            "seen_mean": float(seen_dev.mean()),
            "seen_max": float(seen_dev.max()),
            "blind_mean": float(blind_dev.mean()),
            "blind_max": float(blind_dev.max()), "out": out}


if __name__ == "__main__":
    main()
