"""``scripts/run_stripe_torch.py --dry_run -device cpu``: the 2-D
stripe fit (625 sites, the SplineOverlap target, the GaussianCore prior)
through the port's ``fit_lj``, 2 epochs of 11 steps after 30 pretraining
iterations.  The test passes ``-cutoff 3.0`` (the script's 8.0 makes a
table of ~320 neighbors a site, minutes of CPU): the plumbing, the 2-D
system and the prior are the same.  Its configuration is held to the
JAX script's in tests/test_torch_scripts.py."""

import numpy as np
import torch

from test_torch_scripts import load_script


def test_run_stripe_dry_run(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = load_script("run_stripe_torch.py").main(
            ["--dry_run", "-device", "cpu", "-cutoff", "3.0", "-logdir",
             str(tmp_path)], log=lambda m: None)
    finally:
        torch.set_num_threads(n)
    assert len(out["loss_log"]) == 2 and np.isfinite(out["objective"])
    assert (tmp_path / "0" / "paramset.json").exists()
