"""The port's ``viz.py`` and ``train/plots.plot_vacf`` against the JAX
package's (``mdgrad_tpu/viz.py``, ``mdgrad_tpu/train/plots.py``).

The same numpy-seeded frames go through both ``export_xyz``; the files
must be equal byte for byte, from a float32 tensor as from the array.
Neither nglview nor mdtraj is installed here, so both packages'
``xyz_to_nglview`` raise the same ImportError.
"""

import numpy as np
import pytest
import torch

from mdgrad_tpu import viz as viz_j
from mdgrad_tpu.train import plots as plots_j
from mdgrad_tpu_torch import viz
from mdgrad_tpu_torch.train import plots


def _frames():
    rng = np.random.default_rng(0)
    return rng.uniform(-5.0, 5.0, (3, 7, 3)).astype(np.float32)


@pytest.mark.parametrize("numbers", [None, [14] * 5 + [8, 1]])
def test_export_xyz_bytes_equal_jax(tmp_path, numbers):
    frames = _frames()
    ref = viz_j.export_xyz(str(tmp_path / "jax.xyz"), frames,
                           numbers=numbers)
    got = viz.export_xyz(str(tmp_path / "port.xyz"), torch.tensor(frames),
                         numbers=numbers)
    arr = viz.export_xyz(str(tmp_path / "array.xyz"), frames,
                         numbers=numbers)
    assert got == str(tmp_path / "port.xyz")
    ref_bytes = open(ref, "rb").read()
    assert open(got, "rb").read() == ref_bytes
    assert open(arr, "rb").read() == ref_bytes
    assert ref_bytes.count(b"\n") == 3 * (7 + 2)


def test_xyz_to_nglview_raises_like_jax():
    with pytest.raises(ImportError) as e_j:
        viz_j.xyz_to_nglview(_frames())
    with pytest.raises(ImportError, match="export_xyz") as e:
        viz.xyz_to_nglview(torch.tensor(_frames()))
    assert str(e.value) == str(e_j.value)


@pytest.mark.parametrize("target", [True, False])
def test_plot_vacf_writes_what_jax_writes(tmp_path, target):
    """The same file name in both packages, an image of the same size;
    with matplotlib absent both write nothing."""
    rng = np.random.default_rng(1)
    vacf = np.exp(-np.arange(20) / 5.0) + 0.01 * rng.standard_normal(20)
    tgt = np.exp(-np.arange(15) / 5.0) if target else None
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    plots_j.plot_vacf(vacf, tgt, "lj", str(tmp_path / "jax"), dt=0.005)
    plots.plot_vacf(torch.tensor(vacf), tgt, "lj", str(tmp_path / "port"),
                    dt=0.005)
    names_j = sorted(p.name for p in (tmp_path / "jax").iterdir())
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == names_j
    if plots._plt() is not None:
        assert names == ["vacf_lj.jpg"]
        from matplotlib.image import imread
        assert (imread(tmp_path / "port" / "vacf_lj.jpg").shape
                == imread(tmp_path / "jax" / "vacf_lj.jpg").shape)
