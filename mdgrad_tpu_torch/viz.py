"""Trajectory visualization helpers.

Port of ``mdgrad_tpu/viz.py``.  nglview and mdtraj are optional: without
them ``xyz_to_nglview`` raises and points to ``export_xyz``, whose
multi-frame ``.xyz`` any standard viewer opens.  Frames may be numpy
arrays or tensors on any device.
"""

from .md.utils import write_xyz


def xyz_to_nglview(frames, numbers=None):
    """An nglview widget for (F, N, 3) frames (needs nglview and mdtraj);
    raises ImportError with a pointer to the xyz fallback otherwise."""
    try:
        import tempfile
        import mdtraj
        import nglview
    except ImportError as e:
        raise ImportError(
            "nglview/mdtraj not installed; use export_xyz() and open the "
            "file in a viewer instead") from e
    with tempfile.NamedTemporaryFile(suffix=".xyz", delete=False) as f:
        write_xyz(f.name, frames, numbers=numbers)
        traj = mdtraj.load_xyz(f.name, top=None)
    return nglview.show_mdtraj(traj)


def export_xyz(filename, frames, numbers=None):
    """Always-available fallback: dump (F, N, 3) frames to a multi-frame
    .xyz; returns ``filename``."""
    write_xyz(filename, frames, numbers=numbers)
    return filename
