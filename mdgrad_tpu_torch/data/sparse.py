"""Sparse-tensor converters.

Port of ``mdgrad_tpu/data/sparse.py``: a dense array to a sparse COO
tensor and back, ``torch.sparse_coo_tensor`` where the JAX package uses
``jax.experimental.sparse.BCOO``.  The result's ``_nnz()`` is BCOO's
``nse``.
"""

import torch


def sparsify_array(arr, threshold=0.0):
    """Dense array -> coalesced sparse COO tensor, dropping the entries
    with |x| <= ``threshold`` (the zeros always)."""
    arr = torch.as_tensor(arr)
    if threshold > 0:
        arr = torch.where(arr.abs() > threshold, arr, torch.zeros_like(arr))
    return arr.to_sparse().coalesce()


def densify(sp):
    return sp.to_dense()


def sparsify_tensor(tensor, threshold=0.0):
    """Alias of :func:`sparsify_array`, under the JAX package's second
    name."""
    return sparsify_array(tensor, threshold)
