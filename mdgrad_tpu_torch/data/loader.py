"""Padded batching for supervised training.

Port of ``mdgrad_tpu/data/loader.py``, numpy only and kept as a copy.  A
batch is (B, N_max) / (B, P_max) arrays with validity masks, N_max and
P_max taken once over the whole dataset, so every batch has one shape.
The loader draws its order from the same numpy generators as the JAX
package's, so one seed gives the same batches, ``_idx`` and
``batch_weight`` in both.  The port's SchNet takes such a batch as one
disjoint graph (``SchNet.batched_energy``).
"""

import numpy as np


def pad_batch(items, n_max=None, p_max=None):
    """Collate a list of geometry dicts into padded arrays.

    Returns dict with:
      z (B, N) int32 (0-padded), xyz (B, N, 3), atom_mask (B, N) bool,
      nbr_idx (B, P, 2) int32 (padded rows point at N), offsets (B, P, 3),
      nbr_mask (B, P) bool, plus padded targets for any 'energy' /
      '*_grad' keys present.
    """
    B = len(items)
    ns = [len(np.asarray(it["nxyz"])) for it in items]
    n_max = n_max or max(ns)
    have_nbrs = "nbr_list" in items[0]
    if have_nbrs:
        ps = [len(np.asarray(it["nbr_list"])) for it in items]
        p_max = p_max or max(max(ps), 1)

    z = np.zeros((B, n_max), dtype=np.int32)
    xyz = np.zeros((B, n_max, 3), dtype=np.float32)
    atom_mask = np.zeros((B, n_max), dtype=bool)
    out = {}
    if have_nbrs:
        nbr_idx = np.full((B, p_max, 2), n_max, dtype=np.int32)
        offsets = np.zeros((B, p_max, 3), dtype=np.float32)
        nbr_mask = np.zeros((B, p_max), dtype=bool)

    for b, it in enumerate(items):
        nxyz = np.asarray(it["nxyz"])
        n = len(nxyz)
        z[b, :n] = nxyz[:, 0].astype(np.int32)
        xyz[b, :n] = nxyz[:, 1:4]
        atom_mask[b, :n] = True
        if have_nbrs:
            nl = np.asarray(it["nbr_list"])
            p = len(nl)
            if p > p_max:
                raise ValueError(f"nbr list ({p}) exceeds p_max ({p_max})")
            nbr_idx[b, :p] = nl
            offsets[b, :p] = np.asarray(it.get(
                "offsets", np.zeros((p, 3))))[:p]
            nbr_mask[b, :p] = True

    out.update(z=z, xyz=xyz, atom_mask=atom_mask, num_atoms=np.array(ns))
    if have_nbrs:
        out.update(nbr_idx=nbr_idx, offsets=offsets, nbr_mask=nbr_mask)

    for key in items[0]:
        if key in ("nxyz", "nbr_list", "offsets", "num_atoms"):
            continue
        vals = [np.asarray(it[key]) for it in items]
        if vals[0].ndim == 0 or vals[0].size == 1:
            out[key] = np.asarray([float(v.reshape(-1)[0]) for v in vals],
                                  dtype=np.float32)
        elif vals[0].shape[0] == ns[0]:  # per-atom target (e.g. forces)
            arr = np.zeros((B, n_max) + vals[0].shape[1:],
                           dtype=np.float32)
            for b, v in enumerate(vals):
                arr[b, :len(v)] = v
            out[key] = arr
    return out


class PrioritizedSampler:
    """Weighted with-replacement index sampler for priority training.

    Weights start uniform, ``update_weights`` sets per-example priorities
    (e.g. to the example's loss, through ``UpdatePrioritiesHook``), and
    sampling draws in proportion to weight^alpha.
    """

    def __init__(self, n, alpha=1.0, seed=0, min_weight=1e-6):
        self.weights = np.ones(n, dtype=np.float64)
        self.alpha = alpha
        self.min_weight = min_weight
        self.rng = np.random.default_rng(seed)

    def update_weights(self, idx, priorities):
        idx = np.asarray(idx, dtype=int).reshape(-1)
        pri = np.maximum(np.asarray(priorities, dtype=np.float64
                                    ).reshape(-1), self.min_weight)
        self.weights[idx] = pri

    def sample(self, n_draw):
        p = self.weights ** self.alpha
        p = p / p.sum()
        return self.rng.choice(len(self.weights), size=n_draw, p=p)


class DataLoader:
    """Minimal shuffling batch iterator with fixed padded shapes.

    Global (n_max, p_max) are computed once over the dataset so every batch
    has the same shape.  When ``sampler`` (a
    :class:`PrioritizedSampler`) is given, epoch indices are drawn from it
    with replacement and each batch carries ``_idx`` so
    ``UpdatePrioritiesHook`` can feed priorities back.
    """

    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 sampler=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.rng = np.random.default_rng(seed)
        self.n_max = max(len(np.asarray(x))
                         for x in dataset.props["nxyz"])
        if "nbr_list" in dataset.props:
            self.p_max = max(max(len(np.asarray(x))
                                 for x in dataset.props["nbr_list"]), 1)
        else:
            self.p_max = None

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        if self.sampler is not None:
            idx = self.sampler.sample(len(self.dataset))
        else:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                self.rng.shuffle(idx)
        for s in range(0, len(idx), self.batch_size):
            chunk = idx[s:s + self.batch_size]
            items = [self.dataset[int(i)] for i in chunk]
            ids = list(chunk)
            # repeat last item to keep the batch full (masked out via
            # a batch weight)
            weight = np.ones(self.batch_size, dtype=np.float32)
            while len(items) < self.batch_size:
                weight[len(items)] = 0.0
                items.append(items[-1])
                ids.append(ids[-1])
            batch = pad_batch(items, self.n_max, self.p_max)
            batch["batch_weight"] = weight
            batch["_idx"] = np.asarray(ids, dtype=np.int32)
            yield batch
