"""Detection -> memory assignment search (counterpart of
`instance_based_loc_tpu/ops/assignment.py`; replaces the reference's
`utils/similarity_volume.py` SimVolume).

For every C(D, k) subset of detections (k = min(D, 3)) the reference builds a
dense (M+1)^k volume whose entry [i1..ik] is the product of the chosen
similarities (index M = "unassigned", similarity 1), masks non-injective
assignments to -inf and pops argmaxes one at a time. Here the volume is a
broadcast outer product, the injectivity mask a comparison of index grids,
and the pops one stable descending sort of each flattened volume, batched
over the subsets, in the order of `lax.top_k` (ties keep the lower flat
index first; +0.0 ranks above -0.0). The small final selection (dedup, top per assignment length)
stays on the host, as in the reference.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import resolve_device


def _topk_total_order(x: torch.Tensor, k: int):
    """`lax.top_k` of fp32 x over the last dim: the k largest in IEEE total
    order (+0.0 above -0.0, which a float sort holds equal), ties to the
    lower index. Sorts the order-preserving int32 keys of the bits."""
    bits = x.contiguous().view(torch.int32)
    keys = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    _, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx


def _subvolume_topk(rows: torch.Tensor, mem_valid: torch.Tensor, k: int,
                    topk: int):
    """rows (S, k, M+1): each subset's similarity rows with a trailing
    "unassigned" column of 1; mem_valid (M+1,): False marks a padded memory
    slot (never assignable; the unassigned column is always valid).

    Returns (values (S, topk), flat indices (S, topk) int64) of the best
    injective assignments of each subset, a flat index unravelling into k
    coordinates in base M+1."""
    s, _, m1 = rows.shape
    vol = rows[:, 0]
    for i in range(1, k):
        vol = vol[..., None] * rows[:, i].reshape((s,) + (1,) * i + (m1,))
    shape = (m1,) * k
    ar = torch.arange(m1, device=rows.device)
    coords = [ar.reshape((1,) * d + (m1,) + (1,) * (k - d - 1))
              for d in range(k)]
    bad = torch.zeros(shape, dtype=torch.bool, device=rows.device)
    for a in range(k):
        for b in range(a + 1, k):
            bad = bad | ((coords[a] == coords[b]) & (coords[a] != m1 - 1))
    for a in range(k):
        bad = bad | ~mem_valid[coords[a]]
    all_unassigned = torch.ones(shape, dtype=torch.bool, device=rows.device)
    for a in range(k):
        all_unassigned = all_unassigned & (coords[a] == m1 - 1)
    bad = bad | all_unassigned
    vol = torch.where(bad, torch.full_like(vol, float("-inf")), vol)
    return _topk_total_order(vol.reshape(s, -1), topk)


class SimVolume:
    """The reference SimVolume's paths that the pipeline uses
    (`fast_construct_volume` + `get_top_indices_from_subvolumes`), the
    volumes and their top-k computed on `device` in one batched call."""

    def __init__(self, cosine_similarities: np.ndarray, device="cuda"):
        sims = np.asarray(cosine_similarities, np.float32)
        if sims.ndim != 2:
            raise ValueError(f"similarities must be (D, M); got {sims.shape}")
        self.sims = sims
        d, m = sims.shape
        aug = np.ones((d, m + 1), np.float32)
        aug[:, :-1] = sims
        self.aug = aug
        self.device = resolve_device(device)
        self._subsets: list[tuple[int, ...]] | None = None
        self._topk_vals: np.ndarray | None = None
        self._topk_idx: np.ndarray | None = None
        self._k: int | None = None

    def fast_construct_volume(self, subvolume_size: int,
                              num_per_length: int = 4) -> None:
        d, m1 = self.aug.shape
        if d < 1:
            raise ValueError("no detections")
        k = min(subvolume_size, d)
        self._k = k
        self._subsets = list(itertools.combinations(range(d), k))
        rows = torch.as_tensor(self.aug[np.array(self._subsets)],
                               device=self.device)            # (S, k, M+1)
        mem_valid = torch.ones((m1,), dtype=torch.bool, device=self.device)
        # pop budget per subvolume (reference: num_per_length * D * 4)
        budget = min(num_per_length * d * 4, m1 ** k)
        vals, idx = _subvolume_topk(rows, mem_valid, k, budget)
        self._topk_vals = vals.cpu().numpy()
        self._topk_idx = idx.cpu().numpy()

    def get_top_indices_from_subvolumes(self, num_per_length: int = 3):
        """The reference's selection rules: gather all popped entries,
        convert them to (detection, memory) pair lists without the
        "unassigned" coordinates, dedup, then keep the top max(1, L) by
        score for each assignment length L in 1..D."""
        if self._topk_vals is None:
            raise RuntimeError("call fast_construct_volume first")
        d, m1 = self.aug.shape
        unassigned = m1 - 1
        k = self._k

        entries = []  # (assignment, score)
        for subset, vals, idxs in zip(self._subsets, self._topk_vals,
                                      self._topk_idx):
            coords = np.stack(np.unravel_index(idxs, (m1,) * k), axis=-1)
            for val, coord in zip(vals, coords):
                if not np.isfinite(val):
                    continue
                assn = [[det, int(mem)] for det, mem in zip(subset, coord)
                        if mem != unassigned]
                if not assn:
                    continue
                entries.append((assn, float(val)))

        seen = []
        deduped = []
        for assn, val in entries:
            key = tuple(map(tuple, assn))
            if key in seen:
                continue
            seen.append(key)
            deduped.append((assn, val))

        selected = []
        for length in range(1, d + 1):
            of_len = [e for e in deduped if len(e[0]) == length]
            of_len.sort(key=lambda e: e[1], reverse=True)
            selected += of_len[: max(1, length)]

        return [assn for assn, _ in selected]


def top_assignments(closest_similarities: np.ndarray,
                    subvolume_size: int = 3,
                    num_per_length: int = 4,
                    device="cuda") -> list[list[list[int]]]:
    """One call: the volume, its top-k on `device`, the host selection."""
    sv = SimVolume(closest_similarities, device=device)
    sv.fast_construct_volume(min(len(closest_similarities), subvolume_size),
                             num_per_length=num_per_length)
    return sv.get_top_indices_from_subvolumes(num_per_length=num_per_length)
