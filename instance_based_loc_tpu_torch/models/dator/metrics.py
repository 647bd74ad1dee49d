"""ReID evaluation (a copy of the numpy module
`instance_based_loc_tpu/models/dator/metrics.py`): market-style CMC / mAP
(reference `dator/utils/metrics.py:41-150` R1_mAP_eval: L2 norm, distance
matrix, per-query CMC with same-camera-same-id filtering) and k-reciprocal
re-ranking (reference `dator/utils/reranking.py`, toggled by
TEST.RE_RANKING). All numpy, on the host."""

from __future__ import annotations

import numpy as np


def cosine_distmat(query: np.ndarray, gallery: np.ndarray) -> np.ndarray:
    q = query / np.maximum(np.linalg.norm(query, axis=1, keepdims=True), 1e-12)
    g = gallery / np.maximum(np.linalg.norm(gallery, axis=1, keepdims=True), 1e-12)
    return 1.0 - q @ g.T


def euclidean_distmat(query: np.ndarray, gallery: np.ndarray) -> np.ndarray:
    qq = (query ** 2).sum(1)[:, None]
    gg = (gallery ** 2).sum(1)[None, :]
    return np.maximum(qq + gg - 2 * query @ gallery.T, 0.0)


def cmc_map(distmat: np.ndarray, q_pids, g_pids, q_camids=None, g_camids=None,
            max_rank: int = 50) -> tuple[np.ndarray, float]:
    """CMC curve + mAP with the market1501 protocol (same-pid same-cam gallery
    entries are excluded per query — utils/metrics.py:103-150)."""
    nq, ng = distmat.shape
    q_pids = np.asarray(q_pids)
    g_pids = np.asarray(g_pids)
    q_camids = np.zeros(nq, int) if q_camids is None else np.asarray(q_camids)
    g_camids = np.ones(ng, int) if g_camids is None else np.asarray(g_camids)

    indices = np.argsort(distmat, axis=1)
    matches = (g_pids[indices] == q_pids[:, None]).astype(np.int32)

    all_cmc, all_ap = [], []
    for qi in range(nq):
        # drop gallery items with same pid AND same camid as the query
        order = indices[qi]
        remove = (g_pids[order] == q_pids[qi]) & (g_camids[order] == q_camids[qi])
        keep = ~remove
        raw = matches[qi][keep]
        if not raw.any():
            continue
        cmc = raw.cumsum()
        cmc[cmc > 1] = 1
        all_cmc.append(cmc[:max_rank].astype(np.float64))
        num_rel = raw.sum()
        tmp = raw.cumsum() / (np.arange(len(raw)) + 1.0)
        ap = float((tmp * raw).sum() / num_rel)
        all_ap.append(ap)

    if not all_cmc:
        raise ValueError("all queries had no valid gallery")
    # pad cmc rows shorter than max_rank
    all_cmc = [np.pad(c, (0, max(0, max_rank - len(c))), constant_values=c[-1])
               for c in all_cmc]
    cmc = np.stack(all_cmc).mean(0)
    return cmc, float(np.mean(all_ap))


def k_reciprocal_rerank(q_feats: np.ndarray, g_feats: np.ndarray,
                        k1: int = 20, k2: int = 6, lambda_value: float = 0.3
                        ) -> np.ndarray:
    """k-reciprocal encoding re-ranking (Zhong et al., CVPR'17 — the method
    behind reference utils/reranking.py). Returns the re-ranked distmat."""
    feats = np.concatenate([q_feats, g_feats])
    n = len(feats)
    nq = len(q_feats)
    d2 = euclidean_distmat(feats, feats)
    original = d2 / (d2.max(axis=0, keepdims=True) + 1e-12)
    v = np.zeros_like(original, dtype=np.float32)
    ranks = np.argsort(original, axis=1)

    k1_half = max(1, int(round(k1 / 2)))
    for i in range(n):
        fwd = ranks[i, : k1 + 1]
        back = ranks[fwd, : k1 + 1]
        recip = fwd[np.any(back == i, axis=1)]
        expanded = list(recip)
        for cand in recip:
            c_fwd = ranks[cand, : k1_half + 1]
            c_back = ranks[c_fwd, : k1_half + 1]
            c_recip = c_fwd[np.any(c_back == cand, axis=1)]
            if len(np.intersect1d(c_recip, recip)) > 2 / 3 * len(c_recip):
                expanded += list(c_recip)
        expanded = np.unique(expanded)
        weights = np.exp(-original[i, expanded])
        v[i, expanded] = weights / weights.sum()

    if k2 > 1:
        v = np.stack([v[ranks[i, :k2]].mean(0) for i in range(n)])

    inv_index = [np.nonzero(v[:, j])[0] for j in range(n)]
    jaccard = np.zeros((nq, n), np.float32)
    for i in range(nq):
        mins = np.zeros(n, np.float32)
        nz = np.nonzero(v[i])[0]
        for j in nz:
            rows = inv_index[j]
            mins[rows] += np.minimum(v[i, j], v[rows, j])
        jaccard[i] = 1.0 - mins / (2.0 - mins)

    final = jaccard * (1 - lambda_value) + original[:nq] * lambda_value
    return final[:, nq:]
