"""Host-side DBSCAN (counterpart of `instance_based_loc_tpu/ops/clustering.py:
dbscan`; replaces Open3D's `cluster_dbscan`).

Same labels as the JAX package's numpy path, computed from an eps-graph
instead of its per-point Python loop: the neighbour pairs come from a
k-d tree and are kept where the numpy path keeps them
(sum((p - q)^2) <= eps^2 in float64), core points are joined by
`connected_components`, and border points join the cluster of their
lowest-indexed core neighbour in the numpy path's cell order, which is the
neighbour its candidate scan meets first. The JAX package also hands large
inputs to a compiled helper; the port does not load it.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree


def dbscan(points: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """Labels (N,) int32: cluster id >= 0 or -1 for noise.

    A point is core iff it has >= min_points neighbours within eps (self
    included); clusters are the connected components of core points under
    the eps-graph; a border point joins a neighbouring core's cluster; the
    rest are noise. Cluster ids number the clusters in the order their first
    core point appears when points are sorted by their eps-cell."""
    points = np.asarray(points, np.float64)
    n = len(points)
    if n == 0:
        return np.zeros(0, np.int32)
    cell = np.floor(points / eps).astype(np.int64)
    order = np.lexsort((cell[:, 2], cell[:, 1], cell[:, 0]))
    pts = points[order]

    # neighbour pairs (i < j) in sorted-index space; the tree's radius has
    # slack and the exact test is the numpy path's
    pairs = cKDTree(pts).query_pairs(eps * (1 + 1e-9) + 1e-12,
                                     output_type="ndarray")
    i, j = pairs[:, 0], pairs[:, 1]
    keep = ((pts[i] - pts[j]) ** 2).sum(-1) <= eps * eps
    i, j = i[keep], j[keep]
    counts = 1 + np.bincount(i, minlength=n) + np.bincount(j, minlength=n)
    core = counts >= min_points

    both = core[i] & core[j]
    graph = coo_matrix((np.ones(int(both.sum()), np.int8), (i[both], j[both])),
                       shape=(n, n))
    _, comp = connected_components(graph, directed=False)

    labels = np.full(n, -1, np.int64)
    core_idx = np.nonzero(core)[0]
    if len(core_idx):
        # number components by their first core point in sorted order
        first = np.full(comp.max() + 1, n, np.int64)
        np.minimum.at(first, comp[core_idx], core_idx)
        rank = np.empty(len(first), np.int64)
        used = first < n
        rank[np.argsort(first)] = np.arange(len(first))
        rank[~used] = -1
        labels[core_idx] = rank[comp[core_idx]]

    # border points: the lowest-indexed core neighbour
    attach = np.full(n, n, np.int64)
    border_i = ~core[i] & core[j]
    np.minimum.at(attach, i[border_i], j[border_i])
    border_j = ~core[j] & core[i]
    np.minimum.at(attach, j[border_j], i[border_j])
    border = ~core & (attach < n)
    labels[border] = labels[attach[border]]

    out = np.full(n, -1, np.int64)
    out[order] = labels
    return out.astype(np.int32)
