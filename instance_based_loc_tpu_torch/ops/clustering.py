"""Host-side clustering (counterpart of
`instance_based_loc_tpu/ops/clustering.py`): DBSCAN, which replaces Open3D's
`cluster_dbscan`, and agglomerative clustering on a precomputed distance
matrix.

DBSCAN gives the same labels as the JAX package's numpy path: neighbours
are the pairs with sum((p - q)^2) <= eps^2 in float64, a point is core
iff it has >= min_points neighbours (self included), clusters are the
connected components of core points, a border point joins the cluster of its
lowest-indexed core neighbour in the numpy path's cell order (the neighbour
its candidate scan meets first), and clusters are numbered by their first
core point in that order. The JAX package also hands large inputs to a
compiled helper; the port does not load it.

Memory grows with the number of points, not with the number of neighbour
pairs, so overlapping objects (the same surface seen by hundreds of
detections: billions of pairs within eps) stay cheap. Space is cut into
sub-cells of side eps / 2, whose points are all neighbours of each other
(diameter 0.87 eps):

* a point in a sub-cell of >= min_points points is core; the others count
  their neighbours with a k-d tree (lengths only);
* the core points of one sub-cell are one component; two sub-cells within
  reach join when their representatives (the core point nearest each
  centre) are neighbours, and otherwise, if they are not joined already,
  when an exact search finds any core pair within eps;
* a non-core point has fewer than min_points neighbours, so its neighbour
  list is short: the border rule reads it directly.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree

_REACH = 2            # sub-cells of side eps / 2: neighbours lie <= 2 away
_PAIR_BLOCK = 1 << 20  # distances per block of an exact sub-cell check


def _codes(keys: np.ndarray, lo: np.ndarray, span: np.ndarray) -> np.ndarray:
    k = keys - lo
    return (k[:, 0] * span[1] + k[:, 1]) * span[2] + k[:, 2]


def _any_within(a: np.ndarray, b: np.ndarray, eps2: float) -> bool:
    """Whether some row of a and some row of b are neighbours (exact test),
    checked block by block with an early exit."""
    rows = max(1, _PAIR_BLOCK // max(len(b), 1))
    for s in range(0, len(a), rows):
        if (((a[s:s + rows, None, :] - b[None, :, :]) ** 2).sum(-1)
                <= eps2).any():
            return True
    return False


def dbscan(points: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """Labels (N,) int32: cluster id >= 0 or -1 for noise."""
    points = np.asarray(points, np.float64)
    n = len(points)
    if n == 0:
        return np.zeros(0, np.int32)
    cell = np.floor(points / eps).astype(np.int64)
    order = np.lexsort((cell[:, 2], cell[:, 1], cell[:, 0]))
    pts = points[order]
    eps2 = eps * eps
    tree = cKDTree(pts)
    # radii that bracket the exact test: the tree at r_hi misses no
    # neighbour, and every point it finds at r_lo is one
    r_hi = eps * (1 + 1e-9) + 1e-12
    r_lo = eps * (1 - 1e-9)

    # core points
    sub = np.floor(pts / (eps / 2)).astype(np.int64)
    lo = sub.min(0) - _REACH
    span = sub.max(0) + _REACH + 1 - lo
    sub_code = _codes(sub, lo, span)
    uniq, sub_id, sub_count = np.unique(sub_code, return_inverse=True,
                                        return_counts=True)
    core = sub_count[sub_id] >= min_points
    rest = np.nonzero(~core)[0]
    if len(rest):
        c_hi = tree.query_ball_point(pts[rest], r_hi, return_length=True)
        c_lo = tree.query_ball_point(pts[rest], r_lo, return_length=True)
        core[rest[c_lo >= min_points]] = True
        for p in rest[(c_lo < min_points) & (c_hi >= min_points)]:
            nb = np.asarray(tree.query_ball_point(pts[p], r_hi), np.int64)
            core[p] = (((pts[nb] - pts[p]) ** 2).sum(-1) <= eps2).sum() \
                >= min_points

    labels = np.full(n, -1, np.int64)
    core_idx = np.nonzero(core)[0]
    if len(core_idx):
        # one node per sub-cell holding core points
        node_sub, node = np.unique(sub_id[core_idx], return_inverse=True)
        n_nodes = len(node_sub)
        by_node = core_idx[np.argsort(node, kind="stable")]
        starts = np.searchsorted(node[np.argsort(node, kind="stable")],
                                 np.arange(n_nodes + 1))
        # representative: the core point nearest its sub-cell's centre
        keys = sub[core_idx]
        centre = (keys + 0.5) * (eps / 2)
        dc = ((pts[core_idx] - centre) ** 2).sum(-1)
        rep = core_idx[np.lexsort((dc, node))][starts[:-1]]
        # node pairs within reach, each once
        node_code = uniq[node_sub]
        a_list, b_list = [], []
        r = np.arange(-_REACH, _REACH + 1)
        for off in np.stack(np.meshgrid(r, r, r, indexing="ij"), -1) \
                .reshape(-1, 3):
            if tuple(off) <= (0, 0, 0):
                continue
            target = node_code + (off[0] * span[1] + off[1]) * span[2] + off[2]
            hit = np.searchsorted(node_code, target)
            hit = np.minimum(hit, n_nodes - 1)
            ok = node_code[hit] == target
            a_list.append(np.nonzero(ok)[0])
            b_list.append(hit[ok])
        a = np.concatenate(a_list)
        b = np.concatenate(b_list)
        sure = ((pts[rep[a]] - pts[rep[b]]) ** 2).sum(-1) <= eps2
        graph = coo_matrix((np.ones(int(sure.sum()), np.int8),
                            (a[sure], b[sure])), shape=(n_nodes, n_nodes))
        _, comp = connected_components(graph, directed=False)
        parent = np.arange(comp.max() + 1)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for i in np.nonzero(~sure & (comp[a] != comp[b]))[0]:
            ra, rb = find(comp[a[i]]), find(comp[b[i]])
            if ra != rb and _any_within(
                    pts[by_node[starts[a[i]]:starts[a[i] + 1]]],
                    pts[by_node[starts[b[i]]:starts[b[i] + 1]]], eps2):
                parent[max(ra, rb)] = min(ra, rb)
        roots = np.array([find(c) for c in range(len(parent))])
        comp_of = roots[comp[node]]                 # per core point

        # number components by their first core point in sorted order
        first = np.full(len(parent), n, np.int64)
        np.minimum.at(first, comp_of, core_idx)
        used = first < n
        rank = np.full(len(parent), -1, np.int64)
        rank[np.nonzero(used)[0][np.argsort(first[used])]] = np.arange(
            int(used.sum()))
        labels[core_idx] = rank[comp_of]

        # border points: the lowest-indexed core neighbour
        noncore = np.nonzero(~core)[0]
        if len(noncore):
            nbrs = tree.query_ball_point(pts[noncore], r_hi)
            lengths = np.fromiter((len(x) for x in nbrs), np.int64,
                                  len(nbrs))
            if lengths.sum():
                flat = np.concatenate([np.asarray(x, np.int64) for x in nbrs
                                       if len(x)])
                owner = np.repeat(noncore, lengths)
                keep = core[flat] & (((pts[flat] - pts[owner]) ** 2).sum(-1)
                                     <= eps2)
                attach = np.full(n, n, np.int64)
                np.minimum.at(attach, owner[keep], flat[keep])
                border = ~core & (attach < n)
                labels[border] = labels[attach[border]]

    out = np.full(n, -1, np.int64)
    out[order] = labels
    return out.astype(np.int32)


def agglomerative_precomputed(distance_matrix: np.ndarray,
                              distance_threshold: float,
                              linkage: str = "average") -> np.ndarray:
    """Agglomerative clustering on a precomputed distance matrix (copy of
    the JAX package's numpy function): merge the closest pair until the
    smallest inter-cluster distance reaches `distance_threshold`, with
    Lance-Williams updates for 'average' and 'complete' linkage. The same
    partition as sklearn's AgglomerativeClustering(n_clusters=None,
    distance_threshold=t, metric='precomputed'). O(N^3): meant for the
    few hundred objects of a memory."""
    d = np.array(distance_matrix, np.float64)
    n = d.shape[0]
    if d.shape != (n, n):
        raise ValueError(f"distance matrix of shape {d.shape} is not square")
    if linkage not in ("average", "complete"):
        raise ValueError(linkage)
    if n == 1:
        return np.zeros(1, np.int32)
    np.fill_diagonal(d, np.inf)

    active = np.ones(n, bool)
    sizes = np.ones(n, np.int64)
    members: list[list[int]] = [[i] for i in range(n)]

    while active.sum() > 1:
        sub = np.where(active)[0]
        dsub = d[np.ix_(sub, sub)]
        i_s, j_s = np.unravel_index(np.argmin(dsub), dsub.shape)
        if dsub[i_s, j_s] >= distance_threshold:
            break
        a, b = sub[i_s], sub[j_s]
        # merge b into a
        for c in sub:
            if c == a or c == b:
                continue
            if linkage == "average":
                new = (sizes[a] * d[a, c] + sizes[b] * d[b, c]) \
                    / (sizes[a] + sizes[b])
            else:
                new = max(d[a, c], d[b, c])
            d[a, c] = d[c, a] = new
        sizes[a] += sizes[b]
        members[a] += members[b]
        active[b] = False
        d[b, :] = np.inf
        d[:, b] = np.inf

    labels = np.zeros(n, np.int32)
    for label, root in enumerate(np.where(active)[0]):
        for m in members[root]:
            labels[m] = label
    return labels
