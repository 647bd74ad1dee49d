"""The localisation query and the memory-build frame step (counterpart of
`instance_based_loc_tpu/ops/localise_kernels.py`).

  _prepare_body          backproject + radius outliers + top-N detections +
                         per-detection subsample + per-exemplar cosine
                         similarities + the SimVolume subset top-k.
  _select_body           the reference's assignment selection rules
                         (dedup, top max(1, L) per length L) as tensor ops.
  _register_select_body  per-assignment union gather + subsample + normals
                         + FPFH + RANSAC + centroid-Kabsch init + multi-scale
                         coloured ICP + full-cloud evaluation + centroid gate
                         + best-assignment argmax + pose composition.
  localise_frame         the three above as one query.
  localise_frames_batched  G queries as one program with a leading query
                         axis, each query giving what localise_frame gives
                         it, bit for bit.
  process_frame          memory build: backproject + outliers + optional
                         noise + world transform + per-mask subsample.

Each `vmap` of the reference is a batch dimension here and each `lax.scan`
a Python loop. Random draws come from an explicit `torch.Generator`; they
cannot reproduce JAX's draws, so the op tests feed both sides the same
numbers (`uniform=` / `samples=`) and the end-to-end tests gate on quality
thresholds. Where the reference's `lax.top_k` can meet ties (pixel counts,
SimVolume entries, selection scores), a stable descending sort keeps its
lower-index-first order.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from .backprojection import backproject
from .fpfh import compute_fpfh
from .icp import evaluate_transform_arrays, icp, icp_scheduled
from .kabsch import kabsch_transform
from .normals import estimate_normals
from .outliers import radius_outlier_keep_mask
from .pointcloud import gather_rows, gather_values, masked_mean
from .ransac import feature_correspondences, ransac_registration
from .transforms import (rotmat_to_quat_xyzw, transform_points,
                         transform_points_kinect)


def make_subsets(top_n: int, k: int = 3) -> np.ndarray:
    """All C(top_n, k) detection-slot subsets."""
    return np.asarray(list(itertools.combinations(range(top_n), k)), np.int32)


def _topk_stable(x: torch.Tensor, k: int):
    """lax.top_k over the last dim: the k largest, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@functools.lru_cache(maxsize=None)
def _fixed_perm(n: int, device) -> torch.Tensor:
    """The reference's fixed pseudo-random permutation of range(n), made
    once per device, so a captured program copies nothing from the host."""
    return torch.as_tensor(np.random.default_rng(0x5eed).permutation(n)
                           .astype(np.int64), device=device)


def _masked_subsample_linear(valid: torch.Tensor, cap: int,
                             generator: torch.Generator | None = None,
                             shift: torch.Tensor | None = None):
    """O(P) uniform masked subsample: walk the pool in a randomly rotated
    fixed permutation and keep the first `cap` valid rows (cumsum +
    searchsorted, no sort). valid (..., n); `shift` (...) is the rotation
    (drawn when None). Returns (idx (..., cap), keep (..., cap)).

    The reference's alternative to `_masked_subsample` for pools of 2^15 rows
    and more, off by default there; nothing on the port's path calls it until
    a measurement on the card shows a pool large enough to need it."""
    n = valid.shape[-1]
    dev = valid.device
    if shift is None:
        shift = torch.randint(0, n, valid.shape[:-1], generator=generator,
                              device=dev)
    perm = _fixed_perm(n, dev)
    # jnp.roll(perm, s)[i] == perm[(i - s) % n]
    pos_in_perm = (torch.arange(n, device=dev) - shift[..., None]) % n
    rows = perm[pos_in_perm]                                   # (..., n)
    c = torch.cumsum(gather_values(valid.to(torch.int32), rows), dim=-1)
    targets = torch.arange(1, cap + 1, device=dev).expand(
        valid.shape[:-1] + (cap,)).contiguous()
    pos = torch.searchsorted(c.contiguous(), targets.to(c.dtype))
    idx = gather_values(rows, torch.clamp(pos, 0, n - 1))
    total = c[..., -1:]
    keep = torch.arange(cap, device=dev) < torch.clamp(total, max=cap)
    return idx, keep


def _masked_subsample(valid: torch.Tensor, cap: int,
                      generator: torch.Generator | None = None,
                      uniform: torch.Tensor | None = None):
    """Pick up to `cap` valid rows of each (..., n) pool uniformly at random
    (all of them when count <= cap). Returns (idx (..., cap), keep
    (..., cap)) with valid rows first, in random order. `uniform` (..., n)
    replaces the random scores, so a test can feed in the reference's."""
    n = valid.shape[-1]
    if uniform is None:
        uniform = torch.rand(valid.shape, generator=generator,
                             device=valid.device)
    scores = torch.where(valid, uniform, torch.full_like(uniform, -torch.inf))
    if cap >= n:   # pool smaller than the budget: take everything, pad
        top, idx = torch.sort(scores, dim=-1, descending=True)
        pad = cap - n
        idx = torch.nn.functional.pad(idx, (0, pad))
        top = torch.nn.functional.pad(top, (0, pad), value=-torch.inf)
        return idx, torch.isfinite(top)
    top, idx = torch.topk(scores, cap, dim=-1, sorted=True)
    return idx, torch.isfinite(top)


def _masked_median(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """np.median over the valid entries of the last dim (mean of the two
    middles for even counts); +inf when nothing is valid."""
    n = values.shape[-1]
    v = torch.sort(torch.where(valid, values, torch.full_like(values, torch.inf)),
                   dim=-1).values
    cnt = torch.sum(valid.to(torch.int64), dim=-1)
    lo = torch.clamp((cnt - 1) // 2, 0, n - 1)
    hi = torch.clamp(cnt // 2, 0, n - 1)
    med = 0.5 * (gather_values(v, lo[..., None])[..., 0]
                 + gather_values(v, hi[..., None])[..., 0])
    return torch.where(cnt > 0, med, torch.full_like(med, torch.inf))


# --------------------------------------------------------------------------- #
# frame preparation
# --------------------------------------------------------------------------- #
def _prepare_body(depth, rgb, masks, det_embs, det_valid,
                  mem_ex, mem_ex_valid, mem_valid, subsets,
                  fx, fy, radius, generator, *,
                  top_n: int, det_cap: int, budget: int,
                  outlier_passes: int, nb_points: int,
                  min_det_points: int = 16):
    """The query side of localise (reference object_memory.py:888-984).

    depth (H, W) f32; rgb (H, W, 3); masks (Dpad, H, W) bool with
    Dpad >= top_n; det_embs (Dpad, E); det_valid (Dpad,) bool; mem_ex
    (Mpad, Epad, E) unit-norm exemplars; mem_ex_valid (Mpad, Epad);
    mem_valid (Mpad,); subsets (S, k) from make_subsets(top_n).
    outlier_passes: 0 = none, 1 = backprojection cleanup, 2 = + the second
    pre-registration cleanup.

    Returns (fetch, kept): fetch holds order, counts, active (top_n,), sims
    (top_n, Mpad), vol_vals / vol_idx (S, budget); kept holds the
    per-detection camera-frame subsamples sel_pts / sel_cols / sel_msk
    (top_n, det_cap, ...), sel_cent (top_n, 3) and active."""
    d_pad = masks.shape[0]
    m_pad = mem_valid.shape[0]
    k = subsets.shape[1]

    points, valid = backproject(depth, fx, fy)
    colors = (rgb.to(torch.float32) / 255.0).reshape(-1, 3)
    pm = masks.reshape(d_pad, -1) & valid[None, :] & det_valid[:, None]
    for _ in range(outlier_passes):
        pm = pm & radius_outlier_keep_mask(points, pm, radius, nb_points)

    counts = torch.sum(pm, dim=1)
    # top-N largest clouds (object_memory.py:900-908); counts can tie
    ocounts, order = _topk_stable(counts, top_n)
    omask = pm[order]                                        # (top_n, P)

    # active slots: >= min points, and never more detections than memory
    # objects (counts are sorted descending, so both keep a prefix)
    m_count = torch.sum(mem_valid.to(torch.int64))
    active = ((ocounts >= min_det_points)
              & (torch.arange(top_n, device=counts.device) < m_count))

    sel_idx, sel_keep = _masked_subsample(omask, det_cap, generator)
    sel_pts = points[sel_idx]                                # (top_n, cap, 3)
    sel_cols = colors[sel_idx]
    sel_msk = sel_keep & active[:, None]
    sel_cent = masked_mean(points[None], omask)              # (top_n, 3)

    # per-exemplar max cosine (object_memory.py:913-936)
    q = det_embs[order]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    ex_sims = torch.einsum("ne,mke->nmk", q, mem_ex)
    ex_sims = torch.where(mem_ex_valid[None], ex_sims,
                          torch.full_like(ex_sims, -torch.inf))
    sims = torch.amax(ex_sims, dim=-1)                       # (top_n, Mpad)
    sims = torch.where(mem_valid[None, :] & active[:, None], sims,
                       torch.zeros_like(sims))

    # SimVolume subset top-k (reference similarity_volume.py:102-164)
    aug = torch.cat([sims, torch.ones_like(sims[:, :1])], dim=1)
    m1 = m_pad + 1
    unassigned = m1 - 1
    dev = sims.device
    coords = [torch.arange(m1, device=dev).reshape(
        (1,) + (1,) * d + (m1,) + (1,) * (k - 1 - d)) for d in range(k)]
    mem_ok = torch.cat([mem_valid, torch.ones_like(mem_valid[:1])])  # (m1,)
    static_bad = torch.zeros((1,) + (m1,) * k, dtype=torch.bool, device=dev)
    for a in range(k):
        for b in range(a + 1, k):
            static_bad = static_bad | ((coords[a] == coords[b])
                                       & (coords[a] != unassigned))
        static_bad = static_bad | ~mem_ok[coords[a]]
    all_un = torch.ones_like(static_bad)
    for a in range(k):
        all_un = all_un & (coords[a] == unassigned)
    static_bad = static_bad | all_un

    def volumes(sub):                                        # sub (s, k)
        rows = aug[sub]                                      # (s, k, m1)
        vol = rows[:, 0]
        for i in range(1, k):
            vol = vol[..., None] * rows[:, i].reshape(
                (rows.shape[0],) + (1,) * i + (m1,))
        bad = static_bad.clone()
        for a in range(k):
            # inactive detection slots may only be "unassigned"
            inactive = ~active[sub[:, a]].reshape((-1,) + (1,) * k)
            bad = bad | (inactive & (coords[a] != unassigned))
        vol = torch.where(bad, torch.full_like(vol, -torch.inf), vol)
        return _topk_stable(vol.reshape(vol.shape[0], -1), budget)

    # small memories: every subset volume at once; big ones one subset at a
    # time so peak memory stays one (m_pad+1)^k volume (the reference's
    # vmap / lax.map rule)
    if subsets.shape[0] * m1 ** k <= 1 << 20:
        vol_vals, vol_idx = volumes(subsets)
    else:
        parts = [volumes(subsets[i:i + 1]) for i in range(subsets.shape[0])]
        vol_vals = torch.cat([p[0] for p in parts])
        vol_idx = torch.cat([p[1] for p in parts])

    fetch = dict(order=order, counts=ocounts, active=active, sims=sims,
                 vol_vals=vol_vals, vol_idx=vol_idx)
    kept = dict(sel_pts=sel_pts, sel_cols=sel_cols, sel_msk=sel_msk,
                sel_cent=sel_cent, active=active)
    return fetch, kept


# --------------------------------------------------------------------------- #
# assignment selection
# --------------------------------------------------------------------------- #
def _select_body(subsets, vol_vals, vol_idx, m_pad: int, a_pad: int):
    """The reference's selection rules (similarity_volume.py:213-270) as
    tensor ops: decode the popped entries, dedup identical assignments
    across subvolumes (lexicographic order on canonical pair codes, then
    value descending, then index), keep the top max(1, L) by score per
    assignment length L, pad to a_pad.

    Returns (assn_det (a_pad, k), assn_mem (a_pad, k), pair_valid
    (a_pad, k), assn_valid (a_pad,))."""
    s, budget = vol_vals.shape
    k = subsets.shape[1]
    m1 = m_pad + 1
    n = s * budget
    dev = vol_vals.device

    vals = vol_vals.reshape(n)
    rem = vol_idx.reshape(n)
    coords = []
    for _ in range(k):
        coords.append(rem % m1)
        rem = rem // m1
    coords = torch.stack(coords[::-1], dim=-1)                 # (N, k)
    dets = subsets.to(torch.int64)[:, None, :].expand(s, budget, k).reshape(n, k)
    pairs = coords != (m1 - 1)
    lengths = torch.sum(pairs, dim=-1)
    valid = torch.isfinite(vals) & (lengths > 0)

    # lexicographic stable order by (pair codes..., -value, index): stable
    # sorts from the least significant key to the most
    pair_code = torch.where(pairs, dets * m1 + coords + 1,
                            torch.zeros_like(coords))
    sidx = torch.sort(-vals, stable=True).indices
    for j in range(k - 1, -1, -1):
        sidx = sidx[torch.sort(pair_code[sidx, j], stable=True).indices]
    skeys = pair_code[sidx]
    # row 0 always starts a run (a where, not an element store: a store of
    # a host scalar into a 0-d view is a host copy, which a captured
    # program cannot hold)
    first = torch.any(skeys != torch.roll(skeys, 1, dims=0), dim=-1) \
        | (torch.arange(n, device=dev) == 0)

    vals_s = vals[sidx]
    keep = first & valid[sidx]
    lengths_s = lengths[sidx]

    rows, row_ok = [], []
    for length in range(1, k + 1):
        sc = torch.where(keep & (lengths_s == length), vals_s,
                         torch.full_like(vals_s, -torch.inf))
        tv, ti = _topk_stable(sc, max(1, length))
        rows.append(sidx[ti])
        row_ok.append(torch.isfinite(tv))
    rows = torch.cat(rows)
    row_ok = torch.cat(row_ok)
    pad = a_pad - rows.shape[0]
    if pad < 0:
        raise ValueError(f"a_pad {a_pad} < {rows.shape[0]} selected rows")
    rows = torch.nn.functional.pad(rows, (0, pad))
    row_ok = torch.nn.functional.pad(row_ok, (0, pad))
    assn_det = dets[rows]
    assn_mem = torch.clamp(coords[rows], max=m_pad - 1)   # clamp "unassigned"
    pair_valid = pairs[rows] & row_ok[:, None]
    return assn_det, assn_mem, pair_valid, row_ok


def select_assignments(subsets: np.ndarray, vol_vals: np.ndarray,
                       vol_idx: np.ndarray, m_pad: int,
                       num_per_length: int = 4) -> list[list[list[int]]]:
    """Host numpy form of the selection rules (the reference's
    `get_top_indices_from_subvolumes`, similarity_volume.py:213-270).
    Detection indices are in ordered-slot space (0 = largest cloud)."""
    k = subsets.shape[1]
    m1 = m_pad + 1
    s, budget = vol_vals.shape
    n = s * budget
    coords = np.stack(np.unravel_index(vol_idx.reshape(-1), (m1,) * k),
                      axis=-1).reshape(n, k)
    dets = np.broadcast_to(subsets[:, None, :], (s, budget, k)).reshape(n, k)
    vals = vol_vals.reshape(n)
    pairs = coords != m_pad
    lengths = pairs.sum(1)
    ok = np.isfinite(vals) & (lengths > 0)

    pair_code = np.where(pairs, dets.astype(np.int64) * m1 + coords + 1, 0)
    base = np.int64(subsets.max() + 1) * m1 + 1
    key = np.zeros(n, np.int64)
    for j in range(k):
        key = key * base + pair_code[:, j]

    idx = np.nonzero(ok)[0]
    if len(idx) == 0:
        return []
    _, first = np.unique(key[idx], return_index=True)
    idx = idx[first]

    selected: list[int] = []
    for length in range(1, int(lengths[idx].max()) + 1):
        of_len = idx[lengths[idx] == length]
        if len(of_len) == 0:
            continue
        selected += list(of_len[np.argsort(vals[of_len])[::-1][: max(1, length)]])
    return [[[int(d), int(m)] for d, m in
             zip(dets[i][pairs[i]], coords[i][pairs[i]])] for i in selected]


# --------------------------------------------------------------------------- #
# batched assignment registration + selection
# --------------------------------------------------------------------------- #
def _register_one(sp, sc, sm, tp, tc, tm, init_T, has_init, generator, *,
                  fpfh_cap, voxel_size, global_dist_factor,
                  local_dist_factor, num_hyp, icp_coarse_iters,
                  icp_fine_iters, icp_early_exit, fpfh_nn=100,
                  do_ransac=True, check_basin=True):
    """A batch of assignments (leading dim A): FPFH+RANSAC coarse alignment
    on a feature subsample, the better of RANSAC and the centroid-Kabsch
    init by coarse inlier count, then multi-scale coloured ICP (reference
    fpfh_register.py:100-143). Clouds are mean-centred by the caller.

      do_ransac=False   seed ICP from the centroid-Kabsch init alone.
      check_basin=False skip the RANSAC-vs-init comparison (used when no
                        lane has an init)."""
    radius_normal = voxel_size * 2.0
    radius_feature = voxel_size * 5.0
    coarse_dist = voxel_size * 4.0
    fine_dist = voxel_size * local_dist_factor
    eye = torch.eye(4, dtype=init_T.dtype, device=init_T.device).expand_as(init_T)

    if not do_ransac:
        T0 = torch.where(has_init[..., None, None], init_T, eye)
    else:
        # rows are in random order (top-k of uniform scores), so a prefix is
        # a uniform subsample
        fsp, fsm = sp[..., :fpfh_cap, :], sm[..., :fpfh_cap]
        ftp, ftm = tp[..., :fpfh_cap, :], tm[..., :fpfh_cap]
        sn = estimate_normals(fsp, fsm, radius_normal, max_nn=30)
        tn = estimate_normals(ftp, ftm, radius_normal, max_nn=30)
        sf = compute_fpfh(fsp, sn, fsm, radius_feature, max_nn=fpfh_nn)
        tf = compute_fpfh(ftp, tn, ftm, radius_feature, max_nn=fpfh_nn)
        ci, cv = feature_correspondences(sf, fsm, tf, ftm, mutual=True)
        T_ransac, _, _ = ransac_registration(
            fsp, fsm, ftp, ci, cv, voxel_size * global_dist_factor,
            generator, num_hypotheses=num_hyp)
        if check_basin:
            _, fit_r = evaluate_transform_arrays(sp, sm, tp, tm, T_ransac,
                                                 coarse_dist)
            _, fit_i = evaluate_transform_arrays(sp, sm, tp, tm, init_T,
                                                 coarse_dist)
            fit_i = torch.where(has_init, fit_i, torch.full_like(fit_i, -1.0))
            T0 = torch.where((fit_i > fit_r)[..., None, None], init_T, T_ransac)
        else:
            T0 = T_ransac

    if icp_early_exit:
        T, _, _ = icp(sp, sm, tp, tm, coarse_dist, init_transform=T0,
                      src_colors=sc, tgt_colors=tc,
                      max_iterations=icp_coarse_iters, use_colors=True,
                      early_exit=True)
        T, fitness, rmse = icp(sp, sm, tp, tm, fine_dist, init_transform=T,
                               src_colors=sc, tgt_colors=tc,
                               max_iterations=icp_fine_iters,
                               use_colors=True, early_exit=True)
    else:
        schedule = ([coarse_dist] * icp_coarse_iters
                    + [fine_dist] * icp_fine_iters)
        T, fitness, rmse = icp_scheduled(sp, sm, tp, tm, schedule,
                                         init_transform=T0, src_colors=sc,
                                         tgt_colors=tc, use_colors=True)
    return T, rmse, fitness


@functools.lru_cache(maxsize=None)
def _slot_partition(lens: tuple, ransac_pairs_max: int, device):
    """The static split of the assignment rows into FPFH+RANSAC lanes and
    Kabsch-init-only lanes, as device index tensors made once per layout
    (a captured program copies nothing from the host): (rows of the first,
    rows of the second or None, the inverse permutation or None, whether a
    RANSAC lane can have an init)."""
    idx_r = [i for i, L in enumerate(lens) if 1 <= L <= ransac_pairs_max]
    idx_k = [i for i, L in enumerate(lens) if not 1 <= L <= ransac_pairs_max]
    if not idx_r:
        raise ValueError("no RANSAC-eligible slot (ransac_pairs_max < 1?)")
    basin = any(lens[i] >= 2 for i in idx_r)
    gr = torch.as_tensor(idx_r, device=device)
    if not idx_k:
        return gr, None, None, basin
    gk = torch.as_tensor(idx_k, device=device)
    inv = torch.as_tensor(np.argsort(np.asarray(idx_r + idx_k)), device=device)
    return gr, gk, inv, basin


def _register_select_body(sel_pts, sel_cols, sel_msk, sel_cent, active,
                          mem_pts, mem_cols, mem_msk, mem_cent,
                          eval_mem_pts, eval_mem_msk,
                          assn_det, assn_mem, pair_valid, assn_valid,
                          top1_mem,
                          voxel_size, global_dist_factor, local_dist_factor,
                          centroid_gate, generator, *,
                          reg_cap: int, fpfh_cap: int, eval_cap: int,
                          num_hyp: int, icp_coarse_iters: int,
                          icp_fine_iters: int, icp_early_exit: bool = False,
                          reg_seeds: int = 1, fpfh_nn: int = 100,
                          slot_lengths: tuple | None = None,
                          ransac_pairs_max: int = 3):
    """Every assignment's registration, evaluation, selection and the pose
    composition (reference object_memory.py:1020-1131), batched over the
    assignments.

    sel_* / active: `kept` of _prepare_body. mem_*: the packed memory
    (Mpad, mcap, ...) and centroids (Mpad, 3). eval_mem_*: the full-memory
    evaluation cloud. assn_det / assn_mem / pair_valid (A, Kmax) and
    assn_valid (A,): the selected assignments. top1_mem (top_n,): each
    detection's top-1 memory object, for the centroid gate. slot_lengths:
    static per-slot pair counts; with ransac_pairs_max < max(slot_lengths)
    slots of 1 <= L <= ransac_pairs_max run FPFH+RANSAC and the rest seed
    ICP from the centroid-Kabsch init alone.

    Returns (pose7, best, stats) with stats a dict of (A,) tensors."""
    a_pad = assn_det.shape[0]
    flat_pts = sel_pts.reshape(-1, 3)
    flat_cols = sel_cols.reshape(-1, 3)
    flat_msk = sel_msk.reshape(-1)
    ev_idx, ev_keep = _masked_subsample(flat_msk, eval_cap, generator)
    eval_det_pts, eval_det_msk = flat_pts[ev_idx], ev_keep

    def build_side(pts_bank, cols_bank, msk_bank, idx, pvalid):
        """Union of each assignment's chosen objects, mean-centred and
        subsampled to reg_cap. idx, pvalid (A, Kmax)."""
        a = idx.shape[0]
        up = pts_bank[idx].reshape(a, -1, 3)
        uc = cols_bank[idx].reshape(a, -1, 3)
        um = (msk_bank[idx] & pvalid[..., None]).reshape(a, -1)
        mean = masked_mean(up, um)
        sidx, skeep = _masked_subsample(um, reg_cap, generator)
        return (gather_rows(up, sidx) - mean[:, None, :],
                gather_rows(uc, sidx), skeep, mean)

    # seed-redundant registration: each assignment registered reg_seeds
    # times with independent draws; the best copy wins below
    if reg_seeds > 1:
        assn_det = assn_det.repeat(reg_seeds, 1)
        assn_mem = assn_mem.repeat(reg_seeds, 1)
        pair_valid = pair_valid.repeat(reg_seeds, 1)
        assn_valid = assn_valid.repeat(reg_seeds)
    a_rows = assn_det.shape[0]

    def register(det_idx, mem_idx, pvalid, do_ransac, check_basin):
        sp, sc, sm, dmean = build_side(sel_pts, sel_cols, sel_msk,
                                       det_idx, pvalid)
        tp, tc, tm, mmean = build_side(mem_pts, mem_cols, mem_msk,
                                       mem_idx, pvalid)
        # centroid-Kabsch init (correspondence-free coarse alignment)
        dc = sel_cent[det_idx] - dmean[:, None, :]
        mc = mem_cent[mem_idx] - mmean[:, None, :]
        w = pvalid.to(torch.float32)
        init_T = kabsch_transform(dc, mc, weights=w)
        has_init = torch.sum(w, dim=-1) >= 2

        T, rmse, fitness = _register_one(
            sp, sc, sm, tp, tc, tm, init_T, has_init, generator,
            fpfh_cap=fpfh_cap, voxel_size=voxel_size,
            global_dist_factor=global_dist_factor,
            local_dist_factor=local_dist_factor, num_hyp=num_hyp,
            icp_coarse_iters=icp_coarse_iters,
            icp_fine_iters=icp_fine_iters,
            icp_early_exit=icp_early_exit, fpfh_nn=fpfh_nn,
            do_ransac=do_ransac, check_basin=check_basin)

        # compose the global transform; evaluate on the FULL clouds
        # (object_memory.py:1096-1106)
        R, tx = T[:, :3, :3], T[:, :3, 3]
        gt = tx + mmean - (R @ dmean[..., None])[..., 0]
        gT = torch.zeros_like(T)
        gT[:, :3, :3] = R
        gT[:, :3, 3] = gt
        gT[:, 3, 3] = 1.0
        full_rmse, full_fitness = evaluate_transform_arrays(
            eval_det_pts, eval_det_msk, eval_mem_pts, eval_mem_msk, gT, 0.02)

        # centroid consistency gate: the pose must map the active
        # detections' centroids near their top-1 matches (median); gated
        # assignments are demoted below every ungated one
        moved = (sel_cent[None] - dmean[:, None, :]) @ R.transpose(-1, -2) \
            + tx[:, None, :]
        errs = torch.linalg.norm(
            moved - (mem_cent[top1_mem][None] - mmean[:, None, :]), dim=-1)
        gated = _masked_median(errs, active[None].expand_as(errs)) > centroid_gate
        score = torch.where(gated, full_fitness - 2.0, full_fitness)
        fitness = torch.where(gated, torch.full_like(fitness, -1.0), fitness)
        return (T, gT, rmse, fitness, full_rmse, full_fitness, score,
                dmean, mmean)

    lens = tuple(slot_lengths) * reg_seeds if slot_lengths else None
    if lens is not None and ransac_pairs_max < max(lens):
        if len(lens) != a_rows:
            raise ValueError(f"{len(lens)} slot lengths for {a_rows} rows")
        # static partition: full-path lanes vs Kabsch-init-only lanes
        gr, gk, inv, basin = _slot_partition(lens, ransac_pairs_max,
                                             assn_det.device)
        out_r = register(assn_det[gr], assn_mem[gr], pair_valid[gr],
                         True, basin)
        if gk is not None:
            out_k = register(assn_det[gk], assn_mem[gk], pair_valid[gk],
                             False, False)
            outs = [torch.cat([r, kx])[inv] for r, kx in zip(out_r, out_k)]
        else:
            outs = list(out_r)
    else:
        outs = register(assn_det, assn_mem, pair_valid, True, True)
    T, gT, rmse, fitness, full_rmse, full_fitness, scores, dmeans, mmeans = outs

    score = torch.where(assn_valid, scores, torch.full_like(scores, -torch.inf))
    if reg_seeds > 1:
        # keep each logical assignment's best-scoring seed copy
        sel = torch.argmax(score.reshape(reg_seeds, a_pad), dim=0)
        idx = sel * a_pad + torch.arange(a_pad, device=sel.device)
        (T, gT, rmse, fitness, full_rmse, full_fitness, score, dmeans,
         mmeans) = (x[idx] for x in (T, gT, rmse, fitness, full_rmse,
                                     full_fitness, score, dmeans, mmeans))
    best = torch.argmax(score)

    # pose from the best assignment's means (the reference composes it from
    # loop-leaked means, a bug the JAX package fixed); indexed by a 1-element
    # tensor: a 0-d index is read on the host, which a captured program
    # cannot do
    at = best.reshape(1)
    Rb, tb = T[at, :3, :3][0], T[at, :3, 3][0]
    t_avg = tb + mmeans[at][0] - Rb @ dmeans[at][0]
    pose7 = torch.cat([t_avg, rotmat_to_quat_xyzw(Rb)])
    stats = dict(rmse=rmse, fitness=fitness, full_rmse=full_rmse,
                 full_fitness=full_fitness, transform=gT,
                 eval_det_pts=eval_det_pts, eval_det_msk=eval_det_msk)
    return pose7, best, stats


def localise_frame(depth, rgb, masks, det_embs, det_valid,
                   mem_pts, mem_cols, mem_msk, mem_cent,
                   mem_ex, mem_ex_valid, mem_valid,
                   eval_mem_pts, eval_mem_msk, subsets,
                   fx, fy, radius,
                   voxel_size, global_dist_factor, local_dist_factor,
                   centroid_gate, generator, *,
                   top_n: int, budget: int, outlier_passes: int,
                   nb_points: int, min_det_points: int, a_pad: int,
                   reg_cap: int, fpfh_cap: int, eval_cap: int,
                   num_hyp: int, icp_coarse_iters: int,
                   icp_fine_iters: int, icp_early_exit: bool = False,
                   reg_seeds: int = 1, fpfh_nn: int = 100,
                   ransac_pairs_max: int = 3):
    """The whole localise query (reference object_memory.py:852-1169):
    preparation + assignment selection + registration + evaluation + pose
    composition, all on the tensors' device with no host round trip."""
    fetch, kept = _prepare_body(
        depth, rgb, masks, det_embs, det_valid,
        mem_ex, mem_ex_valid, mem_valid, subsets,
        fx, fy, radius, generator,
        top_n=top_n, det_cap=reg_cap, budget=budget,
        outlier_passes=outlier_passes, nb_points=nb_points,
        min_det_points=min_det_points)

    m_pad = mem_valid.shape[0]
    assn_det, assn_mem, pair_valid, assn_valid = _select_body(
        subsets, fetch["vol_vals"], fetch["vol_idx"], m_pad, a_pad)
    top1 = torch.argmax(fetch["sims"], dim=1)
    # _select_body's slot layout is static: max(1, L) slots per length L in
    # ascending order, zero-padded to a_pad
    k = subsets.shape[1]
    slot_lengths = tuple(L for L in range(1, k + 1) for _ in range(max(1, L)))
    slot_lengths += (0,) * (a_pad - len(slot_lengths))
    pose7, best, stats = _register_select_body(
        kept["sel_pts"], kept["sel_cols"], kept["sel_msk"],
        kept["sel_cent"], kept["active"],
        mem_pts, mem_cols, mem_msk, mem_cent,
        eval_mem_pts, eval_mem_msk,
        assn_det, assn_mem, pair_valid, assn_valid, top1,
        voxel_size, global_dist_factor, local_dist_factor,
        centroid_gate, generator,
        reg_cap=reg_cap, fpfh_cap=fpfh_cap, eval_cap=eval_cap,
        num_hyp=num_hyp, icp_coarse_iters=icp_coarse_iters,
        icp_fine_iters=icp_fine_iters, icp_early_exit=icp_early_exit,
        reg_seeds=reg_seeds, fpfh_nn=fpfh_nn,
        slot_lengths=slot_lengths, ransac_pairs_max=ransac_pairs_max)
    return dict(pose7=pose7, best=best,
                assn_det=assn_det, assn_mem=assn_mem,
                pair_valid=pair_valid, assn_valid=assn_valid,
                order=fetch["order"], counts=fetch["counts"],
                active=fetch["active"], sims=fetch["sims"], **stats)


def localise_frames_batched(depth, rgb, masks, det_embs, det_valid,
                            mem_pts, mem_cols, mem_msk, mem_cent,
                            mem_ex, mem_ex_valid, mem_valid,
                            eval_mem_pts, eval_mem_msk, subsets,
                            fx, fy, radius,
                            voxel_size, global_dist_factor, local_dist_factor,
                            centroid_gate, generators, **statics):
    """G localise queries as one program (counterpart of the reference's
    vmapped `localise_frames_batched`): depth (G, H, W), rgb (G, H, W, 3),
    masks (G, Dpad, H, W), det_embs (G, Dpad, E), det_valid (G, Dpad) and
    one generator per query; the memory tensors are shared, and every
    output gains a leading query axis.

    Each query runs `localise_frame`'s kernels at `localise_frame`'s shapes
    and draws from its own generator, so row g is bit for bit what
    `localise_frame` gives frame g, on any device, as the reference
    promises of its vmap. A program vectorised over the query axis does
    not keep that promise on the card: its reductions and matmuls sum in
    an order that follows the batch size, and registration (normals'
    orientation, RANSAC's pick, ICP) turns the last-bit differences into
    other assignments (PERF.md, perf/torch_batch_invariance.py). On
    the card the G programs replay as one CUDA graph (ops/query_graph.py),
    which amortises the launches as the reference's single dispatch did."""
    outs = [localise_frame(depth[g], rgb[g], masks[g], det_embs[g],
                           det_valid[g], mem_pts, mem_cols, mem_msk,
                           mem_cent, mem_ex, mem_ex_valid, mem_valid,
                           eval_mem_pts, eval_mem_msk, subsets, fx, fy,
                           radius, voxel_size, global_dist_factor,
                           local_dist_factor, centroid_gate, gen, **statics)
            for g, gen in enumerate(generators)]
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}


# --------------------------------------------------------------------------- #
# memory-build frame processing
# --------------------------------------------------------------------------- #
def process_frame(depth, rgb, masks, pose7, fx, fy, radius, depth_noise,
                  generator, *, proc_cap: int, apply_outlier: bool,
                  nb_points: int, kinect: bool, add_noise: bool):
    """Memory-build side (reference object_memory.py:163-228): backproject,
    per-mask radius outlier removal, optional gaussian point noise (the
    reference's fault injection), world transform, and per-mask subsample
    to `proc_cap` rows.

    Returns (pc6 (Dpad, proc_cap, 6) [xyz|rgb], raw_counts (Dpad,),
    sub_counts (Dpad,)): raw_counts is the post-cleanup point count the
    min_points filter reads; rows [:sub_counts[i]] of pc6[i] are valid."""
    d_pad = masks.shape[0]
    points, valid = backproject(depth, fx, fy)
    colors = (rgb.to(torch.float32) / 255.0).reshape(-1, 3)
    pm = masks.reshape(d_pad, -1) & valid[None, :]
    if apply_outlier:
        pm = pm & radius_outlier_keep_mask(points, pm, radius, nb_points)
    if add_noise:
        points = points + depth_noise * torch.randn(
            points.shape, generator=generator, device=points.device)
    world = (transform_points_kinect(points, pose7) if kinect
             else transform_points(points, pose7))
    raw_counts = torch.sum(pm, dim=1)
    idx, keep = _masked_subsample(pm, proc_cap, generator)
    pc6 = torch.cat([world[idx], colors[idx]], dim=-1)
    pc6 = torch.where(keep[..., None], pc6, torch.zeros_like(pc6))
    return pc6, raw_counts, torch.sum(keep, dim=1)
