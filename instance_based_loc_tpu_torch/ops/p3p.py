"""Perspective-three-point pose estimation for clip_loc (counterpart of
`instance_based_loc_tpu/ops/p3p.py`; reference `clip_loc/loc_utils.py`,
which calls OpenCV's `solveP3P`).

Grunert's formulation: with u = s2/s1 and v = s3/s1 the three law-of-cosines
constraints reduce to a quartic in v, derived here by multiplying the
coefficient lists of

    N(v)^2 - 2 cos(gamma) N(v) D(v) + M(v) D(v)^2 = 0,   u = N(v) / D(v).

Its four complex roots come from 50 Durand-Kerner iterations in complex64,
each root updated in turn from the roots before it already updated (the
JAX package's order), then 6 Newton steps polish the real parts; the depths
follow and the pose of each root comes from Kabsch. Every function takes
leading batch dimensions, so all RANSAC rounds solve in one call.

Poses are camera-to-world 4x4 matrices; pixels and intrinsics follow the CV
convention (x right, y down, z forward).
"""

from __future__ import annotations

import torch

from .kabsch import kabsch_transform


def _polymul(p, q):
    """Coefficient convolution, highest degree first."""
    out = [0.0] * (len(p) + len(q) - 1)
    for i, pi in enumerate(p):
        for j, qj in enumerate(q):
            out[i + j] = out[i + j] + pi * qj
    return out


def _polyadd(p, q):
    n = max(len(p), len(q))
    p = [0.0] * (n - len(p)) + list(p)
    q = [0.0] * (n - len(q)) + list(q)
    return [a + b for a, b in zip(p, q)]


def durand_kerner_quartic(coeffs: torch.Tensor, iters: int = 50):
    """The 4 complex roots of quartics: coeffs (..., 5) [a4, a3, a2, a1, a0]
    complex64 -> (..., 4) complex64."""
    tiny = torch.full_like(coeffs[..., 0], 1e-12)
    lead = torch.where(coeffs[..., 0].abs() > 1e-12, coeffs[..., 0], tiny)
    a = coeffs / lead[..., None]
    a1, a2, a3, a4 = a[..., 1], a[..., 2], a[..., 3], a[..., 4]

    def poly(z):
        return (((z + a1) * z + a2) * z + a3) * z + a4

    w = torch.full_like(lead, 0.4 + 0.9j)
    w2 = w * w
    z = [w, w2, w * w2, w2 * w2]          # integer powers as jnp's `w ** k`
    for _ in range(iters):
        for i in range(4):
            denom = None
            for j in range(4):
                if j != i:
                    d = z[i] - z[j]
                    denom = d if denom is None else denom * d
            denom = torch.where(denom.abs() > 1e-12, denom, tiny)
            z[i] = z[i] - poly(z[i]) / denom
    return torch.stack(z, dim=-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def p3p_grunert(world_pts: torch.Tensor, bearings: torch.Tensor):
    """world_pts (..., 3, 3), bearings (..., 3, 3) unit camera-frame rays ->
    (poses (..., 4, 4, 4) camera-to-world candidates, valid (..., 4));
    invalid slots hold the identity."""
    p1, p2, p3 = world_pts[..., 0, :], world_pts[..., 1, :], world_pts[..., 2, :]
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    a2 = torch.sum((p2 - p3) ** 2, dim=-1)
    b2 = torch.sum((p1 - p3) ** 2, dim=-1)
    c2 = torch.sum((p1 - p2) ** 2, dim=-1)
    ca, cb, cg = _dot(f2, f3), _dot(f1, f3), _dot(f1, f2)

    b2_safe = torch.clamp(b2, min=1e-12)
    A = a2 / b2_safe
    B = c2 / b2_safe
    N = [A - B - 1.0, -2.0 * (A - B) * cb, A - B + 1.0]
    D = [-2.0 * ca, 2.0 * cg]
    M = [-B, 2.0 * B * cb, 1.0 - B]
    quartic = _polyadd(_polymul(N, N), _polyadd(
        [-2.0 * cg * x for x in _polymul(N, D)], _polymul(M, _polymul(D, D))))
    cr = torch.stack(quartic, dim=-1)                      # (..., 5) real
    roots = durand_kerner_quartic(cr.to(torch.complex64))

    real_ok = roots.imag.abs() < 1e-3 * (1.0 + roots.real.abs())
    v = roots.real.contiguous()
    c = [cr[..., k, None] for k in range(5)]
    for _ in range(6):           # Newton polish of the real parts
        f = (((c[0] * v + c[1]) * v + c[2]) * v + c[3]) * v + c[4]
        df = ((4.0 * c[0] * v + 3.0 * c[1]) * v + 2.0 * c[2]) * v + c[3]
        v = v - f / torch.where(df.abs() > 1e-9, df,
                                torch.full_like(df, 1e-9))

    A_, B_ = A[..., None], B[..., None]
    ca_, cb_, cg_ = ca[..., None], cb[..., None], cg[..., None]
    denom_s1 = 1.0 + v * v - 2.0 * v * cb_
    s1 = torch.sqrt(torch.clamp(b2[..., None] / torch.clamp(denom_s1,
                                                            min=1e-12),
                                min=0.0))
    d_v = -2.0 * ca_ * v + 2.0 * cg_
    n_v = ((A_ - B_ - 1.0) * v * v - 2.0 * (A_ - B_) * cb_ * v
           + (A_ - B_ + 1.0))
    u = n_v / torch.where(d_v.abs() > 1e-9, d_v, torch.full_like(d_v, 1e-9))
    s2, s3 = u * s1, v * s1
    valid = (real_ok & (v > 1e-6) & (u > 1e-6) & (s1 > 1e-6)
             & torch.isfinite(s1) & torch.isfinite(s2))

    # (..., 4 roots, 3 points, 3): each root's camera-frame points
    cam = torch.stack([s1[..., None] * f1[..., None, :],
                       s2[..., None] * f2[..., None, :],
                       s3[..., None] * f3[..., None, :]], dim=-2)
    world = world_pts[..., None, :, :].expand(cam.shape)
    e = kabsch_transform(world, cam)                     # world -> camera
    r_t = e[..., :3, :3].transpose(-1, -2)
    poses = torch.zeros_like(e)
    poses[..., :3, :3] = r_t
    poses[..., :3, 3] = -(r_t @ e[..., :3, 3:])[..., 0]
    poses[..., 3, 3] = 1.0
    eye = torch.eye(4, dtype=poses.dtype, device=poses.device)
    poses = torch.where(valid[..., None, None], poses, eye)
    return poses, valid


def pixel_bearings(pixels: torch.Tensor, intrinsics: torch.Tensor):
    """Unit bearing vectors (..., N, 3) of pixels (..., N, 2) under a 3x3 K."""
    k_inv = torch.linalg.inv(intrinsics)
    homo = torch.cat([pixels, torch.ones_like(pixels[..., :1])], dim=-1)
    rays = homo @ k_inv.T
    return rays / torch.linalg.norm(rays, dim=-1, keepdim=True)


def batched_p3p(world_pts: torch.Tensor, pixels: torch.Tensor,
                intrinsics: torch.Tensor):
    """S independent P3P problems in one call: world_pts (S, 3, 3), pixels
    (S, 3, 2) -> (poses (S, 4, 4, 4), valid (S, 4))."""
    return p3p_grunert(world_pts, pixel_bearings(pixels.float(), intrinsics))


def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    angle = torch.linalg.norm(w) + 1e-12
    ax = w / angle
    zero = torch.zeros_like(angle)
    kx = torch.stack([torch.stack([zero, -ax[2], ax[1]]),
                      torch.stack([ax[2], zero, -ax[0]]),
                      torch.stack([-ax[1], ax[0], zero])])
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(angle) * kx + (1 - torch.cos(angle)) * (kx @ kx)


def refine_pnp(pose: torch.Tensor, world_pts: torch.Tensor,
               pixels: torch.Tensor, weights: torch.Tensor,
               intrinsics: torch.Tensor, iters: int = 10,
               damping: float = 1e-3) -> torch.Tensor:
    """Gauss-Newton refinement of a camera-to-world pose (4, 4) over
    weighted 2D-3D correspondences, world_pts (N, 3) and pixels (N, 2), in
    axis-angle and translation parameters; the Jacobian is exact
    (forward-mode, as `jax.jacfwd` in the JAX package)."""
    from torch.func import jacfwd

    def residuals(params):
        rot, t = _rodrigues(params[:3]), params[3:]
        cam = (world_pts - t) @ rot
        z = torch.where(cam[:, 2].abs() > 1e-9, cam[:, 2],
                        torch.full_like(cam[:, 2], 1e-9))
        px = (cam @ intrinsics.T)[:, :2] / z[:, None]
        return ((px - pixels) * weights[:, None]).reshape(-1)

    r0, t0 = pose[:3, :3], pose[:3, 3]
    trace = torch.clamp((torch.trace(r0) - 1) / 2, -1 + 1e-6, 1 - 1e-6)
    axis0 = torch.stack([r0[2, 1] - r0[1, 2], r0[0, 2] - r0[2, 0],
                         r0[1, 0] - r0[0, 1]])
    axis0 = axis0 / (torch.linalg.norm(axis0) + 1e-12)
    params = torch.cat([axis0 * torch.arccos(trace), t0])
    eye6 = damping * torch.eye(6, dtype=params.dtype, device=params.device)
    jac = jacfwd(residuals)
    for _ in range(iters):
        r, j = residuals(params), jac(params)
        params = params - torch.linalg.solve(j.T @ j + eye6, j.T @ r)
    out = torch.eye(4, dtype=pose.dtype, device=pose.device)
    out[:3, :3] = _rodrigues(params[:3])
    out[:3, 3] = params[3:]
    return out


def project_points(points: torch.Tensor, intrinsics: torch.Tensor,
                   camera_pose: torch.Tensor):
    """World points (..., N, 3) through camera-to-world poses (..., 4, 4) ->
    (pixels (..., N, 2), in_front (..., N))."""
    rot, t = camera_pose[..., :3, :3], camera_pose[..., :3, 3]
    cam = (points - t[..., None, :]) @ rot                 # world -> camera
    z = cam[..., 2]
    zs = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    px = cam @ intrinsics.T
    return px[..., :2] / zs[..., None], z > 0
