"""Closed-form 3x3 symmetric eigendecomposition and SVD (counterpart of
`instance_based_loc_tpu/ops/eigen3.py`).

Cardano's trigonometric solution of the characteristic cubic plus
cross-product eigenvectors: branch-free elementwise maths that batches over
the tens of thousands of tiny problems a query solves (one per RANSAC
hypothesis Kabsch, per point normal). Degenerate (repeated eigenvalue) cases
fall back to an orthogonal completion.
"""

from __future__ import annotations

import torch


def det3x3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors (elementwise; no LU)."""
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]))


def _basis(like: torch.Tensor, axis: int) -> torch.Tensor:
    """The unit vector along `axis`, shaped like `like` (built on its device:
    no host-to-device copy)."""
    out = torch.zeros_like(like)
    out[..., axis] = 1.0
    return out


def eigh3x3(a: torch.Tensor):
    """Eigen-decomposition of symmetric (..., 3, 3).

    Returns (w (..., 3) ascending, v (..., 3, 3) with eigenvectors in
    COLUMNS), torch.linalg.eigh's convention."""
    a = 0.5 * (a + a.transpose(-1, -2))
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = (a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2])[..., None, None] / 3.0
    b = a - q * eye
    p2 = torch.sum(b * b, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(det3x3(b) / (2.0 * p ** 3 + 1e-30), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    q_s = q[..., 0, 0]
    w2 = q_s + 2.0 * p * torch.cos(phi)                          # largest
    w0 = q_s + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)   # smallest
    w1 = 3.0 * q_s - w0 - w2
    w = torch.stack([w0, w1, w2], dim=-1)

    def eigvec(wi):
        # any nonzero cross product of two rows of (A - wi I)
        m = a - wi[..., None, None] * eye
        c0 = torch.linalg.cross(m[..., 0, :], m[..., 1, :])
        c1 = torch.linalg.cross(m[..., 0, :], m[..., 2, :])
        c2 = torch.linalg.cross(m[..., 1, :], m[..., 2, :])
        norms = torch.stack([torch.sum(c * c, dim=-1) for c in (c0, c1, c2)],
                            dim=-1)
        best = torch.argmax(norms, dim=-1)
        cand = torch.stack([c0, c1, c2], dim=-2)
        idx = best[..., None, None].expand(best.shape + (1, 3))
        vec = torch.gather(cand, -2, idx)[..., 0, :]
        norm = torch.linalg.norm(vec, dim=-1, keepdim=True)
        return vec / torch.clamp(norm, min=1e-30), norm[..., 0]

    v0, n0 = eigvec(w[..., 0])
    v2, n2 = eigvec(w[..., 2])
    # fully degenerate (multiples of I): every cross product is 0
    ez = _basis(v2, 2)
    v2 = torch.where((n2 > 1e-20)[..., None], v2, ez)
    # repeated eigenvalue: build v0 orthogonal to v2 instead
    alt = _any_orthogonal(v2)
    v0 = torch.where((n0 > 1e-20)[..., None], v0, alt)
    v0 = v0 - torch.sum(v0 * v2, dim=-1, keepdim=True) * v2
    v0n = torch.linalg.norm(v0, dim=-1, keepdim=True)
    v0 = torch.where(v0n > 1e-20, v0 / torch.clamp(v0n, min=1e-30),
                     _any_orthogonal(v2))
    v1 = torch.linalg.cross(v2, v0)
    return w, torch.stack([v0, v1, v2], dim=-1)


def _any_orthogonal(u: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to unit vector u (batched)."""
    ex = _basis(u, 0)
    ey = _basis(u, 1)
    base = torch.where(torch.abs(u[..., 0:1]) < 0.9, ex, ey)
    v = torch.linalg.cross(u, base)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)


def _safe_normalize(vec, fallback_orth=None):
    norm = torch.linalg.norm(vec, dim=-1, keepdim=True)
    safe = vec / torch.clamp(norm, min=1e-30)
    if fallback_orth is None:
        fb = _any_orthogonal(_basis(vec, 2))
    else:
        fb = _any_orthogonal(fallback_orth)
    return torch.where(norm > 1e-12, safe, fb)


def svd3x3(a: torch.Tensor):
    """SVD of general (..., 3, 3): returns (u, s, vT) with s descending, via
    eigh3x3(AᵀA) and U = A V / s with orthogonal completion for near-zero
    singular values. Signs may differ from LAPACK (a valid SVD regardless)."""
    ata = torch.einsum("...ji,...jk->...ik", a, a)
    w, v_asc = eigh3x3(ata)
    s = torch.sqrt(torch.clamp(w.flip(-1), min=0.0))
    v = v_asc.flip(-1)

    u_raw = a @ v
    u0 = _safe_normalize(u_raw[..., :, 0])
    u1_raw = u_raw[..., :, 1]
    u1_raw = u1_raw - torch.sum(u1_raw * u0, dim=-1, keepdim=True) * u0
    u1 = _safe_normalize(u1_raw, fallback_orth=u0)
    # u2 = u0 x u1, signed to agree with A v2 (U then reproduces A, even for
    # det(A) < 0). The JAX package takes A v2 itself, orthogonalised and
    # normalised, whenever its norm exceeds 1e-12; for a rank-deficient A
    # (every 3-point Kabsch covariance) A v2 is rounding noise, and U comes
    # out non-orthogonal (~4% of random 3-point covariances, with R then no
    # rotation). This completion is orthonormal for every A.
    c = torch.linalg.cross(u0, u1)
    agree = torch.sum(c * u_raw[..., :, 2], dim=-1, keepdim=True) >= 0
    u2 = torch.where(agree, c, -c)
    u = torch.stack([u0, u1, u2], dim=-1)
    return u, s, v.transpose(-1, -2)
