"""Batched small linear algebra with fixed iteration counts.

Counterpart of ``rgbd_visualodometry_tpu/ops/smalleig.py``: cyclic Jacobi
``eigh`` with a fixed sweep count, the adjugate 3x3 inverse, an unrolled
Cholesky solve, and Horn's quaternion Kabsch.  The same fixed iteration
counts and update order keep the port's numbers within float rounding of
the reference's.
"""

from __future__ import annotations

import torch

from vobench.reference.ops import se3


def jacobi_eigh_sym(A: torch.Tensor, sweeps: int = 8):
    """Eigendecomposition of batched symmetric ``A [..., n, n]``: eigenvalues
    ascending ``[..., n]`` and eigenvectors as columns ``[..., n, n]``."""
    n = A.shape[-1]
    A = A.clone()
    V = torch.zeros_like(A) + torch.eye(n, dtype=A.dtype, device=A.device)  # batched like A under vmap
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app = A[..., p, p]
                aqq = A[..., q, q]
                apq = A[..., p, q]
                theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
                c = torch.cos(theta)[..., None]
                s = torch.sin(theta)[..., None]
                Ap = A[..., p, :].clone()
                Aq = A[..., q, :].clone()
                A[..., p, :] = c * Ap - s * Aq
                A[..., q, :] = s * Ap + c * Aq
                Ap = A[..., :, p].clone()
                Aq = A[..., :, q].clone()
                A[..., :, p] = c * Ap - s * Aq
                A[..., :, q] = s * Ap + c * Aq
                Vp = V[..., :, p].clone()
                Vq = V[..., :, q].clone()
                V[..., :, p] = c * Vp - s * Vq
                V[..., :, q] = s * Vp + c * Vq
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    w_sorted, order = torch.sort(w, dim=-1, stable=True)
    V_sorted = torch.take_along_dim(V, order[..., None, :], dim=-1)
    return w_sorted, V_sorted


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18), det)
    adj = torch.stack([A11, A12, A13, A21, A22, A23, A31, A32, A33], dim=-1).reshape(A.shape)
    return adj / det[..., None, None]


def cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD ``A x = b`` (``A [..., n, n]``, ``b [..., n]``) with a fully
    unrolled Cholesky; the diagonal is floored at 1e-12 like the reference."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp_min(s, 1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def horn_quat_from_crosscov(S: torch.Tensor) -> torch.Tensor:
    """Horn's unit quaternion (w, x, y, z) of the R with ``cam ~= R @ world``
    from the centered cross-covariance ``S [..., 3, 3]``."""
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack(
        [
            Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx,
            Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz,
            Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy,
            Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz,
        ],
        dim=-1,
    ).reshape(S.shape[:-2] + (4, 4))
    _, V = jacobi_eigh_sym(N)
    q = V[..., :, -1]
    return q / torch.clamp_min(se3._norm(q, keepdim=True), 1e-12)


def kabsch_quat(world: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Pose ``[..., 7]`` with ``cam ~= R @ world + t`` from ``[..., k, 3]``."""
    wc = world.mean(dim=-2, keepdim=True)
    cc = cam.mean(dim=-2, keepdim=True)
    S = torch.einsum("...ka,...kb->...ab", world - wc, cam - cc)
    q = horn_quat_from_crosscov(S)
    t = cc[..., 0, :] - se3.quat_rotate(q, wc[..., 0, :])
    return se3.make(q, t)
