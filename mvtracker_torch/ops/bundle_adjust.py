"""Batched Gauss-Newton camera and point refinement with Schur elimination,
counterpart of `mvtracker_tpu/ops/bundle_adjust.py`.

Given per-view pixel observations of P points (with visibility weights), it
refines world->camera extrinsics (one se(3) twist per view, applied on the
left) and the points to minimise

    sum_{v,p} w_vp * || proj(K_v, exp(xi_v) E_v, X_p) - obs_vp ||^2.

The point block of the normal equations is block-diagonal (3x3 a point), so
the points are eliminated through the Schur complement, the small reduced
camera system (6V x 6V) is solved densely and the points are
back-substituted; Levenberg damping. Plain PyTorch in fp32: einsums and
`torch.linalg`, no kernel of the port's own.

`refine_cameras_sharded` splits the points over the ranks of a process
group: each rank builds its points' share of the reduced camera system and
its right-hand side, the shares are summed over the group (`all_reduce`,
JAX's `psum`), every rank solves the same camera update and then its own
points.
"""

from __future__ import annotations

import torch

from mvtracker_torch.parallel import mesh as mesh_lib
from mvtracker_torch.utils import geometry as geo


def _hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], zeros], -1),
        ],
        -2,
    )


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist [..., 6] (rho, phi) -> [..., 4, 4] by the exponential map."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta = torch.linalg.norm(phi, dim=-1, keepdim=True)[..., None]
    k = _hat(phi)
    k2 = k @ k
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(k.shape)
    safe = torch.clamp(theta, min=1e-9)
    a = torch.sin(safe) / safe
    b = (1 - torch.cos(safe)) / safe**2
    c = (safe - torch.sin(safe)) / safe**3
    small = (theta[..., 0, 0] < 1e-6)[..., None, None]
    one = torch.ones_like(a)
    r = eye + torch.where(small, one, a) * k + torch.where(small, 0.5 * one, b) * k2
    v = eye + torch.where(small, 0.5 * one, b) * k + torch.where(small, one / 6.0, c) * k2
    t = (v @ rho[..., None])[..., 0]
    top = torch.cat([r, t[..., None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype, device=xi.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)


def _project_residuals(intrs, extrs, points, obs, weights):
    """Reprojection residuals r [V, P, 2] scaled by sqrt(w), camera-space
    points [V, P, 3] and their depth [V, P, 1] (at least 1e-6). With sqrt(w)
    on the residual and the Jacobians, the normal equations carry w once."""
    cam = torch.einsum("vij,pj->vpi", extrs, geo.to_homogeneous(points))
    z = torch.clamp(cam[..., 2:], min=1e-6)
    pix_h = torch.einsum("vij,vpj->vpi", intrs, cam)
    pix = pix_h[..., :2] / torch.clamp(pix_h[..., 2:], min=1e-6)
    r = (pix - obs) * torch.sqrt(weights)[..., None]
    return r, cam, z


def _jacobians(intrs, extrs, cam, z, weights):
    """J_cam [V, P, 2, 6] (d r / d twist) and d r / d camera point [V, P, 2, 3]."""
    fx = intrs[:, None, 0, 0, None]
    fy = intrs[:, None, 1, 1, None]
    x, y = cam[..., 0:1], cam[..., 1:2]
    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    j_pc = torch.stack(
        [
            torch.cat([fx * inv_z, zero, -fx * x * inv_z**2], -1),
            torch.cat([zero, fy * inv_z, -fy * y * inv_z**2], -1),
        ],
        -2,
    )  # [V, P, 2, 3]
    eye = torch.eye(3, dtype=cam.dtype, device=cam.device).expand(cam.shape[:-1] + (3, 3))
    j_ct = torch.cat([eye, -_hat(cam)], -1)  # d cam / d xi = [I | -[cam]x], [V, P, 3, 6]
    w = torch.sqrt(weights)[..., None, None]
    return (j_pc @ j_ct) * w, j_pc * w


def _blocks(intrs, extrs, points, obs, weights, damping):
    """The normal equations' blocks at the current estimate: residuals r,
    camera blocks a [V, 6, 6], camera-point blocks w_blk [V, P, 6, 3],
    damped point blocks d [P, 3, 3], gradients g_cam [V, 6], g_pt [P, 3]."""
    r, cam, z = _project_residuals(intrs, extrs, points, obs, weights)
    j_cam, j_pc = _jacobians(intrs, extrs, cam, z, weights)
    j_pt = torch.einsum("vpij,vjk->vpik", j_pc, extrs[:, :, :3])  # [V, P, 2, 3]
    a = torch.einsum("vpiu,vpiw->vuw", j_cam, j_cam)
    d = torch.einsum("vpiu,vpiw->puw", j_pt, j_pt) + damping * torch.eye(3, dtype=r.dtype, device=r.device)
    w_blk = torch.einsum("vpiu,vpiw->vpuw", j_cam, j_pt)
    g_cam = -torch.einsum("vpiu,vpi->vu", j_cam, r)
    g_pt = -torch.einsum("vpiu,vpi->pu", j_pt, r)
    return r, a, d, w_blk, g_cam, g_pt


def _schur(a, d_inv, w_blk, g_cam, g_pt):
    """The reduced camera system's share of these points: S [V, V, 6, 6] =
    blockdiag(a) - W D^-1 W^T (undamped diagonal) and rhs [V, 6]."""
    v = a.shape[0]
    wdi = torch.einsum("vpuw,pwx->vpux", w_blk, d_inv)
    s = -torch.einsum("vpux,wpyx->vwuy", wdi, w_blk)
    s[torch.arange(v), torch.arange(v)] += a
    return s, g_cam - torch.einsum("vpux,px->vu", wdi, g_pt)


def _solve_cameras(s, rhs, damping):
    """Damp the diagonal blocks of S [V, V, 6, 6] and solve for the twists [V, 6]."""
    v = s.shape[0]
    s = s.clone()
    s[torch.arange(v), torch.arange(v)] += damping * torch.eye(6, dtype=s.dtype, device=s.device)
    s2 = s.permute(0, 2, 1, 3).reshape(6 * v, 6 * v)
    return torch.linalg.solve(s2, rhs.reshape(6 * v)).reshape(v, 6)


def _back_substitute(d_inv, w_blk, g_pt, d_xi):
    return torch.einsum("puw,pw->pu", d_inv, g_pt - torch.einsum("vpuw,vu->pw", w_blk, d_xi))


def gauss_newton_step(intrs, extrs, points, obs, weights, damping: float = 1e-4, eliminate_points: bool = True):
    """One damped Gauss-Newton step. With `eliminate_points` the cameras and
    points are solved jointly (points by back-substitution); without, the
    points stay fixed and each view's 6x6 system is solved alone.

    intrs [V, 3, 3], extrs [V, 3, 4], points [P, 3], obs [V, P, 2], weights
    [V, P]. Returns (d_xi [V, 6], d_points [P, 3], mean squared residual)."""
    r, a, d, w_blk, g_cam, g_pt = _blocks(intrs, extrs, points, obs, weights, damping)
    msr = (r**2).sum() / torch.clamp(weights.sum(), min=1.0)
    if not eliminate_points:
        a_damped = a + damping * torch.eye(6, dtype=a.dtype, device=a.device)
        return torch.linalg.solve(a_damped, g_cam[..., None])[..., 0], torch.zeros_like(points), msr
    d_inv = torch.linalg.inv(d)
    s, rhs = _schur(a, d_inv, w_blk, g_cam, g_pt)
    d_xi = _solve_cameras(s, rhs, damping)
    return d_xi, _back_substitute(d_inv, w_blk, g_pt, d_xi), msr


def _apply_twist(d_xi, extrs):
    return (se3_exp(d_xi) @ geo.extrinsics_square(extrs))[:, :3, :]


def refine_cameras(intrs, extrs, points, obs, weights, iterations: int = 10, damping: float = 1e-4,
                   refine_points: bool = True):
    """Refine the extrinsics (and the points with `refine_points`) by
    `iterations` damped Gauss-Newton steps. Returns (extrs [V, 3, 4],
    points [P, 3], the last step's mean squared residual)."""
    msr = None
    for _ in range(iterations):
        d_xi, d_pts, msr = gauss_newton_step(intrs, extrs, points, obs, weights, damping,
                                             eliminate_points=refine_points)
        extrs = _apply_twist(d_xi, extrs)
        if refine_points:
            points = points + d_pts
    return extrs, points, msr


def refine_cameras_sharded(intrs, extrs, points_local, obs_local, weights_local, group, iterations: int = 10,
                           damping: float = 1e-4):
    """`refine_cameras` (cameras and points) with the points split over the
    ranks of `group`: this rank holds points_local [P/D, 3] and their
    observations [V, P/D, 2] and weights [V, P/D]. The reduced camera system
    and its right-hand side are summed over the group, so every rank takes
    the same camera step. Returns (extrs [V, 3, 4], this rank's points)."""
    for _ in range(iterations):
        _, a, d, w_blk, g_cam, g_pt = _blocks(intrs, extrs, points_local, obs_local, weights_local, damping)
        d_inv = torch.linalg.inv(d)
        s, rhs = _schur(a, d_inv, w_blk, g_cam, g_pt)
        s = mesh_lib.all_reduce(s.contiguous(), group)
        rhs = mesh_lib.all_reduce(rhs.contiguous(), group)
        d_xi = _solve_cameras(s, rhs, damping)
        points_local = points_local + _back_substitute(d_inv, w_blk, g_pt, d_xi)
        extrs = _apply_twist(d_xi, extrs)
    return extrs, points_local
