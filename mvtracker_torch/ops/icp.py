"""Point-cloud registration: ICP and the wrist-camera z-offset search,
counterpart of `mvtracker_tpu/ops/icp.py`.

- `icp`: rigid ICP with a fixed number of iterations. The nearest neighbour
  of every source point comes from `ops/knn.knn` (K1 on the card, K4 above
  its switch), correspondences beyond `max_corr_dist` get weight 0, and the
  point-to-plane step solves the damped 6x6 normal equations of the
  linearised SE(3) residual (point-to-point: weighted Kabsch). Fitness is
  the inlier fraction, Open3D's definition.
- `estimate_normals`: the smallest eigenvector of each point's k=16
  neighbourhood covariance, turned to the positive z hemisphere
  (`torch.linalg.eigh` defines it up to sign; the point-to-plane equations
  do not depend on the sign).
- `z_offset_fitness`, `optimize_wrist_z_offset[_multi_frame]`: the wrist
  camera's z offset from a candidate grid (one batched kNN for all
  candidates) refined by golden-section search.
- `apply_z_offset_to_extrinsics` for world->camera [..., 3, 4] extrinsics.

Plain PyTorch in fp32 around the kNN, on the device of the inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from mvtracker_torch.ops import knn as knn_ops


def estimate_normals(points: torch.Tensor, k: int = 16) -> torch.Tensor:
    """Unit normals [P, 3] of points [P, 3] from their k-neighbourhood
    covariance, with a z component of at least 0."""
    kk = min(k, points.shape[0])
    _, idx = knn_ops.knn(points[None], points[None], kk)
    nbrs = points[idx[0]]  # [P, kk, 3]
    centered = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("pki,pkj->pij", centered, centered)
    n = torch.linalg.eigh(cov)[1][..., 0]  # eigenvalues ascend: the smallest's vector
    return n * torch.where(n[..., 2:3] < 0, -1.0, 1.0)


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: so(3) vector [3] -> rotation [3, 3]."""
    theta = torch.linalg.norm(w) + 1e-12
    k = w / theta
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    kx = torch.stack([
        torch.stack([zero, -k[2], k[1]]), torch.stack([k[2], zero, -k[0]]), torch.stack([-k[1], k[0], zero]),
    ])
    return torch.eye(3, dtype=w.dtype, device=w.device) + torch.sin(theta) * kx + (1.0 - torch.cos(theta)) * (kx @ kx)


def icp(source: torch.Tensor, target: torch.Tensor, target_normals: torch.Tensor | None = None,
        max_corr_dist: float = 0.05, iters: int = 20, point_to_plane: bool = True, damping: float = 1e-6):
    """Rigid ICP moving `source` [N, 3] onto `target` [P, 3]. Returns (R [3, 3],
    t [3], fitness) with `source @ R.T + t` aligned to the target and fitness
    the last iteration's inlier fraction (a 0-d tensor)."""
    if point_to_plane and target_normals is None:
        target_normals = estimate_normals(target)
    dev, dt_ = source.device, source.dtype
    r, t = torch.eye(3, dtype=dt_, device=dev), torch.zeros(3, dtype=dt_, device=dev)
    fitness = torch.zeros((), dtype=dt_, device=dev)
    for _ in range(iters):
        src = source @ r.T + t
        d, idx = knn_ops.knn(target[None], src[None], 1)
        idx, dist = idx[0, :, 0], d[0, :, 0]
        w = (dist < max_corr_dist).to(dt_)
        tgt = target[idx]
        if point_to_plane:
            nrm = target_normals[idx]
            resid = (src - tgt).mul(nrm).sum(-1)
            a = torch.cat([torch.linalg.cross(src, nrm), nrm], dim=1)  # d resid / d (w, dt)
            ata = torch.einsum("ni,nj,n->ij", a, a, w) + damping * torch.eye(6, dtype=dt_, device=dev)
            atb = -torch.einsum("ni,n,n->i", a, resid, w)
            x = torch.linalg.solve(ata, atb)
            dr, dt = _so3_exp(x[:3]), x[3:]
        else:
            wsum = torch.clamp(w.sum(), min=1.0)
            mu_s = (src * w[:, None]).sum(0) / wsum
            mu_t = (tgt * w[:, None]).sum(0) / wsum
            h = torch.einsum("ni,nj,n->ij", src - mu_s, tgt - mu_t, w)
            u, _, vt = torch.linalg.svd(h)
            d_sign = torch.sign(torch.linalg.det(vt.T @ u.T))
            dcorr = torch.diag(torch.stack([torch.ones_like(d_sign), torch.ones_like(d_sign), d_sign]))
            dr = vt.T @ dcorr @ u.T
            dt = mu_t - dr @ mu_s
        r, t = dr @ r, dr @ t + dt
        fitness = w.mean()
    return r, t, fitness


def z_offset_fitness(z_offsets: torch.Tensor, wrist_points_local: torch.Tensor, wrist_cam_to_world: torch.Tensor,
                     external_points_world: torch.Tensor, external_normals: torch.Tensor,
                     max_corr_dist: float = 0.05, icp_iters: int = 0):
    """Alignment quality per z-offset candidate: (inlier fraction [C],
    inlier-weighted mean point-to-plane |residual| [C]) of the wrist cloud
    shifted along the camera's z axis, against the external cloud. With
    `icp_iters` > 0 each shifted cloud is first aligned by ICP (the
    reference's objective, flat where ICP undoes the shift); at 0, the JAX
    package's default, the residual is scored in place, and every candidate
    shares one kNN call."""
    c = z_offsets.shape[0]
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=wrist_points_local.dtype, device=wrist_points_local.device)
    shifted = wrist_points_local[None] + ez * z_offsets[:, None, None]  # [C, N, 3]
    world = shifted @ wrist_cam_to_world[:3, :3].T + wrist_cam_to_world[:3, 3]
    if icp_iters > 0:
        aligned = []
        for cand in world:
            r, t, _ = icp(cand, external_points_world, external_normals, max_corr_dist=max_corr_dist,
                          iters=icp_iters, point_to_plane=True)
            aligned.append(cand @ r.T + t)
        world = torch.stack(aligned)
    ext = external_points_world[None].expand(c, -1, -1).contiguous()
    d, idx = knn_ops.knn(ext, world, 1)
    nn_i, w = idx[..., 0], (d[..., 0] < max_corr_dist).to(world.dtype)
    resid = ((world - external_points_world[nn_i]) * external_normals[nn_i]).sum(-1).abs()
    return w.mean(-1), (resid * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)


def optimize_wrist_z_offset(wrist_points_local, wrist_cam_to_world, external_points_world,
                            z_range: tuple[float, float] = (-0.05, 0.05), n_grid: int = 21,
                            max_corr_dist: float = 0.05, icp_iters: int = 0, refine_tol: float = 1e-5,
                            device="cuda"):
    """Single-frame z-offset search; returns (optimal_z, its fitness)."""
    frame = {"wrist_points_local": wrist_points_local, "wrist_cam_to_world": wrist_cam_to_world,
             "external_points_world": external_points_world}
    return optimize_wrist_z_offset_multi_frame([frame], z_range=z_range, n_grid=n_grid, max_corr_dist=max_corr_dist,
                                               icp_iters=icp_iters, refine_tol=refine_tol, device=device)


def optimize_wrist_z_offset_multi_frame(frames_data: list[dict], z_range: tuple[float, float] = (-0.05, 0.05),
                                        n_grid: int = 21, max_corr_dist: float = 0.05, icp_iters: int = 0,
                                        refine_tol: float = 1e-5, device="cuda"):
    """Multi-frame z-offset search: the inlier-weighted mean |residual|,
    averaged over the frames (frames with fewer than 100 points on either
    side skipped), over a grid of `n_grid` candidates (those with an inlier
    fraction of at most 0.05 excluded), then golden-section refinement to
    `refine_tol` inside the best candidate's neighbouring cells.

    frames_data: dicts of `wrist_points_local` [N, 3], `wrist_cam_to_world`
    [4, 4] (or `wrist_transform`, the reference's key) and
    `external_points_world` [P, 3], arrays or tensors, computed on `device`.
    Returns (optimal_z, mean fitness at it); (0.0, 0.0) without a usable
    frame or candidate."""
    from mvtracker_torch.device import resolve_device

    dev = resolve_device(device)

    def as_tensor(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=torch.float32).to(dev)

    frames = []
    for frame in frames_data:
        wl = as_tensor(frame["wrist_points_local"])
        c2w = as_tensor(frame.get("wrist_cam_to_world", frame.get("wrist_transform")))
        ext = as_tensor(frame["external_points_world"])
        if wl.shape[0] < 100 or ext.shape[0] < 100:
            continue  # the reference skips under-populated frames
        frames.append((wl, c2w, ext, estimate_normals(ext)))
    if not frames:
        return 0.0, 0.0

    def objective(zs: np.ndarray):
        zs_t = torch.as_tensor(zs, dtype=torch.float32, device=dev)
        fit_sum, res_sum = np.zeros(len(zs)), np.zeros(len(zs))
        for wl, c2w, ext, nrm in frames:
            f, r = z_offset_fitness(zs_t, wl, c2w, ext, nrm, max_corr_dist=max_corr_dist, icp_iters=icp_iters)
            fit_sum += f.cpu().numpy()
            res_sum += r.cpu().numpy()
        fit, res = fit_sum / len(frames), res_sum / len(frames)
        return fit, np.where(fit > 0.05, res, np.inf)  # almost no inliers: no geometric signal

    zs = np.linspace(z_range[0], z_range[1], n_grid)
    _, res = objective(zs)
    i = int(np.argmin(res))
    if not np.isfinite(res[i]):
        return 0.0, 0.0
    inv_phi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = zs[max(i - 1, 0)], zs[min(i + 1, n_grid - 1)]
    c, d = b - inv_phi * (b - a), a + inv_phi * (b - a)
    fc, fd = objective(np.array([c]))[1][0], objective(np.array([d]))[1][0]
    while b - a > refine_tol:
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - inv_phi * (b - a)
            fc = objective(np.array([c]))[1][0]
        else:
            a, c, fc = c, d, fd
            d = a + inv_phi * (b - a)
            fd = objective(np.array([d]))[1][0]
    z_best = float((a + b) / 2)
    return z_best, float(objective(np.array([z_best]))[0][0])


def apply_z_offset_to_extrinsics(extrs: torch.Tensor, z_offset: float) -> torch.Tensor:
    """Move each camera's centre by `z_offset` along its own viewing axis:
    for world->camera [..., 3, 4] extrinsics, t' = t - z_offset * e_z."""
    out = extrs.clone()
    out[..., 2, 3] -= z_offset
    return out
