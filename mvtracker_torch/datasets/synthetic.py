"""Procedural multi-view RGB-D scene generator with exact ground truth.

The reference trains on Kubric renders (31 GB on disk). For hermetic tests,
overfit smoke runs (the reference's convergence test strategy, SURVEY.md §4:
`configs/experiment/mvtracker_overfit*.yaml`), and benchmarks, this module
synthesizes consistent multi-view scenes analytically:

- K textured spheres move along smooth trajectories above a ground plane;
- V cameras on a circle render exact RGB + z-depth by per-pixel ray casting
  (no renderer dependency, pure numpy);
- ground-truth 3D tracks ride the sphere surfaces; per-view visibility is
  exact (front-facing + z-buffer test), matching the Datapoint contract of
  the reference's Kubric loader (`kubric_multiview_dataset.py:470-1113`).
"""

from __future__ import annotations

import numpy as np

from mvtracker_torch.datasets.datapoint import Datapoint


def _look_at(cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World->camera extrinsics [3, 4] for a camera at cam_pos looking at
    target, with +z forward, +y down (OpenCV convention)."""
    fwd = target - cam_pos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, -1.0])
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    r = np.stack([right, down, fwd], axis=0)  # world->cam rotation
    t = -r @ cam_pos
    return np.concatenate([r, t[:, None]], axis=1)


def _sphere_trajectories(rng, n_obj, t, speed: float = 1.0):
    """Smooth per-object center trajectories [n_obj, T, 3].

    `speed` scales per-frame displacement. Keep per-frame motion within the
    correlation neighborhood at the training resolution (a cloud cell at
    stride 4 covers ~depth*stride/f world units) or the tracker gets no
    correlation gradient toward the target and collapses to no-motion.
    """
    base = rng.uniform(-1.2, 1.2, size=(n_obj, 3))
    base[:, 2] = rng.uniform(0.3, 1.2, size=n_obj)  # above ground
    amp = speed * rng.uniform(0.1, 0.6, size=(n_obj, 3))
    freq = rng.uniform(0.5, 2.0, size=(n_obj, 3))
    phase = rng.uniform(0, 2 * np.pi, size=(n_obj, 3))
    ts = np.linspace(0, 1, t)[None, :, None]
    return base[:, None, :] + amp[:, None, :] * np.sin(
        2 * np.pi * freq[:, None, :] * ts + phase[:, None, :]
    )


def _rotations_about_axis(axis: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rodrigues rotations [T, 3, 3] about a unit axis for angles [T]."""
    kx = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    k2 = kx @ kx
    return (
        np.eye(3)[None]
        + np.sin(angles)[:, None, None] * kx[None]
        + (1 - np.cos(angles))[:, None, None] * k2[None]
    )


def analytic_visibility(
    traj3d: np.ndarray,  # [T, N, 3] world-space track points
    obj_of_track: np.ndarray,  # [N] sphere index each track rides
    centers: np.ndarray,  # [O, T, 3] sphere centers
    radii: np.ndarray,  # [O]
    intrs: np.ndarray,  # [V, T, 3, 3]
    extrs: np.ndarray,  # [V, T, 3, 4]
    width: int,
    height: int,
    ground_extent: float = 4.0,
) -> np.ndarray:
    """EXACT per-view visibility for sphere-surface track points. [V, T, N].

    The z-buffer visibility test (`z <= depth[round(pixel)] + tol`) is noisy
    near sphere silhouettes: the depth at the rounded pixel can belong to a
    neighboring surface patch whose camera-z differs by O(radius) where the
    surface grazes the view ray, so labels within ~1 px of the silhouette
    are wrong at a rate set by the rendering resolution. Mislabeled GT caps
    the occlusion accuracy any model can reach (and corrupts the visibility
    BCE targets during training). For this analytic scene there is no need
    to sample the render: a point p riding sphere i is visible from camera
    c iff

      1. it projects inside the image with camera-z > 0;
      2. it is on its own sphere's camera-facing hemisphere
         ((p - c) . normal < 0 — otherwise the sphere self-occludes it);
      3. no OTHER sphere intersects the open segment c -> p;
      4. the segment does not cross the ground plane z=0 inside the ground
         extent (only possible when p dips below z=0).

    This is the exact geometric ground truth the renderer approximates.
    """
    v, t = extrs.shape[:2]
    n = traj3d.shape[1]
    n_obj = centers.shape[0]
    vis = np.zeros((v, t, n), bool)
    own = obj_of_track  # [N]
    for vi in range(v):
        for ti in range(t):
            p = traj3d[ti]  # [N, 3]
            r_wc = extrs[vi, ti, :, :3]
            t_wc = extrs[vi, ti, :, 3]
            cam = -r_wc.T @ t_wc  # camera origin in world
            # 1. Projection / bounds / front-of-camera.
            cam_xyz = (r_wc @ p.T).T + t_wc
            z = cam_xyz[:, 2]
            pix = (intrs[vi, ti] @ cam_xyz.T).T
            pix_xy = pix[:, :2] / np.maximum(pix[:, 2:], 1e-9)
            ok = (
                (z > 1e-6)
                & (pix_xy[:, 0] >= -0.5)
                & (pix_xy[:, 0] < width - 0.5)
                & (pix_xy[:, 1] >= -0.5)
                & (pix_xy[:, 1] < height - 0.5)
            )
            # 2. Own-sphere hemisphere test.
            c_own = centers[own, ti]  # [N, 3]
            normal = p - c_own
            nrm = np.linalg.norm(normal, axis=-1)
            normal = normal / np.maximum(nrm, 1e-12)[:, None]
            d = p - cam[None]  # segment camera -> point
            seg_len = np.linalg.norm(d, axis=-1)
            u = d / np.maximum(seg_len, 1e-12)[:, None]
            ok &= (u * normal).sum(-1) < 0.0
            # 3. Occlusion by every other sphere (first-entry t within the
            # open segment). Track points sit at 0.999 * radius, so an
            # epsilon on the segment end is unnecessary for the own sphere
            # (excluded anyway) and harmless for others.
            for oi in range(n_obj):
                other = own != oi
                if not other.any():
                    continue
                oc = cam[None] - centers[oi, ti][None]  # [1, 3]
                b = 2.0 * (u @ oc[0])
                c = (oc[0] @ oc[0]) - radii[oi] ** 2
                disc = b * b - 4.0 * c
                sq = np.sqrt(np.maximum(disc, 0.0))
                t_enter = (-b - sq) / 2.0
                blocked = other & (disc > 0) & (t_enter > 0.0) & (t_enter < seg_len)
                ok &= ~blocked
            # 4. Ground-plane occlusion (only for points below z=0).
            below = p[:, 2] < 0.0
            if below.any() and cam[2] > 0.0:
                s_g = cam[2] / np.maximum(cam[2] - p[:, 2], 1e-12)  # in (0,1)
                cross = cam[None] + s_g[:, None] * d
                on_ground = (
                    (np.abs(cross[:, 0]) < ground_extent)
                    & (np.abs(cross[:, 1]) < ground_extent)
                )
                ok &= ~(below & on_ground)
            vis[vi, ti] = ok
    return vis


def _hash3(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray, salt: float) -> np.ndarray:
    """Deterministic lattice hash -> [0, 1) (classic frac(sin) GPU hash)."""
    h = np.sin(ix * 127.1 + iy * 311.7 + iz * 74.7 + salt * 53.13) * 43758.5453
    return h - np.floor(h)


def _value_noise3(local: np.ndarray, salt: float, octaves: int = 3,
                  base_freq: float = 5.0) -> np.ndarray:
    """Multi-octave trilinear value noise of [..., 3] local coords -> [...].

    Non-periodic (hashed lattice), smooth (smoothstep interpolation),
    output roughly in [-1, 1].
    """
    out = np.zeros(local.shape[:-1])
    amp, total = 1.0, 0.0
    for o in range(octaves):
        p = local * (base_freq * (2.0 ** o))
        ip = np.floor(p)
        fp = p - ip
        w = fp * fp * (3.0 - 2.0 * fp)  # smoothstep weights
        acc = np.zeros(local.shape[:-1])
        for dx in (0.0, 1.0):
            wx = w[..., 0] if dx else 1.0 - w[..., 0]
            for dy in (0.0, 1.0):
                wy = w[..., 1] if dy else 1.0 - w[..., 1]
                for dz in (0.0, 1.0):
                    wz = w[..., 2] if dz else 1.0 - w[..., 2]
                    corner = _hash3(
                        ip[..., 0] + dx, ip[..., 1] + dy, ip[..., 2] + dz,
                        salt + 7.77 * o,
                    )
                    acc += corner * (wx * wy * wz)
        out += amp * (acc * 2.0 - 1.0)
        total += amp
        amp *= 0.55
    return out / total


def render_scene(
    seed: int = 0,
    n_views: int = 4,
    n_frames: int = 12,
    height: int = 64,
    width: int = 64,
    n_tracks: int = 32,
    n_objects: int = 5,
    static_fraction: float = 0.25,
    cam_radius: float = 4.0,
    focal_factor: float = 1.0,
    rotate_objects: bool = True,
    motion_speed: float = 1.0,
    valid_from_visibility: bool = False,
    texture_detail: float = 0.0,
    texture_noise: float = 0.0,
    use_analytic_visibility: bool = True,
) -> Datapoint:
    """Render a synthetic scene; returns a fully populated Datapoint.

    Objects translate along smooth trajectories AND spin about random axes
    (`rotate_objects`); the procedural texture is painted in each object's
    LOCAL frame so its appearance rotates with the surface — surface tracks
    stay photo-consistent, and rotation makes motion patterns that cannot
    be memorized from query position alone.

    `valid_from_visibility` marks loss validity only where the point is
    visible in at least one view: surface tracks on the blind hemisphere
    are unobservable, and supervising them rewards the static-copy local
    optimum (their conditional-mean target is near the query position).

    `texture_detail` > 0 adds high-frequency local-frame texture bands
    (quasi-random oriented sinusoids). The default smooth bands are locally
    ambiguous at 64x64 — correlation features can slide along a band, so
    models trained on many scenes collapse to the no-motion optimum on
    held-out scenes; the detail bands make surface points localizable.

    `texture_noise` > 0 adds hashed multi-octave VALUE NOISE in the local
    frame — the round-4 fix for the residual ambiguity the bands leave:
    every band component (base and texture_detail alike) is a PERIODIC
    plane wave with wavelength 0.25-1 world units, so surface points a
    fraction of a unit apart have near-identical appearance and the only
    scene-GENERIC solution for a correlation tracker is no motion
    (measured: the identical recipe that tracks 2 memorized scenes at ATE
    0.30x CopyCat collapses to identity at 16 scenes). Hashed lattice
    noise never repeats and is high-contrast at every octave, giving
    points a locally unique appearance — the role real Kubric object
    textures play for the reference. 0 keeps all earlier scenes
    bit-identical.
    0 keeps the historical output bit-for-bit.

    `use_analytic_visibility` replaces the z-buffer visibility labels with
    the exact geometric test (`analytic_visibility`): the z-buffer lookup at
    a rounded pixel with a fixed 0.05 camera-z tolerance mislabels points
    near sphere silhouettes at a rate set by the render resolution, and that
    label noise caps the occlusion accuracy any model can reach on this
    benchmark. Set False for the historical (noisy) labels.
    """
    rng = np.random.default_rng(seed)
    v, t, h, w = n_views, n_frames, height, width

    # Objects.
    centers = _sphere_trajectories(rng, n_objects, t, speed=motion_speed)  # [O, T, 3]
    n_static = int(n_objects * static_fraction)
    if n_static:
        centers[:n_static] = centers[:n_static, :1]  # freeze static objects
    radii = rng.uniform(0.25, 0.55, size=n_objects)
    colors = rng.uniform(0.2, 1.0, size=(n_objects, 3))

    # Per-object spin: axis + angular velocity; static objects do not spin.
    rotations = np.tile(np.eye(3), (n_objects, t, 1, 1))
    if rotate_objects:
        for oi in range(n_static, n_objects):
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            omega = rng.uniform(-2.5, 2.5)
            angles = omega * np.linspace(0, 1, t)
            rotations[oi] = _rotations_about_axis(axis, angles)
    # Per-object texture frequencies/phases (multi-band, in local coords).
    tex_freq = rng.uniform(6.0, 16.0, size=(n_objects, 3))
    tex_phase = rng.uniform(0, 2 * np.pi, size=(n_objects, 3))
    # High-frequency detail bands (texture_detail > 0): random 3D
    # orientations, frequencies kept below the pixel Nyquist at 64x64
    # (~5 px wavelength at the working depth) so views stay consistent.
    # Drawn from a forked generator so the main RNG stream — and therefore
    # every texture_detail=0 scene ever rendered — is untouched.
    rng_hf = np.random.default_rng(seed * 1_000_003 + 77_777)
    n_hf = 4
    hf_dirs = rng_hf.normal(size=(n_objects, n_hf, 3))
    hf_dirs /= np.linalg.norm(hf_dirs, axis=-1, keepdims=True)
    hf_freq = rng_hf.uniform(15.0, 25.0, size=(n_objects, n_hf))
    hf_phase = rng_hf.uniform(0, 2 * np.pi, size=(n_objects, n_hf))

    # Cameras on a circle, slight height variation, looking at the origin.
    intrs = np.zeros((v, t, 3, 3), np.float32)
    extrs = np.zeros((v, t, 3, 4), np.float32)
    f = focal_factor * w
    for vi in range(v):
        ang = 2 * np.pi * vi / v + rng.uniform(-0.2, 0.2)
        cam = np.array(
            [cam_radius * np.cos(ang), cam_radius * np.sin(ang), rng.uniform(1.0, 2.5)]
        )
        e = _look_at(cam, np.array([0.0, 0.0, 0.7]))
        for ti in range(t):
            extrs[vi, ti] = e
            intrs[vi, ti] = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])

    # Ray directions per pixel (camera space), shared across views.
    xs = (np.arange(w) + 0.5) - w / 2
    ys = (np.arange(h) + 0.5) - h / 2
    xx, yy = np.meshgrid(xs, ys)
    dirs_cam = np.stack([xx / f, yy / f, np.ones_like(xx)], axis=-1)  # [H, W, 3]

    video = np.zeros((v, t, h, w, 3), np.float32)
    depth = np.zeros((v, t, h, w), np.float32)
    seg = np.zeros((v, t, h, w), np.int32)

    for vi in range(v):
        r_wc = extrs[vi, 0, :, :3]  # world->cam rotation
        t_wc = extrs[vi, 0, :, 3]
        cam_origin = -r_wc.T @ t_wc
        dirs_world = dirs_cam @ r_wc  # [H, W, 3] (R^T applied to each dir)
        dn = dirs_world / np.linalg.norm(dirs_world, axis=-1, keepdims=True)
        fwd = r_wc[2]  # camera forward axis in world coords
        cos_fwd = dn @ fwd  # camera-z per unit step along the (unit) ray

        for ti in range(t):
            zbuf = np.full((h, w), np.inf, np.float32)
            rgb = np.zeros((h, w, 3), np.float32)
            sg = np.zeros((h, w), np.int32)

            # Ground plane z=0 (world), checkerboard texture.
            dz = dn[..., 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                t_hit = -cam_origin[2] / dz
            valid = (t_hit > 0.1) & (np.abs(dz) > 1e-6)
            pts = cam_origin[None, None] + t_hit[..., None] * dn
            in_extent = valid & (np.abs(pts[..., 0]) < 4) & (np.abs(pts[..., 1]) < 4)
            cam_z = t_hit * cos_fwd
            checker = ((np.floor(pts[..., 0]) + np.floor(pts[..., 1])) % 2).astype(bool)
            ground_col = np.where(checker[..., None], 0.55, 0.35)
            sel = in_extent & (cam_z < zbuf)
            zbuf[sel] = cam_z[sel]
            rgb[sel] = ground_col[sel]

            # Spheres (analytic ray-sphere intersection).
            for oi in range(n_objects):
                oc = cam_origin - centers[oi, ti]
                b = 2 * (dn @ oc)
                c = oc @ oc - radii[oi] ** 2
                disc = b * b - 4 * c
                hit = disc > 0
                sq = np.sqrt(np.maximum(disc, 0))
                t0 = (-b - sq) / 2
                hit &= t0 > 0.1
                p = cam_origin[None, None] + t0[..., None] * dn
                cam_z_s = t0 * cos_fwd
                sel = hit & (cam_z_s < zbuf)
                # Lambertian shading + multi-band texture in LOCAL coords so
                # the pattern rides the rotating surface.
                normal = (p - centers[oi, ti]) / radii[oi]
                light = np.clip(normal @ np.array([0.5, 0.5, 0.7071]), 0.2, 1.0)
                local = np.einsum(
                    "ji,hwj->hwi", rotations[oi, ti], p - centers[oi, ti]
                )
                f, ph = tex_freq[oi], tex_phase[oi]
                stripes = 0.6 + 0.2 * np.sin(f[0] * local[..., 0] + ph[0]) * np.sin(
                    f[1] * local[..., 2] + ph[1]
                ) + 0.2 * np.sin(f[2] * (local[..., 1] + local[..., 0]) + ph[2])
                if texture_detail > 0:
                    hf = sum(
                        np.sin(hf_freq[oi, j] * (local @ hf_dirs[oi, j]) + hf_phase[oi, j])
                        for j in range(n_hf)
                    )
                    stripes = stripes + texture_detail * 0.25 * (hf / n_hf)
                if texture_noise > 0:
                    # Only the pixels this sphere actually claims need the
                    # 24 lattice hashes; evaluate on the selected subset.
                    noise = np.zeros_like(stripes)
                    noise[sel] = _value_noise3(
                        local[sel], salt=seed * 0.173 + oi * 13.7
                    )
                    # The interpolated noise's empirical std is ~0.3; the
                    # 1.5 gain puts one noise std at ~half the base stripe
                    # level — high-contrast texture, not a subtle dither
                    # (weak texture was the original ambiguity problem).
                    stripes = stripes + texture_noise * 1.5 * noise
                col = colors[oi][None, None] * (light * stripes)[..., None]
                zbuf[sel] = cam_z_s[sel]
                rgb[sel] = col[sel]
                sg[sel] = oi + 1

            depth[vi, ti] = np.where(np.isfinite(zbuf), zbuf, 0.0)
            video[vi, ti] = np.clip(rgb, 0, 1) * 255
            seg[vi, ti] = sg

    # Ground-truth tracks: points on sphere surfaces, rigid with the
    # object's rotation+translation.
    obj_of_track = rng.integers(0, n_objects, size=n_tracks)
    u = rng.normal(size=(n_tracks, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    offsets = u * radii[obj_of_track][:, None] * 0.999  # local-frame offsets
    traj3d = centers[obj_of_track] + np.einsum(
        "ntij,nj->nti", rotations[obj_of_track], offsets
    )  # [N, T, 3]
    traj3d = traj3d.transpose(1, 0, 2).astype(np.float32)  # [T, N, 3]

    # Per-view projection + exact visibility via the z-buffer.
    traj2d = np.zeros((v, t, n_tracks, 3), np.float32)
    visibility = np.zeros((v, t, n_tracks), bool)
    for vi in range(v):
        for ti in range(t):
            xyz_h = np.concatenate([traj3d[ti], np.ones((n_tracks, 1))], -1)
            cam_xyz = (extrs[vi, ti] @ xyz_h.T).T
            z = cam_xyz[:, 2]
            pix = (intrs[vi, ti] @ cam_xyz.T).T
            pix_xy = pix[:, :2] / np.maximum(pix[:, 2:], 1e-6)
            traj2d[vi, ti, :, :2] = pix_xy
            traj2d[vi, ti, :, 2] = z
            xi = np.round(pix_xy[:, 0]).astype(int)
            yi = np.round(pix_xy[:, 1]).astype(int)
            inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h) & (z > 0)
            d_at = np.where(inb, depth[vi, ti, np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)], 0)
            visibility[vi, ti] = inb & (d_at > 0) & (z <= d_at + 0.05)

    if use_analytic_visibility:
        visibility = analytic_visibility(
            traj3d, obj_of_track, centers, radii, intrs, extrs, w, h
        )

    vis_any = visibility.any(axis=0)  # [T, N]
    # Query at first any-view-visible frame (guarantee at least one).
    has_vis = vis_any.any(axis=0)
    first_vis = np.argmax(vis_any, axis=0)
    first_vis[~has_vis] = 0
    query = np.concatenate(
        [
            first_vis[:, None].astype(np.float32),
            traj3d[first_vis, np.arange(n_tracks)],
        ],
        axis=1,
    )

    return Datapoint(
        video=video,
        videodepth=depth,
        intrs=intrs,
        extrs=extrs,
        trajectory=traj2d,
        visibility=visibility,
        trajectory_3d=traj3d,
        query_points_3d=query,
        valid=vis_any.copy() if valid_from_visibility else np.ones((t, n_tracks), bool),
        segmentation=seg,
        seq_name=f"synthetic_{seed}",
    )
