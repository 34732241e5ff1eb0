"""Seeded multi-view RGB-D clips and their queries, rendered with torch on
the device.

A frozen copy of the scene model of `mvtracker_torch/datasets/synthetic.py`
(`render_scene`): textured spheres that move along smooth paths and spin
above a checkered ground plane, seen by V cameras on a circle around the
origin, inside a textured dome that closes the room. Depth is the exact
camera z of the first hit by ray casting, so it is smooth on every surface
(no sensor noise), and every pixel has one: with holes of depth 0, every
hole would lift to its camera's centre, and a support point there would tie
with hundreds of cloud points at distance 0, whose order no two kNN searches
share. The render runs on the device for all frames of one view at once.

Queries are surface points: a pixel of a view at the query's frame, jittered
inside the pixel and lifted through that pixel's depth. Query times follow a
rule of the traffic file (`QUERY_TIMES`) and are the same multiset for every
seed, so every seed's requests run the same windows.

`generate` is the generator of every `.json` traffic mix: it reads the
mix's shapes, each a number or a list that the pool's clips take in turn.
"""

from __future__ import annotations

import math

import torch

OBJECTS = 5  # spheres; the first quarter stand still
STATIC_FRACTION = 0.25
CAM_RADIUS = 4.0  # cameras on a circle of this radius around the origin, looking at (0, 0, 0.7)
DOME_RADIUS = 9.0


def _look_at(cam: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """World->camera [3, 4] for a camera at `cam` looking at `target`, +z
    forward, +y down."""
    fwd = target - cam
    fwd = fwd / fwd.norm()
    right = torch.linalg.cross(fwd, torch.tensor([0.0, 0.0, -1.0], dtype=cam.dtype))
    right = right / right.norm()
    down = torch.linalg.cross(fwd, right)
    rot = torch.stack([right, down, fwd])
    return torch.cat([rot, (-rot @ cam)[:, None]], 1)


def _rodrigues(axis: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotations [T, 3, 3] about a unit axis."""
    kx = torch.tensor([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]], [-axis[1], axis[0], 0.0]],
                      dtype=axis.dtype)
    return (torch.eye(3, dtype=axis.dtype)[None] + angles.sin()[:, None, None] * kx[None]
            + (1 - angles.cos())[:, None, None] * (kx @ kx)[None])


def scene_params(gen: torch.Generator, views: int, frames: int, width: int, height: int):
    """The scene's random draws, on the host in float64: object paths,
    radii, colours, spins and textures, and the cameras."""
    objects = OBJECTS

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, dtype=torch.float64)

    t = frames
    base = u(-1.2, 1.2, objects, 3)
    base[:, 2] = u(0.3, 1.2, objects)
    amp, freq, phase = u(0.1, 0.6, objects, 3), u(0.5, 2.0, objects, 3), u(0.0, 2 * math.pi, objects, 3)
    ts = torch.linspace(0, 1, t, dtype=torch.float64)[None, :, None]
    centers = base[:, None] + amp[:, None] * torch.sin(2 * math.pi * freq[:, None] * ts + phase[:, None])
    n_static = int(objects * STATIC_FRACTION)
    centers[:n_static] = centers[:n_static, :1]
    radii = u(0.25, 0.55, objects)
    colors = u(0.2, 1.0, objects, 3)
    rot = torch.eye(3, dtype=torch.float64).repeat(objects, t, 1, 1)
    for oi in range(n_static, objects):
        axis = torch.randn(3, generator=gen, dtype=torch.float64)
        rot[oi] = _rodrigues(axis / axis.norm(), u(-2.5, 2.5, 1) * torch.linspace(0, 1, t, dtype=torch.float64))
    tex = {"freq": u(6.0, 16.0, objects, 3), "phase": u(0.0, 2 * math.pi, objects, 3)}
    dirs = torch.randn(objects, 4, 3, generator=gen, dtype=torch.float64)
    tex.update(dirs=dirs / dirs.norm(dim=-1, keepdim=True), hf_freq=u(15.0, 25.0, objects, 4),
               hf_phase=u(0.0, 2 * math.pi, objects, 4))
    f = float(width)
    intr = torch.tensor([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], dtype=torch.float64)
    extrs = []
    for vi in range(views):
        ang = 2 * math.pi * vi / views + float(u(-0.2, 0.2, 1))
        cam = torch.tensor([CAM_RADIUS * math.cos(ang), CAM_RADIUS * math.sin(ang), float(u(1.0, 2.5, 1))],
                           dtype=torch.float64)
        extrs.append(_look_at(cam, torch.tensor([0.0, 0.0, 0.7], dtype=torch.float64)))
    return {"centers": centers, "radii": radii, "colors": colors, "rot": rot, "tex": tex,
            "intr": intr, "extrs": torch.stack(extrs)}


def render_view(p: dict, vi: int, height: int, width: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """One view's frames: rgb [T, H, W, 3] float in 0..1 and depth [T, H, W]."""
    dd = dict(device=device, dtype=torch.float32)
    ext = p["extrs"][vi].to(**dd)
    r_wc, t_wc = ext[:, :3], ext[:, 3]
    origin = -r_wc.T @ t_wc
    f = float(p["intr"][0, 0])
    ys = (torch.arange(height, **dd) + 0.5) - height / 2
    xs = (torch.arange(width, **dd) + 0.5) - width / 2
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    dirs = torch.stack([xx / f, yy / f, torch.ones_like(xx)], -1) @ r_wc  # [H, W, 3] world
    dn = dirs / dirs.norm(dim=-1, keepdim=True)
    cos_fwd = dn @ r_wc[2]
    centers = p["centers"].to(**dd)  # [O, T, 3]
    rot = p["rot"].to(**dd)
    tex = {k: v.to(**dd) for k, v in p["tex"].items()}
    t = centers.shape[1]
    zbuf = torch.full((t, height, width), float("inf"), **dd)
    rgb = torch.zeros((t, height, width, 3), **dd)
    # Ground plane z = 0 inside |x|, |y| < 4, checkered.
    dz = dn[..., 2]
    t_hit = torch.where(dz.abs() > 1e-6, -origin[2] / dz, torch.full_like(dz, -1.0))
    pts = origin + t_hit[..., None] * dn
    ground = (t_hit > 0.1) & (pts[..., 0].abs() < 4) & (pts[..., 1].abs() < 4)
    checker = ((torch.floor(pts[..., 0]) + torch.floor(pts[..., 1])) % 2) == 1
    gz = t_hit * cos_fwd
    zbuf[:, ground] = gz[ground]
    rgb[:, ground] = torch.where(checker[ground], 0.55, 0.35)[:, None].expand(-1, 3)
    light_dir = torch.tensor([0.5, 0.5, 0.7071], **dd)
    for oi in range(centers.shape[0]):
        oc = origin[None] - centers[oi]  # [T, 3]
        b = 2 * torch.einsum("hwc,tc->thw", dn, oc)
        c = (oc * oc).sum(-1)[:, None, None] - float(p["radii"][oi]) ** 2
        disc = b * b - 4 * c
        t0 = (-b - disc.clamp_min(0).sqrt()) / 2
        cz = t0 * cos_fwd[None]
        sel = (disc > 0) & (t0 > 0.1) & (cz < zbuf)
        hit = origin + t0[..., None] * dn[None]  # [T, H, W, 3]
        rel = hit - centers[oi][:, None, None]
        normal = rel / float(p["radii"][oi])
        light = (normal @ light_dir).clamp(0.2, 1.0)
        local = torch.einsum("tji,thwj->thwi", rot[oi], rel)
        fr, ph = tex["freq"][oi], tex["phase"][oi]
        stripes = (0.6 + 0.2 * torch.sin(fr[0] * local[..., 0] + ph[0]) * torch.sin(fr[1] * local[..., 2] + ph[1])
                   + 0.2 * torch.sin(fr[2] * (local[..., 1] + local[..., 0]) + ph[2]))
        hf = sum(torch.sin(tex["hf_freq"][oi, j] * (local @ tex["dirs"][oi, j]) + tex["hf_phase"][oi, j])
                 for j in range(4))
        stripes = stripes + 0.25 * hf / 4
        col = p["colors"][oi].to(**dd) * (light * stripes)[..., None]
        zbuf = torch.where(sel, cz, zbuf)
        rgb = torch.where(sel[..., None], col, rgb)
    # A textured dome of radius DOME_RADIUS around the origin closes the
    # room: every ray that hits nothing else ends on it, so every pixel has a
    # depth (a robot's workspace camera sees walls, not the sky).
    b = 2 * (dn @ origin)
    c = float(origin @ origin) - DOME_RADIUS**2
    t_far = (-b + (b * b - 4 * c).clamp_min(0).sqrt()) / 2
    far = origin + t_far[..., None] * dn
    az, el = torch.atan2(far[..., 1], far[..., 0]), torch.asin((far[..., 2] / DOME_RADIUS).clamp(-1, 1))
    wall = 0.45 + 0.15 * torch.sin(9 * az) * torch.sin(7 * el) + 0.1 * torch.sin(23 * az + 3 * el)
    miss = ~torch.isfinite(zbuf)
    zbuf = torch.where(miss, (t_far * cos_fwd)[None].expand_as(zbuf), zbuf)
    rgb = torch.where(miss[..., None], torch.stack([wall, wall * 0.9, wall * 0.8], -1)[None].expand_as(rgb), rgb)
    return rgb.clamp(0, 1), zbuf


def lift(pix: torch.Tensor, z: torch.Tensor, intr: torch.Tensor, extr: torch.Tensor) -> torch.Tensor:
    """Pixel xy [P, 2] at camera z [P] -> world xyz [P, 3]."""
    ray = torch.cat([pix, torch.ones_like(pix[:, :1])], 1) @ torch.linalg.inv(intr).T
    cam = ray * z[:, None]
    return (cam - extr[:, 3]) @ extr[:, :3]


# Query times, as the multiset 0..P-1 in turn over the N queries, shuffled:
# "first_half" spreads them over the clip's first half (P = T // 2), the
# range that `mvtracker_torch/scene.py::make_scene` draws them from for the
# port's headline; "first" puts every query at frame 0 (P = 1), as
# `cli.droid track` samples its depth queries.
QUERY_TIMES = {"first_half": lambda t: max(t // 2, 1), "first": lambda t: 1}


def generate(seed: int, index: int, traffic: dict, device) -> dict:
    """Clip `index` of a `.json` mix's pool, drawn from `seed`."""
    def pick(key):
        v = traffic[key]
        return v[index % len(v)] if isinstance(v, list) else v

    return make_clip(seed, pick("views"), pick("frames"), pick("height"), pick("width"), pick("queries"), device,
                     query_times=traffic["query_times"])


def make_clip(seed: int, views: int, frames: int, height: int, width: int, queries: int, device,
              query_times: str = "first_half") -> dict:
    """One clip as host tensors: rgbs uint8 [V, T, H, W, 3], depths float32
    [V, T, H, W], intrs [V, T, 3, 3], extrs [V, T, 3, 4], queries [N, 4]."""
    gen = torch.Generator().manual_seed(int(seed) % (2**63))
    p = scene_params(gen, views, frames, width, height)
    rgbs, depths = [], []
    for vi in range(views):
        rgb, depth = render_view(p, vi, height, width, device)
        rgbs.append((rgb * 255).to(torch.uint8))
        depths.append(depth)
    rgbs, depths = torch.stack(rgbs), torch.stack(depths)  # on the device
    intrs = p["intr"].float().expand(views, frames, 3, 3).contiguous()
    extrs = p["extrs"].float()[:, None].expand(views, frames, 3, 4).contiguous()
    # Queries: times by the rule, shuffled; a random view; a random pixel
    # with depth, redrawn until it has one.
    qt = (torch.arange(queries) % QUERY_TIMES[query_times](frames))[torch.randperm(queries, generator=gen)]
    qv = torch.randint(0, views, (queries,), generator=gen)
    px = torch.randint(0, width, (queries,), generator=gen)
    py = torch.randint(0, height, (queries,), generator=gen)
    dep_host = depths.cpu()
    for _ in range(64):
        bad = dep_host[qv, qt, py, px] <= 0
        if not bool(bad.any()):
            break
        nb = int(bad.sum())
        px[bad] = torch.randint(0, width, (nb,), generator=gen)
        py[bad] = torch.randint(0, height, (nb,), generator=gen)
    else:
        raise RuntimeError("no pixel with depth found for some queries")
    # The render casts pixel j's ray through x = j + 0.5 (the scene model's
    # convention); the jitter stays inside that pixel.
    pix = torch.stack([px, py], 1).float() + torch.rand(queries, 2, generator=gen)
    z = dep_host[qv, qt, py, px]
    xyz = _lift_many(pix, z, intrs[:, 0], extrs[:, 0], qv)
    qpts = torch.cat([qt[:, None].float(), xyz], 1)
    return {"rgbs": rgbs.cpu(), "depths": dep_host, "intrs": intrs, "extrs": extrs, "queries": qpts}


def _lift_many(pix, z, intrs, extrs, views):
    """`lift` of each point through its own view's camera."""
    out = torch.empty(pix.shape[0], 3)
    for vi in views.unique().tolist():
        sel = views == vi
        out[sel] = lift(pix[sel], z[sel], intrs[vi], extrs[vi])
    return out
