"""Plain PyTorch reference of the MVTracker forward and of the evaluation
predictor, written from the model's description and its state-dict layout.

It imports nothing of the program under test. Everything runs in float32
with TF32 off (the caller sets `torch.backends`), as straightforward code:
- the encoder with `F.conv2d`, a two-pass instance norm and
  `F.interpolate(bilinear, align_corners=True)`, in blocks of frames;
- the fused world-space clouds per pyramid level;
- an exact kNN: squared distances and `torch.topk`, frame by frame;
- the correlation as a gather and a dot product;
- the factorized space/time update transformer with its virtual tracks;
- the visibility head, with the per-view depth z-test features when the
  configuration has them.

`lowp` is a rounding (identity when None) applied where the configuration
computes in its low precision (bf16): the operands and the outputs of the
encoder's convolutions and of the update transformer's dense layers and
attention products, the activations those layers keep (norms' outputs,
residual sums, the encoder's resized maps), the fused clouds' features (and
so the queries' features), and the correlation's operands. The geometry, the
kNN, the flow head, the feature update and the visibility head stay fp32, as
the configuration states. The check computes the reference once with
`lowp=None` (the reference answer) and once with a bf16 round trip (the
deviation the configured precision alone causes); the control passes an fp8
round trip, the precision below.

Layouts: rgbs [V, T, H, W, 3] in 0..255, depths [V, T, H, W], queries
[N, 4] (t, x, y, z), intrs [V, T, 3, 3], extrs [V, T, 3, 4] world->camera;
out traj [T, N, 3], vis [T, N].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

VIS_TAUS = (0.05, 0.2, 1.0)
DIM_HEAD = 48
# The configuration keys this reference computes; any other key of a
# configuration's `widths` is refused, so that no option of the program runs
# unchecked against a reference that leaves it out.
WIDTHS = frozenset({"sliding_window_len", "stride", "fmaps_dim", "hidden_size", "num_heads", "space_depth",
                    "time_depth", "num_virtual_tracks", "corr_n_levels", "corr_neighbors", "flow_embed_dim",
                    "vis_geom_features", "vis_head_hidden"})


def _ident(x):
    return x


class Ref:
    """The reference forward for one configuration (`cfg`, the widths of
    the configuration file) and one state dict (name -> float32 tensor)."""

    def __init__(self, cfg: dict, state: dict, lowp=None, frame_block: int = 8):
        unknown = sorted(set(cfg) - WIDTHS)
        if unknown:
            raise ValueError(f"the reference does not compute {unknown}")
        self.cfg = cfg
        self.w = {k: v.float() for k, v in state.items()}
        self.q = lowp or _ident
        self.frame_block = frame_block

    # -- dense pieces ------------------------------------------------------

    def linear(self, name, x, low=True):
        """A dense layer; `low=False` for the layers that stay fp32."""
        b = self.w.get(name + ".bias")
        if not low:
            return F.linear(x, self.w[name + ".weight"], b)
        return self.q(F.linear(self.q(x), self.q(self.w[name + ".weight"]), None if b is None else self.q(b)))

    def conv(self, name, x, stride=1, padding=0):
        return self.q(F.conv2d(self.q(x), self.q(self.w[name + ".weight"]), self.q(self.w[name + ".bias"]),
                               stride=stride, padding=padding))

    @staticmethod
    def inorm(x, eps=1e-5):
        m = x.mean(dim=(2, 3), keepdim=True)
        v = ((x - m) ** 2).mean(dim=(2, 3), keepdim=True)
        return (x - m) / torch.sqrt(v + eps)

    @staticmethod
    def layernorm(x, eps, weight=None, bias=None):
        m = x.mean(-1, keepdim=True)
        v = ((x - m) ** 2).mean(-1, keepdim=True)
        y = (x - m) / torch.sqrt(v + eps)
        if weight is not None:
            y = y * weight + bias
        return y

    # -- encoder ------------------------------------------------------------

    def resblock(self, name, x, stride, has_down):
        y = F.relu(self.q(self.inorm(self.conv(name + ".conv1", x, stride, 1))))
        y = F.relu(self.q(self.inorm(self.conv(name + ".conv2", y, 1, 1))))
        if has_down:
            x = self.q(self.inorm(self.conv(name + ".downsample.0", x, stride, 0)))
        return F.relu(self.q(x + y))

    def encode_block(self, x):
        """[B, 3, H, W] in [-1, 1] -> [B, C, H/4, W/4]."""
        stride = self.cfg["stride"]
        h, w = x.shape[-2:]
        x = F.relu(self.q(self.inorm(self.conv("fnet.conv1", x, 2, 3))))
        feats = []
        for li, (first_stride, first_down) in enumerate(((1, False), (2, True), (2, True), (2, True)), start=1):
            x = self.resblock(f"fnet.layer{li}.0", x, first_stride, first_down)
            x = self.resblock(f"fnet.layer{li}.1", x, 1, False)
            feats.append(x)
        size = (h // stride, w // stride)
        feats = torch.cat([f if f.shape[-2:] == size else
                           self.q(F.interpolate(f, size=size, mode="bilinear", align_corners=True)) for f in feats], 1)
        feats = F.relu(self.q(self.inorm(self.conv("fnet.conv2", feats, 1, 1))))
        return self.conv("fnet.conv3", feats)

    def encode(self, rgbs):
        """[V, T, H, W, 3] 0..255 -> [V, T, H/4, W/4, C], in blocks of frames."""
        v, t, h, w, _ = rgbs.shape
        flat = rgbs.reshape(v * t, h, w, 3)
        out = []
        for s in range(0, v * t, self.frame_block):
            x = flat[s:s + self.frame_block].float().permute(0, 3, 1, 2) / 255.0 * 2.0 - 1.0
            out.append(self.encode_block(x).permute(0, 2, 3, 1))
        f = torch.cat(out)
        return f.reshape(v, t, *f.shape[1:])

    # -- geometry -----------------------------------------------------------

    @staticmethod
    def cam_to_world(extrs):
        """[..., 3, 4] world->camera -> [..., 4, 4] camera->world."""
        bottom = torch.zeros(*extrs.shape[:-2], 1, 4, dtype=extrs.dtype, device=extrs.device)
        bottom[..., 0, 3] = 1.0
        return torch.linalg.inv(torch.cat([extrs, bottom], -2))

    @staticmethod
    def unproject(pix, z, intrs, extrs):
        """pixel xy [..., P, 2], camera z [..., P] -> world xyz [..., P, 3]."""
        ones = torch.ones_like(pix[..., :1])
        ray = torch.einsum("...ij,...pj->...pi", torch.linalg.inv(intrs), torch.cat([pix, ones], -1))
        cam = ray * z[..., None]
        world = torch.einsum("...ij,...pj->...pi", Ref.cam_to_world(extrs), torch.cat([cam, ones], -1))
        return world[..., :3]

    @staticmethod
    def project(xyz, intrs, extrs):
        """world [..., P, 3] -> (pixel xy [..., P, 2], camera z [..., P])."""
        cam = torch.einsum("...ij,...pj->...pi", extrs[..., :3], xyz) + extrs[..., None, :, 3]
        pix = torch.einsum("...ij,...pj->...pi", intrs, cam)
        return pix[..., :2] / pix[..., 2:3], cam[..., 2]

    def clouds(self, fmaps, depths, intrs, extrs):
        """Per level: (xyz [T, P, 3], fvec [T, P, C]); a frame's cloud lists
        the cells of view 0 row by row, then view 1, and so on."""
        stride = self.cfg["stride"]
        v, t, h, w, c = fmaps.shape
        feat = fmaps.permute(0, 1, 4, 2, 3).reshape(v * t, c, h, w)
        dep = depths[:, :, ::stride, ::stride]
        out = []
        for lvl in range(self.cfg["corr_n_levels"]):
            if lvl:
                feat = F.avg_pool2d(feat, 2)
                dep = dep[:, :, ::2, ::2]
            hl, wl = dep.shape[-2:]
            s = stride * 2 ** lvl
            ys, xs = torch.meshgrid((torch.arange(hl, device=dep.device) + 0.5) * s - 0.5,
                                    (torch.arange(wl, device=dep.device) + 0.5) * s - 0.5, indexing="ij")
            pix = torch.stack([xs, ys], -1).reshape(1, 1, hl * wl, 2).expand(v, t, -1, -1)
            xyz = self.unproject(pix, dep.reshape(v, t, -1), intrs, extrs)  # [V, T, P, 3]
            fv = feat.reshape(v, t, c, hl * wl).permute(0, 1, 3, 2)
            out.append((xyz.permute(1, 0, 2, 3).reshape(t, v * hl * wl, 3),
                        self.q(fv.permute(1, 0, 2, 3).reshape(t, v * hl * wl, c))))
        return out

    @staticmethod
    def knn(ref, query, k):
        """Exact kNN, frame by frame: ref [S, P, 3], query [S, M, 3] ->
        indices [S, M, k] of the k smallest squared distances."""
        out = []
        for s in range(ref.shape[0]):
            d2 = ((query[s][:, None, :] - ref[s][None, :, :]) ** 2).sum(-1)
            out.append(torch.topk(d2, min(k, ref.shape[1]), dim=-1, largest=False).indices)
        idx = torch.stack(out)
        if idx.shape[-1] < k:  # fewer points than neighbours: the ranks wrap
            idx = idx[..., torch.arange(k, device=idx.device) % idx.shape[-1]]
        return idx

    # -- embeddings -----------------------------------------------------------

    @staticmethod
    def sincos(dim, pos):
        """[M] -> [M, dim] = [sin(pos w) | cos(pos w)], w_i = 10000^(-2i/dim)."""
        w = 1.0 / 10000.0 ** (torch.arange(dim // 2, device=pos.device, dtype=torch.float32) / (dim / 2.0))
        a = pos.reshape(-1, 1).float() * w
        return torch.cat([a.sin(), a.cos()], 1)

    @staticmethod
    def flow_embed(xyz, c):
        """[..., 3] -> [..., 3c + 3]: per axis sin/cos interleaved at 2i*1000/c,
        then the raw offsets."""
        div = torch.arange(0, c, 2, device=xyz.device, dtype=torch.float32) * (1000.0 / c)
        parts = []
        for i in range(3):
            a = xyz[..., i:i + 1] * div
            parts.append(torch.stack([a.sin(), a.cos()], -1).reshape(*xyz.shape[:-1], c))
        return torch.cat(parts + [xyz], -1)

    # -- update transformer -----------------------------------------------------

    def attention(self, name, x, ctx, key_mask=None):
        heads = self.cfg["num_heads"]
        q = self.linear(name + ".to_q", x)
        k, v = self.linear(name + ".to_kv", ctx).chunk(2, -1)
        b, nq, _ = q.shape
        nk = k.shape[1]
        q = q.reshape(b, nq, heads, DIM_HEAD).transpose(1, 2)
        k = k.reshape(b, nk, heads, DIM_HEAD).transpose(1, 2)
        v = v.reshape(b, nk, heads, DIM_HEAD).transpose(1, 2)
        sim = self.q(self.q(self.q(q) @ self.q(k).transpose(-1, -2)) / math.sqrt(DIM_HEAD))
        if key_mask is not None:
            sim = sim.masked_fill(~key_mask[:, None, None, :], torch.finfo(torch.float32).min)
        att = torch.softmax(sim, -1)
        out = self.q(self.q(att) @ self.q(v)).transpose(1, 2).reshape(b, nq, heads * DIM_HEAD)
        return self.linear(name + ".to_out", out)

    def mlp(self, name, x):
        return self.linear(name + ".fc2", self.q(F.gelu(self.linear(name + ".fc1", x), approximate="tanh")))

    def self_block(self, name, x):
        h = self.q(self.layernorm(x, 1e-6))
        x = self.q(x + self.attention(name + ".attn", h, h))
        return self.q(x + self.mlp(name + ".mlp", self.q(self.layernorm(x, 1e-6))))

    def cross_block(self, name, x, ctx, key_mask=None):
        ctx = self.q(self.layernorm(ctx, 1e-5, self.w[name + ".norm_context.weight"],
                                    self.w[name + ".norm_context.bias"]))
        x = self.q(x + self.attention(name + ".cross_attn", self.q(self.layernorm(x, 1e-6)), ctx, key_mask))
        return self.q(x + self.mlp(name + ".mlp", self.q(self.layernorm(x, 1e-6))))

    def updateformer(self, x, active):
        """x [N, S, D_in], active [N] bool -> [N, S, 3 + C]."""
        n, s, _ = x.shape
        p = "updateformer."
        tok = self.linear(p + "input_transform", x)
        c = tok.shape[-1]
        virt = self.q(self.w[p + "virual_tracks"][0].expand(-1, s, -1))  # [Nv, S, C]
        tok = torch.cat([tok, virt], 0)
        depth_t, depth_s = self.cfg["time_depth"], self.cfg["space_depth"]
        interval = depth_t // depth_s
        key_mask = active[None].expand(s, n)
        j = 0
        for i in range(depth_t):
            tok = self.self_block(f"{p}time_blocks.{i}", tok)
            if i % interval == 0:
                st = tok.transpose(0, 1)  # [S, N + Nv, C]
                point, virt = st[:, :n], st[:, n:]
                virt = self.cross_block(f"{p}space_virtual2point_blocks.{j}", virt, point, key_mask)
                virt = self.self_block(f"{p}space_virtual_blocks.{j}", virt)
                point = self.cross_block(f"{p}space_point2virtual_blocks.{j}", point, virt)
                tok = torch.cat([point, virt], 1).transpose(0, 1)
                j += 1
        h = tok[:n]
        h = F.relu(self.linear(p + "flow_head.0", h, low=False))
        h = F.relu(self.linear(p + "flow_head.2", h, low=False))
        return self.linear(p + "flow_head.4", h, low=False)

    # -- visibility ---------------------------------------------------------

    @staticmethod
    def bilinear(img, x, y):
        """img [H, W], x, y [P] -> [P]; corner indices clamped, weights not."""
        h, w = img.shape
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        xi0, xi1 = x0.clamp(0, w - 1).long(), (x0 + 1).clamp(0, w - 1).long()
        yi0, yi1 = y0.clamp(0, h - 1).long(), (y0 + 1).clamp(0, h - 1).long()
        return (img[yi0, xi0] * (1 - fx) * (1 - fy) + img[yi0, xi1] * fx * (1 - fy)
                + img[yi1, xi0] * (1 - fx) * fy + img[yi1, xi1] * fx * fy)

    def geom_features(self, depths, intrs, extrs, coords):
        """The per-view depth z-test features [S, N, 7] of world coords
        [S, N, 3] in the window's frames (depths [V, S, H, W])."""
        v, s, h, w = depths.shape
        feats = []
        for si in range(s):
            pts = coords[si]
            per_view_score, per_view_valid = [], []
            for vi in range(v):
                pix, z = self.project(pts, intrs[vi, si], extrs[vi, si])
                d = self.bilinear(depths[vi, si], pix[:, 0], pix[:, 1])
                inside = (pix[:, 0] >= 0) & (pix[:, 0] <= w - 1) & (pix[:, 1] >= 0) & (pix[:, 1] <= h - 1)
                per_view_valid.append(inside & (z > 1e-3) & (d > 0))
                per_view_score.append(d - z)
            valid = torch.stack(per_view_valid)  # [V, N]
            clear = torch.stack(per_view_score)
            count = valid.sum(0).clamp_min(1)
            f = []
            for tau in VIS_TAUS:
                sc = torch.tanh(clear / tau)
                f.append(torch.where(valid, sc, -torch.ones_like(sc)).max(0).values)
                f.append(torch.where(valid, sc, torch.zeros_like(sc)).sum(0) / count)
            f.append(valid.float().mean(0) * 2 - 1)
            feats.append(torch.stack(f, -1))
        return torch.stack(feats)

    def vis_logits(self, ffeats, geom, coords):
        x = ffeats
        if self.cfg.get("vis_geom_features"):
            x = torch.cat([x, self.geom_features(*geom, coords)], -1)
        if self.cfg.get("vis_head_hidden", 0):
            x = F.gelu(self.linear("vis_hidden", x, low=False))
        return self.linear("vis_predictor.0", x, low=False)[..., 0]

    # -- the forward ----------------------------------------------------------

    def corr_features(self, clouds_w, coords, ffeats):
        """[S, N, sum_l 4k] of (correlation, neighbour offset xyz) per neighbour."""
        s, n, _ = coords.shape
        k = self.cfg["corr_neighbors"]
        c = ffeats.shape[-1]
        out = []
        for xyz, fvec in clouds_w:
            idx = self.knn(xyz, coords, k)  # [S, N, k]
            rows = torch.gather(fvec, 1, idx.reshape(s, -1, 1).expand(-1, -1, c)).reshape(s, n, k, c)
            corr = (self.q(rows) * self.q(ffeats)[:, :, None, :]).sum(-1) / math.sqrt(c)
            nxyz = torch.gather(xyz, 1, idx.reshape(s, -1, 1).expand(-1, -1, 3)).reshape(s, n, k, 3)
            out.append(torch.cat([corr[..., None], nxyz - coords[:, :, None, :]], -1).reshape(s, n, -1))
        return torch.cat(out, -1)

    def iterate(self, clouds_w, coords, vis_init, track_mask, active, feat_init, iters, geom):
        s, n, _ = coords.shape
        c = self.cfg["fmaps_dim"]
        d_in = (self.cfg["flow_embed_dim"] + 1) * 3 + self.cfg["corr_n_levels"] * self.cfg["corr_neighbors"] * 4 \
            + c + 2
        e3 = d_in + (-d_in) % 6
        pos = torch.cat([self.sincos(e3 // 3, coords[0, :, i]) for i in range(3)], -1)[:, :d_in]  # [N, D]
        times = self.sincos(d_in + d_in % 2, torch.arange(s, device=coords.device) / s)[:, :d_in]  # [S, D]
        ffeats = feat_init[None].expand(s, n, c)
        mv = torch.stack([track_mask, vis_init], -1)
        for _ in range(iters):
            fc = self.corr_features(clouds_w, coords, ffeats)
            x = torch.cat([self.flow_embed(coords - coords[:1], self.cfg["flow_embed_dim"]), fc, ffeats, mv], -1)
            x = x + pos[None] + times[:, None]
            delta = self.updateformer(x.transpose(0, 1), active).transpose(0, 1)  # [S, N, 3 + C]
            coords = coords + delta[..., :3]
            upd = self.layernorm(delta[..., 3:], 1e-5, self.w["ffeats_norm.weight"], self.w["ffeats_norm.bias"])
            ffeats = ffeats + F.gelu(self.linear("ffeats_updater.0", upd, low=False))
        return coords, self.vis_logits(ffeats, geom, coords)

    @torch.no_grad()
    def forward(self, rgbs, depths, queries, intrs, extrs, iters):
        rgbs, depths, queries, intrs, extrs = (a.float() for a in (rgbs, depths, queries, intrs, extrs))
        v, t = rgbs.shape[:2]
        n = queries.shape[0]
        s = self.cfg["sliding_window_len"]
        hop = s // 2
        dev = rgbs.device
        qt = queries[:, 0].long()
        qxyz = queries[:, 1:]

        fmaps = self.encode(rgbs)
        clouds = self.clouds(fmaps, depths, intrs, extrs)
        del fmaps
        # The query's feature: its nearest level-0 point in its own frame.
        xyz0, fvec0 = clouds[0]
        qf = qt.clamp(0, t - 1)
        feat_init = torch.empty(n, fvec0.shape[-1], device=dev)
        for f in qf.unique().tolist():
            sel = (qf == f).nonzero()[:, 0]
            nearest = self.knn(xyz0[f:f + 1], qxyz[sel][None], 1)[0, :, 0]
            feat_init[sel] = fvec0[f, nearest]

        t0 = int(qt.min())
        n_windows = min(max((t - t0 - 1) // hop, 1), len(range(0, max(t - hop, 1), hop)))
        win_coords, win_vis, win_active = [], [], []
        for wi in range(n_windows):
            start = t0 + wi * hop
            frames = torch.clamp(torch.arange(s, device=dev) + start, max=t - 1)
            active = qt < start + s
            clouds_w = [(xyz[frames], fv[frames]) for xyz, fv in clouds]
            geom = None
            if self.cfg.get("vis_geom_features"):
                geom = (depths[:, frames], intrs[:, frames], extrs[:, frames])
            coords = qxyz[None].expand(s, n, 3)
            vis_init = torch.full((s, n), 10.0, device=dev)
            if wi:
                chained = qt < start + (s - hop)
                tail, vtail = win_coords[-1][hop:], win_vis[-1][hop:]
                cc = torch.cat([tail, tail[-1:].expand(s - hop, n, 3)])
                vv = torch.cat([vtail, vtail[-1:].expand(s - hop, n)])
                coords = torch.where(chained[None, :, None], cc, coords)
                vis_init = torch.where(chained[None], vv, vis_init)
            cutoff = qt if wi == 0 else qt.clamp(min=start + s - hop)
            mask = (frames[:, None] >= cutoff[None]).float()
            c_out, v_out = self.iterate(clouds_w, coords, vis_init, mask, active, feat_init, iters, geom)
            win_coords.append(c_out)
            win_vis.append(v_out)
            win_active.append(active)

        tt = torch.arange(t, device=dev)
        wsel = torch.clamp(torch.div(tt - t0, hop, rounding_mode="floor"), 0, n_windows - 1)
        local = torch.clamp(tt - (t0 + wsel * hop), 0, s - 1)
        traj = torch.stack(win_coords)[wsel, local]
        vis = torch.sigmoid(torch.stack(win_vis)[wsel, local])
        alive = torch.stack(win_active)[wsel] & (tt >= t0)[:, None]
        return torch.where(alive[..., None], traj, 0.0), torch.where(alive, vis, 0.0)


def support_grid(depths, intrs, extrs, grid_size):
    """The predictor's support points: a grid_size^2 pixel grid (margin
    W/64) in every view at frame 0, lifted through the bilinear depth ->
    [V * grid_size^2, 4] (t=0, xyz)."""
    v, t, h, w = depths.shape
    margin = w / 64
    ys = torch.linspace(margin, h - margin, grid_size, device=depths.device)
    xs = torch.linspace(margin, w - margin, grid_size, device=depths.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    out = []
    for vi in range(v):
        z = Ref.bilinear(depths[vi, 0], pix[:, 0], pix[:, 1])
        xyz = Ref.unproject(pix, z, intrs[vi, 0], extrs[vi, 0])
        out.append(torch.cat([torch.zeros_like(xyz[:, :1]), xyz], 1))
    return torch.cat(out)


def resize(rgbs, depths, intrs, shape):
    """Nearest resize of every frame to `shape` (H, W), the source pixel of
    output pixel i being floor(i * H_in / H_out) in integers, with the
    intrinsics' first two rows scaled by the same factors."""
    h_raw, w_raw = depths.shape[-2:]
    h, w = shape
    rows = torch.arange(h, device=depths.device) * h_raw // h
    cols = torch.arange(w, device=depths.device) * w_raw // w
    rgbs = rgbs[:, :, rows][:, :, :, cols]
    depths = depths[:, :, rows][:, :, :, cols]
    intrs = intrs.clone()
    intrs[..., 0, :] *= w / w_raw
    intrs[..., 1, :] *= h / h_raw
    return rgbs, depths, intrs


def predictor(ref: Ref, rgbs, depths, queries, intrs, extrs, n_iters=6, grid_size=5, interp_shape=None):
    """The evaluation predictor: the clip resized to `interp_shape` (native
    size when None), the queries and one support grid a view at frame 0
    tracked together; the queries' rows returned."""
    depths, intrs, extrs = depths.float(), intrs.float(), extrs.float()
    if interp_shape is not None:
        rgbs, depths, intrs = resize(rgbs, depths, intrs, interp_shape)
    support = support_grid(depths, intrs, extrs, grid_size)
    traj, vis = ref.forward(rgbs, depths, torch.cat([queries.float(), support]), intrs, extrs, n_iters)
    n = queries.shape[0]
    return traj[:, :n], vis[:, :n]
