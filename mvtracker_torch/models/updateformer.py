"""Factorized space/time update transformer (L2), counterpart of
`mvtracker_tpu/models/updateformer.py`.

Per-track time attention over the window's S tokens, interleaved with space
attention routed through a few learnable virtual tracks: virtual<-point
cross-attention (inactive tracks masked from the keys), virtual
self-attention, point<-virtual cross-attention.

Differences from the JAX module, none of them numerical:
- time attention runs per track sequence. The JAX `time_pack` packs several
  sequences into one block-diagonal attention to fill TPU lanes; its own
  test (`test_time_pack_attention_equivalence`) shows the results equal;
- layers are separate modules named like the reference state dict
  (`time_blocks.i`, `space_virtual2point_blocks.i`, ...); the JAX package
  stacks them into one scanned tree.

Attention is a plain matmul, an fp32 softmax with masked scores set to
float32's lowest value, and a matmul.

With `support_memory_tokens` > 0 the head first refines the point tokens
against a learned bank of that many memory tokens (`support_memory`,
[1, M, hidden], 0.1 at initialisation) through a LoFTR transformer
(`gnn`, 4 heads, `support_memory_attention` "full" or "linear") over the
B x (N x T) flattened tokens, in fp32 whatever the compute dtype, with
inactive tracks masked in (track, time) order. The bank is a parameter; the
reference's residual updates of it across windows are dropped, as in the
JAX module.

Inside `graph.scope()` (every `MVTracker.forward` opens one), a call on CUDA
with autograd off and no `TorchDispatchMode` active is replayed from a CUDA
graph (`CallGraph`): captured at the scope's first call of its signature,
replayed for the later ones, so that a call's hundreds of small ops cost
the host one graph launch rather than one dispatch each. The graph runs
the eager code's own kernels on the same inputs, so its outputs are the
eager call's to the bit. Every other call (training, the CPU,
`FlopCounterMode`, which does not see a replay) runs the eager code.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from mvtracker_torch.models.layers import LayerNorm, Linear, layer_norm_noaffine
from mvtracker_torch.models.loftr import LocalFeatureTransformer
from mvtracker_torch.utils.observability import span


class Attention(nn.Module):
    """Multi-head attention (dim_head 48), optionally cross, with key masking."""

    def __init__(self, query_dim, num_heads=8, dim_head=48, qkv_bias=True, dtype=None, device=None):
        super().__init__()
        inner = num_heads * dim_head
        self.num_heads, self.dim_head = num_heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=qkv_bias, dtype=dtype, device=device)
        self.to_kv = Linear(query_dim, 2 * inner, bias=qkv_bias, dtype=dtype, device=device)
        self.to_out = Linear(inner, query_dim, dtype=dtype, device=device)

    def forward(self, x, context=None, key_mask=None):
        ctx = x if context is None else context
        q = self.to_q(x)
        k, v = self.to_kv(ctx).chunk(2, dim=-1)
        b, nq, _ = q.shape
        nk = k.shape[1]
        h, d = self.num_heads, self.dim_head
        q = q.reshape(b, nq, h, d).transpose(1, 2)
        k = k.reshape(b, nk, h, d).transpose(1, 2)
        v = v.reshape(b, nk, h, d).transpose(1, 2)
        sim = (q @ k.transpose(-1, -2)) * d**-0.5
        sim = sim.float()
        if key_mask is not None:
            sim = sim.masked_fill(~key_mask[:, None, None, :], torch.finfo(torch.float32).min)
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, nq, h * d)
        return self.to_out(out)


class Mlp(nn.Module):
    """Linear -> tanh-approximate GELU -> Linear."""

    def __init__(self, dim, hidden, dtype=None, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype, device=device)
        self.fc2 = Linear(hidden, dim, dtype=dtype, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class AttnBlock(nn.Module):
    """Pre-LN self-attention block."""

    def __init__(self, hidden_size, num_heads, mlp_ratio=4.0, dtype=None, device=None):
        super().__init__()
        self.attn = Attention(hidden_size, num_heads=num_heads, dtype=dtype, device=device)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio), dtype=dtype, device=device)

    def forward(self, x, key_mask=None):
        x = x + self.attn(layer_norm_noaffine(x), key_mask=key_mask)
        return x + self.mlp(layer_norm_noaffine(x))


class CrossAttnBlock(nn.Module):
    """Pre-LN cross-attention block; the context LayerNorm has parameters."""

    def __init__(self, hidden_size, num_heads, mlp_ratio=4.0, dtype=None, device=None):
        super().__init__()
        self.norm_context = LayerNorm(hidden_size, eps=1e-5, dtype=dtype, device=device)
        self.cross_attn = Attention(hidden_size, num_heads=num_heads, dtype=dtype, device=device)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio), dtype=dtype, device=device)

    def forward(self, x, context, key_mask=None):
        ctx = self.norm_context(context)
        x = x + self.cross_attn(layer_norm_noaffine(x), context=ctx, key_mask=key_mask)
        return x + self.mlp(layer_norm_noaffine(x))


class CallGraph:
    """One CUDA graph of a module's call, alive for one scope.

    `scope()` brackets a stretch of calls (one `MVTracker.forward`). Inside
    it, `engages(device)` says whether a call replays: on CUDA, with
    autograd off (a replay records no graph) and no `TorchDispatchMode`
    active (a mode sees none of a replay's ops). The first such call of a
    signature (input shape, dtype and device; the mask's shape, or none)
    captures the eager call on a side stream and replays it; later calls of
    that signature only replay. A different signature captures anew.

    Memory: the static input, mask and output live until the scope closes,
    so nothing of them is held between forwards. The caller may build its
    input in `input_buffer` and pass a view of it, which the graph then
    reads in place; any other input is copied into a static tensor of its
    own layout, so that the graph runs the kernels the eager call would.
    The graphs share one memory pool across scopes, so a capture reuses the
    blocks of the last one rather than calling `cudaMalloc`; the
    last graph is kept past its scope (it is never replayed again), since a
    pool that no graph holds may not be captured into again. cuBLAS's
    workspaces are dropped around each capture, so that the capture
    stream's workspace lives in that pool and is not held besides.

    While a profiler records, the graph launch of a call that captured opens
    `mvtracker::<name>_capture` and that of a call that only replays
    `mvtracker::<name>_replay`. They hold the launch alone: the capture
    itself, which launches nothing, stays in the caller's span, whose idle
    it is."""

    def __init__(self, name: str):
        self.name = name
        self.depth = 0  # open scopes
        self.pool = None
        self.stream = None
        self.graph = None
        self.key = None  # signature of `graph` while its static tensors live
        self.buf = self.x = self.mask = self.out = None

    def __deepcopy__(self, memo):
        """A copy starts with no graph: the capture's stream, pool, graph and
        static tensors belong to this object's device, and none of them
        copies."""
        return CallGraph(self.name)

    @contextlib.contextmanager
    def scope(self):
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1
            if self.depth == 0:
                self.key = self.buf = self.x = self.mask = self.out = None

    def engages(self, device: torch.device) -> bool:
        return (self.depth > 0 and device.type == "cuda" and not torch.is_grad_enabled()
                and torch._C._len_torch_dispatch_stack() == 0)

    def input_buffer(self, shape, dtype, device):
        """A tensor of `shape` to build the next call's input in, or None
        where that call runs eagerly."""
        if not self.engages(device):
            return None
        if self.buf is None or self.buf.shape != shape or self.buf.dtype != dtype or self.buf.device != device:
            self.buf = torch.empty(shape, dtype=dtype, device=device)
        return self.buf

    def __call__(self, fn, x, mask=None):
        """`fn(x, mask)`, replayed; the output is the graph's static output,
        valid until the next call."""
        key = (tuple(x.shape), x.stride(), x.dtype, x.device, None if mask is None else tuple(mask.shape))
        captured = key != self.key
        if captured:
            in_buf = self.buf is not None and x.data_ptr() == self.buf.data_ptr()
            self.x = x if in_buf else torch.empty_like(x)
            self.mask = None if mask is None else torch.empty_like(mask)
        if x.data_ptr() != self.x.data_ptr():
            self.x.copy_(x)
        if mask is not None:
            self.mask.copy_(mask)
        if captured:
            self._capture(fn)
            self.key = key
        with span(self.name + ("_capture" if captured else "_replay")):
            self.graph.replay()
        return self.out

    def _capture(self, fn):
        dev = self.x.device
        if self.stream is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(dev)
        self.out = None  # its block goes back to the pool for this capture
        graph = torch.cuda.CUDAGraph()
        torch._C._cuda_clearCublasWorkspaces()
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                out = fn(self.x, self.mask)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        torch._C._cuda_clearCublasWorkspaces()
        self.graph, self.out = graph, out


class EfficientUpdateFormer(nn.Module):
    """Factorized space/time transformer over [B, N, T, C_in] track tokens
    -> [B, N, T, output_dim] fp32. `track_mask` [B, N] bool hides inactive
    tracks from the virtual tokens."""

    def __init__(
        self,
        space_depth=6,
        time_depth=6,
        input_dim=320,
        hidden_size=384,
        num_heads=8,
        output_dim=130,
        mlp_ratio=4.0,
        add_space_attn=True,
        num_virtual_tracks=64,
        dtype=None,
        support_memory_tokens=0,
        support_memory_attention="full",
        device=None,
    ):
        super().__init__()
        if add_space_attn and (space_depth <= 0 or time_depth % space_depth != 0):
            raise ValueError(
                f"time_depth ({time_depth}) must be a positive multiple of space_depth ({space_depth})"
            )
        self.add_space_attn = add_space_attn
        self.interval = time_depth // space_depth if add_space_attn else 0
        self.compute_dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.input_transform = Linear(input_dim, hidden_size, **kw)
        # sic: the reference state dict misspells this parameter.
        self.virual_tracks = nn.Parameter(torch.zeros(1, num_virtual_tracks, 1, hidden_size, device=device))
        blk = (hidden_size, num_heads, mlp_ratio)
        self.time_blocks = nn.ModuleList([AttnBlock(*blk, **kw) for _ in range(time_depth)])
        n_space = space_depth if add_space_attn else 0
        self.space_virtual2point_blocks = nn.ModuleList([CrossAttnBlock(*blk, **kw) for _ in range(n_space)])
        self.space_virtual_blocks = nn.ModuleList([AttnBlock(*blk, **kw) for _ in range(n_space)])
        self.space_point2virtual_blocks = nn.ModuleList([CrossAttnBlock(*blk, **kw) for _ in range(n_space)])
        self.support_memory_tokens = support_memory_tokens
        if support_memory_tokens > 0:
            self.support_memory = nn.Parameter(
                torch.full((1, support_memory_tokens, hidden_size), 0.1, device=device)
            )
            self.gnn = LocalFeatureTransformer(hidden_size, nhead=4, attention=support_memory_attention, device=device)
        self.graph = CallGraph("transformer")
        # flow_head.{0,2,4} are the Linear layers, in fp32 like the JAX head.
        self.flow_head = nn.Sequential(
            Linear(hidden_size, output_dim, device=device),
            nn.ReLU(),
            Linear(output_dim, output_dim, device=device),
            nn.ReLU(),
            Linear(output_dim, output_dim, device=device),
        )

    def forward(self, x: torch.Tensor, track_mask=None) -> torch.Tensor:
        if self.graph.engages(x.device):
            return self.graph(self._forward, x, track_mask)
        return self._forward(x, track_mask)

    def _forward(self, x: torch.Tensor, track_mask=None) -> torch.Tensor:
        b, n, t, _ = x.shape
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        tokens = self.input_transform(x)
        c = tokens.shape[-1]
        virtual = self.virual_tracks.expand(b, -1, t, -1).to(tokens.dtype)
        tokens = torch.cat([tokens, virtual], dim=1)
        n_tot = tokens.shape[1]
        key_mask_bt = None if track_mask is None else track_mask.repeat_interleave(t, dim=0)

        j = 0
        for i, time_block in enumerate(self.time_blocks):
            tokens = time_block(tokens.reshape(b * n_tot, t, c)).reshape(b, n_tot, t, c)
            if self.add_space_attn and i % self.interval == 0:
                st = tokens.permute(0, 2, 1, 3).reshape(b * t, n_tot, c)
                point, virtual = st[:, :n], st[:, n:]
                virtual = self.space_virtual2point_blocks[j](virtual, point, key_mask=key_mask_bt)
                virtual = self.space_virtual_blocks[j](virtual)
                point = self.space_point2virtual_blocks[j](point, virtual)
                st = torch.cat([point, virtual], dim=1)
                tokens = st.reshape(b, t, n_tot, c).permute(0, 2, 1, 3)
                j += 1
        tokens = tokens[:, :n].float()
        if self.support_memory_tokens > 0:
            flat = tokens.reshape(b, n * t, c)
            flat_mask = None if track_mask is None else track_mask.repeat_interleave(t, dim=1)
            flat, _ = self.gnn(flat, self.support_memory.expand(b, -1, -1), mask0=flat_mask)
            tokens = flat.reshape(b, n, t, c)
        return self.flow_head(tokens)
