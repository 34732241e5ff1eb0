"""Lower-precision round trips of the reference's products.

`bf16` gives the deviation that the configuration's own precision causes,
which the correctness check measures the program's deviation in; `fp8_e4m3`
is the control, the step below it.

`fp8_e4m3(x)`: x scaled by one factor for the whole tensor so that its
largest magnitude maps to e4m3's largest finite value (448), rounded to
`torch.float8_e4m3fn` and back, then unscaled: the per-tensor scaled fp8
that an fp8 inference path computes its products in. The control applies it
to every operand of the reference's convolutions, dense layers, attention
products and correlation, where the program computes in bf16."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = E4M3_MAX / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    """A bf16 round trip."""
    return x.to(torch.bfloat16).float()


LOWP = {"fp8_e4m3": fp8_e4m3, "bf16": bf16}
