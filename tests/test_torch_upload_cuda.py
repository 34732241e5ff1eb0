"""The predictor's upload (`mvtracker_torch.device.to_device_fp32`) on the
card: a pinned uint8 clip crosses as one pinned host-to-device copy of its
own bytes, and is widened to fp32 on the card.

Marked `cuda`; the test skips on a host without a GPU. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_upload_cuda.py
"""

import json

import pytest
import torch

from mvtracker_torch.device import to_device_fp32

pytestmark = pytest.mark.cuda


def test_pinned_uint8_frames_cross_once_at_their_own_width(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (3, 8, 704, 1280, 3), dtype=torch.uint8, generator=gen).pin_memory()
    to_device_fp32(x[:1, :1], "cuda")  # the context and the first copy, outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        y = to_device_fp32(x, "cuda")
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    copies = [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("Memcpy")]
    htod = [e for e in copies if "HtoD" in e["name"]]
    assert [e["name"] for e in htod] == ["Memcpy HtoD (Pinned -> Device)"], copies
    assert htod[0]["args"]["bytes"] == x.nbytes
    assert not any("Pageable" in e["name"] for e in copies)
    assert y.dtype == torch.float32 and y.device.type == "cuda"
    assert torch.equal(y.cpu(), x.float())
