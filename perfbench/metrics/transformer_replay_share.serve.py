"""transformer_replay_share.serve (%): of the update transformer's calls a
request (the program's `transformer` spans), the share that only replayed
a CUDA graph captured earlier in the same forward (`transformer_replay`);
the rest captured it (`transformer_capture`) or ran eagerly. One capture a
forward reads 100 (calls - 1) / calls. None where the program replays no
graph of the transformer (opens neither span)."""


def read(t):
    spans = (t.program or {}).get("spans", {})
    if not spans.get("transformer", {}).get("calls"):
        return None
    if "transformer_replay" not in spans and "transformer_capture" not in spans:
        return None
    return 100.0 * spans.get("transformer_replay", {}).get("calls", 0) / spans["transformer"]["calls"]
