"""Spans around the program's layers, set up from the benchmark's files.

Each `perfbench/spans/<name>.json` names one span `perfbench::<name>`:
- {"module": "fnet"}: a `record_function` range around every call of that
  submodule of the model, by forward pre- and post-hooks;
- {"function": "pkg.module:attr", "record": true, "keep": [i]}: the
  module attribute is replaced by a wrapper that opens the range around
  each call and, while recording, keeps each call's argument metadata
  (shape, dtype, element size of tensors; ints as they are) and copies of
  the arguments listed in `keep`.

`install` returns a `Spans` whose `close()` removes every hook and wrapper.
A `FlopCounterMode` given to `Spans.flop_counter` has what it counts inside
the wrapped functions subtracted into `flops_inside` (the plain versions
run on the CPU; the kernels, called through ctypes, it never sees).
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import torch
from torch.profiler import record_function

PREFIX = "perfbench::"


def load_specs(root: Path) -> dict:
    return {p.stem: json.loads(p.read_text()) for p in sorted((root / "spans").glob("*.json"))}


def _meta(x):
    if torch.is_tensor(x):
        return {"shape": tuple(x.shape), "dtype": str(x.dtype).replace("torch.", ""), "itemsize": x.element_size()}
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    return type(x).__name__


class Spans:
    def __init__(self):
        self.calls: dict[str, list] = {}
        self.recording = False
        self.flop_counter = None
        self.flops_inside = 0
        self._undo = []

    def close(self):
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()

    def _wrap(self, name, fn, spec):
        keep = spec.get("keep", [])
        record = spec.get("record", False)

        def wrapper(*args, **kwargs):
            with record_function(PREFIX + name):
                if self.recording and record:
                    self.calls.setdefault(name, []).append(
                        {"args": [_meta(a) for a in args],
                         "kept": {i: args[i].detach().clone() for i in keep if i < len(args)}})
                before = self.flop_counter.get_total_flops() if self.flop_counter is not None else 0
                out = fn(*args, **kwargs)
                if self.flop_counter is not None:
                    self.flops_inside += self.flop_counter.get_total_flops() - before
                return out

        return wrapper

    def _hook(self, name, module):
        stack = []

        def pre(mod, args):
            rf = record_function(PREFIX + name)
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            stack.pop().__exit__(None, None, None)

        handles = [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
        self._undo.append(lambda: [h.remove() for h in handles])


def install(model: torch.nn.Module, specs: dict) -> Spans:
    spans = Spans()
    for name, spec in specs.items():
        if "module" in spec:
            module = model
            for part in spec["module"].split("."):
                module = getattr(module, part)
            spans._hook(name, module)
        else:
            mod_name, attr = spec["function"].split(":")
            mod = importlib.import_module(mod_name)
            original = getattr(mod, attr)
            setattr(mod, attr, spans._wrap(name, original, spec))
            spans._undo.append(lambda mod=mod, attr=attr, original=original: setattr(mod, attr, original))
    return spans
