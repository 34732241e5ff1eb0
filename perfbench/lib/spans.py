"""Spans around the program's layers, set up from the benchmark's files.

Each `perfbench/spans/<name>.json` names one span `perfbench::<name>`:
- {"module": "fnet"}: a `record_function` range around every call of that
  submodule of the model, by forward pre- and post-hooks;
- {"function": "pkg.module:attr", "record": true, "keep": [i]}: the
  module attribute is replaced by a wrapper that opens the range around
  each call and, while recording, keeps each call's argument metadata
  (shape, dtype, element size of tensors; ints as they are) and copies of
  the arguments listed in `keep`.

A span on a part that older programs lack (a new submodule, run on the
parent with the new benchmark files) says `"optional": true`: where the
program lacks that part, the span is left out and named in `Spans.missing`
(the traced result line lists it under "spans_missing"), so its metrics
find nothing to read. Any other span whose part is missing is an error,
so that a metric never vanishes unseen when the program renames a part.

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
        self.missing: list[str] = []
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


def _target(model: torch.nn.Module, spec: dict):
    """The submodule or (module, attribute, function) a span names, or None
    where the program lacks it."""
    if "module" in spec:
        module = model
        for part in spec["module"].split("."):
            module = getattr(module, part, None)
        return module if isinstance(module, torch.nn.Module) else None
    mod_name, attr = spec["function"].split(":")
    try:
        mod = importlib.import_module(mod_name)
    except ModuleNotFoundError as exc:  # the named module itself, not one it imports
        if exc.name != mod_name and not mod_name.startswith(f"{exc.name}."):
            raise
        return None
    original = getattr(mod, attr, None)
    return None if original is None else (mod, attr, original)


def install(model: torch.nn.Module, specs: dict) -> Spans:
    spans = Spans()
    for name, spec in specs.items():
        target = _target(model, spec)
        if target is None:
            if not spec.get("optional", False):
                raise LookupError(f"span {name}: the program has no {spec.get('module') or spec['function']}")
            spans.missing.append(name)
        elif "module" in spec:
            spans._hook(name, target)
        else:
            mod, attr, original = target
            setattr(mod, attr, spans._wrap(name, original, spec))
            spans._undo.append(lambda mod=mod, attr=attr, original=original: setattr(mod, attr, original))
    return spans
