"""Which modules a benchmark process may not hold: the JAX stack and the
JAX package that the program was ported from. Names are compared by their
whole top-level part, the text before the first dot, because the program's
package name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mvtracker_tpu"})


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules (or `names`) whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
