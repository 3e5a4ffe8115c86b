"""Tiny ``fire``-style CLI dispatcher (a copy of the JAX package's ``utils/cli.py``).

The reference exposes its CLIs via ``fire.Fire(fn)`` (cli_lora_add.py:117,
cli_lora_pti.py:769, cli_svd.py:114); fire isn't in this image, so this
module provides the subset used: call a function from argv with positional
args and ``--flag value`` / ``--flag=value`` keywords, with values parsed as
Python literals when possible (ints, floats, bools, lists, None).
"""

from __future__ import annotations

import ast
import inspect
import sys
from typing import Any, Callable, Optional, Sequence


def _parse_value(s: str) -> Any:
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def Fire(fn: Callable, argv: Optional[Sequence[str]] = None) -> Any:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = []
    kwargs = {}
    # signature-aware boolean flags: ``--overwrite lora.pt`` must not
    # swallow the positional when the parameter's default is a bool (real
    # fire does the same); explicit true/false after the flag still works
    try:
        bool_params = {
            name for name, p in inspect.signature(fn).parameters.items()
            if isinstance(p.default, bool)
        }
    except (TypeError, ValueError):
        bool_params = set()
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("--"):
            key = tok[2:]
            if "=" in key:
                key, val = key.split("=", 1)
                kwargs[key.replace("-", "_")] = _parse_value(val)
            else:
                name = key.replace("-", "_")
                nxt = argv[i + 1] if i + 1 < len(argv) else None
                if name in bool_params and (
                    nxt is None or nxt.lower() not in ("true", "false")
                ):
                    kwargs[name] = True
                elif nxt is not None and not nxt.startswith("--"):
                    kwargs[name] = _parse_value(nxt)
                    i += 1
                else:
                    kwargs[name] = True
        else:
            args.append(_parse_value(tok))
        i += 1

    if ("help" in kwargs) or ("h" in kwargs):
        sig = inspect.signature(fn)
        print(f"usage: {fn.__name__} " + " ".join(
            f"[--{name} {p.default!r}]" if p.default is not inspect.Parameter.empty
            else f"<{name}>"
            for name, p in sig.parameters.items()
        ))
        if fn.__doc__:
            print(fn.__doc__)
        return None
    return fn(*args, **kwargs)
