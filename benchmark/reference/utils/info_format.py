"""Parser for Boost property-tree INFO files (utils/info_format.py
counterpart: numpy only, the same code as the JAX package's; the port keeps
its own copy so that it never imports the JAX package).

The reference robot configs (task.info / reference.info / gait.info)
use Boost's INFO format.  Supporting it natively lets users point this
framework at their existing robot config sets unchanged.

Grammar subset supported (all the reference files need):
  key value          -> leaf
  key { ... }        -> subtree
  key                -> subtree opened by "{" on the following line
  ; and // comments, trailing comments after values
  quoted strings

Additionally this module decodes the reference's Eigen-matrix conventions:
``(i,0) v`` entries for vectors, ``(i,j) v`` with optional ``scaling`` for
matrices (loadData::loadEigenMatrix semantics), and ``[i] v`` entries for
std::vector loading (loadData::loadStdVector).
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np

_TOKEN_RE = re.compile(r'"[^"]*"|\{|\}|[^\s{}]+')


def _strip_comments(text: str) -> str:
    out_lines = []
    for line in text.splitlines():
        # remove ';' and '//' comments (INFO uses ';'; the reference mixes both)
        for marker in (";", "//"):
            idx = line.find(marker)
            if idx >= 0:
                line = line[:idx]
        out_lines.append(line)
    return "\n".join(out_lines)


def parse_info(text: str) -> dict:
    """Parse INFO text into a nested dict of str -> (str | dict)."""
    tokens = _TOKEN_RE.findall(_strip_comments(text))
    root: dict = {}
    stack = [root]
    pending_key: str | None = None
    for tok in tokens:
        if tok == "{":
            sub: dict = {}
            key = pending_key if pending_key is not None else ""
            stack[-1][key] = sub
            stack.append(sub)
            pending_key = None
        elif tok == "}":
            if pending_key is not None:
                stack[-1][pending_key] = ""
                pending_key = None
            stack.pop()
        else:
            val = tok[1:-1] if tok.startswith('"') else tok
            if pending_key is None:
                pending_key = val
            else:
                stack[-1][pending_key] = val
                pending_key = None
    if pending_key is not None:
        stack[-1][pending_key] = ""
    return root


def load_info(path: str) -> dict:
    with open(path) as f:
        return parse_info(f.read())


def get_node(tree: dict, dotted: str, default: Any = None) -> Any:
    node: Any = tree
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def get_scalar(tree: dict, dotted: str, default: float | None = None) -> float:
    v = get_node(tree, dotted)
    if v is None:
        if default is None:
            raise KeyError(dotted)
        return default
    return float(v)


def get_bool(tree: dict, dotted: str, default: bool | None = None) -> bool:
    v = get_node(tree, dotted)
    if v is None:
        if default is None:
            raise KeyError(dotted)
        return default
    return str(v).strip().lower() in ("true", "1")


def get_string(tree: dict, dotted: str, default: str | None = None) -> str:
    v = get_node(tree, dotted)
    if v is None:
        if default is None:
            raise KeyError(dotted)
        return default
    return str(v)


def get_string_list(tree: dict, dotted: str) -> list[str]:
    """Decode a ``[i] value`` block (loadStdVector semantics)."""
    node = get_node(tree, dotted)
    if node is None:
        return []
    items = []
    for key, val in node.items():
        m = re.fullmatch(r"\[(\d+)\]", key)
        if m:
            items.append((int(m.group(1)), val))
    items.sort()
    return [v for _, v in items]


def get_scalar_list(tree: dict, dotted: str) -> list[float]:
    return [float(v) for v in get_string_list(tree, dotted)]


def get_matrix(tree: dict, dotted: str, rows: int, cols: int = 1) -> np.ndarray:
    """Decode ``(i,j) value`` entries with optional ``scaling`` factor
    (loadEigenMatrix semantics; scaling supports forms like ``1e-3``)."""
    node = get_node(tree, dotted)
    if node is None:
        raise KeyError(dotted)
    out = np.zeros((rows, cols))
    scaling = 1.0
    for key, val in node.items():
        if key == "scaling":
            scaling = float(val)
            continue
        m = re.fullmatch(r"\((\d+),(\d+)\)", key)
        if m:
            out[int(m.group(1)), int(m.group(2))] = float(val)
    out *= scaling
    return out[:, 0] if cols == 1 else out
