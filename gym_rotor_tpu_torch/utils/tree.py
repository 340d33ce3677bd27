"""Minimal pytree helpers over dataclasses, (named) tuples and dicts of tensors
(the port's stand-in for ``jax.tree.map`` on flax struct dataclasses)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over structurally identical trees."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        items = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in field-declaration order (the order ``tree_map`` visits)."""
    out: List[torch.Tensor] = []
    tree_map(lambda x: out.append(x), tree)
    return out


def tree_named_leaves(tree: Any, prefix: str = "") -> List[tuple]:
    """``[(dotted.path, leaf), ...]`` over nested dataclasses, in
    field-declaration order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            out += tree_named_leaves(getattr(tree, f.name),
                                     f"{prefix}{f.name}.")
        return out
    return [(prefix[:-1], tree)]


def tree_from_named(template: Any, leaves: dict, prefix: str = "") -> Any:
    """Rebuild ``template``'s dataclass structure from ``{path: leaf}``."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{
            f.name: tree_from_named(getattr(template, f.name), leaves,
                                    f"{prefix}{f.name}.")
            for f in dataclasses.fields(template)})
    return leaves[prefix[:-1]]


def select(flag: torch.Tensor, new: Any, old: Any) -> Any:
    """``where(flag, new, old)`` leafwise, broadcasting ``flag`` over each
    leaf's trailing dims (batch.py ``sel``)."""
    def pick(a, b):
        f = flag.reshape(flag.shape + (1,) * (a.dim() - flag.dim()))
        return torch.where(f, a, b)
    return tree_map(pick, new, old)
