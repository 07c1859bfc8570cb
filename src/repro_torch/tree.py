"""Minimal pytree helpers for the port's nested dict / list params.

The port keeps the JAX package's parameter layout — nested dicts and lists
of tensors, with ``None`` for empty slots — so these few functions stand in
for ``jax.tree.map`` / ``jax.tree.leaves``.  A NamedTuple (a train state)
is rebuilt field by field.
"""

from __future__ import annotations

import repro_torch._fp32  # noqa: F401  (TF32 off before any torch work)
from typing import Any, Callable, List, Tuple

import torch


def _rebuild(seq, items):
    """A list / tuple / NamedTuple like ``seq`` holding ``items``."""
    items = list(items)
    return type(seq)(*items) if hasattr(seq, "_fields") else type(seq)(items)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every tensor leaf (and its counterparts in ``rest``),
    rebuilding fresh containers; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, (tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def flatten(tree: Any) -> Tuple[List[torch.Tensor], Any]:
    """(leaves, treedef): the treedef is the tree with leaf indices."""
    leaves: List[torch.Tensor] = []

    def index(x):
        leaves.append(x)
        return len(leaves) - 1

    return leaves, tree_map(index, tree)


def unflatten(treedef: Any, leaves: List[torch.Tensor]) -> Any:
    if isinstance(treedef, dict):
        return {k: unflatten(v, leaves) for k, v in treedef.items()}
    if isinstance(treedef, (list, tuple)):
        return _rebuild(treedef, (unflatten(v, leaves) for v in treedef))
    if treedef is None:
        return None
    return leaves[treedef]
