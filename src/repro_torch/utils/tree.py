"""Frozen dataclasses of tensors and the few tree helpers the engine
needs — the port's counterpart of ``repro/utils/pytree.py``.

A tree is a tensor (a leaf), ``None``, a ``tree_dataclass`` instance, a
tuple/list, or a dict; every other value passes through ``tree_map``
untouched.  ``is_leaf`` widens what counts as a leaf (``is_value``:
every non-container value but None).  Leaves carry a leading lane dim where the helpers below say
so (``tree_gather``/``tree_scatter``/``tree_where``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, TypeVar

import torch

_T = TypeVar("_T")


def tree_dataclass(cls: type[_T]) -> type[_T]:
    """Decorator: a frozen dataclass with ``replace(**changes)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def _replace(self: _T, **changes: Any) -> _T:
        return dataclasses.replace(self, **changes)

    cls.replace = _replace  # type: ignore[attr-defined]
    return cls


def _children(tree: Any) -> list[tuple[str, Any]] | None:
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    return None


def _rebuild(tree: Any, values: list[Any]) -> Any:
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
        return dataclasses.replace(tree, **dict(zip(names, values)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(values)
    return dict(zip(tree.keys(), values))


def _is_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def is_value(x: Any) -> bool:
    return x is not None


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] = _is_tensor) -> Any:
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves
    of ``rest``, which share its structure)."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest) if is_leaf(tree) else tree
    others = [_children(r) for r in rest]
    values = [
        tree_map(fn, v, *(o[i][1] for o in others), is_leaf=is_leaf)
        for i, (_, v) in enumerate(kids)
    ]
    return _rebuild(tree, values)


def tree_leaves_with_path(tree: Any, prefix: str = "",
                          is_leaf: Callable[[Any], bool] = _is_tensor
                          ) -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` pairs; a path joins field names, sequence
    indices and dict keys with dots (``env_states.pos``,
    ``tf_state.0.buf``)."""
    kids = _children(tree)
    if kids is None:
        if is_leaf(tree):
            yield prefix, tree
        return
    for name, v in kids:
        yield from tree_leaves_with_path(
            v, f"{prefix}.{name}" if prefix else name, is_leaf)


def tree_leaves(tree: Any, is_leaf: Callable[[Any], bool] = _is_tensor
                ) -> list[Any]:
    """The leaves of ``tree``, in ``tree_map``'s order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree, "", is_leaf)]


def tree_map_with_path(fn: Callable[[str, torch.Tensor], Any], tree: Any,
                       prefix: str = "") -> Any:
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree) if isinstance(tree, torch.Tensor) else tree
    return _rebuild(tree, [
        tree_map_with_path(fn, v, f"{prefix}.{name}" if prefix else name)
        for name, v in kids
    ])


def tree_gather(tree: Any, idx: torch.Tensor) -> Any:
    """Rows ``idx`` of the leading dim of every leaf."""
    return tree_map(lambda x: x.index_select(0, idx), tree)


def tree_scatter(tree: Any, idx: torch.Tensor, rows: Any) -> Any:
    """Out-of-place ``.at[idx].set(rows)`` on every leaf (``idx``
    unique), one ``index_copy`` each."""
    return tree_map(lambda x, r: x.index_copy(0, idx, r.to(x.dtype)),
                    tree, rows)


def lane_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (N,) lane mask reshaped to broadcast against (N, ...)."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def tree_where(mask: torch.Tensor, new: Any, old: Any) -> Any:
    """Per-leaf lane select: ``new`` where ``mask``, else ``old``."""
    return tree_map(lambda n, o: torch.where(lane_mask(mask, n), n, o),
                    new, old)


__all__ = [
    "is_value", "lane_mask", "tree_dataclass", "tree_gather", "tree_leaves",
    "tree_leaves_with_path", "tree_map", "tree_map_with_path",
    "tree_scatter", "tree_where",
]
