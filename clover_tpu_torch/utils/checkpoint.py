"""Checkpoint / resume for quantized containers and solver state
(counterpart of clover_tpu/utils/checkpoint.py, on ``torch.save`` and a
weights-only ``torch.load`` instead of Orbax).

    save(path, {"phi": qphi, "x": x, "step": 123})
    state = load(path, like={"phi": qphi0, "x": x0, "step": 0})

A state is a tree of dicts, lists and tuples whose leaves are tensors,
numbers, strings, None or quantized containers.  A container is stored as
its type name plus its fields (tensors and ints), so a weights-only load,
which unpickles nothing but such plain data, can rebuild it.  ``load``
places every tensor on the device of its counterpart in ``like``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import formats

_CONTAINERS = {cls.__name__: cls for cls in (
    *formats.VECTOR_TYPES.values(), *formats.MATRIX_TYPES.values())}
_TAG = "__container__"


def _encode(state):
    if isinstance(state, tuple(_CONTAINERS.values())):
        return {_TAG: type(state).__name__,
                **{f.name: getattr(state, f.name)
                   for f in dataclasses.fields(state)}}
    if isinstance(state, dict):
        return {k: _encode(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_encode(v) for v in state]
    if isinstance(state, tuple):           # a NamedTuple is stored plain
        return tuple(_encode(v) for v in state)
    return state


def _decode(data, like):
    if isinstance(data, dict) and _TAG in data:
        name = data[_TAG]
        if type(like).__name__ != name:
            raise TypeError(f"checkpoint holds a {name} where like has a "
                            f"{type(like).__name__}")
        return _CONTAINERS[name](**{k: _decode(v, getattr(like, k))
                                    for k, v in data.items() if k != _TAG})
    if isinstance(data, dict):
        return {k: _decode(v, like.get(k) if isinstance(like, dict) else None)
                for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        if not isinstance(like, (list, tuple)) or len(like) != len(data):
            raise TypeError(f"checkpoint holds a sequence of {len(data)} "
                            f"where like has {like!r:.60}")
        items = [_decode(v, w) for v, w in zip(data, like)]
        if isinstance(like, tuple) and hasattr(like, "_fields"):
            return type(like)(*items)
        return type(data)(items)
    if isinstance(data, torch.Tensor) and isinstance(like, torch.Tensor):
        return data.to(like.device)
    return data


def save(path: str, state) -> None:
    """Write ``state`` (containers allowed) to ``path``."""
    torch.save(_encode(state), path)


def load(path: str, like):
    """Restore a state saved by :func:`save`, weights-only.

    ``like`` is a matching tree (the initial state of a solve); each
    stored tensor goes to the device of its counterpart there."""
    return _decode(torch.load(path, map_location="cpu", weights_only=True),
                   like)
