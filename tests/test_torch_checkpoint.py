"""Checkpoints (clover_tpu_torch.utils.checkpoint) on the CPU: a round trip
of every container type, plain tensors, ints and nested sequences, bytes
equal; the load is weights-only; every tensor follows ``like``'s device.

clover_tpu saves through Orbax, which is not installed here, so the
reference's side is its quantized containers: the same NumPy draws,
quantized by clover_tpu, must equal the loaded containers byte for byte.
"""

import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu_torch.models.solvers import SolveResult
from clover_tpu_torch.utils import checkpoint
from torch_helpers import to_numpy, to_torch

BITS = (4, 8, 16, 32)


def _state(rng):
    """Every container type (from clover_tpu's quantize of NumPy draws),
    a solver result, a tensor, an int, a float, a string and None."""
    a = rng.random((130, 200), dtype=np.float32) * 2 - 1
    v = rng.random(300, dtype=np.float32) * 2 - 1
    jax_side = {**{f"mat{b}": ct.quantize(jnp.asarray(a), b) for b in BITS},
                **{f"vec{b}": ct.quantize(jnp.asarray(v), b) for b in BITS}}
    state = {name: to_torch(q) for name, q in jax_side.items()}
    x = state["vec8"]
    state.update(result=SolveResult(x=x, trace=torch.arange(5.0)),
                 pair=(torch.ones(3, dtype=torch.int8), [7, "iht"]),
                 step=123, mu=2.5e-4, note="after 123 steps", nothing=None)
    return state, jax_side


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if hasattr(a, "__dataclass_fields__"):
        return type(a) is type(b) and all(
            _same(getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__)
    return a == b


def test_round_trip_of_every_container(rng, tmp_path):
    state, jax_side = _state(rng)
    path = tmp_path / "state.pt"
    checkpoint.save(str(path), state)
    got = checkpoint.load(str(path), like=state)
    assert _same(got, state)
    assert isinstance(got["result"], SolveResult)
    assert got["step"] == 123 and isinstance(got["step"], int)
    for name, q in jax_side.items():
        kind, codes, scales, meta = to_numpy(got[name])
        want = to_numpy(q)
        assert (kind, meta) == (want[0], want[3]), name
        np.testing.assert_array_equal(codes, want[1])
        if scales is not None:
            np.testing.assert_array_equal(scales, want[2])


def test_load_is_weights_only(rng, tmp_path, monkeypatch):
    state, _ = _state(rng)
    path = tmp_path / "state.pt"
    checkpoint.save(str(path), state)
    seen = []
    real = torch.load

    def recording(*args, **kwargs):
        seen.append(kwargs.get("weights_only"))
        return real(*args, **kwargs)
    monkeypatch.setattr(torch, "load", recording)
    checkpoint.load(str(path), like=state)
    assert seen == [True]
    # a file holding an arbitrary pickled object is refused
    bad = tmp_path / "bad.pt"
    torch.save({"x": _Opaque()}, bad)
    with pytest.raises(pickle.UnpicklingError):
        checkpoint.load(str(bad), like={"x": None})


class _Opaque:
    pass


@pytest.mark.parametrize("bits", BITS)
def test_load_follows_like_device(rng, tmp_path, bits):
    """Tensors go to the device of their counterpart in ``like`` (the meta
    device stands in for a card here)."""
    q = tt.quantize(torch.from_numpy(
        rng.random((64, 128), dtype=np.float32)), bits)
    path = tmp_path / "q.pt"
    checkpoint.save(str(path), {"phi": q, "scale": torch.ones(2)})
    like = {"phi": tt.to_device(q, "meta"), "scale": torch.ones(2)}
    got = checkpoint.load(str(path), like)
    fields = [getattr(got["phi"], f) for f in got["phi"].__dataclass_fields__]
    assert all(t.device.type == "meta" for t in fields
               if isinstance(t, torch.Tensor))
    assert got["scale"].device.type == "cpu"


def test_load_refuses_another_container_type(rng, tmp_path):
    q = tt.quantize(torch.rand(128), 4)
    path = tmp_path / "q.pt"
    checkpoint.save(str(path), {"x": q})
    with pytest.raises(TypeError, match="QVec4"):
        checkpoint.load(str(path), like={"x": tt.quantize(torch.rand(128), 8)})
