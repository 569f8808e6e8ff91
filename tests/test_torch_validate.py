"""The ``-v`` validation mode of clover_tpu_torch on the CPU (the kernels'
plain versions), against clover_tpu's: the same checks by name, the same
NumPy draws, the port's copy of golden.py bit for bit clover_tpu's, failure
dumps, the CLI's exit code, and the debug printers."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
from clover_tpu import golden as ct_golden
from clover_tpu.harness import validate as ct_validate
from clover_tpu_torch import cli, golden
from clover_tpu_torch.harness import validate
from clover_tpu_torch.utils import compare, format_blocks, format_qvec

VEC_SIZES = [128, 200]
MAT_SHAPES = [(200, 300), (512, 512)]


def _run(module, monkeypatch, **kw):
    """-> (passed, log lines, the sweep's generator after the run)."""
    lines, made = [], []
    real = np.random.default_rng

    def recording(seed):
        made.append(real(seed))
        return made[-1]

    with monkeypatch.context() as m:
        m.setattr(np.random, "default_rng", recording)
        ok = module.run_validation(vec_sizes=VEC_SIZES, mat_shapes=MAT_SHAPES,
                                   log=lines.append, **kw)
    return ok, lines, made[0]


@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp:
        return _run(ct_validate, mp)


def _names(lines):
    return [line[len("Validating "):].rsplit(" ", 1)[0].rstrip()
            for line in lines if line.startswith("Validating ")]


def test_validation_passes_on_cpu(monkeypatch):
    ok, lines, _ = _run(validate, monkeypatch, device="cpu")
    assert ok and lines[-1] == f"\n{len(_names(lines))} checks, 0 failures"
    assert not any("Failed" in line for line in lines)


def test_check_names_and_draws_match_jax(monkeypatch, reference):
    """The port runs clover_tpu's checks in its order, plus the
    whole-iteration and chain-of-4 rows where its iteration kernels are
    eligible (512x512), and leaves the generator where clover_tpu's run
    leaves it: the same draws, the int4 rows' included."""
    ok, lines, rng = _run(validate, monkeypatch, device="cpu")
    ref_ok, ref_lines, ref_rng = reference
    assert ok and ref_ok
    extra = [n for n in _names(lines) if n.startswith(("iteration", "chain"))]
    assert extra == ["iteration  4x 4-bit 512x512", "chain4  4x 4-bit 512x512",
                     "iteration  4x 8-bit 512x512", "chain4  4x 8-bit 512x512"]
    assert [n for n in _names(lines) if n not in extra] == _names(ref_lines)
    assert rng.bit_generator.state == ref_rng.bit_generator.state


def test_golden_copy_matches_jax():
    """Every function of the port's golden.py against clover_tpu's on the
    same random inputs: bit for bit (its divide is NumPy's, equal to XLA's
    IEEE divide on the CPU)."""
    rng = np.random.default_rng(7)
    s = (rng.random(2_000_000, dtype=np.float32) * 3).astype(np.float32)
    s[:1000] = rng.random(1000, dtype=np.float32) * 1e-30
    for num, den in ((7.0, s), (127.0, s), (s, 7.0), (s, 127.0)):
        np.testing.assert_array_equal(
            golden._xla_div(num, den).view(np.uint32),
            ct_golden._xla_div(num, den).view(np.uint32))
    x = rng.random(1024, dtype=np.float32) * 2 - 1
    x[:64] = 0.0
    a = rng.random((256, 384), dtype=np.float32) * 2 - 1
    noise = rng.random(1024, dtype=np.float32)
    cases = [("block_scales", (x,)), ("tile_scales", (a,))]
    for bits in (4, 8):
        qmax = 7 if bits == 4 else 127
        codes = rng.integers(-qmax, qmax + 1, 1024).astype(np.int8)
        codes2 = rng.integers(-qmax, qmax + 1, 1024).astype(np.int8)
        mc = rng.integers(-qmax, qmax + 1, (256, 384)).astype(np.int8)
        sc = rng.random(16, dtype=np.float32) + 0.1
        sc2 = rng.random(16, dtype=np.float32) + 0.1
        ms = rng.random((4, 6), dtype=np.float32) + 0.1
        cases += [
            ("quantize_vec", (x, bits, 0.0)), ("quantize_vec", (x, bits, noise)),
            ("restore_vec", (codes, sc, bits)),
            ("quantize_mat", (a, bits, 0.0)), ("restore_mat", (mc, ms, bits)),
            ("dot", (codes, sc, codes2, sc2, bits)),
            ("scale_and_add", (codes, sc, codes2, sc2, -0.5, bits, noise)),
            ("mvm_f32_exact", (mc[:, :128], ms[:, :2], codes2[:128], sc2[:2],
                               bits)),
            ("mvm", (mc[:, :128], ms[:, :2], codes2[:128], sc2[:2], bits)),
            ("mvm_mixed", (mc, ms, bits, x[:384])),
            ("threshold", (codes, sc, 100, 1000, bits))]
    for bits in (16, 32):
        cases.append(("restore_vec", (x, None, bits)))
    cases.append(("threshold_f32", (x, 100, 1000)))

    def leaves(r):
        return [np.atleast_1d(np.asarray(a))
                for a in (r if isinstance(r, tuple) else (r,))]

    for name, args in cases:
        got = leaves(getattr(golden, name)(*args))
        want = leaves(getattr(ct_golden, name)(*args))
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                          err_msg=name)


def test_planted_fault_fails_with_a_dump(monkeypatch):
    """A wrong dot prints a Failed line and the side-by-side dump, and the
    run returns False; the CLI then exits 1."""
    real = validate.dot
    monkeypatch.setattr(validate, "dot", lambda u, v: real(u, v) + 1.0)
    lines = []
    ok = validate.run_validation(vec_sizes=[128], mat_shapes=[],
                                 log=lines.append, device="cpu")
    assert not ok
    failed = [i for i, line in enumerate(lines) if line.endswith("Failed")]
    assert [lines[i].split()[1] for i in failed] == ["dot"] * 2
    assert all("mismatch" in lines[i + 1] for i in failed)
    assert lines[-1].endswith(f"checks, {len(failed)} failures")
    monkeypatch.setattr(validate, "DEFAULT_VEC_SIZES", [128])
    monkeypatch.setattr(validate, "DEFAULT_MAT_SHAPES", [])
    assert cli.main(["-v", "--device", "cpu"]) == 1


def test_cli_validate_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(validate, "DEFAULT_VEC_SIZES", [129])
    monkeypatch.setattr(validate, "DEFAULT_MAT_SHAPES", [(128, 256)])
    assert cli.main(["-v", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device   : cpu" in out and "TF32 off" in out
    assert out.rstrip().endswith("25 checks, 0 failures")
    assert "Validating mvm  4x32-bit 128x256" in out
    assert cli.main([]) == 0 and "--validate" in capsys.readouterr().out


def test_debug_printers():
    """As tests/test_harness.py holds clover_tpu's; the port's take tensors
    and NumPy arrays alike."""
    import clover_tpu_torch as tt
    q = tt.quantize(torch.linspace(-1, 1, 200), 4)
    s = format_qvec(q, max_elems=8)
    assert "code" in s and "scale" in s and s.count("\n") == 8
    jq = ct.quantize(jnp.asarray(np.linspace(-1, 1, 200, dtype=np.float32)),
                     4)
    from clover_tpu.utils.debug import format_qvec as ct_format_qvec
    assert s == ct_format_qvec(jq, max_elems=8)
    c = compare([1, 2, 3], [1, 9, 3])
    assert "mismatch" in c
    assert compare(torch.tensor([1, 2, 3]), np.array([1, 9, 3])) == c
    assert "[     0]" in format_blocks(np.arange(32))
    assert format_blocks(torch.arange(32)) == format_blocks(np.arange(32))
