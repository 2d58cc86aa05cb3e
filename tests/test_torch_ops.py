"""The port's primitive ops (katsdpsigproc_tpu_torch.ops) against the JAX
package's, on the CPU.

Each input is made from a seed with numpy and fed to both.  Templates are
built from the same JAX tuning on both sides, the port's through
``tune.from_jax_tuning``.  A JAX template whose engine is ``"pallas"`` runs
its kernel in interpret mode, as the JAX package's own tests run it here.

Tolerances:

* K4's plain version (``percentile5_plain``) against the JAX Pallas kernel
  in interpret mode: bit for bit, on amplitudes and on NaN-bearing rows.
  K4's radix select step by step (``percentile5_radix_plain``) against
  both: bit for bit, on rows of NaN, +-inf, -0, negatives, denormals and
  ties.  Against JAX, not on denormals (XLA on the CPU flushes them to
  zero) and not the min of a row whose min is -0 (its reduction returns
  +0).
  Every port engine against ``np.percentile(..., method="lower")``: exact
  on float32 amplitudes; on complex64 input rtol 1e-6, as
  ``tests/test_ops.py`` allows (the amplitude may differ from numpy's by
  one ulp).
* K5's plain version against the JAX Pallas kernel in interpret mode, and
  the torch engine against the XLA engine: exact.
* ``maskedsum`` and ``plus`` reductions and scans: rtol 1e-5 against JAX,
  because torch and XLA sum in different orders.
* max, min, fmax, fmin reductions and scans, a user operator's scan, and
  fill: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from katsdpsigproc_tpu.ops import (
    fill as jfill,
    maskedsum as jms,
    percentile as jpct,
    reduce as jreduce,
    transpose as jtr,
    wgreduce as jwg,
)
from katsdpsigproc_tpu_torch.ops import fill, maskedsum, percentile, reduce as hreduce, transpose
from katsdpsigproc_tpu_torch.ops import wgreduce
from katsdpsigproc_tpu_torch.pytest_plugin import patch_autotune  # noqa: F401
from katsdpsigproc_tpu_torch.scripts import common
from katsdpsigproc_tpu_torch.utils import tune

from .helpers import complex_normal


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.fixture
def ctx(patch_autotune):  # noqa: F811
    from katsdpsigproc_tpu_torch.utils import backend

    return backend.create_some_context()


class TestFill:
    @pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.complex64])
    def test_fill(self, ctx, dtype):
        op = fill.FillTemplate(ctx, dtype).instantiate(None, (83, 107))
        op.set_value(4)
        op.ensure_all_bound()
        op()
        jop = jfill.FillTemplate(None, dtype).instantiate(None, (83, 107))
        jop.set_value(4)
        jop.ensure_all_bound()
        jop()
        np.testing.assert_array_equal(op.buffer("data").numpy(), np.asarray(jop.buffer("data")))
        assert op.parameters()["shape"] == (83, 107)


def _transpose_src(rs, dtype, shape):
    if dtype == np.complex64:
        return complex_normal(rs, size=shape).astype(dtype)
    return rs.uniform(0, 100, shape).astype(dtype)


class TestTranspose:
    @pytest.mark.parametrize("jax_tuning", [
        {"engine": "xla", "tile_r": 256, "tile_c": 256},
        {"engine": "pallas", "tile_r": 512, "tile_c": 512},
    ])
    @pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.uint8])
    @pytest.mark.parametrize("shape", [(53, 7), (73, 521)])
    def test_template_matches_jax(self, ctx, jax_tuning, dtype, shape):
        src = _transpose_src(np.random.RandomState(seed=1), dtype, shape)
        jtmpl = jtr.TransposeTemplate(None, dtype, tuning=jax_tuning)
        tmpl = transpose.TransposeTemplate(ctx, dtype, tuning=tune.from_jax_tuning(jax_tuning))
        assert tmpl.engine == {"xla": "torch", "pallas": "cuda"}[jax_tuning["engine"]]
        out = tmpl.instantiate(None, shape)(src=_t(src))["dest"]
        want = jtr.transpose(jnp.asarray(src), jtmpl, interpret=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        assert out.is_contiguous()

    @pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.uint8])
    @pytest.mark.parametrize("shape", [(16, 384), (130, 260)])
    def test_plain_matches_pallas_interpret(self, dtype, shape):
        src = _transpose_src(np.random.RandomState(seed=1), dtype, shape)
        want = jtr._pallas_transpose(jnp.asarray(src), 8, 128, interpret=True)
        np.testing.assert_array_equal(transpose.transpose_plain(_t(src)).numpy(), np.asarray(want))
        # On a CPU tensor K5's wrapper takes its plain version.
        np.testing.assert_array_equal(transpose.transpose_cuda(_t(src)).numpy(), np.asarray(want))

    def test_planar_matches_pallas_interpret(self):
        src = np.random.RandomState(seed=2).uniform(0, 100, (48, 260, 2)).astype(np.float32)
        want = jtr._pallas_transpose(jnp.asarray(src), 8, 128, interpret=True)
        got = transpose.transpose_cuda(_t(src))
        assert got.shape == (260, 48, 2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("seed", np.random.RandomState(12).randint(0, 1 << 30, size=6))
    def test_random_shapes(self, seed):
        rs = np.random.RandomState(seed)
        data = rs.standard_normal((int(rs.randint(1, 300)), int(rs.randint(1, 300))))
        data = data.astype(np.float32)
        np.testing.assert_array_equal(transpose.transpose(_t(data)).numpy(),
                                      np.asarray(jtr.transpose(jnp.asarray(data))))

    def test_rejects_other_layouts(self):
        with pytest.raises(ValueError):
            transpose.transpose_plain(torch.zeros((2, 3, 4)))
        with pytest.raises(ValueError, match="engine"):
            transpose.transpose(torch.zeros((2, 3)),
                                transpose.TransposeTemplate(None, np.float32,
                                                            tuning={"engine": "xla"}))


class TestMaskedSum:
    @pytest.mark.parametrize("use_amplitudes", [False, True])
    def test_matches_jax(self, ctx, use_amplitudes):
        shape = (223, 497)
        rs = np.random.RandomState(seed=1)
        src = complex_normal(rs, size=shape).astype(np.complex64)
        mask = rs.uniform(size=(shape[0],)).astype(np.float32)
        op = maskedsum.MaskedSumTemplate(ctx, use_amplitudes).instantiate(None, shape)
        out = op(src=_t(src), mask=_t(mask))["dest"].numpy()
        jop = jms.MaskedSumTemplate(None, use_amplitudes).instantiate(None, shape)
        want = np.asarray(jop(src=jnp.asarray(src), mask=jnp.asarray(mask))["dest"])
        assert out.dtype == want.dtype
        # Summation order differs between torch and XLA.
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
        terms = np.abs(src) if use_amplitudes else src
        np.testing.assert_allclose(out, (mask[:, None] * terms).sum(axis=0), rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("seed", np.random.RandomState(14).randint(0, 1 << 30, size=4))
    @pytest.mark.parametrize("use_amplitudes", [False, True])
    def test_planar_matches_jax(self, seed, use_amplitudes):
        rs = np.random.RandomState(seed)
        rows, cols = int(rs.randint(2, 400)), int(rs.randint(1, 60))
        cdata = (rs.standard_normal((rows, cols))
                 + 1j * rs.standard_normal((rows, cols))).astype(np.complex64)
        planar = np.stack([cdata.real, cdata.imag], axis=-1).astype(np.float32)
        mask = (rs.random_sample(rows) < 0.7).astype(np.float32)
        got = maskedsum.maskedsum(_t(planar), _t(mask), use_amplitudes).numpy()
        want = np.asarray(jms.maskedsum(jnp.asarray(planar), jnp.asarray(mask), use_amplitudes))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class TestHReduce:
    @pytest.mark.parametrize("op_name", ["plus", "max", "min", "fmax", "fmin"])
    @pytest.mark.parametrize("column_range", [None, (7, 300)])
    def test_named_ops_match_jax(self, ctx, op_name, column_range):
        shape = (129, 409)
        src = np.random.RandomState(seed=1).standard_normal(shape).astype(np.float32)
        src[3, 10:20] = np.nan
        if op_name in ("plus", "max", "min"):
            src[3] = 0.5  # NaN only where the operator ignores it
        op = hreduce.HReduceTemplate(ctx, np.float32, op=op_name).instantiate(
            None, shape, column_range)
        out = op(src=_t(src))["dest"].numpy()
        jop = jreduce.HReduceTemplate(None, np.float32, op=op_name).instantiate(
            None, shape, column_range)
        want = np.asarray(jop(src=jnp.asarray(src))["dest"])
        if op_name == "plus":
            # Summation order differs between torch and XLA.
            np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(out, want)

    def test_custom_op_matches_jax(self, ctx):
        src = np.random.RandomState(seed=1).standard_normal((16, 33)).astype(np.float32)
        op = hreduce.HReduceTemplate(ctx, np.float32, op=torch.maximum,
                                     identity=-np.inf).instantiate(None, (16, 33))
        jop = jreduce.HReduceTemplate(None, np.float32, op=jnp.maximum,
                                      identity=-np.inf).instantiate(None, (16, 33))
        np.testing.assert_array_equal(op(src=_t(src))["dest"].numpy(),
                                      np.asarray(jop(src=jnp.asarray(src))["dest"]))

    def test_column_range_validation(self, ctx):
        template = hreduce.HReduceTemplate(ctx, np.float32, op="plus")
        with pytest.raises(ValueError):
            template.instantiate(None, (4, 8), (5, 3))
        with pytest.raises(ValueError):
            template.instantiate(None, (4, 8), (0, 9))
        with pytest.raises(ValueError):
            template.instantiate(None, (4, 8, 2))


class TestWgReduce:
    @pytest.mark.parametrize("seed", np.random.RandomState(13).randint(0, 1 << 30, size=4))
    def test_reduce_matches_jax(self, seed):
        rs = np.random.RandomState(seed)
        data = rs.standard_normal((int(rs.randint(1, 50)), int(rs.randint(1, 500))))
        data = data.astype(np.float32)
        nan_data = data.copy()
        nan_data[0, :] = np.nan
        nan_data[:, 0] = np.nan
        for name in ("plus", "max", "min", "fmax", "fmin"):
            x = nan_data if name.startswith("f") else data
            got = wgreduce.reduce(_t(x), wgreduce.BY_NAME[name], axis=1).numpy()
            want = np.asarray(jwg.reduce(jnp.asarray(x), jwg.BY_NAME[name], axis=1))
            if name == "plus":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(got, want)

    def test_custom_reduce(self):
        x = np.abs(np.random.RandomState(2).standard_normal((5, 37))).astype(np.float32) + 0.5
        mul = wgreduce.ReduceOp("prod", lambda a, b: a * b, lambda dt: torch.ones((), dtype=dt))
        np.testing.assert_allclose(wgreduce.reduce(_t(x), mul).numpy(), np.prod(x, axis=-1),
                                   rtol=1e-5)

    def _data(self):
        return np.random.RandomState(seed=5).standard_normal((6, 40)).astype(np.float32)

    @pytest.mark.parametrize("reverse", [False, True])
    @pytest.mark.parametrize("exclusive", [False, True])
    @pytest.mark.parametrize("name", ["plus", "max", "min", "fmax", "fmin"])
    def test_scan_matches_jax(self, name, reverse, exclusive):
        x = self._data()
        if name.startswith("f"):
            x[:, 7] = np.nan
            x[2, :3] = np.nan
        got = wgreduce.scan(_t(x), wgreduce.BY_NAME[name], axis=-1, reverse=reverse,
                            exclusive=exclusive).numpy()
        want = np.asarray(jwg.scan(jnp.asarray(x), jwg.BY_NAME[name], axis=-1, reverse=reverse,
                                   exclusive=exclusive))
        if name == "plus":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("reverse", [False, True])
    def test_custom_scan_matches_jax_associative_scan(self, reverse):
        x = np.abs(self._data()) + 0.1
        mul = wgreduce.ReduceOp("prod", lambda a, b: a * b, lambda dt: torch.ones((), dtype=dt))
        jmul = jwg.ReduceOp("prod", lambda a, b: a * b, lambda dt: jnp.ones((), dt))
        got = wgreduce.scan(_t(x), mul, axis=-1, reverse=reverse).numpy()
        want = np.asarray(jwg.scan(jnp.asarray(x), jmul, axis=-1, reverse=reverse))
        np.testing.assert_array_equal(got, want)  # the same pairing of the products


def _percentile_expected(amp):
    return np.r_[[np.min(amp, axis=1), np.max(amp, axis=1)],
                 np.percentile(amp, [25, 75, 50], axis=1, method="lower").astype(np.float32)]


class TestPercentile5:
    @pytest.mark.parametrize("jax_engine", ["rank", "sort", "pallas"])
    @pytest.mark.parametrize("is_amplitude", [True, False])
    @pytest.mark.parametrize("columns", [7, 241, 500])
    def test_vs_numpy_and_jax(self, ctx, jax_engine, is_amplitude, columns):
        rows = 37
        rs = np.random.RandomState(seed=1)
        if is_amplitude:
            src = rs.uniform(0.01, 100.0, (rows, columns)).astype(np.float32)
            amp = src
        else:
            src = complex_normal(rs, size=(rows, columns)).astype(np.complex64)
            amp = np.abs(src)
        jax_tuning = {"engine": jax_engine}
        tmpl = percentile.Percentile5Template(ctx, columns, is_amplitude,
                                              tuning=tune.from_jax_tuning(jax_tuning))
        out = tmpl.instantiate(None, (rows, columns))(src=_t(src))["dest"].numpy()
        jtmpl = jpct.Percentile5Template(None, columns, is_amplitude, tuning=jax_tuning)
        want = np.asarray(jtmpl.instantiate(None, (rows, columns))(src=jnp.asarray(src))["dest"])
        expected = _percentile_expected(amp)
        assert out.shape == (5, rows)
        if is_amplitude:
            np.testing.assert_array_equal(out, expected.astype(np.float32))
            _bits_equal(out, want)
        else:
            # The amplitude may differ from numpy's (and XLA's) by one ulp.
            np.testing.assert_allclose(out, expected, rtol=1e-6)
            np.testing.assert_allclose(out, want, rtol=1e-6)

    @pytest.mark.parametrize("columns", [7, 241, 500])
    def test_plain_matches_pallas_with_nan_rows(self, columns):
        x = np.random.RandomState(columns).uniform(0.01, 100.0, (37, columns)).astype(np.float32)
        x[3, ::3] = np.nan
        x[5] = np.nan  # an all-NaN row: min +inf, max -inf in both
        x[6, 1:] = np.nan
        got = percentile.percentile5_plain(_t(x))
        _bits_equal(got.numpy(), jpct.percentile5(jnp.asarray(x), engine="pallas",
                                                 interpret=True))
        _bits_equal(percentile.percentile5_cuda(_t(x)).numpy(), got.numpy())

    def test_plain_matches_pallas_on_amplitudes_of_complex_input(self):
        src = complex_normal(np.random.RandomState(4), size=(19, 300)).astype(np.complex64)
        from katsdpsigproc_tpu_torch.utils import numerics

        amp = numerics.complex_abs(_t(src))
        np.testing.assert_array_equal(amp.numpy(), np.abs(src))  # numpy's rounding
        want = jpct.percentile5(jnp.asarray(np.abs(src)), engine="pallas", interpret=True)
        _bits_equal(percentile.percentile5_plain(amp).numpy(), want)

    @pytest.mark.parametrize("seed", np.random.RandomState(11).randint(0, 1 << 30, size=4))
    def test_random_shapes(self, seed):
        rs = np.random.RandomState(seed)
        rows, cols = int(rs.randint(1, 40)), int(rs.randint(5, 700))
        data = np.abs(rs.standard_normal((rows, cols))).astype(np.float32) + 0.01
        expected = _percentile_expected(data).astype(np.float32)
        pallas = np.asarray(jpct.percentile5(jnp.asarray(data), engine="pallas", interpret=True))
        _bits_equal(percentile.percentile5_plain(_t(data)).numpy(), pallas)
        for engine in ("rank", "sort", "cuda"):
            got = percentile.percentile5(_t(data), engine=engine).numpy()
            np.testing.assert_array_equal(got, expected, err_msg=f"engine={engine}")

    def test_column_range(self, ctx):
        rows, columns = 11, 100
        src = np.random.RandomState(seed=1).uniform(0.01, 100.0, (rows, columns))
        src = src.astype(np.float32)
        for engine in ("rank", "sort", "cuda"):
            tmpl = percentile.Percentile5Template(ctx, columns, True, tuning={"engine": engine})
            out = tmpl.instantiate(None, (rows, columns), (13, 77))(src=_t(src))["dest"].numpy()
            sub = src[:, 13:77]
            np.testing.assert_array_equal(out[0], np.min(sub, axis=1))
            np.testing.assert_array_equal(
                out[4], np.percentile(sub, 50, axis=1, method="lower").astype(np.float32))

    @pytest.mark.parametrize("n", [1, 2, 3, 7, 4096, 5000])
    def test_radix_plain_matches_plain_and_pallas(self, n):
        x = common.adversarial_rows(10, n, seed=n)
        radix = percentile.percentile5_radix_plain(_t(x)).numpy()
        _bits_equal(radix, percentile.percentile5_plain(_t(x)).numpy())
        x = common.adversarial_rows(10, n, seed=n, xla_cpu=True)
        radix = percentile.percentile5_radix_plain(_t(x)).numpy()
        _bits_equal(radix, percentile.percentile5_plain(_t(x)).numpy())
        _bits_equal(radix, jpct.percentile5(jnp.asarray(x), engine="pallas", interpret=True))

    def test_radix_plain_end_states(self):
        """+inf or a rank beyond the non-NaN count gives 0x7fffffff; key 0 gives +0."""
        x = np.array([[1, np.inf, np.inf, 2, 3], [-1, -0.0, 0.5, np.nan, 4],
                      [np.nan, np.nan, np.nan, 1, 2]], np.float32)
        got = percentile.percentile5_radix_plain(_t(x)).numpy().view(np.int32)
        _bits_equal(got.view(np.float32), percentile.percentile5_plain(_t(x)).numpy())
        assert got[3, 0] == 0x7FFFFFFF  # p75 of [1, inf, inf, 2, 3]; numpy's lower gives inf
        assert got[2, 1] == 0  # p25 of [-1, -0, 0.5, nan, 4]: +0
        assert got[2, 2] == np.float32(2).view(np.int32)  # rank 1 of the two non-NaN values
        assert list(got[3:, 2]) == [0x7FFFFFFF] * 2  # ranks 3 and 2 lie beyond them

    @settings(max_examples=60, deadline=None)
    @given(st.lists(st.lists(st.floats(width=32, allow_nan=True, allow_infinity=True,
                                       allow_subnormal=True), min_size=9, max_size=9),
                    min_size=1, max_size=6))
    def test_radix_plain_matches_plain_on_any_floats(self, rows):
        x = np.array(rows, np.float32)
        _bits_equal(percentile.percentile5_radix_plain(_t(x)).numpy(),
                    percentile.percentile5_plain(_t(x)).numpy())

    def test_instantiate_checks(self, ctx):
        tmpl = percentile.Percentile5Template(ctx, 64, True, tuning={"engine": "cuda"})
        for shape, column_range in (((4, 8, 2), None), ((4, 8), (5, 3)), ((4, 8), (0, 9)),
                                    ((4, 100), None)):
            with pytest.raises(ValueError):
                tmpl.instantiate(None, shape, column_range)
        with pytest.raises(ValueError, match="engine"):
            percentile.percentile5(torch.ones((2, 3)), engine="pallas")
        with pytest.raises(TypeError, match="float32"):
            percentile.percentile5_plain(torch.ones((2, 3), dtype=torch.float64))


def test_ops_and_templates_run_without_jax_or_triton():
    """A subprocess where `import jax` and `import triton` fail imports every
    module of the port, the package root's `parallel` and `utils` among them,
    and runs a region copy, the ops path and FlaggerDevice on the CPU."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['triton'] = None\n"
        "import numpy as np, torch\n"
        "import katsdpsigproc_tpu_torch\n"
        "from katsdpsigproc_tpu_torch.ops import base, fill, maskedsum, percentile, rank, reduce\n"
        "from katsdpsigproc_tpu_torch.ops import transpose, wgreduce\n"
        "from katsdpsigproc_tpu_torch.utils import backend, kernels, numerics, shapes, tune\n"
        "from katsdpsigproc_tpu_torch.models.rfi import device, fused_flagger, host\n"
        "import katsdpsigproc_tpu_torch.pytest_plugin\n"
        "from katsdpsigproc_tpu_torch.utils import regions\n"
        "from katsdpsigproc_tpu_torch.test import test_accel\n"
        "from katsdpsigproc_tpu_torch.scripts import (maskedsumabstest, maskedsumtest,\n"
        "    percentiletest, transposetest, tune_all)\n"
        "assert katsdpsigproc_tpu_torch.parallel.mesh and katsdpsigproc_tpu_torch.utils.tune\n"
        "assert {'parallel', 'utils'} <= set(katsdpsigproc_tpu_torch.__all__)\n"
        "d = regions.copy_region(torch.arange(6.), torch.zeros(4), np.s_[1:5], np.s_[:])\n"
        "assert d.tolist() == [1, 2, 3, 4]\n"
        "ctx = backend.create_some_context(devices=[torch.device('cpu')])\n"
        "x = torch.rand((6, 50))\n"
        "p = percentile.Percentile5Template(ctx, 50, True).instantiate(None, (6, 50))\n"
        "assert p(src=x)['dest'].shape == (5, 6)\n"
        "assert torch.equal(transpose.TransposeTemplate(ctx, 'float32').instantiate("
        "None, (6, 50))(src=x)['dest'], x.T)\n"
        "t = device.FlaggerDeviceTemplate(device.BackgroundMedianFilterDeviceTemplate(ctx, 13),"
        " device.NoiseEstMADTDeviceTemplate(ctx), device.ThresholdSumDeviceTemplate(ctx))\n"
        "v = torch.randn((64, 4), dtype=torch.complex64)\n"
        "assert t.instantiate(None, 64, 4)(vis=v)['flags'].shape == (64, 4)\n"
        "assert 'katsdpsigproc_tpu' not in sys.modules\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["KATSDPSIGPROC_TPU_TORCH_TUNE_STUB"] = "1"
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
