"""The port's FFT operation (katsdpsigproc_tpu_torch.ops.fft) on the CPU.

Every case of ``tests/test_fft.py``, on the port, against numpy and the
JAX operation at that file's tolerances (rtol 1e-4 / atol 1e-3, and rtol
1e-3 / atol 1e-3 for the unnormalised inverse), plus double precision
against numpy and the validation errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katsdpsigproc_tpu.ops import fft as jfft
from katsdpsigproc_tpu_torch.ops import fft
from katsdpsigproc_tpu_torch.utils import backend

from .helpers import complex_normal


@pytest.fixture
def ctx():
    return backend.DeviceContext(torch.device("cpu"))


def _run(template, mode, src):
    return template.instantiate(None, mode)(src=torch.from_numpy(src))["dest"].numpy()


def _jax(n, shape, dtype_src, dtype_dest, mode, src, **kw):
    template = jfft.FftTemplate(None, n, shape, dtype_src, dtype_dest, **kw)
    return np.asarray(template.instantiate(None, jfft.FftMode[mode.name])(
        src=jnp.asarray(src))["dest"])


class TestFft:
    @pytest.mark.parametrize("batch", [(), (3,)])
    @pytest.mark.parametrize("n", [1, 2])
    def test_c2c_forward(self, ctx, batch, n):
        shape = batch + ((16, 48) if n == 2 else (48,))
        rs = np.random.RandomState(1)
        src = complex_normal(rs, size=shape).astype(np.complex64)
        template = fft.FftTemplate(ctx, n, shape, np.complex64, np.complex64)
        out = _run(template, fft.FftMode.FORWARD, src)
        assert out.dtype == np.complex64
        expected = np.fft.fftn(src, axes=tuple(range(len(shape) - n, len(shape))))
        np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-3)
        jax_out = _jax(n, shape, np.complex64, np.complex64, fft.FftMode.FORWARD, src)
        np.testing.assert_allclose(out, jax_out, rtol=1e-4, atol=1e-3)

    def test_c2c_roundtrip_unnormalised(self, ctx):
        """forward then inverse scales by the number of elements (cuFFT's convention)."""
        shape = (8, 32)
        rs = np.random.RandomState(2)
        src = complex_normal(rs, size=shape).astype(np.complex64)
        template = fft.FftTemplate(ctx, 2, shape, np.complex64, np.complex64)
        mid = _run(template, fft.FftMode.FORWARD, src)
        out = _run(template, fft.FftMode.INVERSE, mid)
        np.testing.assert_allclose(out, src * (8 * 32), rtol=1e-4, atol=1e-2)
        jax_out = _jax(2, shape, np.complex64, np.complex64, fft.FftMode.INVERSE, mid)
        np.testing.assert_allclose(out, jax_out, rtol=1e-4, atol=1e-2)

    def test_r2c(self, ctx):
        shape = (4, 35)
        rs = np.random.RandomState(3)
        src = rs.standard_normal(shape).astype(np.float32)
        template = fft.FftTemplate(ctx, 1, shape, np.float32, np.complex64)
        assert template.shape_dest == (4, 18)
        out = _run(template, fft.FftMode.FORWARD, src)
        np.testing.assert_allclose(out, np.fft.rfft(src, axis=-1), rtol=1e-4, atol=1e-3)
        jax_out = _jax(1, shape, np.float32, np.complex64, fft.FftMode.FORWARD, src)
        np.testing.assert_allclose(out, jax_out, rtol=1e-4, atol=1e-3)

    def test_c2r_unnormalised(self, ctx):
        shape = (4, 35)  # an odd final dimension exercises s=
        rs = np.random.RandomState(4)
        real = rs.standard_normal(shape).astype(np.float32)
        spectrum = np.fft.rfft(real, axis=-1).astype(np.complex64)
        template = fft.FftTemplate(ctx, 1, shape, np.complex64, np.float32)
        out = _run(template, fft.FftMode.INVERSE, spectrum)
        assert out.dtype == np.float32 and out.shape == shape
        np.testing.assert_allclose(out, real * 35, rtol=1e-3, atol=1e-3)
        jax_out = _jax(1, shape, np.complex64, np.float32, fft.FftMode.INVERSE, spectrum)
        np.testing.assert_allclose(out, jax_out, rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("kind", ["r2c", "c2r", "c2c"])
    def test_double_precision(self, ctx, kind):
        shape = (3, 40)
        rs = np.random.RandomState(5)
        real = rs.standard_normal(shape)
        cplx = complex_normal(rs, size=shape).astype(np.complex128)
        if kind == "r2c":
            template = fft.FftTemplate(ctx, 1, shape, np.float64, np.complex128)
            out, want = _run(template, fft.FftMode.FORWARD, real), np.fft.rfft(real)
        elif kind == "c2r":
            template = fft.FftTemplate(ctx, 1, shape, np.complex128, np.float64)
            spectrum = np.fft.rfft(real)
            out, want = _run(template, fft.FftMode.INVERSE, spectrum), real * 40
        else:
            template = fft.FftTemplate(ctx, 1, shape, torch.complex128, torch.complex128)
            out = _run(template, fft.FftMode.INVERSE, cplx)
            want = np.fft.ifft(cplx) * 40
        assert out.dtype == want.dtype
        np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)

    def test_mode_validation(self, ctx):
        template = fft.FftTemplate(ctx, 1, (16,), np.float32, np.complex64)
        with pytest.raises(ValueError, match="R2C transform must use FftMode.FORWARD"):
            template.instantiate(None, fft.FftMode.INVERSE)
        template = fft.FftTemplate(ctx, 1, (16,), np.complex64, np.float32)
        with pytest.raises(ValueError, match="C2R transform must use FftMode.INVERSE"):
            template.instantiate(None, fft.FftMode.FORWARD)
        with pytest.raises(ValueError, match="Invalid combination of dtypes"):
            fft.FftTemplate(ctx, 1, (16,), np.float32, np.float32)
        with pytest.raises(ValueError, match="Invalid combination of dtypes"):
            fft.FftTemplate(ctx, 1, (16,), np.float32, np.complex128)

    def test_batch_padding_rejected(self, ctx):
        with pytest.raises(ValueError, match="Source must not be padded"):
            fft.FftTemplate(ctx, 1, (4, 16), np.complex64, np.complex64,
                            padded_shape_src=(5, 16), padded_shape_dest=(4, 16))
        with pytest.raises(ValueError, match="Destination must not be padded"):
            fft.FftTemplate(ctx, 1, (4, 16), np.complex64, np.complex64,
                            padded_shape_dest=(5, 16))
        with pytest.raises(ValueError, match="same length"):
            fft.FftTemplate(ctx, 1, (4, 16), np.complex64, np.complex64,
                            padded_shape_src=(16,))
        with pytest.raises(ValueError, match="same length"):
            fft.FftTemplate(ctx, 1, (4, 16), np.complex64, np.complex64,
                            padded_shape_dest=(16,))

    def test_parameters_and_slots(self, ctx):
        template = fft.FftTemplate(ctx, 1, (4, 35), np.float32, np.complex64)
        op = template.instantiate(None, fft.FftMode.FORWARD)
        assert op.parameters() == {"shape": (4, 35), "N": 1, "kind": "r2c", "mode": "FORWARD"}
        assert op.slots["src"].shape == (4, 35) and op.slots["src"].dtype == torch.float32
        assert op.slots["dest"].shape == (4, 18) and op.slots["dest"].dtype == torch.complex64
        assert op.device == torch.device("cpu")
        op.bind(src=torch.ones((4, 35)))
        op()
        np.testing.assert_allclose(op.buffer("dest").numpy()[:, 0], 35.0)


class TestFftPaddedEmbedding:
    def test_padded_transform_axis_accepted(self, ctx):
        """Padded shapes on the transform axes are recorded; the op transforms
        the logical region."""
        shape = (4, 48)
        rs = np.random.RandomState(3)
        src = complex_normal(rs, size=shape).astype(np.complex64)
        template = fft.FftTemplate(ctx, 1, shape, np.complex64, np.complex64,
                                   padded_shape_src=(4, 64), padded_shape_dest=(4, 56))
        assert template.padded_shape_src == (4, 64)
        assert template.padded_shape_dest == (4, 56)
        out = _run(template, fft.FftMode.FORWARD, src)
        np.testing.assert_allclose(out, np.fft.fft(src, axis=-1), rtol=1e-4, atol=1e-3)

    def test_r2c_dest_padding(self, ctx):
        shape = (4, 48)
        rs = np.random.RandomState(4)
        src = rs.standard_normal(shape).astype(np.float32)
        template = fft.FftTemplate(ctx, 1, shape, np.float32, np.complex64,
                                   padded_shape_dest=(4, 32))
        out = _run(template, fft.FftMode.FORWARD, src)
        assert out.shape == (4, 25)  # logical (N//2 + 1), not the padded shape
        np.testing.assert_allclose(out, np.fft.rfft(src, axis=-1), rtol=1e-4, atol=1e-3)
        jax_out = _jax(1, shape, np.float32, np.complex64, fft.FftMode.FORWARD, src,
                       padded_shape_dest=(4, 32))
        np.testing.assert_allclose(out, jax_out, rtol=1e-4, atol=1e-3)
