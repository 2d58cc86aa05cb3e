"""The cost probes K8 (katsdpsigproc_tpu_torch.scripts.prim_cost) and K10
(katsdpsigproc_tpu_torch.scripts.roofline_skeleton) on the CPU, where each
wrapper takes its plain PyTorch version, against the TPU scripts'
Pallas kernels in interpret mode and the roofline model of
``katsdpsigproc_tpu/models/rfi/roofline.py``.

The scripts are loaded by path, unedited.  K8: each ported body's chain
against ``prim_cost.make_kernel(body, 2, 2, 8, 256, h=1, interpret=True)``.
K10: the plain skeleton against ``skeleton_block`` in a whole-array
``pl.pallas_call(..., interpret=True)``, on its uint8 output and on its
rank carry, taken where the script's ``lax.fori_loop`` returns it.

Tolerance: exact, except
- ``reduce``: the plain version sums a row in another order than XLA, so
  rtol 1e-6 (values reach 6e4; one ulp is 6e-8 relative);
- ``mul`` and ``sqrt``: under jit XLA on the CPU may contract
  ``x * y + 1`` into an FMA (as tests/test_torch_device.py pins for the
  amplitude), which the plain version, like the card's kernel built with
  ``-fmad=false``, rounds twice: rtol 1e-6 over the chain's 4 reps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from katsdpsigproc_tpu.models.rfi import roofline
from katsdpsigproc_tpu_torch.models.rfi import flagger_probe as fp
from katsdpsigproc_tpu_torch.scripts import prim_cost, roofline_skeleton as rsk

from .test_torch_probes import _script

TOLERANCE = {"reduce": 1e-6, "mul": 1e-6, "sqrt": 1e-6}


@pytest.fixture(scope="module")
def jax_prim_cost():
    return _script("prim_cost")


@pytest.fixture(scope="module")
def jax_skeleton():
    return _script("roofline_skeleton")


def _block(rows=8, width=256):
    return np.random.RandomState(1).uniform(0.25, 0.75, (rows, width)).astype(np.float32)


# K8, the primitive-cost chains.


@pytest.mark.parametrize("body", [None] + list(prim_cost.BODIES))
def test_k8_chain_matches_the_tpu_kernel(jax_prim_cost, body):
    x = _block()
    jax_body = None if body is None else jax_prim_cost.BODIES[body][0]
    run = jax_prim_cost.make_kernel(jax_body, 2, 2, 8, 256, 1, True)
    want = np.asarray(run(jnp.asarray(x)))
    got = prim_cost.chain(torch.from_numpy(x), body, 2, 2)
    assert got.dtype == torch.float32 and got.shape == x.shape
    rtol = TOLERANCE.get(body, 0)
    if rtol:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_k8_bodies_and_deductions_are_the_tpu_scripts(jax_prim_cost):
    ported = set(prim_cost.BODIES)
    assert ported | set(prim_cost.NO_COUNTERPART) == set(jax_prim_cost.BODIES)
    assert not ported & set(prim_cost.NO_COUNTERPART)
    for name, (_, n_ops, n_helpers, _) in prim_cost.BODIES.items():
        assert (n_ops, n_helpers) == jax_prim_cost.BODIES[name][1:], name
    assert prim_cost.EXTRA_DEDUCT == {k: v for k, v in jax_prim_cost.EXTRA_DEDUCT.items()
                                      if k in ported}
    codes = [spec[3] for spec in prim_cost.BODIES.values()]
    assert sorted(codes) == list(range(1, len(codes) + 1))  # csrc/prim_cost.cu's Body enum


def test_k8_net_ns_is_the_scripts_arithmetic(jax_prim_cost):
    raw = {name: 10.0 + 7.0 * i for i, name in enumerate(prim_cost.BODIES)}
    add_ns = raw["add"]
    want = {}
    for name, (_, n_ops, n_helpers) in jax_prim_cost.BODIES.items():  # prim_cost.py:223-229
        if name not in raw:
            continue
        ns = raw[name] - add_ns * n_helpers / n_ops
        for other, cnt in jax_prim_cost.EXTRA_DEDUCT.get(name, []):
            ns -= max(want.get(other, 0.0), 0.0) * cnt / n_ops
        want[name] = ns
    assert prim_cost.net_ns(raw) == want


def test_k8_measure_runs_on_cpu_tensors(capsys):
    before = dict(prim_cost.launches)
    results = prim_cost.measure(torch.from_numpy(_block(4, 64)), steps=1, unroll=1, iters=1,
                                reps=1, card="cpu")
    assert set(results) == set(prim_cost.BODIES)
    assert prim_cost.launches == before  # no kernel on the CPU
    out = capsys.readouterr().out
    assert "roll_sub" in out and "no counterpart (band fold)" in out and "[cpu]" in out


def test_k8_chain_validation():
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="unknown body"):
        prim_cost.chain(x, "band_mm", 1, 1)
    with pytest.raises(ValueError, match="width"):
        prim_cost.chain(torch.zeros((2, 48)), "add", 1, 1)
    with pytest.raises(ValueError, match="unroll"):
        prim_cost.chain(x, "add", 1, 3)
    with pytest.raises(TypeError, match="float32"):
        prim_cost.chain(x.double(), "add", 1, 1)


# K10, the op-inventory skeleton.


class _LaxCapture:
    """``lax`` for the script, keeping what its one ``fori_loop`` (the rank rounds) returns."""

    def __init__(self):
        self.carry = None

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def fori_loop(self, *args, **kwargs):
        self.carry = jax.lax.fori_loop(*args, **kwargs)
        return self.carry


class _NpScale1:
    """``np`` for the script with its flag scale (``np.float32(0.5)``, :104) set to 1."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def float32(value):
        return np.float32(1.0 if value == 0.5 else value)


def _jax_skeleton(module, amp: np.ndarray, flag_scale: float):
    capture = _LaxCapture()
    saved = module.lax, module.np
    module.lax = capture
    if flag_scale == 1.0:
        module.np = _NpScale1()

    def kernel(in_ref, out_ref, rank_ref):
        module.skeleton_block(in_ref, out_ref, width=13, interpret=True)
        rank_ref[...] = capture.carry

    try:
        out, rank = pl.pallas_call(
            kernel, interpret=True,
            out_shape=(jax.ShapeDtypeStruct(amp.shape, jnp.uint8),
                       jax.ShapeDtypeStruct((amp.shape[0], 1), jnp.float32)))(jnp.asarray(amp))
    finally:
        module.lax, module.np = saved
    return np.asarray(out), np.asarray(rank)[:, 0]


def _amplitudes(kind: str, channels: int) -> np.ndarray:
    rs = np.random.RandomState(channels)
    if kind == "uniform":  # the JAX tool's input (roofline_skeleton.py:131-132)
        return rs.uniform(0.25, 0.75, (8, channels)).astype(np.float32)
    # Constant rows with sparse dips: the deviations are 0 but at the dips,
    # the rank carry stays 0 and the flags are the ladders' and the
    # dilation's reach around each dip.
    amp = np.ones((8, channels), np.float32)
    amp[rs.random_sample(amp.shape) < 1.0 / 40.0] = 0.2
    return amp


@pytest.mark.parametrize("flag_scale", [rsk.FLAG_SCALE, 1.0])
@pytest.mark.parametrize("kind", ["uniform", "dips"])
@pytest.mark.parametrize("channels", [256, 257, 512])
def test_k10_matches_the_tpu_skeleton(jax_skeleton, channels, kind, flag_scale):
    amp = _amplitudes(kind, channels)
    want_out, want_rank = _jax_skeleton(jax_skeleton, amp, flag_scale)
    got_out, got_rank = rsk.skeleton(torch.from_numpy(amp), flag_scale=flag_scale,
                                     return_rank=True)
    assert got_out.dtype == torch.uint8 and got_rank.dtype == torch.float32
    np.testing.assert_array_equal(got_out.numpy(), want_out)
    np.testing.assert_array_equal(got_rank.numpy(), want_rank)
    if flag_scale == rsk.FLAG_SCALE:
        assert not want_out.any()  # the JAX skeleton's output is 0 for every input
    elif kind == "dips":
        assert 0 < want_out.mean() < 1  # the ladders and the dilation show
    if kind == "uniform":
        assert (want_rank > 0).all()


def test_k10_wrapper_returns_the_rank_only_when_asked():
    amp = torch.from_numpy(_amplitudes("uniform", 64))
    before = dict(rsk.launches)
    out = rsk.skeleton(amp)
    assert isinstance(out, torch.Tensor) and out.shape == amp.shape
    assert torch.equal(out, rsk.skeleton_plain(amp))
    assert rsk.launches == before
    with pytest.raises(ValueError, match="at least 13"):
        rsk.skeleton(torch.zeros((2, 12)))
    with pytest.raises(ValueError, match="odd"):
        rsk.skeleton(amp, width=12)
    with pytest.raises(TypeError, match="float32"):
        rsk.skeleton(amp.double())


@pytest.mark.parametrize("n_windows", range(1, 7))
@pytest.mark.parametrize("width", range(3, 42, 2))
def test_inventory_is_the_roofline_models(width, n_windows):
    assert rsk.op_inventory(width, n_windows) == roofline.op_inventory(width, n_windows)


def test_model_arithmetic_is_compute_roofline():
    table = {"add": 7.5, "minmax": 8.25, "shift_ch": 31.0, "rank_round": 410.0, "sqrt": 9.0,
             "mul": 8.0, "select": 7.0, "cmp_f32": 12.0, "reduce": 60.0}
    for args in ((8064, 32768, 13, 4, 256), (64, 4096, 7, 6, 128)):
        baselines, channels, width, n_windows, rows = args
        want = roofline.compute_roofline(baselines, channels, width=width, n_windows=n_windows,
                                         prim_table=table, rows=rows)
        got = rsk.compute_roofline(baselines, channels, table, width=width, n_windows=n_windows,
                                   rows=rows)
        for key in ("seconds_per_dump", "vis_per_second", "block_ns", "stage_ns"):
            assert got[key] == want[key], key
    assert rsk.ops_per_element() == sum(c for _, _, c in roofline.op_inventory())


def test_k10_run_on_cpu_tensors(capsys):
    vis_t = torch.from_numpy(np.random.RandomState(3).uniform(0.0, 1.0, (4, 64, 2))
                             .astype(np.float32))
    result = rsk.run(vis_t, iters=1, reps=1, card="cpu",
                     prim_block=torch.from_numpy(_block(4, 256)), prim_steps=1, prim_unroll=1)
    assert result["ratio"] == result["skeleton_ms"] / result["model_ms"]
    assert set(result["prim_ns"]) == set(prim_cost.BODIES)
    assert "skeleton/model" in capsys.readouterr().out


def test_k10_run_beside_k11_full_on_cpu_tensors(capsys):
    """With the dump's pairs, the tool times K11's ``full`` in the skeleton's
    rounds and prints the skeleton's ratio to it."""
    rs = np.random.RandomState(4)
    vis_t = torch.from_numpy(rs.standard_normal((4, 64, 2)).astype(np.float32))
    before = dict(fp.launches)
    result = rsk.run(vis_t, iters=1, reps=1, card="cpu",
                     prim_block=torch.from_numpy(_block(4, 256)), prim_steps=1, prim_unroll=1)
    assert result["full_ms"] > 0 and result["ratio"] == result["skeleton_ms"] / result["model_ms"]
    assert fp.launches == before  # no kernel on the CPU
    assert "skeleton / full = " in capsys.readouterr().out


@pytest.mark.parametrize("tool", [prim_cost, rsk])
def test_cost_tools_refuse_to_run_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([])
