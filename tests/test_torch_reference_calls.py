"""The JAX package's own call forms, made against the port on the CPU.

Each call is one that the JAX package's callers make (its tests,
``bench.py``, ``scripts/rfiflagtest.py``, ``models/rfi/twodflag.py``),
with the TPU keywords they pass.  The port takes the same arguments and
gives JAX's masks or values; the JAX side runs its Pallas kernels in
interpret mode on the CPU.

Tolerance: exact, bit for bit, on every mask and value.  The inputs are
small (8 or 16 rows of 300 channels), made from seeds with numpy.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katsdpsigproc_tpu.models.rfi import device as jdev, pallas_flagger as jpf
from katsdpsigproc_tpu.ops import percentile as jpct, rank as jrank, transpose as jtr
from katsdpsigproc_tpu.ops import base as jbase
from katsdpsigproc_tpu.utils import backend as jbackend
from katsdpsigproc_tpu_torch.models.rfi import device as tdev, fused_flagger as ff
from katsdpsigproc_tpu_torch.ops import base as tbase
from katsdpsigproc_tpu_torch.ops import percentile as tpct, rank as trank, transpose as ttr
from katsdpsigproc_tpu_torch.utils import backend as tbackend, profiling

from .helpers import rfi_test_data

ROWS, CHANNELS = 8, 300


def _dump(rows=ROWS, seed=31):
    """(rows, channels, 2) planar visibilities with planted RFI, and FULL flags."""
    vis, _, iflags = rfi_test_data(shape=(CHANNELS, rows), seed=seed)
    vt = np.ascontiguousarray(np.moveaxis(jdev.to_planar(vis), 0, 1))
    return vt, np.ascontiguousarray(iflags.T)


def _channel_flags():
    cf = np.zeros(CHANNELS, np.uint8)
    cf[[5, 120, 121, 299]] = 1
    return cf


def _form(form: str):
    """The JAX and the port's arguments of a call form: (args, kwargs) each."""
    vt, iflags = _dump()
    kw = {}
    if "leading" in form:
        vt = np.ascontiguousarray(np.moveaxis(vt, -1, 0))
        kw["layout"] = "leading"
    if "amp" in form:
        kw["ingest"] = "amp"
    jargs, targs = [jnp.asarray(vt)], [torch.from_numpy(vt)]
    jkw, tkw = dict(kw), dict(kw)
    if "full" in form:
        jargs.append(jnp.asarray(iflags))
        targs.append(torch.from_numpy(iflags))
    if "channel" in form:
        jkw["channel_flags"] = jnp.asarray(_channel_flags())
        tkw["channel_flags"] = torch.from_numpy(_channel_flags())
    return (jargs, jkw), (targs, tkw)


DMA_FORMS = ["planar", "full", "channel", "amp", "amp_channel", "leading", "leading_full"]


@pytest.mark.parametrize("form", DMA_FORMS)
def test_flag_transposed_dma_matches_jax(form):
    """``flag_transposed_dma(vt, bb=8, interpret=True)`` in each of its forms
    (tests/rfi/test_pallas_flagger.py:224-408, bench.py:428-433)."""
    (jargs, jkw), (targs, tkw) = _form(form)
    want = np.asarray(jpf.flag_transposed_dma(*jargs, bb=8, interpret=True, **jkw))
    before = ff.launches["flagger"]
    got = ff.flag_transposed_dma(*targs, bb=8, interpret=True, **tkw)
    assert ff.launches["flagger"] == before  # the CPU takes the plain version
    assert got.dtype == torch.uint8 and want.any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("entry, form", [("flag_transposed", "amp_full"),
                                         ("flag_dump_grid", "leading"),
                                         ("flag_dump_dma", "leading_amp_channel")])
def test_other_entries_take_the_forms(entry, form):
    """``flag_transposed`` and ``flag_dump`` (both pipelines) in the same forms."""
    (jargs, jkw), (targs, tkw) = _form(form)
    if entry == "flag_transposed":
        jfn, tfn = jpf.flag_transposed, ff.flag_transposed
    else:
        pipeline = entry.rsplit("_", 1)[1]
        jkw, tkw = dict(jkw, pipeline=pipeline, slab=8), dict(tkw, pipeline=pipeline, slab=8)
        jfn, tfn = jpf.flag_dump, ff.flag_dump
    want = np.asarray(jfn(*jargs, bb=8, interpret=True, **jkw))
    np.testing.assert_array_equal(tfn(*targs, bb=8, interpret=True, **tkw).numpy(), want)


def test_the_forms_give_the_planar_flags():
    """JAX's contract for the forms ("Bit-identical flags"), held on the port alone."""
    for flags in ("", "_full", "_channel"):
        (_, _), (targs, tkw) = _form("planar" + flags)
        base = ff.flag_transposed_dma(*targs, **tkw).numpy()
        for form in ("amp", "leading", "leading_amp"):
            (_, _), (targs, tkw) = _form(form + flags)
            np.testing.assert_array_equal(ff.flag_transposed_dma(*targs, **tkw).numpy(), base)


PALLAS_KW = {
    "grid": dict(bb=8, nref=1, fold=1024, interpret=True),
    "dma": dict(bb=8, fold=1024, interpret=True, pipeline="dma"),
}


@pytest.mark.parametrize("layout, block_impl, jax_kw", [
    ("straight", "pad", "grid"), ("straight", "slice", "dma"), ("straight", "scan", "dma"),
    ("straight", "unroll", "grid"), ("transposed", "pad", "dma"),
    ("transposed", "slice", "grid"), ("transposed", "scan", "grid"),
    ("transposed", "unroll", "dma")])
def test_hybrid_engine_with_the_bench_keywords(layout, block_impl, jax_kw):
    """``make_flagger_fn(..., engine="hybrid", pallas_kw=...)`` as bench.py:383-394
    builds it, with each ``layout``, ``block_impl`` and ``background_fast``.

    JAX's engine runs once a case, with one of the two ``pallas_kw``
    (its flags are the same with either); the port runs with both.
    """
    vis, _, _ = rfi_test_data(shape=(CHANNELS, 16), seed=32)
    planar = jdev.to_planar(vis)
    common = dict(threshold="sum", baseline_block=8, engine="hybrid", layout=layout,
                  block_impl=block_impl)
    want = np.asarray(jdev.make_flagger_fn(13, 11.0, pallas_kw=PALLAS_KW[jax_kw], **common)(
        jnp.asarray(planar)))
    assert want.any()
    for name, pallas_kw in PALLAS_KW.items():
        for fast in (None, False, True):
            fn = tdev.make_flagger_fn(13, 11.0, pallas_kw=pallas_kw, background_fast=fast,
                                      **common)
            np.testing.assert_array_equal(fn(torch.from_numpy(planar)).numpy(), want,
                                          err_msg=f"{name}, background_fast={fast}")


def test_background_fast_reaches_the_background(monkeypatch):
    """``background_fast`` is passed on as ``fast_path``; ``None`` means ``False``."""
    seen = []
    real = tdev.background_median_filter

    def spy(*args, **kwargs):
        seen.append(kwargs["fast_path"])
        return real(*args, **kwargs)

    monkeypatch.setattr(tdev, "background_median_filter", spy)
    planar = torch.from_numpy(jdev.to_planar(rfi_test_data(shape=(64, 4), seed=3)[0]))
    for engine in ("torch", "hybrid"):
        for fast in (None, False, True):
            tdev.make_flagger_fn(13, 11.0, engine=engine, background_fast=fast)(planar)
    assert seen == [False, False, True] * 2


@pytest.mark.parametrize("engine", ["rank", "sort", "pallas"])
def test_percentile5_with_interpret(engine):
    """``percentile5(x, engine=e, interpret=True)`` (tests/test_ops_fuzz.py:42)."""
    rs = np.random.RandomState(41)
    data = np.abs(rs.standard_normal((13, 301))).astype(np.float32) + 0.01
    want = np.asarray(jpct.percentile5(jnp.asarray(data), engine=engine, interpret=True))
    port_engine = {"pallas": "cuda"}.get(engine, engine)
    got = tpct.percentile5(torch.from_numpy(data), engine=port_engine, interpret=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(37, 211), (19, 45, 2)])
def test_transpose_with_interpret(shape):
    """``transpose(x, interpret=True)`` (tests/test_ops_fuzz.py:54)."""
    data = np.random.RandomState(42).standard_normal(shape).astype(np.float32)
    want = np.asarray(jtr.transpose(jnp.asarray(data), interpret=True))
    got = ttr.transpose(torch.from_numpy(data), interpret=True)
    np.testing.assert_array_equal(got.numpy(), want)


def _rank_data():
    rs = np.random.RandomState(43)
    vals = np.abs(rs.standard_normal((6, 7, 33))).astype(np.float32)
    vals[rs.random_sample(vals.shape) < 0.2] = np.nan  # absent
    vals[rs.random_sample(vals.shape) < 0.1] = 0.0
    return vals, np.sum(~np.isnan(vals), axis=-1).astype(np.int32)


def test_find_rank_float_with_unroll():
    """``find_rank_float(..., unroll=False, radix_bits=4)`` as twodflag.py:73 calls it."""
    vals, n = _rank_data()
    want = np.asarray(jrank.find_rank_float(jnp.asarray(vals), jnp.asarray(n // 2),
                                            jnp.asarray((n & 1) == 0), unroll=False,
                                            radix_bits=4))
    got = trank.find_rank_float(torch.from_numpy(vals), torch.from_numpy(n // 2),
                                torch.from_numpy((n & 1) == 0), unroll=False, radix_bits=4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("unroll", [False, True])
def test_median_non_zero_with_unroll(unroll):
    vals, n = _rank_data()
    want = np.asarray(jrank.median_non_zero(jnp.asarray(vals), jnp.asarray(n), unroll=unroll))
    got = trank.median_non_zero(torch.from_numpy(vals), torch.from_numpy(n), unroll=unroll)
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_context_takes_extra():
    ctx = tbackend.DeviceContext("cpu", {"note": 1})
    assert ctx.extra == {"note": 1} and ctx.device == torch.device("cpu")
    assert tbackend.DeviceContext("cpu").extra == {}
    jctx = jbackend.DeviceContext(jbackend.all_devices()[0], extra={"note": 1})
    assert jctx.extra == tbackend.DeviceContext("cpu", extra={"note": 1}).extra


def test_slot_validate_and_as_output_take_array():
    slot = tbase.Slot((3, 4), torch.float32, tbase.Direction.IN)
    slot.validate(array=torch.zeros((3, 4)))
    with pytest.raises(ValueError):
        slot.validate(array=torch.zeros((4, 3)))
    x = torch.ones(2)
    assert tbase.as_output("out", array=x)["out"] is x
    assert jbase.as_output("out", array=1) == {"out": 1}


def test_trace_writes_under_a_log_dir(tmp_path):
    """``trace(log_dir, create_perfetto_link=False)``: one Chrome trace file in the directory."""
    log_dir = tmp_path / "logs"
    x = torch.ones((16, 16))
    with profiling.trace(str(log_dir), create_perfetto_link=False):
        with profiling.annotate("stage:probe"):
            (x @ x).sum()
    (path,) = log_dir.iterdir()
    assert path.suffix == ".json"
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "stage:probe" in names
    file_path = tmp_path / "one.json"  # a .json path stays the file
    with profiling.trace(file_path, create_perfetto_link=True):
        (x @ x).sum()
    assert file_path.is_file()


# Each side's flagger module, engine module and array maker.
SIDES = {"jax": (jpf, jdev, jnp.asarray), "port": (ff, tdev, torch.from_numpy)}


def _both_flags(side):
    flagger, _, conv = SIDES[side]
    vt, iflags = _dump()
    flagger.flag_transposed_dma(conv(vt), conv(iflags), channel_flags=conv(_channel_flags()),
                                bb=8, interpret=True)


def _flag_call(shape=None, **kw):
    def call(side):
        flagger, _, conv = SIDES[side]
        vt, _ = _dump()
        vt = vt if shape is None else vt.reshape(shape)
        flagger.flag_transposed_dma(conv(vt), bb=8, interpret=True, **kw)
    return call


def _amp_nref(side):
    flagger, _, conv = SIDES[side]
    flagger.flag_transposed(conv(_dump()[0]), bb=8, interpret=True, ingest="amp", nref=2)


def _engine_call(**kw):
    def call(side):
        _, engines, conv = SIDES[side]
        planar = jdev.to_planar(rfi_test_data(shape=(CHANNELS, 16), seed=33)[0])
        engines.make_flagger_fn(13, 11.0, threshold="sum", baseline_block=8, engine="hybrid",
                                **kw)(conv(planar))
    return call


ERRORS = {
    "both_flags": (_both_flags, ValueError, "either"),
    "ingest": (_flag_call(ingest="complex"), ValueError, "ingest"),
    "layout": (_flag_call(layout="planar"), ValueError, "layout"),
    "trailing_shape": (_flag_call(shape=(ROWS, CHANNELS * 2)), ValueError, "trailing"),
    "leading_shape": (_flag_call(layout="leading"), ValueError, "leading"),
    "amp_nref": (_amp_nref, ValueError, "nref"),
    "engine_layout": (_engine_call(layout="channel_major"), ValueError, "layout"),
    "block_impl": (_engine_call(block_impl="gather"), ValueError, "block_impl"),
    "pallas_kw": (_engine_call(pallas_kw=dict(bb=8, interpret=True, lanes=128)), TypeError,
                  "lanes"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_bad_calls_raise_as_in_jax(case):
    call, exc, match = ERRORS[case]
    for side in SIDES:
        with pytest.raises(exc, match=match):
            call(side)
