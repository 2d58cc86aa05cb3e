"""The port's compute roofline (katsdpsigproc_tpu_torch.models.rfi.roofline)
against the JAX package's (katsdpsigproc_tpu/models/rfi/roofline.py), and
K8's chains at K1's launch on the CPU.

Every case of ``tests/test_roofline.py`` runs on the port's module: the
inventory's counts and stages, linear scaling, and the ``prim_ns``
override rules.  ``op_inventory`` and ``compute_roofline`` are held to
JAX's exactly; the shipped ``prim_ns.json`` must price every primitive the
inventory uses, measured on an NVIDIA card at K1's launch.  K8's plain
chains at the widths only K1's launch takes are held to the JAX chains of
``scripts/prim_cost.py`` in interpret mode, with the tolerances of
``tests/test_torch_cost_probes.py`` (exact but ``reduce``, ``mul`` and
``sqrt``: rtol 1e-6, for their summation order and XLA's FMA contraction).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katsdpsigproc_tpu.models.rfi import roofline as jax_roofline
from katsdpsigproc_tpu_torch.models.rfi import roofline
from katsdpsigproc_tpu_torch.scripts import prim_cost, roofline_skeleton as rsk

from .test_torch_cost_probes import TOLERANCE
from .test_torch_probes import _script

# The payloads prim_ns must survive with the defaults (tests/test_roofline.py).
MALFORMED = ('{"add": null}', '{"add": [1, 2]}', "not json at all", "[1, 2]",
             '"just a string"', "3.5")


def test_inventory_counts():
    inv = roofline.op_inventory(width=13, n_windows=4)
    total = sum(c for _, _, c in inv)
    assert 100 < total < 330
    assert {s for s, _, _ in inv} == {"amplitude", "median", "rank", "threshold", "output"}
    rank_rounds = sum(c for s, p, c in inv if s == "rank" and p == "rank_round")
    assert rank_rounds == 32


def test_roofline_scales_linearly():
    a = roofline.compute_roofline(2016, 32768)
    b = roofline.compute_roofline(4032, 32768)
    np.testing.assert_allclose(b["seconds_per_dump"], 2 * a["seconds_per_dump"])
    assert a["vis_per_second"] == b["vis_per_second"]
    c = roofline.compute_roofline(2016, 32768, width=17)
    assert c["seconds_per_dump"] > a["seconds_per_dump"]


def test_prim_table_override(tmp_path):
    p = tmp_path / "prim_ns.json"
    full = {k: 100.0 + i for i, k in enumerate(roofline.DEFAULT_PRIM_NS)}
    p.write_text(json.dumps(dict(full, bogus_key=50.0)))
    t = roofline.prim_ns(str(p))
    assert t["add"] == full["add"]
    assert "bogus_key" not in t
    assert t.pop("__measured__", None) == 1.0
    # a partial table overrides per key; the measured fraction reflects it
    p.write_text(json.dumps({"add": 42.0}))
    t = roofline.prim_ns(str(p))
    assert t["add"] == 42.0
    assert t.pop("__measured__") == 1.0 / len(roofline.DEFAULT_PRIM_NS)
    assert t.pop("__measured_keys__") == ["add"]
    assert t["cmp_f32"] == roofline.DEFAULT_PRIM_NS["cmp_f32"]
    # implausibly cheap entries are rejected
    p.write_text(json.dumps(dict(full, add=1.0)))
    t = roofline.prim_ns(str(p))
    assert t["add"] == roofline.DEFAULT_PRIM_NS["add"]
    n = len(roofline.DEFAULT_PRIM_NS)
    assert t.pop("__measured__") == (n - 1) / n
    # a missing file falls back to pure defaults, unmarked
    t2 = roofline.prim_ns(str(tmp_path / "absent.json"))
    assert "__measured__" not in t2
    assert t2 == roofline.DEFAULT_PRIM_NS


@pytest.mark.parametrize("bad", MALFORMED)
def test_malformed_tables_fall_back_to_the_defaults(tmp_path, bad):
    p = tmp_path / "prim_ns.json"
    p.write_text(bad)
    assert roofline.prim_ns(str(p)) == roofline.DEFAULT_PRIM_NS
    assert jax_roofline.prim_ns(str(p)) == jax_roofline.DEFAULT_PRIM_NS  # as JAX's does


def test_card_and_launch_records_are_ignored(tmp_path):
    p = tmp_path / "prim_ns.json"
    full = {k: 100.0 + i for i, k in enumerate(roofline.DEFAULT_PRIM_NS)}
    p.write_text(json.dumps(dict(full, __card__="NVIDIA H100 80GB HBM3, 700.00 W",
                                 __launch__="k1")))
    t = roofline.prim_ns(str(p))
    assert "__card__" not in t and "__launch__" not in t
    assert t.pop("__measured__") == 1.0
    assert t.pop("__measured_keys__") == sorted(full)
    assert t == full


def test_names_and_floor():
    assert set(roofline.DEFAULT_PRIM_NS) == set(jax_roofline.DEFAULT_PRIM_NS)
    assert all(v >= roofline.MIN_PLAUSIBLE_NS for v in roofline.DEFAULT_PRIM_NS.values())
    # The card's one-instruction floor at K1's launch, rounded down.
    assert roofline.MIN_PLAUSIBLE_NS == np.floor(262144 / (132 * 128) / 1.98 * 10) / 10
    assert prim_cost.FLOOR_NS == roofline.MIN_PLAUSIBLE_NS


def test_one_copy_of_the_inventory_and_the_model():
    assert rsk.op_inventory is roofline.op_inventory
    table = dict(roofline.DEFAULT_PRIM_NS)
    assert rsk.compute_roofline(8064, 32768, table) == roofline.compute_roofline(
        8064, 32768, prim_table=table)


_TABLES = {
    "port defaults": dict(roofline.DEFAULT_PRIM_NS),
    "jax defaults": dict(jax_roofline.DEFAULT_PRIM_NS),
    "measured": {"add": 7.92, "minmax": 10.43, "cmp_f32": 7.88, "shift_ch": 57.43,
                 "reduce": 21.08, "sqrt": 300.2, "rank_round": 32.96,
                 "__measured__": 1.0, "__measured_keys__": sorted(roofline.DEFAULT_PRIM_NS)},
    "partly measured": dict(roofline.DEFAULT_PRIM_NS, add=9.5, __measured__=1 / 7,
                            __measured_keys__=["add"]),
}


@pytest.mark.parametrize("config", [(8064, 32768, 13, 4, 256), (2016, 32768, 13, 4, 256),
                                    (64, 4096, 7, 6, 128), (300, 1000, 41, 1, 32)])
@pytest.mark.parametrize("table", list(_TABLES))
def test_compute_roofline_is_jaxs(table, config):
    baselines, channels, width, n_windows, rows = config
    kw = dict(width=width, n_windows=n_windows, prim_table=_TABLES[table], rows=rows)
    got = roofline.compute_roofline(baselines, channels, **kw)
    want = jax_roofline.compute_roofline(baselines, channels, **kw)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key


def test_compute_roofline_reads_the_shipped_table():
    got = roofline.compute_roofline(8064, 32768)
    assert got == roofline.compute_roofline(8064, 32768, prim_table=roofline.prim_ns())
    assert got["prim_ns_measured"] == 1.0


def test_the_shipped_table_is_the_cards_at_k1s_launch():
    with open(roofline.PRIM_JSON) as f:
        raw = json.load(f)
    used = {prim for _, prim, _ in roofline.op_inventory()}
    assert used <= set(raw), used - set(raw)
    assert all(raw[k] >= roofline.MIN_PLAUSIBLE_NS for k in raw if not k.startswith("__"))
    assert raw["__card__"].startswith("NVIDIA") and raw["__card__"].endswith(" W")
    assert raw["__launch__"] == "k1"
    table = roofline.prim_ns()
    assert table["__measured_keys__"] == sorted(set(raw) & set(roofline.DEFAULT_PRIM_NS))


def test_emitted_table_reads_back(tmp_path):
    results = {name: 10.0 + i for i, name in enumerate(prim_cost.BODIES)}
    results["select"] = 1.0  # below the floor: dropped
    path = tmp_path / "prim_ns.json"
    out = prim_cost.emit_json(results, "NVIDIA H100 80GB HBM3, 700.00 W", str(path))
    assert "select" not in out and out["__launch__"] == "k1"
    assert json.loads(path.read_text()) == out
    t = roofline.prim_ns(str(path))
    assert all(t[k] == results[k] for k in roofline.DEFAULT_PRIM_NS)
    assert t["__measured__"] == 1.0


# K8's chains at the widths K1's launch takes.


@pytest.fixture(scope="module")
def jax_prim_cost():
    return _script("prim_cost")


@pytest.mark.parametrize("body", [None] + list(prim_cost.BODIES))
def test_k8_k1_launch_chain_matches_the_tpu_kernel(jax_prim_cost, body):
    rows, width = 8, 2048
    x = np.random.RandomState(2).uniform(0.25, 0.75, (rows, width)).astype(np.float32)
    jax_body = None if body is None else jax_prim_cost.BODIES[body][0]
    want = np.asarray(jax_prim_cost.make_kernel(jax_body, 2, 2, rows, width, 1, True)(
        jnp.asarray(x)))
    got = prim_cost.chain(torch.from_numpy(x), body, 2, 2)
    assert got.dtype == torch.float32 and got.shape == x.shape
    rtol = TOLERANCE.get(body, 0)
    if rtol:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_k8_shift_reg_rolls_inside_pieces():
    x = np.random.RandomState(3).uniform(0.25, 0.75, (3, 128)).astype(np.float32)
    y = x * np.float32(0.5) + np.float32(0.125)
    for _ in range(3):
        pieces = y.reshape(3, 16, 8)
        x, y = (np.roll(pieces, -1, axis=2).reshape(3, 128) + x).astype(np.float32), x
    got = prim_cost.chain(torch.from_numpy(np.random.RandomState(3).uniform(
        0.25, 0.75, (3, 128)).astype(np.float32)), "shift_reg", 3, 1)
    np.testing.assert_array_equal(got.numpy(), x + y)
    assert "shift_reg" not in prim_cost.BODIES  # beside the table, never in it


# The ids name K1's launch, the one launch K8 runs at.
@pytest.mark.parametrize("width,ok", [pytest.param(64, True, id="k1-64-True"),
                                      pytest.param(32768, True, id="k1-32768-True"),
                                      pytest.param(96, False, id="k1-96-False"),
                                      pytest.param(32832, False, id="k1-32832-False")])
def test_k8_widths_of_each_launch(width, ok):
    x = torch.zeros((2, width))
    if ok:
        assert prim_cost.chain(x, "add", 1, 1).shape == x.shape
    else:
        with pytest.raises(ValueError, match="width"):
            prim_cost.chain(x, "add", 1, 1)


def test_k8_launches_are_named():
    with pytest.raises(ValueError, match="unknown body"):
        prim_cost.chain(torch.zeros((2, 64)), "k2", 1, 1)
    assert set(prim_cost.launches) == {None, *prim_cost.ALL_BODIES}
    assert set(prim_cost.ALL_BODIES) == {*prim_cost.BODIES, "shift_reg"}


def test_k8_measure_normalises_to_the_tables_unit(capsys):
    x = torch.from_numpy(np.random.RandomState(1).uniform(0.25, 0.75, (2, 128))
                         .astype(np.float32))
    times = {}

    def timer(fns, reps, iters):  # 1 ms a call, 2 ms for add: a fixed clock
        med = {name: (2.0 if name == "add" else 1.0) for name in fns}
        med["empty"] = 0.5
        times.update(med)
        return med, {}

    got = prim_cost.measure(x, steps=1, unroll=2, card="cpu", timer=timer)
    # add: (2 - 0.5) ms / (2 reps x 2 ops) over 256 elements, scaled to 262144.
    assert got["add"] == pytest.approx(1.5e6 / 4 * 262144 / 256)
    assert set(got) == set(prim_cost.BODIES)
    assert "beside the table: shift_reg" in capsys.readouterr().out


def test_k10_run_prices_the_model_three_ways(capsys):
    """The model priced by the shipped table and by K8 at K1's launch (the
    third pricing, K8 at its earlier launch, went with that launch)."""
    rs = np.random.RandomState(4)
    vis_t = torch.from_numpy(rs.standard_normal((4, 64, 2)).astype(np.float32))
    block = torch.from_numpy(np.random.RandomState(1).uniform(0.25, 0.75, (4, 256))
                             .astype(np.float32))
    result = rsk.run(vis_t, iters=1, reps=1, card="cpu", prim_block=block, prim_steps=1,
                     prim_unroll=1)
    assert set(result["models_ms"]) == {"shipped table", "K8 at K1's launch"}
    assert set(result["k11_stages_ms"]) == {"median", "rank", "threshold", "load + store"}
    for stages in result["stages_ms"].values():
        assert set(stages) == {"amplitude", "median", "rank", "threshold", "output"}
    shipped = roofline.compute_roofline(4, 64)["seconds_per_dump"] * 1e3
    assert result["models_ms"]["shipped table"] == shipped
    out = capsys.readouterr().out
    assert "priced two ways" in out and "K11" in out
