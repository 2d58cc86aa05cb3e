"""The port's tuning table (katsdpsigproc_tpu_torch.utils.tune) on the CPU.

The cases of ``tests/test_tune.py`` on the port: the grid search, the
table and user-cache lookup with exact and nearest matching, the stub and
forced modes and their pytest fixture, the staleness check of the shipped
table, and the mapping of JAX tuning results to the port's; and the
offline tuner ``scripts/tune_all``: a CPU run into a table of its own
(two templates' searches, to keep it short: the percentile and fused
flagger searches take tens of seconds each on the CPU), the merge on the
table's key, and a search that raises leaving the script.
"""

import enum
import json
import logging
import os

import numpy as np
import pytest
import torch

from katsdpsigproc_tpu_torch.pytest_plugin import patch_autotune  # noqa: F401
from katsdpsigproc_tpu_torch.scripts import tune_all
from katsdpsigproc_tpu_torch.utils import backend, tune


class TestAutotune:
    def test_picks_best(self):
        scores = {1: 0.5, 2: 0.1, 3: 0.9}
        assert tune.autotune(lambda x: (lambda iters: scores[x]), x=[1, 2, 3]) == {"x": 2}

    def test_skips_exceptions(self):
        """A configuration that does not apply raises SkipConfig and is skipped."""
        def generate(x):
            if x == 2:
                raise tune.SkipConfig("bad config")
            return lambda iters: float(x)

        assert tune.autotune(generate, x=[2, 1, 3]) == {"x": 1}

    def test_raises_if_all_fail(self):
        def generate(x):
            raise tune.SkipConfig(f"bad {x}")

        with pytest.raises(tune.SkipConfig, match="bad 3"):
            tune.autotune(generate, x=[1, 2, 3])

    @pytest.mark.parametrize("where", ["generate", "measure"])
    def test_candidate_errors_propagate(self, where):
        """Any other exception (a kernel that does not build or launch) is
        not skipped: the search raises it instead of picking another engine."""
        def measure(iters):
            raise RuntimeError("launch failed")

        def generate(x):
            if x == 2 and where == "generate":
                raise RuntimeError("launch failed")
            return measure if x == 2 else (lambda iters: float(x))

        with pytest.raises(RuntimeError, match="launch failed"):
            tune.autotune(generate, x=[1, 2, 3])

    def test_product_space(self):
        assert tune.autotune(lambda a, b: (lambda iters: a * 10 + b), a=[1, 2],
                             b=[3, 1]) == {"a": 1, "b": 1}


class _FakeOp:
    autotune_version = 3

    @classmethod
    @tune.autotuner(test={"wgs": 64})
    def autotune(cls, context, size):
        cls.ran = True
        return {"wgs": size * 2}


class TestAutotunerTable:
    def test_miss_runs_and_caches(self, tmp_path, monkeypatch):
        db = tmp_path / "tuning.json"
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_DB", str(db))
        _FakeOp.ran = False
        assert _FakeOp.autotune(None, 8) == {"wgs": 16}
        assert _FakeOp.ran
        _FakeOp.ran = False
        assert _FakeOp.autotune(None, 8) == {"wgs": 16}
        assert not _FakeOp.ran
        records = json.loads(db.read_text())
        assert len(records) == 1 and records[0]["version"] == 3
        assert records[0]["args"] == json.dumps({"size": 8})

    def test_different_args_miss(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_DB", str(tmp_path / "t.json"))
        _FakeOp.autotune(None, 8)
        _FakeOp.ran = False
        assert _FakeOp.autotune(None, 16) == {"wgs": 32}
        assert _FakeOp.ran

    def test_context_device_keys_the_record(self, tmp_path, monkeypatch):
        db = tmp_path / "t.json"
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_DB", str(db))
        _FakeOp.autotune(backend.DeviceContext(torch.device("cpu")), 8)
        record = json.loads(db.read_text())[0]
        assert (record["platform"], record["device_kind"]) == ("cpu", "cpu")

    def test_nearest_match_ignores_device(self, tmp_path, monkeypatch, caplog):
        db = tmp_path / "t.json"
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_DB", str(db))
        _FakeOp.autotune(None, 8)
        records = json.loads(db.read_text())
        records[0]["device_kind"] = "some other card"
        db.write_text(json.dumps(records))
        _FakeOp.ran = False
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_MATCH", "nearest")
        with caplog.at_level(logging.WARNING, logger="katsdpsigproc_tpu_torch.utils.tune"):
            assert _FakeOp.autotune(None, 8) == {"wgs": 16}
        assert not _FakeOp.ran  # inherited, with a warning that names the other card
        assert any("inherited" in r.message and "some other card" in r.message
                   for r in caplog.records)
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_MATCH", "exact")
        _FakeOp.autotune(None, 8)
        assert _FakeOp.ran

    def test_stub(self, monkeypatch):
        monkeypatch.setattr(tune, "autotuner_impl", tune.stub_autotuner)
        _FakeOp.ran = False
        assert _FakeOp.autotune(None, 8) == {"wgs": 64}
        assert not _FakeOp.ran

    def test_stub_env(self, tmp_path, monkeypatch):
        """The environment variable stubs a miss; nothing is saved."""
        db = tmp_path / "t.json"
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_DB", str(db))
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_STUB", "1")
        _FakeOp.ran = False
        assert _FakeOp.autotune(None, 8) == {"wgs": 64}
        assert not _FakeOp.ran
        assert not db.exists()

    def test_force(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_DB", str(tmp_path / "t.json"))
        _FakeOp.autotune(None, 8)
        monkeypatch.setattr(tune, "autotuner_impl", tune.force_autotuner)
        _FakeOp.ran = False
        assert _FakeOp.autotune(None, 8) == {"wgs": 16}
        assert _FakeOp.ran  # the cache is bypassed


class TestMakeMeasure:
    def test_measures_on_the_host_clock_for_cpu_tensors(self):
        calls = []

        def fn(x):
            calls.append(1)
            return x + 1

        measure = tune.make_measure(fn, torch.ones(8), warmup=1)
        assert measure(3) >= 0
        assert len(calls) == 4  # 1 warm-up + 3 timed


def test_patch_autotune_fixture(patch_autotune):  # noqa: F811
    _FakeOp.ran = False
    assert _FakeOp.autotune(None, 8) == {"wgs": 64}
    assert not _FakeOp.ran


@pytest.mark.force_autotune
def test_force_autotune_mark(patch_autotune, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_DB", str(tmp_path / "t.json"))
    _FakeOp.ran = False
    assert _FakeOp.autotune(None, 4) == {"wgs": 8}
    assert _FakeOp.ran


@pytest.mark.force_autotune
def test_forced_search_on_the_cpu_skips_the_cuda_engine(patch_autotune):  # noqa: F811
    """On a CPU context the cuda candidates do not apply: the searches skip
    them and pick a plain engine."""
    from katsdpsigproc_tpu_torch.ops import percentile, transpose

    ctx = backend.DeviceContext(torch.device("cpu"))
    assert percentile.Percentile5Template(ctx, 16, True).engine in ("rank", "sort")
    assert transpose.TransposeTemplate(ctx, "float32").engine == "torch"


def test_adapt_value():
    class Color(enum.Enum):
        RED = 1

    assert tune.adapt_value(np.dtype(np.float32)) == repr(np.dtype(np.float32))
    assert tune.adapt_value(torch.float32) == "torch.float32"
    assert tune.adapt_value(int) == repr(int)
    assert tune.adapt_value(Color.RED) == "RED"
    assert tune.adapt_value(42) == 42


@pytest.mark.parametrize("jax_tuning,port_tuning", [
    ({"engine": "xla", "tile_r": 128, "tile_c": 128}, {"engine": "torch"}),
    ({"engine": "pallas", "tile_r": 512, "tile_c": 512}, {"engine": "cuda"}),
    ({"engine": "pallas"}, {"engine": "cuda"}),
    ({"engine": "rank"}, {"engine": "rank"}),
    ({"engine": "network"}, {"engine": "network"}),
    ({"radix_bits": 2}, {"radix_bits": 2}),
    ({"bb": 16, "fold": 32768, "ingest": "planar", "nref": 1, "pipeline": "dma"}, {}),
])
def test_from_jax_tuning(jax_tuning, port_tuning):
    assert tune.from_jax_tuning(jax_tuning) == port_tuning


def test_shipped_jax_records_map_to_port_engines():
    """Every engine of the JAX package's shipped table maps to one the port has."""
    from katsdpsigproc_tpu.utils import tune as jtune

    table = json.load(open(os.path.join(os.path.dirname(jtune.__file__), "tuning_table.json")))
    engines = {"Percentile5Template.autotune": {"rank", "sort", "cuda"},
               "TransposeTemplate.autotune": {"torch", "cuda"},
               "BackgroundMedianFilterDeviceTemplate.autotune": {"network", "count"}}
    for rec in table:
        mapped = tune.from_jax_tuning(rec["result"])
        if rec["fn"] in engines:
            assert mapped["engine"] in engines[rec["fn"]], rec


def _canonical():
    """The production instantiations of every autotuned template of the port."""
    from katsdpsigproc_tpu_torch.models.rfi import device, fused_flagger
    from katsdpsigproc_tpu_torch.ops import percentile, transpose

    return [
        (transpose.TransposeTemplate, ("float32",)),
        (transpose.TransposeTemplate, ("complex64",)),
        (percentile.Percentile5Template, (5000, True)),
        (device.BackgroundMedianFilterDeviceTemplate, (13,)),
        (device.NoiseEstMADTDeviceTemplate, (32768,)),
        (device.NoiseEstMADDeviceTemplate, ()),
        (fused_flagger.FusedFlaggerTemplate, (13, 4)),
    ]


def test_shipped_table_versions_match_code():
    """Every template's ``autotune_version`` has a record in the shipped table
    at its production arguments, so a version bump without a new search on
    the card fails here and not as a live search in production."""
    table = json.load(open(tune._TABLE_PATH))
    shipped = {(r["fn"], r["version"], r["args"]) for r in table}
    for cls, args in _canonical():
        keys = tune._keys(cls.autotune.__wrapped__, (cls, None) + args, {})
        assert (keys["fn"], cls.autotune_version, keys["args"]) in shipped, (
            f"{keys['fn']}: no shipped record at args {keys['args']}, version "
            f"{cls.autotune_version}: rerun chip_smoke.py's forced search on the card")
    for rec in table:
        assert rec["platform"] == "cuda" and rec["device_kind"].startswith("NVIDIA H100")


def test_shipped_table_covers_every_template(tmp_path, monkeypatch):
    """Building each template on a card would resolve from the shipped table."""
    monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_DB", str(tmp_path / "empty.json"))
    monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_MATCH", "exact")
    monkeypatch.setattr(backend, "device_kind_key",
                        lambda device=None: ("cuda", "NVIDIA H100 80GB HBM3"))

    def strict_impl(test, fn, *args, **kwargs):
        keys = tune._keys(fn, args, kwargs)
        keys["version"] = args[0].autotune_version
        keys.update(tune._device_columns())
        cached = tune._fetch(keys)
        assert cached is not None, f"no shipped tuning record for {keys}"
        return cached

    monkeypatch.setattr(tune, "autotuner_impl", strict_impl)
    made = [cls(None, *args) for cls, args in _canonical()]
    assert made[2].engine == "cuda" and made[1].engine == "cuda"
    assert made[-1].tuning == {}


def test_tune_all_templates_are_the_shipped_tables(monkeypatch):
    """Every shipped record's template and arguments are searched, and
    nothing else (each search short-cut to its first candidate)."""
    monkeypatch.setattr(tune, "autotune",
                        lambda generate, time_limit=0.1, **kw: {k: v[0] for k, v in kw.items()})
    picks = tune_all.search_all(backend.DeviceContext(torch.device("cpu")))
    shipped = json.load(open(tune._TABLE_PATH))
    assert sorted((r["fn"], r["version"], r["args"]) for _, r in picks) == sorted(
        (r["fn"], r["version"], r["args"]) for r in shipped)
    assert [label for label, _ in picks] == [
        "transpose f32", "transpose c64", "percentile 5000", "background median",
        "madnz transposed", "madnz straight", "fused flagger"]


class TestTuneAll:
    """``scripts/tune_all`` on the CPU, each run writing a table under tmp_path."""

    @pytest.fixture(autouse=True)
    def _own_cache(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_DB", str(tmp_path / "cache.json"))
        monkeypatch.setattr(tune_all, "TEMPLATES", tune_all.TEMPLATES[:2])

    def test_cpu_run_merges_the_picks_into_the_shipped_records(self, tmp_path, capsys):
        table = tmp_path / "out" / "table.json"
        tune_all.main(["--device", "cpu", "--table", str(table)])
        err = capsys.readouterr().err
        records = json.load(open(table))
        shipped = json.load(open(tune._TABLE_PATH))
        new = [r for r in records if r["platform"] == "cpu"]
        assert [r for r in records if r["platform"] != "cpu"] == shipped
        assert sorted((r["fn"], r["version"], r["platform"], r["device_kind"], r["args"])
                      for r in new) == [
            ("TransposeTemplate.autotune", 2, "cpu", "cpu", '{"dtype": "complex64"}'),
            ("TransposeTemplate.autotune", 2, "cpu", "cpu", '{"dtype": "float32"}')]
        assert all(r["result"] == {"engine": "torch"} for r in new)  # cuda skipped on a CPU
        assert records == sorted(records, key=lambda r: (r["fn"], r["args"]))
        assert 'transpose f32: TransposeTemplate.autotune {"dtype": "float32"}: ' \
               '{"engine": "torch"} (shipped: none)' in err, err
        assert "differ from the shipped table: transpose f32, transpose c64" in err
        assert f"wrote 9 records to {table}" in err
        assert tune.autotuner_impl is not tune.force_autotuner
        # The search is forced: nothing is read from or saved to the user cache.
        assert not (tmp_path / "cache.json").exists()

    def test_merge_replaces_the_record_of_the_same_key_only(self, tmp_path):
        table = tmp_path / "table.json"
        stale = {"fn": "TransposeTemplate.autotune", "version": 2, "platform": "cpu",
                 "device_kind": "cpu", "args": '{"dtype": "float32"}',
                 "result": {"engine": "cuda"}}
        older = dict(stale, version=1)
        other = dict(stale, device_kind="another cpu")
        table.write_text(json.dumps([stale, older, other]))
        tune_all.main(["--device", "cpu", "--table", str(table)])
        records = json.load(open(table))
        assert len(records) == 4  # the table's own three, the float32 pick replacing one
        assert older in records and other in records and stale not in records
        assert dict(stale, result={"engine": "torch"}) in records

    def test_a_search_that_raises_leaves_the_script(self, tmp_path, monkeypatch):
        class Broken:
            autotune_version = 1

            def __init__(self, context):
                self.tuning = self.autotune(context)

            @classmethod
            @tune.autotuner(test={})
            def autotune(cls, context):
                def generate(engine):
                    raise RuntimeError(f"{engine} kernel failed to launch")

                return tune.autotune(generate, engine=["cuda"])

        monkeypatch.setattr(tune_all, "TEMPLATES",
                            tune_all.TEMPLATES[:1] + (("broken", Broken),))
        table = tmp_path / "table.json"
        with pytest.raises(RuntimeError, match="cuda kernel failed to launch"):
            tune_all.main(["--device", "cpu", "--table", str(table)])
        assert not table.exists()
        assert tune.autotuner_impl is not tune.force_autotuner

class TestBackend:
    """The port's device contexts (the cases of ``tests/test_backend.py``)."""

    def test_all_devices_end_with_the_cpu(self):
        assert backend.all_devices()[-1] == torch.device("cpu")

    def test_env_pinning(self, monkeypatch):
        devices = backend.all_devices()
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_DEVICE", str(len(devices) - 1))
        assert backend.candidate_devices() == [devices[-1]]
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_DEVICE", str(len(devices)))
        with pytest.raises(IndexError):
            backend.candidate_devices()

    def test_device_filter(self):
        assert backend.candidate_devices(lambda d: False) == []
        with pytest.raises(RuntimeError, match="No matching device"):
            backend.create_some_context(device_filter=lambda d: False)

    def test_context_prefers_cuda_and_puts(self):
        ctx = backend.create_some_context(devices=[torch.device("cpu")])
        assert (ctx.platform, ctx.device_kind) == ("cpu", "cpu")
        assert ctx.put(np.ones(3)).device == torch.device("cpu")
        assert backend.device_kind_key(torch.device("cpu")) == ("cpu", "cpu")
        best = backend.create_some_context()
        assert best.platform == ("cuda" if torch.cuda.is_available() else "cpu")
        assert backend.context_device(None) == best.device

    def test_context_none_is_the_card_where_there_is_one(self, monkeypatch):
        """A template built without a context computes on the best device, as
        the JAX package's do on JAX's default device; nothing is allocated."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert backend.context_device(None) == torch.device("cuda", 0)
        ctx = backend.create_some_context(devices=[torch.device("cpu")])
        assert backend.context_device(ctx) == torch.device("cpu")

    def test_interactive_choice(self, monkeypatch):
        import sys

        devs = [torch.device("cpu"), torch.device("cpu")]
        monkeypatch.setattr(sys.stdin, "isatty", lambda: True)
        monkeypatch.setattr("builtins.input", lambda prompt="": "1")
        assert backend.create_some_context(interactive=True, devices=devs).device == devs[1]
        for bad in ("-1", "notanumber", "2"):
            monkeypatch.setattr("builtins.input", lambda prompt="", b=bad: b)
            with pytest.raises(RuntimeError, match="Invalid device"):
                backend.create_some_context(interactive=True, devices=devs)
