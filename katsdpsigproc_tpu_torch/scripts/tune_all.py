"""Offline tuner: run every template's search and merge the picks into a tuning table.

Port of ``scripts/tune_all.py``.  It forces the measured search of the
templates the JAX script tunes (:data:`TEMPLATES`), records each pick
under the table's key (``fn``, ``version``, ``platform``,
``device_kind``, ``args``), prints it beside the shipped table's record
and names those that differ, then merges the picks into ``--table``
(default: the shipped ``katsdpsigproc_tpu_torch/utils/tuning_table.json``).
A record of the same key is replaced and the others kept; a ``--table``
that does not exist yet starts from the shipped table's records.

Unlike the JAX script, which prints ``FAILED`` and goes on when a search
raises, an error leaves the script, as it leaves ``utils/tune.autotune``:
a broken kernel is never silently tuned away.

Run on the card::

    python -m katsdpsigproc_tpu_torch.scripts.tune_all [--table PATH]

It exits without a card unless given ``--device cpu``.
"""

import argparse
import json
import os
import sys
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from ..models.rfi import device as rfi_device, fused_flagger
from ..ops import percentile, transpose
from ..utils import backend, tune
from . import common

#: The templates the JAX script tunes, each with a label and how to build it on a context.
TEMPLATES: Sequence[Tuple[str, Callable]] = (
    ("transpose f32", lambda ctx: transpose.TransposeTemplate(ctx, np.float32)),
    ("transpose c64", lambda ctx: transpose.TransposeTemplate(ctx, np.complex64)),
    ("percentile 5000", lambda ctx: percentile.Percentile5Template(ctx, 5000, True)),
    ("background median",
     lambda ctx: rfi_device.BackgroundMedianFilterDeviceTemplate(ctx, 13)),
    ("madnz transposed", lambda ctx: rfi_device.NoiseEstMADTDeviceTemplate(ctx)),
    ("madnz straight", lambda ctx: rfi_device.NoiseEstMADDeviceTemplate(ctx)),
    ("fused flagger", lambda ctx: fused_flagger.FusedFlaggerTemplate(ctx)),
)


def _key(record: dict) -> tuple:
    return tuple(record.get(k) for k in tune._KEY_FIELDS)


def search_all(ctx: backend.DeviceContext) -> List[Tuple[str, dict]]:
    """Build each of :data:`TEMPLATES` on `ctx` with its real search forced; returns
    (label, record) pairs.

    Each record is the one the search's key and result make, as
    ``utils/tune.autotuner_impl`` would save it.  ``tune.autotuner_impl``
    is restored afterwards, whether a search returns or raises.
    """
    found: List[dict] = []

    def forcing_impl(test, fn, *args, **kwargs):
        cls = args[0] if args else None
        keys = tune._keys(fn, args, kwargs)
        keys["version"] = getattr(cls, "autotune_version", 0)
        keys.update(tune._device_columns(tune._context_of(fn, args, kwargs)))
        result = dict(fn(*args, **kwargs))
        found.append({**keys, "result": result})
        return result

    picks = []
    saved = tune.autotuner_impl
    tune.autotuner_impl = forcing_impl
    try:
        for label, make in TEMPLATES:
            before = len(found)
            make(ctx)
            picks.extend((label, record) for record in found[before:])
    finally:
        tune.autotuner_impl = saved
    return picks


def merge(old: List[dict], new: List[dict]) -> List[dict]:
    """`old` with each record of `new` in place of the one of the same key, sorted as shipped."""
    merged: Dict[tuple, dict] = {_key(r): r for r in old}
    merged.update({_key(r): r for r in new})
    return sorted(merged.values(), key=lambda r: (r["fn"], r["args"]))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--table", default=tune._TABLE_PATH,
                        help="the table to merge the picks into (default: the shipped one)")
    common.add_device_option(parser)
    args = parser.parse_args(argv)
    ctx = backend.DeviceContext(common.harness_device(args.device))
    print(f"tuning for {ctx.device} ({ctx.device_kind})", file=sys.stderr)

    picks = search_all(ctx)
    shipped = {_key(r): r for r in tune._load_records(tune._TABLE_PATH)}
    differ = []
    for label, record in picks:
        was = shipped.get(_key(record))
        was_text = "none" if was is None else json.dumps(was["result"], sort_keys=True)
        print(f"{label}: {record['fn']} {record['args']}: "
              f"{json.dumps(record['result'], sort_keys=True)} (shipped: {was_text})",
              file=sys.stderr)
        if was is None or was["result"] != record["result"]:
            differ.append(label)
    print("differ from the shipped table: " + (", ".join(differ) if differ else "none"),
          file=sys.stderr)

    with open(args.table if os.path.exists(args.table) else tune._TABLE_PATH) as f:
        records = merge(json.load(f), [record for _, record in picks])
    os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
    with open(args.table, "w") as f:
        json.dump(records, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(records)} records to {args.table}", file=sys.stderr)


if __name__ == "__main__":
    main()
