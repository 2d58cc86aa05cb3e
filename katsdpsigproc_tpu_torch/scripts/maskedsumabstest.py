"""Masked-sum-of-amplitudes benchmark and parity check.

Port of ``scripts/maskedsumabstest.py``: :mod:`.maskedsumtest` with
``--amplitudes``.

Run::

    python -m katsdpsigproc_tpu_torch.scripts.maskedsumabstest [--device cpu] [options]
"""

import sys

from . import maskedsumtest


def main(argv=None):
    maskedsumtest.main(["--amplitudes", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    main()
