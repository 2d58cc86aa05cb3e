"""Create a placement context and report the chosen device.

Port of ``doc/examples/hello_device.py``.  Run::

    python -m katsdpsigproc_tpu_torch.examples.hello_device [--device cpu]
"""

from . import parse


def main(argv=None) -> None:
    ctx = parse(__doc__, argv)
    print(f"Successfully created context on {ctx.device} ({ctx.device_kind})")


if __name__ == "__main__":
    main()
