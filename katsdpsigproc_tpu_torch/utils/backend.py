"""Device discovery and selection.

Port of ``katsdpsigproc_tpu/utils/backend.py:68-135``
(``DeviceContext``, ``create_some_context``, ``device_kind_key``) over
``torch.device``:

* :func:`all_devices` / :func:`candidate_devices`: every CUDA card, then
  the CPU, with ``KATSDPSIGPROC_TPU_TORCH_DEVICE`` pinning one by index;
* :func:`create_some_context`: a :class:`DeviceContext` on the best
  device, CUDA before CPU;
* :func:`device_kind_key`: the (platform, device kind) pair that keys the
  tuning table, with ``torch.cuda.get_device_name`` as the kind.
"""

import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

_PLATFORM_RANK = {"cuda": 50, "cpu": 30}


def all_devices() -> List[torch.device]:
    """Every CUDA device, then the CPU."""
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devices + [torch.device("cpu")]


def candidate_devices(device_filter=None) -> List[torch.device]:
    """Devices to consider, honouring ``KATSDPSIGPROC_TPU_TORCH_DEVICE``.

    Port of ``katsdpsigproc_tpu/utils/backend.py::candidate_devices``; the
    variable holds an index into :func:`all_devices`.
    """
    devices = all_devices()
    env = os.environ.get("KATSDPSIGPROC_TPU_TORCH_DEVICE")
    if env is not None:
        idx = int(env)
        if not 0 <= idx < len(devices):
            raise IndexError(
                f"KATSDPSIGPROC_TPU_TORCH_DEVICE={idx} out of range ({len(devices)} devices)")
        devices = [devices[idx]]
    if device_filter is not None:
        devices = [d for d in devices if device_filter(d)]
    return devices


@dataclass
class DeviceContext:
    """A single-device placement context.

    Port of ``katsdpsigproc_tpu/utils/backend.py::DeviceContext``: it
    carries the ``torch.device`` that templates allocate on and measure on,
    and, as in JAX, an ``extra`` dict that callers may fill.
    """

    device: torch.device
    extra: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.device = torch.device(self.device)

    @property
    def platform(self) -> str:
        return self.device.type

    @property
    def device_kind(self) -> str:
        return device_kind_key(self.device)[1]

    def put(self, x) -> torch.Tensor:
        """Place an array (numpy or tensor) on this context's device."""
        return torch.as_tensor(x).to(self.device)

    def __repr__(self) -> str:  # pragma: nocover
        return f"DeviceContext({self.device})"


def create_some_context(interactive: bool = False, device_filter=None,
                        devices: Optional[Sequence[torch.device]] = None) -> DeviceContext:
    """Pick the best available device and wrap it in a :class:`DeviceContext`.

    Port of ``katsdpsigproc_tpu/utils/backend.py::create_some_context``:
    with `interactive`, a tty and several candidates, the user picks one
    by number (an invalid choice raises ``RuntimeError``); otherwise the
    best-ranked device wins, CUDA before CPU.
    """
    if devices is None:
        devices = candidate_devices(device_filter)
    if not devices:
        raise RuntimeError("No matching device found")
    if interactive and len(devices) > 1 and sys.stdin.isatty():
        print("Select device:")
        for i, device in enumerate(devices):
            print(f"    [{i}]: {device_kind_key(device)[1]} ({device.type})")
        print()
        choice_str = input("Enter selection: ")
        try:
            choice = int(choice_str)
            if choice < 0:
                raise IndexError
            best = devices[choice]
        except (ValueError, IndexError):
            raise RuntimeError("Invalid device number") from None
    else:
        best = max(devices, key=lambda d: _PLATFORM_RANK.get(d.type, 10))
    return DeviceContext(best)


def context_device(context) -> torch.device:
    """The device of `context`, or the best device for ``None``.

    A template built without a context computes where the JAX package's
    would, on the default device: the card where there is one
    (:func:`create_some_context`), else the CPU.
    """
    return create_some_context().device if context is None else context.device


def device_kind_key(device: Optional[torch.device] = None) -> tuple:
    """(platform, device kind) tuning-table key for `device` (default: the best device).

    Port of ``katsdpsigproc_tpu/utils/backend.py::device_kind_key``.  A
    CUDA device's kind is ``torch.cuda.get_device_name``, e.g. ``"NVIDIA
    H100 80GB HBM3"``; the CPU's is ``"cpu"``.
    """
    if device is None:
        device = create_some_context().device
    device = torch.device(device)
    if device.type == "cuda":
        return ("cuda", torch.cuda.get_device_name(device))
    return (device.type, device.type)
