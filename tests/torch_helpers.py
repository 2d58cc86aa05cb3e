"""Helpers shared by the port's tests."""

import torch


def inexact_float64_sqrt(monkeypatch):
    """Make ``torch.sqrt`` return float64 roots off by 2**-33 of themselves, up
    and down in turn, as MKL's first call in a process once returned them
    on the CPU (ROADMAP Queue 3)."""
    exact = torch.sqrt

    def sqrt(x):
        root = exact(x)
        if root.dtype != torch.float64:
            return root
        turn = (torch.arange(root.numel()) % 2).reshape(root.shape).to(torch.float64)
        return root * (1.0 + (1.0 - 2.0 * turn) * 2.0 ** -33)

    monkeypatch.setattr(torch, "sqrt", sqrt)
