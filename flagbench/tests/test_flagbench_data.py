"""The data generator: the seed decides the dumps."""

import torch

from flagbench import data, harness

DATA = harness.load_traffic("resident")["data"]


def ring(seed):
    return data.make_ring(seed, 256, 8, DATA, 2, "cpu")


def test_one_seed_repeats():
    a, b = ring(2**31 + 11), ring(2**31 + 11)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_two_seeds_differ():
    a, b = ring(5), ring(6)
    assert not torch.equal(a[0], b[0])


def test_ring_dumps_differ():
    a = ring(5)
    assert not torch.equal(a[0], a[1])


def test_distribution():
    vis = data.make_dump(data.generator(3, "cpu"), 4096, 64, DATA, "cpu")
    assert vis.shape == (4096, 64, 2) and vis.dtype == torch.float32
    spikes = (vis[..., 0] > 40).float().mean().item()
    assert abs(spikes - DATA["spike_fraction"]) < 0.002
    assert abs(vis[..., 1].std().item() - 1.0) < 0.01  # the imaginary part is noise only


def test_large_and_negative_seeds():
    for seed in (2**33 + 1, -7):
        assert data.make_dump(data.generator(seed, "cpu"), 64, 4, DATA, "cpu").shape == (64, 4, 2)
