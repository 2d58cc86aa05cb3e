"""The reader of K1's CTA sizes: None with nothing to read, else the small CTAs' share."""

import pytest

from flagbench import harness


@pytest.mark.parametrize("counts, share", [({128: 3, 256: 0, 512: 0, 1024: 1}, 75.0),
                                           ({128: 0, 256: 2, 512: 2, 1024: 0}, 100.0),
                                           ({128: 0, 256: 0, 512: 0, 1024: 5}, 0.0)])
def test_k1_small_cta_share(monkeypatch, counts, share):
    from katsdpsigproc_tpu_torch.models.rfi import fused_flagger

    monkeypatch.setattr(fused_flagger, "k1_ctas", counts, raising=False)
    assert harness.load_reader("k1_small_cta_share")(None) == pytest.approx(share)


def test_k1_small_cta_share_with_nothing_to_read(monkeypatch):
    from katsdpsigproc_tpu_torch.models.rfi import fused_flagger

    read = harness.load_reader("k1_small_cta_share")
    monkeypatch.setattr(fused_flagger, "k1_ctas", {128: 0, 1024: 0}, raising=False)
    assert read(None) is None  # no K1 launched
    monkeypatch.delattr(fused_flagger, "k1_ctas")  # a program without the counter
    assert read(None) is None
