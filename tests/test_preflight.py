"""Residency decisions: the device-memory budget rule and the
resident-vs-streamed choice (models/prepare.py)."""

import numpy as np
import pytest

from genomic_pca_tpu.errors import DataPrepError
from genomic_pca_tpu.models import prepare as prep_mod


class _Dev:
    def __init__(self, platform, stats, kind="fake"):
        self.platform = platform
        self.device_kind = kind
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_budget_uses_reported_limit(monkeypatch):
    devs = [_Dev("gpu", {"bytes_limit": 60 << 30}) for _ in range(4)]
    monkeypatch.setattr(prep_mod.jax, "local_devices", lambda: devs)
    assert prep_mod._device_memory_budget() == 4 * (60 << 30)
    assert prep_mod._default_device_budget() == 60 << 30


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_accelerator_without_memory_stats_raises(monkeypatch, stats):
    """No silent guess: an accelerator that reports no limit is an
    error, not a default size."""
    devs = [_Dev("gpu", stats)]
    monkeypatch.setattr(prep_mod.jax, "local_devices", lambda: devs)
    with pytest.raises(DataPrepError, match="no memory limit"):
        prep_mod._device_memory_budget()
    with pytest.raises(DataPrepError):
        prep_mod._default_device_budget()


def test_cpu_budget_is_host_memory(monkeypatch):
    import os

    devs = [_Dev("cpu", None), _Dev("cpu", None)]
    monkeypatch.setattr(prep_mod.jax, "local_devices", lambda: devs)
    phys = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert prep_mod._default_device_budget() == phys
    assert prep_mod._device_memory_budget() == 2 * phys


def test_will_stream_and_estimate(tmp_path):
    from genomic_pca_tpu.config import DataPrepConfig
    from genomic_pca_tpu.io.bed import write_plink
    from genomic_pca_tpu.models.prepare import prepare_data

    rng = np.random.default_rng(3)
    g = rng.integers(0, 3, (64, 16)).astype(np.int8)
    write_plink(tmp_path / "fx", g, bp=np.arange(64) * 10 + 10,
                chrom=["1"] * 64)
    (tmp_path / "blocks.tsv").write_text("1 1 1000\n")
    prep = prepare_data(DataPrepConfig(
        bed_path=str(tmp_path / "fx"),
        ld_block_path=str(tmp_path / "blocks.tsv"),
    ))
    est = prep.estimate_resident_bytes()
    assert 0 < est < 1 << 20  # tiny fixture
    assert prep.will_stream(force_streaming=False) is False
    assert prep.will_stream(force_streaming=True) is True
