"""chip_smoke.py's CPU-checkable parts: the GPU gate, phase selection,
the result line, and its comparison helpers."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu()


@pytest.mark.parametrize(
    "four, want", [(False, ("a", "b", "c", "d", "e", "f")), (True, ("four",))]
)
def test_phase_selection(four, want):
    assert chip_smoke.phases_for(four) == want


def test_result_line_is_the_device_as_jax_reports_it():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()] * 4)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 4},
    }
    assert "\n" not in line


def test_separated_prefix_stops_before_a_small_gap():
    # PC2 and PC3 are within 1% of each other: only PC1 is separated.
    assert chip_smoke.separated_k(np.array([10.0, 5.0, 4.95, 1.0])) == 1
    # A gap after the last compared PC needs one more eigenvalue.
    assert chip_smoke.separated_k(np.array([3.0, 2.0, 1.0])) == 2
    assert chip_smoke.separated_k(np.array([1.0, 0.999])) == 0


def test_prefix_min_fails_every_bar_when_nothing_is_separated():
    r = np.array([0.9, 0.5])
    assert chip_smoke.prefix_min(r, 1) == 0.9
    assert not chip_smoke.prefix_min(r, 0) >= 0.0


def test_check_raises_even_when_optimized():
    chip_smoke.check(True, "fine")
    with pytest.raises(AssertionError, match="detail"):
        chip_smoke.check(False, "detail")


def test_write_vcfs_round_trips_through_the_parser(tmp_path, rng):
    from genomic_pca_tpu.io.vcf import load_vcf_directory

    geno = rng.integers(0, 3, (9, 6)).astype(np.int8)
    chip_smoke.write_vcfs(tmp_path, geno, n_files=2)
    names, ids, strips = load_vcf_directory(str(tmp_path), maf_threshold=0.0)
    assert names == [f"s{i}" for i in range(6)]
    got = np.concatenate(list(strips))
    kept = [i for i in range(9) if 0 < geno[i].sum() < 12]  # polymorphic
    np.testing.assert_array_equal(got, geno[kept])
