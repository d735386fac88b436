"""Stage checkpoint/resume tests."""

import numpy as np
import pytest

from genomic_pca_tpu.config import DataPrepConfig, EigenSnpConfig
from genomic_pca_tpu.models.eigensnp import compute_eigensnp_pca
from genomic_pca_tpu.models.prepare import prepare_data
from genomic_pca_tpu.io.bed import write_plink
from genomic_pca_tpu.utils.checkpoint import StageCheckpointer, fingerprint
from tests.conftest import make_genotypes


def test_checkpointer_roundtrip(tmp_path):
    ck = StageCheckpointer(str(tmp_path / "ck"), "abcd1234")
    arrays = {"x": np.arange(6).reshape(2, 3), "y": np.ones(4, dtype=np.float32)}
    ck.save("stage1", arrays)
    loaded = ck.load("stage1")
    np.testing.assert_array_equal(loaded["x"], arrays["x"])
    np.testing.assert_array_equal(loaded["y"], arrays["y"])
    assert ck.load("missing_stage") is None


def test_checkpointer_fingerprint_invalidation(tmp_path):
    d = str(tmp_path / "ck")
    ck1 = StageCheckpointer(d, "fp_one")
    ck1.save("stage1", {"x": np.ones(3)})
    ck2 = StageCheckpointer(d, "fp_two")  # different config -> wipe
    assert ck2.load("stage1") is None


def test_checkpointer_disabled():
    ck = StageCheckpointer(None, "fp")
    ck.save("s", {"x": np.ones(1)})  # no-op
    assert ck.load("s") is None


def _setup(tmp_path, rng):
    geno = make_genotypes(rng, 300, 40, n_pops=4, fst=0.2)
    prefix = str(tmp_path / "toy")
    write_plink(prefix, geno, bp=list(range(10, 3010, 10)))
    blocks = tmp_path / "blocks.tsv"
    blocks.write_text("1 1 1500\n1 1501 4000\n")
    cfg = DataPrepConfig(bed_path=prefix, ld_block_path=str(blocks), snp_chunk_size=128)
    return prepare_data(cfg)


def test_eigensnp_resume_identical(tmp_path, rng):
    prep = _setup(tmp_path, rng)
    algo = EigenSnpConfig(
        k_global=3, min_subset_size=10, refine_passes=2, snp_strip_size=128
    )
    ck_dir = str(tmp_path / "ckpt")
    r1 = compute_eigensnp_pca(prep, algo, checkpoint_dir=ck_dir)
    # second run resumes from completed checkpoints -> identical output
    r2 = compute_eigensnp_pca(prep, algo, checkpoint_dir=ck_dir)
    np.testing.assert_array_equal(r1.scores, r2.scores)
    np.testing.assert_array_equal(r1.loadings, r2.loadings)
    # and matches a run without checkpointing (which takes the fused
    # pca_core path, whose eigensolve pins per-PC signs independently —
    # compare sign-invariantly, like every score consumer does)
    r3 = compute_eigensnp_pca(prep, algo)
    signs = np.sign(np.sum(r1.scores * r3.scores, axis=0))
    np.testing.assert_allclose(
        r1.scores, r3.scores * signs[None, :], rtol=1e-4, atol=1e-4
    )


def test_eigensnp_stop_after_checkpoint_chain(tmp_path, rng):
    """A stop-after chain (stage2_basis -> refine_pass_0 -> completion)
    reproduces the single-invocation checkpointed run exactly — the
    split-process composition used to bound per-process memory (and to
    survive scheduled preemption)."""
    prep = _setup(tmp_path, rng)
    algo = EigenSnpConfig(
        k_global=3, min_subset_size=10, refine_passes=1, snp_strip_size=128
    )
    ref = compute_eigensnp_pca(
        prep, algo, checkpoint_dir=str(tmp_path / "ck_one")
    )

    ck = str(tmp_path / "ck_chain")
    assert compute_eigensnp_pca(
        prep, algo, checkpoint_dir=ck,
        stop_after_checkpoint="stage2_basis",
    ) is None
    assert compute_eigensnp_pca(
        prep, algo, checkpoint_dir=ck,
        stop_after_checkpoint="refine_pass_0",
    ) is None
    r = compute_eigensnp_pca(prep, algo, checkpoint_dir=ck)
    np.testing.assert_array_equal(ref.scores, r.scores)
    np.testing.assert_array_equal(ref.loadings, r.loadings)
    np.testing.assert_array_equal(ref.eigenvalues, r.eigenvalues)


def test_stop_after_checkpoint_validation(tmp_path, rng):
    from genomic_pca_tpu.errors import ComputeError

    prep = _setup(tmp_path, rng)
    algo = EigenSnpConfig(k_global=3, min_subset_size=10)
    with pytest.raises(ComputeError, match="checkpoint_dir"):
        compute_eigensnp_pca(
            prep, algo, stop_after_checkpoint="stage2_basis"
        )
    with pytest.raises(ComputeError, match="not a checkpoint"):
        compute_eigensnp_pca(
            prep, algo, checkpoint_dir=str(tmp_path / "ck"),
            stop_after_checkpoint="refine_pass_9",
        )


def test_eigensnp_checkpoint_config_change_recomputes(tmp_path, rng):
    prep = _setup(tmp_path, rng)
    ck_dir = str(tmp_path / "ckpt")
    algo1 = EigenSnpConfig(k_global=3, min_subset_size=10, snp_strip_size=128)
    algo2 = EigenSnpConfig(k_global=4, min_subset_size=10, snp_strip_size=128)
    compute_eigensnp_pca(prep, algo1, checkpoint_dir=ck_dir)
    r2 = compute_eigensnp_pca(prep, algo2, checkpoint_dir=ck_dir)
    assert r2.scores.shape[1] == 4  # stale k=3 checkpoint was invalidated


def test_fingerprint_sensitivity():
    cfg1 = EigenSnpConfig()
    cfg2 = EigenSnpConfig(seed=9)
    assert fingerprint(cfg1, 10, 100, ["a"]) != fingerprint(cfg2, 10, 100, ["a"])
    assert fingerprint(cfg1, 10, 100, ["a"]) != fingerprint(cfg1, 11, 100, ["a"])
    assert fingerprint(cfg1, 10, 100, ["a"]) == fingerprint(cfg1, 10, 100, ["a"])


def test_checkpointer_has_probe(tmp_path):
    """has() detects presence (and zip-level corruption) without
    materializing arrays or logging a 'Resuming' line."""
    ck = StageCheckpointer(str(tmp_path / "ck"), "fp")
    assert ck.has("stage1") is False
    ck.save("stage1", {"x": np.ones(3)})
    assert ck.has("stage1") is True
    # zip-level corruption -> has() False, load() None
    with open(ck._path("stage1"), "wb") as fh:
        fh.write(b"not a zip")
    assert ck.has("stage1") is False
    assert ck.load("stage1") is None
    assert StageCheckpointer(None, "fp").has("stage1") is False


def test_stop_after_leg_exits_when_pipeline_already_past(tmp_path, rng):
    """A retried stage-1 leg whose stage1_bases checkpoint was lost but
    whose stage2_basis survived must exit immediately: the pipeline is
    already past the requested stopping point, and falling through
    would stream the entire remaining tail in one process (defeating
    the per-process memory bound)."""
    import os

    prep = _setup(tmp_path, rng)
    ck_dir = str(tmp_path / "ckpt")
    algo = EigenSnpConfig(k_global=3, min_subset_size=10, snp_strip_size=128)
    # Leg 1 normally: runs stages 1+2, checkpoints both, exits.
    r = compute_eigensnp_pca(
        prep, algo, checkpoint_dir=ck_dir,
        stop_after_checkpoint="stage2_basis",
    )
    assert r is None
    # Lose the EARLIER checkpoint, retry the stage-1 leg.
    os.remove(os.path.join(ck_dir, "stage1_bases.npz"))
    r = compute_eigensnp_pca(
        prep, algo, checkpoint_dir=ck_dir,
        stop_after_checkpoint="stage1_bases",
    )
    assert r is None  # exited early: stage2_basis implies stage1 done
    # The completion leg still produces the full result from stage2.
    done = compute_eigensnp_pca(prep, algo, checkpoint_dir=ck_dir)
    assert done is not None and done.scores.shape[1] == 3
