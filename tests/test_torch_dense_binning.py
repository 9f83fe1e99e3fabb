"""The port's dense sketch and binning against the reference, with the
matrix split into column blocks narrower than ``_BLOCK`` (a large narrow
matrix, Higgs' 28 columns, spreads over the threads so) and whole: mapper
bytes and binned ids bit for bit, missing values and categorical columns
included."""

import numpy as np
import pytest

from dryad_tpu.data import sketch as jsketch

from dryad_tpu_torch.data import sketch as tsketch
from torch_layout import one_torch_thread  # noqa: F401 (autouse)


def _matrix(n: int, F: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random((n, F)) < 0.03] = np.nan
    X[:, 1] = rng.integers(0, 40, n)           # categorical
    X[:, 2] = np.round(X[:, 2] * 3)            # few distinct values
    return X


@pytest.mark.parametrize("F", [28, 130])
@pytest.mark.parametrize("split", [True, False])
def test_dense_binning_matches_reference(F, split, monkeypatch):
    monkeypatch.setattr(tsketch, "_MAX_THREADS", 4)
    monkeypatch.setattr(tsketch, "_SPLIT_CELLS", 1 if split else 1 << 62)
    X = _matrix(3000, F, seed=F)
    tm = tsketch.sketch_features(X, 64, categorical_features=(1,))
    jm = jsketch.sketch_features(X, 64, categorical_features=(1,))
    assert tm.to_bytes() == jm.to_bytes()
    got, want = tm.transform(X), jm.transform(X)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
