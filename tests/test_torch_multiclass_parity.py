"""The port's multiclass training on ``test_engine_parity.py::
test_multiclass_parity``'s fixture against the reference's XLA arm.

The fixture (``covertype_like(2500, 20)``, 48 bins, K=7, 4 iterations, 10
leaves) takes the reference's defaults otherwise: leaf-wise growth at
effective depth 8.  The XLA arm builds shared-plan fp32 multiclass roots,
which the port does not; on this fixture no split sits near a tie, so
the trees agree.  It is kept apart from ``test_torch_multiclass.py``
because depth 8 on the kernels' plain versions and the reference's
compile take about a minute on the CPU.

Tolerances: integer tree arrays equal, leaf values within 1e-4 (atol),
as in ``test_torch_multiclass.py``; accuracy of predict equal.
"""

import numpy as np

import dryad_tpu
from dryad_tpu.datasets import covertype_like

import dryad_tpu_torch as dt
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

_INT_KEYS = ("feature", "threshold", "left", "right", "default_left",
             "is_cat")


def test_parity_fixture_matches_reference_xla_arm():
    X, y = covertype_like(2500, num_features=20)
    params = dict(objective="multiclass", num_class=7, num_trees=4,
                  num_leaves=10, max_bins=48)
    jb = dryad_tpu.train(params, dryad_tpu.Dataset(X, y, max_bins=48),
                         backend="tpu", hist_backend="xla")
    tb = dt.train(params, dt.Dataset(X, y, max_bins=48), device="cpu")
    assert tb.num_total_trees == 28 and tb.params.max_depth == 8
    ref, got = jb.tree_arrays(), tb.to_reference_arrays()
    for k in _INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["value"], ref["value"], atol=1e-4)
    assert tb.max_depth_seen == jb.max_depth_seen
    acc = (dt.predict(tb, X, device="cpu").argmax(1) == y).mean()
    assert acc == (jb.predict(X).argmax(1) == y).mean()
