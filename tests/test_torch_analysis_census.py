"""The port's op census (dryad_tpu_torch/analysis, layer 2): the
counterparts of tests/test_analysis_jaxpr.py.  Each arm's invariants (the
wired paths sort-free with K1 and K2 on uint8 128-byte records, the legacy
arm's plan sorts, GOSS's and the renewal's one sort, the group arms'
collectives equal to ``RowGroup.stats`` and ``train.comm_stats``, sharded
predict collective-free), the census machinery (a seeded extra
all-reduce is counted, row-scale against slot-scale sorts, the kernel
boundary hides the plain versions' ops), and the digest tripwire
(stable across reruns, moving on a program change, corruption reported,
the ``--update-goldens`` round trip, the torch-version rebaseline).

The arms run for real on the CPU at 4096 rows; the group arms run at
world 2 in one pair of spawned interpreters.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

from dryad_tpu_torch.analysis import census as ce
from dryad_tpu_torch.analysis.digests import load_goldens, save_goldens


@pytest.fixture(scope="module")
def audit_report():
    return ce.run_census()


def _arm(report, name):
    return next(a for a in report.arms if a.name == name)


# ---------------------------------------------------------------------------
# the documented invariants, arm by arm


def test_all_arms_pass_invariants(audit_report):
    assert {a.name for a in audit_report.arms} == set(ce.ARMS)
    for arm in audit_report.arms:
        assert arm.ok, f"{arm.name}: {arm.failures}"


def test_collectives_match_stats_and_comm_stats_every_group_arm(
        audit_report):
    """The c10d ops the census saw, the group's own accounting and the
    iteration's plan must agree, or one of them drifted."""
    for arm in audit_report.arms:
        if ce.ARMS[arm.name][2] != "group":
            continue
        c = arm.census
        assert sum(c.collectives.values()) == sum(c.group_calls.values()), \
            arm.name
        hist = c.group_calls.get("hist", 0) + c.group_calls.get("splits", 0)
        assert hist == arm.comm["collective_calls_per_iter"], arm.name


def test_wired_paths_sort_free(audit_report):
    for name in ("levelwise_wired", "leafwise_wired", "group_fused",
                 "group_feature", "group_leafwise_feature"):
        assert _arm(audit_report, name).census.row_sorts == 0, name


def test_legacy_arm_keeps_its_tile_plan_sorts(audit_report):
    """The comparison arm must keep sorting: if it silently stopped, it is
    no longer the program the wired arm replaced."""
    c = _arm(audit_report, "levelwise_legacy").census
    assert c.row_sorts > 0
    assert c.kernels["hist_rows"] > 0 and c.kernels["hist_nat"] > 0
    stored = load_goldens()["arms"]["levelwise_legacy"]
    assert (stored["row_sorts"], stored["kernels"]) == (
        c.row_sorts, dict(c.kernels))


def test_goss_adds_exactly_one_row_sort(audit_report):
    assert _arm(audit_report, "goss_iteration").census.row_sorts == 1


def test_group_goss_replaces_the_sort_by_the_radix_select(audit_report):
    """The departure from the reference's global sort: over a group the
    threshold is an exact radix select (four all-reduces) plus the top
    count's one all-reduce, and no row sort."""
    c = _arm(audit_report, "group_goss").census
    assert c.row_sorts == 0
    assert c.group_calls["goss"] == 5
    fused = _arm(audit_report, "group_fused").census
    assert c.collectives["allreduce_"] == fused.collectives["allreduce_"] + 5


def test_renewal_adds_exactly_one_row_sort(audit_report):
    for name in ("renewal_iteration", "group_renewal"):
        c = _arm(audit_report, name).census
        assert c.row_sorts == 1, name
        assert sum(e.startswith("aten.sort.stable") for e in c.stream) == 1


def test_sharded_predict_collective_free(audit_report):
    c = _arm(audit_report, "sharded_predict").census
    assert not c.collectives and c.row_sorts == 0


def test_packed_predict_one_table_gather_a_level(audit_report):
    c = _arm(audit_report, "packed_predict").census
    assert c.table_gathers == ce._PREDICT_TREES * (ce._PREDICT_DEPTH + 1)


def test_only_documented_collectives_anywhere(audit_report):
    """fused arms: all-reduce only; the feature arm adds its per-level
    reduce-scatter and split all-gather; the renewal its gathered
    residuals' all-gathers.  Nothing else, anywhere."""
    for arm in audit_report.arms:
        allowed = {"allreduce_"}
        if arm.name in ("group_feature", "group_leafwise_feature"):
            allowed |= {"reduce_scatter_", "allgather_"}
        if arm.name == "group_renewal":
            allowed |= {"allgather_"}
        if ce.ARMS[arm.name][2] != "group":
            allowed = set()
        extra = set(arm.census.collectives) - allowed
        assert not extra, (arm.name, extra)


def test_feature_arm_collective_plan_matches_comm_stats(audit_report):
    """The feature arms' plans, census-verified: the root's one fused
    all-reduce (and the shift's), then each level one reduce-scatter and
    one split all-gather, equal to comm_stats; the depthwise and the
    leaf-wise grower each from its own plan."""
    for name, levels in (("group_feature", 6),
                         ("group_leafwise_feature", 5)):
        arm = _arm(audit_report, name)
        c, comm = arm.census, arm.comm
        assert c.collectives["reduce_scatter_"] == levels \
            == comm["reduce_scatter_calls_per_iter"], name
        assert c.collectives["allgather_"] == levels \
            == comm["all_gather_calls_per_iter"], name
        assert c.collectives["allreduce_"] == 1 + c.group_calls["shift"], \
            name
    fused = _arm(audit_report, "group_fused").census
    assert set(fused.collectives) == {"allreduce_"}


def test_wired_kernels_present_and_u8(audit_report):
    """The wired arms run the layout kernels (the gates admitted): one K1
    per level plus the root, one K2 per level, on uint8 128-byte
    records."""
    for name in ("levelwise_wired", "leafwise_wired", "goss_iteration",
                 "group_leafwise_feature"):
        c = _arm(audit_report, name).census
        assert c.kernels["hist_tiles"] == c.kernels["permute_records"] + 1
        for kname in ("hist_tiles", "permute_records"):
            for sig in c.kernel_sigs[kname]:
                assert sig.startswith("(uint8(") and ", 128)," in sig, sig
    c = _arm(audit_report, "levelwise_wired").census
    assert (c.kernels["hist_tiles"], c.kernels["permute_records"]) == (7, 6)


def test_digests_match_committed_goldens(audit_report):
    assert audit_report.drift_ok, audit_report.drift


# ---------------------------------------------------------------------------
# census machinery: counting, the kernel boundary, the mutation direction


def test_census_seeded_extra_all_reduce_is_counted(tmp_path):
    """Mutation check: a second collective sneaking into a reduction is
    counted (and so fails the stats and comm_stats checks)."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        def one(x):
            dist.all_reduce(x)
            return x

        def two(x):
            dist.all_reduce(x)
            dist.all_reduce(x)
            return x

        for fn, n in ((one, 1), (two, 2)):
            _, c = ce.census_call(fn, torch.ones(4), on="cpu",
                                  row_threshold=2)
            assert c.collectives["allreduce_"] == n
    finally:
        dist.destroy_process_group()


def test_census_splits_row_vs_slot_sorts():
    def f(gains, rows):
        return torch.argsort(gains, stable=True), torch.sort(rows).values

    _, c = ce.census_call(f, torch.rand(31), torch.rand(4096), on="cpu",
                          row_threshold=512)
    assert (c.row_sorts, c.slot_sorts) == (1, 1)
    _, c = ce.census_call(lambda g: torch.topk(g, 3), torch.rand(31),
                          on="cpu", row_threshold=512)
    assert (c.row_sorts, c.slot_sorts) == (0, 1)
    _, c = ce.census_call(lambda r: torch.unique(r, sorted=False),
                          torch.arange(4096), on="cpu", row_threshold=512)
    assert c.row_sorts == 0


def _layout_pass(n_tiles=4, F=4, B=16):
    from dryad_tpu_torch.engine import hist

    rng = np.random.default_rng(3)
    rec = np.zeros((n_tiles * hist.TILE_ROWS, 128), np.uint8)
    rec[:, 9:9 + F] = rng.integers(0, B, (len(rec), F))
    rec[:, 8] = 1
    rec[:, 0:4] = np.ones((len(rec), 1), np.float32).view(np.uint8)
    rec[:, 4:8] = np.ones((len(rec), 1), np.float32).view(np.uint8)
    src = torch.arange(n_tiles)
    ones = torch.ones(len(rec))
    shift = hist.fixed_point_shift(ones, ones, len(rec))
    return (torch.from_numpy(rec), src, torch.zeros_like(src), 1, B, F, 1,
            shift)


def test_kernel_boundary_hides_the_plain_versions_ops():
    """On the CPU a wrapper runs its plain version; the census records one
    kernel event and none of the plain version's ops."""
    from dryad_tpu_torch.engine import hist

    args = _layout_pass()
    out, c = ce.census_call(hist.hist_tiles, *args, on="cpu",
                            row_threshold=512)
    assert c.kernels == {"hist_tiles": 1}
    assert c.stream == ["kernel:hist_tiles"]
    assert c.row_sorts == c.row_gathers == c.table_gathers == 0
    plain, cp = ce.census_call(hist.hist_tiles_plain, *args[:7], args[7],
                               on="cpu", row_threshold=512)
    assert len(cp.stream) > 10 and not cp.kernels
    assert torch.equal(out, plain)


def test_kernel_boundary_is_a_noop_without_a_census():
    from dryad_tpu_torch.engine import cuda_build, hist

    assert cuda_build.census_hook is None
    args = _layout_pass()
    assert torch.equal(hist.hist_tiles(*args),
                       hist.hist_tiles_plain(*args[:7], args[7]))


# ---------------------------------------------------------------------------
# digests


def test_digest_stable_across_reruns():
    a = ce.run_arm("packed_predict").census.digest
    b = ce.run_arm("packed_predict").census.digest
    assert a == b


def test_digest_moves_when_program_changes_not_with_rows():
    def d(fn, n=128, dtype=torch.float32):
        return ce.census_call(fn, torch.ones(n, dtype=dtype), on="cpu",
                              row_threshold=2)[1].digest

    f = lambda x: torch.cumsum(x * 2, 0)        # noqa: E731
    g = lambda x: torch.cumsum(x + x, 0)        # noqa: E731 (op change)
    assert d(f) != d(g)
    assert d(f) != d(f, dtype=torch.float64)    # dtype change
    assert d(f) == d(f, n=4096)                 # rows are not program


def test_goldens_corruption_is_reported(tmp_path):
    """A stale or foreign golden must surface as drift (exit 4 in the
    CLI), never silently pass."""
    gpath = str(tmp_path / "census.json")
    data = json.loads(json.dumps(load_goldens()))
    data["arms"]["sharded_predict"]["digest"] = "not-the-digest"
    save_goldens(data, gpath)
    rep = ce.run_census(arm_names=["sharded_predict"], goldens_path=gpath)
    assert rep.ok and not rep.drift_ok
    assert "digest" in rep.drift[0]


def test_update_goldens_roundtrip(tmp_path):
    gpath = str(tmp_path / "census.json")
    ce.run_census(arm_names=["sharded_predict"], goldens_path=gpath,
                  update_goldens=True)
    rep = ce.run_census(arm_names=["sharded_predict"], goldens_path=gpath)
    assert rep.ok and rep.drift_ok


def test_update_goldens_subset_merges_not_clobbers(tmp_path):
    gpath = str(tmp_path / "census.json")
    ce.run_census(arm_names=["sharded_predict"], goldens_path=gpath,
                  update_goldens=True)
    ce.run_census(arm_names=["renewal_iteration"], goldens_path=gpath,
                  update_goldens=True)
    arms = load_goldens(gpath)["arms"]
    assert set(arms) == {"sharded_predict", "renewal_iteration"}
    rep = ce.run_census(arm_names=["sharded_predict", "renewal_iteration"],
                        goldens_path=gpath)
    assert rep.ok and rep.drift_ok


def test_torch_version_change_reported_as_rebaseline(tmp_path):
    gpath = str(tmp_path / "census.json")
    data = json.loads(json.dumps(load_goldens()))
    data["torch_version"] = "0.0.1"
    save_goldens(data, gpath)
    rep = ce.run_census(arm_names=["sharded_predict"], goldens_path=gpath)
    assert not rep.drift_ok
    assert "re-baseline" in rep.drift[0]


def test_update_goldens_refuses_on_invariant_failure(tmp_path, monkeypatch):
    real = ce.run_arm

    def broken(name, device="cpu"):
        rep = real(name, device)
        rep.failures.append("seeded failure")
        return rep

    monkeypatch.setattr(ce, "run_arm", broken)
    gpath = str(tmp_path / "census.json")
    rep = ce.run_census(arm_names=["sharded_predict"], goldens_path=gpath,
                        update_goldens=True)
    assert not rep.ok
    assert not os.path.exists(gpath)
    assert any("refusing" in d for d in rep.drift)


# ---------------------------------------------------------------------------
# the arms are the programs they name; the CLI's exit codes


def test_wired_arm_gates_really_admit():
    """If an arm's config stopped passing the layout gates, the 'wired' arm
    would quietly run the plan arm and its zero-sort check would pin
    nothing."""
    from dryad_tpu_torch.config import make_params
    from dryad_tpu_torch.engine.leafwise_fast import leafwise_layout_supported
    from dryad_tpu_torch.engine.levelwise import deep_layout_supported

    F, B = ce.N_FEATURES, ce.N_BINS
    p = make_params(ce.ARMS["levelwise_wired"][1]).validate()
    assert deep_layout_supported(p, F, B, 1)
    pl = make_params(ce.ARMS["leafwise_wired"][1]).validate()
    assert leafwise_layout_supported(pl, F, B, 1)
    legacy = make_params(ce.ARMS["levelwise_legacy"][1]).validate()
    assert not deep_layout_supported(legacy, F, B, 1)


def test_single_arm_smoke():
    rep = ce.run_arm("sharded_predict")
    assert rep.ok and rep.census.digest
    assert set(ce.ARMS) >= {"levelwise_wired", "levelwise_legacy",
                            "leafwise_wired", "group_fused", "group_feature",
                            "group_leafwise_feature",
                            "goss_iteration", "group_goss",
                            "renewal_iteration", "group_renewal",
                            "sharded_predict", "packed_predict"}


def test_cli_audit_exit_codes(tmp_path, monkeypatch):
    from dryad_tpu_torch.analysis.__main__ import main

    gpath = str(tmp_path / "census.json")
    assert main(["--update-goldens", "-q", "--arm", "sharded_predict",
                 "--goldens", gpath]) == 0
    assert main(["--audit", "-q", "--arm", "sharded_predict",
                 "--goldens", gpath]) == 0
    data = load_goldens(gpath)
    data["arms"]["sharded_predict"]["row_gathers"] += 1
    save_goldens(data, gpath)
    assert main(["--audit", "-q", "--arm", "sharded_predict",
                 "--goldens", gpath]) == 4
    real = ce.run_arm

    def broken(name, device="cpu"):
        rep = real(name, device)
        rep.failures.append("seeded failure")
        return rep

    monkeypatch.setattr(ce, "run_arm", broken)
    assert main(["--audit", "-q", "--arm", "sharded_predict",
                 "--goldens", gpath]) == 3

    def crash(name, device="cpu"):
        raise RuntimeError("arm crashed")

    monkeypatch.setattr(ce, "run_arm", crash)
    assert main(["--audit", "-q", "--arm", "sharded_predict",
                 "--goldens", gpath]) == 5
