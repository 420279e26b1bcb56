"""The port's host/device boundary lint (``repro_torch.check.boundary``)
against ``repro``'s: the leaky fixtures hit the same rules on the same
kinds of lines, both bad planners hit PLN001/PLN002, the port's engine and
device-loop modules lint clean after waivers, seeded host syncs are caught,
and both packages' waivers agree."""
from __future__ import annotations

import textwrap
from pathlib import Path

import pytest

from repro.check import findings as jfindings
from repro.check.boundary import check_file as jcheck_file
from repro.check.boundary import check_source as jcheck_source
from repro_torch.check import config, findings
from repro_torch.check.boundary import check_file, check_source
from repro_torch.check.findings import Finding, apply_waivers, load_waivers

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "src/repro_torch/check/corpus"
JFIXTURES = REPO / "src/repro/check/fixtures"
JIT_ENGINE = "src/repro_torch/core/jit_engine.py"
CORRIDOR_ENGINE = "src/repro_torch/corridor/engine.py"
CORRIDOR_PLAN = "src/repro_torch/corridor/plan.py"


def _rule_lines(fs):
    """Rules in line order, one per (line, rule)."""
    return [r for _, r in sorted({(f.line, f.rule) for f in fs})]


def test_leaky_fixture_hits_repro_rules_minus_bnd005():
    mine = check_file(FIXTURES / "leaky_engine.py")
    ref = [f for f in jcheck_file(JFIXTURES / "leaky_engine.py")
           if f.rule != "BND005"]
    assert _rule_lines(mine) == _rule_lines(ref) == [
        "BND002", "BND003", "BND003", "BND001", "BND004", "BND002",
        "BND003"]
    assert {f.rule for f in mine} == {"BND001", "BND002", "BND003",
                                      "BND004"}
    assert len({f.line for f in mine}) == 7      # one violation per line


def test_bad_planners_hit_pln_rules():
    mine = check_file(FIXTURES / "bad_planner.py")
    ref = jcheck_source("src/repro/corridor/plan.py",
                        (JFIXTURES / "bad_planner.py").read_text())
    # repro's fixture under the port's planner path: jax and repro imports
    # are engine imports to the port's planner too
    cross = check_source(str(FIXTURES / "bad_planner.py"),
                         (JFIXTURES / "bad_planner.py").read_text())
    for fs in (mine, ref, cross):
        assert {f.rule for f in fs} == {"PLN001", "PLN002"}, \
            [f.format() for f in fs]


@pytest.mark.parametrize("suffix", sorted(
    set(config.ENGINE_MODULES) | set(config.DEVICE_LOOP_FUNCTIONS)))
def test_engine_and_loop_modules_lint_clean_after_waivers(suffix):
    path = REPO / "src" / suffix
    fs = apply_waivers(check_file(path),
                       {path.as_posix(): path.read_text()})
    live = [f.format() for f in fs if not f.waived]
    assert not live, live


@pytest.mark.parametrize("inject, rule", [
    ("bad = qt_host.item()", "BND003"),
    ("bad = t.double()", "BND004"),
    ("bad = float(cu)", "BND003"),
    ("bad = np.asarray(cl)", "BND001"),
])
def test_injection_into_slot_queue_pop_is_caught(inject, rule):
    src = (REPO / JIT_ENGINE).read_text()
    anchor = "        i = torch.argmin(self.qt, dim=0, keepdim=True)\n"
    assert anchor in src
    body = (anchor + "        qt_host = self.qt.index_select(0, i)\n"
            + "        t = self.qt.index_select(0, i)\n"
            + "        cu = self.qcu.index_select(0, i)\n"
            + "        cl = self.qcl.index_select(0, i)\n"
            + f"        {inject}\n")
    fs = check_source(JIT_ENGINE, src.replace(anchor, body, 1))
    line = src[:src.index(anchor)].count("\n") + 6
    assert [(f.rule, f.line) for f in fs] == [(rule, line)]


@pytest.mark.parametrize("inject, rule", [
    ("bad = flat.item()", "BND003"),
    ("bad = t.double()", "BND004"),
    ("bad = int(j)", "BND003"),
    ("bad = np.asarray(cl)", "BND001"),
])
def test_injection_into_corridor_pop_is_caught(inject, rule):
    src = (REPO / CORRIDOR_ENGINE).read_text()
    anchor = "        dl_t = self.qdl.index_select(0, i)\n"
    assert anchor in src
    fs = check_source(CORRIDOR_ENGINE,
                      src.replace(anchor, anchor + f"        {inject}\n", 1))
    line = src[:src.index(anchor)].count("\n") + 2
    assert [(f.rule, f.line) for f in fs] == [(rule, line)]


def test_corridor_planner_is_linted_as_a_planner():
    """corridor/plan.py is clean as a planner; a torch import, an engine
    import or an f32 drop in it is PLN001/PLN002."""
    assert config.matches(CORRIDOR_PLAN, config.PLANNER_MODULES)
    src = (REPO / CORRIDOR_PLAN).read_text()
    assert check_source(CORRIDOR_PLAN, src) == []
    anchor = "    corridor = CorridorMobility(p, n_rsus, entry=entry)\n"
    assert anchor in src
    bad = (anchor + "    import torch\n"
           "    from repro_torch.corridor import engine\n"
           "    drop = np.float32(p.v)\n")
    fs = check_source(CORRIDOR_PLAN, src.replace(anchor, bad, 1))
    assert sorted(f.rule for f in fs) == ["PLN001", "PLN001", "PLN002"]


def test_python_typed_flags_and_shape_reads_are_not_tainted():
    src = textwrap.dedent("""
        import torch

        def body(x, n: int, flag: bool, t: torch.Tensor):
            if flag and n > 2:
                x = x * 2
            if x.shape[0] > 4 and x.dim() == 2 and len(x) > 1:
                x = x + 1
            if t.sum() > 0:
                x = x - 1
            return x

        batched = torch.func.vmap(body)
    """)
    assert [(f.rule, f.line) for f in check_source("t.py", src)] == [
        ("BND002", 9)]


def test_helper_called_from_loop_gets_bnd004_only():
    src = textwrap.dedent("""
        import torch

        def helper(x):
            if x.sum() > 0:
                return x.double()
            return x

        def body(x):
            return helper(x)

        g = torch.func.grad(body)
    """)
    assert [(f.rule, f.line) for f in check_source("t.py", src)] == [
        ("BND004", 6)]


def test_plan_fleet_is_linted_as_a_planner():
    src = (REPO / JIT_ENGINE).read_text()
    anchor = ("    tl = _Timeline(p, seed, cl_scale=None if flt is None "
              "else flt.cl_scale)\n")
    assert anchor in src
    bad = (anchor + "    drop = np.float32(p.v)\n    import torch\n"
           "    t = torch.zeros(3)\n")
    fs = check_source(JIT_ENGINE, src.replace(anchor, bad, 1))
    assert sorted(f.rule for f in fs) == ["PLN001", "PLN002", "PLN002"]


def test_waivers_agree_with_repro():
    src = ("x = 1\n"
           "y = 2  # repro-check: waive[BND004] fixture data is f64\n"
           "z = 3\n"
           "w = 4  # repro-check: waive[BND003, BND001] two rules\n"
           "v = 5  # repro-check: waive[BND002]\n")
    spec = [("BND004", 2), ("BND003", 2), ("BND004", 3), ("BND001", 4),
            ("BND003", 5), ("BND002", 5), ("BND002", 6)]
    mine = apply_waivers([Finding(r, "w.py", ln, "m") for r, ln in spec],
                         {"w.py": src})
    ref = jfindings.apply_waivers(
        [jfindings.Finding(r, "w.py", ln, "m") for r, ln in spec],
        {"w.py": src})
    assert [(f.waived, f.waive_reason) for f in mine] == [
        (f.waived, f.waive_reason) for f in ref]
    assert [f.waived for f in mine] == [True, False, True, True, True,
                                        False, False]
    assert load_waivers(src) == jfindings.load_waivers(src)
    assert 5 not in load_waivers(src)         # no reason: no waiver


def test_rule_catalog_keeps_repro_ids_and_slugs():
    for rid, rule in findings.RULES.items():
        assert jfindings.RULES[rid].slug == rule.slug
    assert not {"TEL001", "BND005"} & set(findings.RULES)
    assert "FLT001" in findings.RULES
