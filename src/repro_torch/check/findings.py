"""Findings, the rule registry, and the waiver escape hatch: the port's copy
of ``repro.check.findings``.

Every analyzer in :mod:`repro_torch.check` reports through this module: a
:class:`Finding` carries ``file:line``, a rule id from :data:`RULES`, and a
human message.  A finding can be *waived* in source with a comment on the
flagged line (or the line directly above it), in ``repro``'s syntax::

    x = t.item()  # repro-check: waive[BND003] one sync per tick by design

The reason text is mandatory: an empty reason does not waive.  ``--strict``
fails on any finding that is not waived.

Rule ids and slugs are ``repro``'s where the contract is the same.  Rules
whose subject the port does not have yet are not registered (ROADMAP queue
1, item 14): TEL001 (telemetry, item 10) and BND005 (torch has no
``donate_argnums``, so the port has no donating call).
"""
from __future__ import annotations

import re
from dataclasses import asdict, dataclass
from typing import Iterable, Optional


@dataclass(frozen=True)
class Rule:
    """One checked invariant: id, short slug, why it exists, which analyzer
    enforces it."""
    id: str
    slug: str
    rationale: str
    analyzer: str


RULES: dict[str, Rule] = {}


def _rule(id: str, slug: str, rationale: str, analyzer: str) -> None:
    RULES[id] = Rule(id, slug, rationale, analyzer)


# -- CUDA grid-race classifier (check/grid_race.py) -------------------------
_rule("PAL001", "racy-kernel-grid",
      "two blocks of one CUDA launch store to the same output element: "
      "blocks run in parallel and in no order, so the stores race (a "
      "read-modify-write loses updates)",
      "grid_race")
_rule("PAL002", "unregistered-kernel",
      "a CudaKernel(...) or .launch( under src/repro_torch/kernels/ has no "
      "registered grid_race case, so no race verdict covers its launches",
      "grid_race")
_rule("PAL003", "hand-rolled-dispatch",
      "a probe of the machine (torch.cuda.is_available / device_count) "
      "inside src/repro_torch/kernels/: a wrapper follows its tensor's "
      "device, the plain version on the CPU and the kernel or an error on "
      "the card, never a silent fallback",
      "grid_race")
_rule("PAL004", "degenerate-probe",
      "a registered case launches fewer than 2 blocks along some grid "
      "axis, so the race analysis is blind to aliasing on that axis",
      "grid_race")

# -- host/device boundary lint (check/boundary.py) --------------------------
_rule("BND001", "host-call-on-tracer",
      "np.* applied to a device tensor inside a device-loop function: the "
      "call copies the tensor to the host and waits for the card",
      "boundary")
_rule("BND002", "python-branch-on-tracer",
      "a Python if/while/for/assert predicate depends on a device tensor: "
      "the branch reads the value on the host and waits for the card",
      "boundary")
_rule("BND003", "host-scalar-pull",
      ".item()/.tolist()/.cpu()/.numpy()/float()/int()/bool() on a device "
      "tensor forces a host sync inside the device loop",
      "boundary")
_rule("BND004", "f64-on-device",
      "torch.float64 or .double() in device-loop code: the device side is "
      "f32 by contract (DESIGN.md §3), and f64 runs at a fraction of the "
      "f32 rate on the card",
      "boundary")

# -- planner dual of the boundary lint --------------------------------------
_rule("PLN001", "planner-imports-engine",
      "the f64 dry-run planner imports engine/kernel internals or torch: "
      "planners must stay pure host numpy so they can replay without "
      "device state (DESIGN.md §3)",
      "boundary")
_rule("PLN002", "planner-precision-drop",
      "f32 cast or torch usage inside the f64 host planner: timelines are "
      "exact only because every planner op stays f64 numpy (DESIGN.md §3)",
      "boundary")
_rule("PLN003", "plan-shape-instability",
      "planner output arrays change shape across seeds: fixed-shape plan "
      "tables are the declared prerequisite for the multi-world engine "
      "(ROADMAP)",
      "plan_shapes")

# -- fault-injection discipline (boundary lint + plan probes) ---------------
_rule("FLT001", "fault-planner-discipline",
      "fault tables must be sampled in the host f64 planner only — no "
      "engine/kernel/torch imports and no f32 inside repro_torch.faults "
      "(duals of PLN001/PLN002), fault-table shapes stable across seeds "
      "(the PLN003 extension), and every faults-off spelling resolving to "
      "None so a faults-off plan carries no fault state (DESIGN.md §16)",
      "boundary+plan_shapes")

# -- dtype-flow checker (check/dtype_flow.py) -------------------------------
_rule("DTF001", "bf16-dot",
      "a matrix product or convolution consumes bf16: all accumulation "
      "stays f32; bf16 is a storage format for ring/upload rows only "
      "(DESIGN.md §12)",
      "dtype_flow")
_rule("DTF002", "bf16-arithmetic",
      "a non-storage op touches bf16: arithmetic must convert to f32 "
      "first; bf16 may only move (copy, view, index, concatenate, "
      "convert), never accumulate (DESIGN.md §12)",
      "dtype_flow")
_rule("DTF003", "unexpected-bf16",
      "bf16 appears in a run whose ring dtype is f32: the quantized "
      "storage path leaked into the exact path",
      "dtype_flow")


@dataclass
class Finding:
    """One analyzer hit.  ``path`` is repo-relative where possible; probe
    findings use a ``<probe:name>`` pseudo-path with line 0."""
    rule: str
    path: str
    line: int
    message: str
    waived: bool = False
    waive_reason: Optional[str] = None

    def format(self) -> str:
        mark = f"  [waived: {self.waive_reason}]" if self.waived else ""
        return (f"{self.path}:{self.line}: {self.rule} "
                f"({RULES[self.rule].slug}) {self.message}{mark}")

    def to_json(self) -> dict:
        d = asdict(self)
        d["slug"] = RULES[self.rule].slug
        return d


# -- waivers ----------------------------------------------------------------
_WAIVE_RE = re.compile(
    r"#\s*repro-check:\s*waive\[([A-Za-z0-9_,\s]+)\]\s*(.*\S)")


def load_waivers(source: str) -> dict[int, tuple[set[str], str]]:
    """Map 1-based line number -> (rule ids, reason) for every waiver
    comment in ``source``.  A waiver with no reason text is ignored."""
    out: dict[int, tuple[set[str], str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _WAIVE_RE.search(line)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out[i] = (rules, m.group(2).strip())
    return out


def apply_waivers(findings: Iterable[Finding],
                  sources: dict[str, str]) -> list[Finding]:
    """Mark findings waived when the flagged line (or the line above it)
    carries a matching waiver comment.  ``sources`` maps path -> text."""
    cache: dict[str, dict[int, tuple[set[str], str]]] = {}
    out = []
    for f in findings:
        src = sources.get(f.path)
        if src is not None:
            if f.path not in cache:
                cache[f.path] = load_waivers(src)
            waivers = cache[f.path]
            for ln in (f.line, f.line - 1):
                hit = waivers.get(ln)
                if hit and f.rule in hit[0]:
                    f.waived = True
                    f.waive_reason = hit[1]
                    break
        out.append(f)
    return out
