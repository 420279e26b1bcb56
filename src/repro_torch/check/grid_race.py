"""CUDA grid-race classifier (rules PAL001-PAL004), the counterpart of
``repro.check.pallas_race`` for the port's hand-written CUDA kernels.  The
name differs because the port has no Pallas.

A Pallas kernel can only write the output block its ``BlockSpec`` index map
names; a CUDA block can store anywhere.  So each kernel declares what its
launches store: ``kernels/*/ops.py:geometry(...)`` returns one
:class:`~repro_torch.kernels.geometry.LaunchGeometry` per launch of a
wrapper call (the grid, and for each output the element ranges each block
stores to), transcribed from its ``.cu``'s host launch code, whose grid the
``.cu``'s ``<name>_geometry`` export gives back on the card
(``chip_smoke.py`` holds the two together and launches each kernel into
NaN-filled outputs to see the ranges are what it writes).

A registered *case* calls ``geometry(...)`` at tiny representative shapes
with at least two blocks on every grid axis, so no card and no ``nvcc`` are
needed.  The classifier enumerates the blocks and checks, on ranges rather
than element sets (a main-path shape stays cheap), which blocks store to
each element:

- ``parallel-safe``: every element is stored by at most one block.
- ``racy``: some element is stored by two blocks of one launch.  CUDA
  blocks of one launch have no order, so ``repro``'s
  ``sequential-axis-required`` (a revisit by consecutive grid steps, legal
  on a TPU) cannot arise inside a launch; the three-valued classification
  and ``revisit_axes`` (the grid axes along which the colliding blocks
  differ) are kept so that the report reads like ``repro``'s.

The launches of one call (K4 runs a chunk kernel, then a combine kernel)
are ordered by the stream, so each is classified alone and the call folds
to the worst.  There is no ``dispatch.py``: a wrapper raises on the wrong
card, and a tier-1 test pins every production kernel to ``parallel-safe``.
"""
from __future__ import annotations

import ast
import functools
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import torch

from repro_torch.check.findings import Finding
from repro_torch.kernels.cross_entropy import ops as ce_ops
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.swa_attention import ops as sa_ops
from repro_torch.kernels.weighted_agg import ops as wa_ops
from repro_torch.models.cnn import CNN_SHAPES

CLASSIFICATIONS = ("parallel-safe", "sequential-axis-required", "racy")


@dataclass(frozen=True)
class KernelReport:
    """Race verdict for one kernel: the grid of its worst launch, the
    classification, and whether the compiled kernel may run on the card
    (``compiled_legal["gpu"]``, only when parallel-safe)."""
    kernel_id: str
    fn_name: str
    grid: tuple
    classification: str
    revisit_axes: tuple
    compiled_legal: dict = field(hash=False)

    def to_json(self) -> dict:
        return {
            "kernel_id": self.kernel_id,
            "fn_name": self.fn_name,
            "grid": list(self.grid),
            "classification": self.classification,
            "revisit_axes": list(self.revisit_axes),
            "compiled_legal": dict(self.compiled_legal),
        }


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------
def _collide(cluster: list, axes: set) -> bool:
    """Whether two blocks store to a common element within ``cluster``
    (spans ``(start, stop, block)`` sorted by start); adds the grid axes
    along which such blocks differ to ``axes``."""
    if len({blk for _, _, blk in cluster}) < 2:
        return False
    hit = False
    for j, (_, stop, p) in enumerate(cluster):
        for start2, _, q in cluster[j + 1:]:
            if start2 >= stop:
                break
            if p != q:
                hit = True
                axes.update(ax for ax in range(len(p)) if p[ax] != q[ax])
    return hit


def classify_launch(geo) -> tuple[str, tuple]:
    """(classification, revisit_axes) for one launch."""
    racy, axes = False, set()
    for name, out in geo.outputs.items():
        spans = []
        for blk in geo.blocks():
            for a, b in out.ranges(blk):
                if not 0 <= a <= b <= out.size:
                    raise ValueError(
                        f"{geo.kernel}: block {blk} declares a store to "
                        f"[{a}, {b}) outside {name}[0:{out.size}]")
                if b > a:
                    spans.append((a, b, blk))
        spans.sort(key=lambda s: s[0])
        # clusters of transitively overlapping spans; only spans inside
        # one cluster can share an element
        cluster, end = [], 0
        for s in spans:
            if cluster and s[0] >= end:
                racy |= _collide(cluster, axes)
                cluster = []
            cluster.append(s)
            end = max(end, s[1]) if len(cluster) > 1 else s[1]
        if cluster:
            racy |= _collide(cluster, axes)
    return ("racy" if racy else "parallel-safe"), tuple(sorted(axes))


def analyze_launches(kernel_id: str, fn_name: str,
                     launches: list) -> KernelReport:
    """Classify every launch of one call and fold to the worst."""
    if not launches:
        raise RuntimeError(f"case for {kernel_id} launches no kernel")
    worst, axes, grid = "parallel-safe", (), launches[0].grid
    for geo in launches:
        c, a = classify_launch(geo)
        if CLASSIFICATIONS.index(c) > CLASSIFICATIONS.index(worst):
            worst, axes, grid = c, a, geo.grid
    return KernelReport(kernel_id=kernel_id, fn_name=fn_name,
                        grid=tuple(grid), classification=worst,
                        revisit_axes=axes,
                        compiled_legal={"gpu": worst == "parallel-safe"})


def analyze_callable(kernel_id: str, fn_name: str,
                     invoke: Callable[[], list]) -> KernelReport:
    """Classify the launches ``invoke()`` returns (``repro``'s name for
    the entry point the fixture tests call)."""
    return analyze_launches(kernel_id, fn_name, invoke())


# ---------------------------------------------------------------------------
# the registered corpus: one case per kernel under src/repro_torch/kernels/
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Case:
    """A kernel's wrapper, its declared launch geometry, and the shape
    arguments of its registered case."""
    path: str              # module of the wrapper, by path suffix
    fn_name: str           # the wrapper that launches the kernel
    kernel: str            # its CudaKernel's name
    geometry: Callable     # geometry(*args) -> [LaunchGeometry]
    cu_grids: Callable     # cu_grids(*args) -> the .cu's grids (card only)
    args: tuple            # the case's shape arguments

    def launches(self, *args) -> list:
        return self.geometry(*(args or self.args))

    def grids(self, *args) -> list:
        return self.cu_grids(*(args or self.args))


_WA = "repro_torch/kernels/weighted_agg/ops.py"
_SA = "repro_torch/kernels/swa_attention/ops.py"
# one merge of the paper CNN: its leaves' sizes in order
CNN_SIZES = tuple(math.prod(s) for s in CNN_SHAPES.values())


@functools.lru_cache(maxsize=None)
def smollm_leaf_shapes() -> dict:
    """smollm-360m's 290 parameter leaves, name -> shape, in the order a
    training merge takes them (built on the meta device)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    model = T.Transformer(get_config("smollm-360m"), torch.float32, "meta")
    return {k: tuple(p.shape) for k, p in T.param_dict(model).items()}


def smollm_leaf_sizes() -> tuple:
    """The element counts of :func:`smollm_leaf_shapes`, in order."""
    return tuple(math.prod(s) for s in smollm_leaf_shapes().values())


# kernel_id -> Case.  Each case has >= 2 blocks on every grid axis: K2 a
# CNN merge (ragged leaves, one of 98 blocks), K1 runs of 2 and 3 packs
# (288 over 132 blocks), K4 four chunks (so both launches run), K5 a
# ragged last query tile (f32) or row tile (bf16, G 3).
KERNEL_CASES: dict[str, Case] = {
    "weighted_agg.weighted_agg": Case(
        _WA, "weighted_agg_tree", "weighted_agg", wa_ops.geometry,
        wa_ops.cu_grids, (CNN_SIZES, torch.float32)),
    "weighted_agg.ring_agg": Case(
        _WA, "ring_agg", "ring_agg", wa_ops.ring_geometry,
        wa_ops.ring_cu_grids, (1152, 2, torch.float32)),
    "weighted_agg.ring_agg_worlds": Case(
        _WA, "ring_agg", "ring_agg", wa_ops.ring_geometry,
        wa_ops.ring_cu_grids, (1152, 2, torch.float32, 3)),
    "cross_entropy.nll_and_lse": Case(
        "repro_torch/kernels/cross_entropy/ops.py", "nll_and_lse",
        "cross_entropy", ce_ops.geometry, ce_ops.cu_grids, (4, 64)),
    "decode_attention.decode_attention": Case(
        "repro_torch/kernels/decode_attention/ops.py", "decode_attention",
        "decode_attention", da_ops.geometry, da_ops.cu_grids,
        (2, 256, 2, 1, 64)),
    "swa_attention.swa_attention": Case(
        _SA, "swa_attention", "swa_attention", sa_ops.geometry,
        sa_ops.cu_grids, (2, 100, 2, 1, 64, torch.float32)),
    "swa_attention.swa_attention_bf16": Case(
        _SA, "swa_attention", "swa_attention", sa_ops.geometry,
        sa_ops.cu_grids, (2, 100, 6, 2, 64, torch.bfloat16)),
}


def main_path_shapes() -> dict[str, list[tuple[str, tuple]]]:
    """kernel_id -> [(label, geometry args)] at the shapes the main paths
    launch: K2 at a paper-CNN merge (f32 and bf16), a smollm-360m
    training merge (290 f32 leaves, 3 launches) and the corridor's EMA
    reconcile (one [R, P] leaf, R 4 and 8), K1 at the packed CNN (P
    422,016, U 10), K3 at training's R 512 and ``make_train_step``'s R
    4,096 (V 49,152), K4 at the serve shape and smollm-360m's decode_32k,
    K5 at 512- and 1024-token prefills in f32 and bf16; and the dense
    archs' serving: K4 over mistral-nemo-12b's sliding-window ring (W
    4,096, G 4), qwen1.5-4b's slots (G 1), internvl2-2b's batch (G 2) and
    musicgen-large's slots (G 1, hd 64), K5 at mistral-nemo-12b's windowed
    prefill (S 8,192 > W 4,096) and through the chunk reshape (chunks of
    4,096 as rows of a B * ceil(S / C) batch); and llama4-scout-17b-a16e's
    10,240-token generate (G 5, bf16): K4 over its chunk ring of 8,192 and
    its global layer's full cache of 10,272, K5 through the chunk reshape (2
    chunks of 8,192) and over the global layer's whole prompt."""
    return {
        "weighted_agg.weighted_agg": [
            ("paper CNN f32", (CNN_SIZES, torch.float32)),
            ("paper CNN bf16", (CNN_SIZES, torch.bfloat16)),
            ("smollm-360m 290 leaves f32",
             (smollm_leaf_sizes(), torch.float32)),
            ("corridor [4, P] stack f32", ((4 * 422016,), torch.float32)),
            ("corridor [8, P] stack f32", ((8 * 422016,), torch.float32))],
        "weighted_agg.ring_agg": [
            ("P 422016 U 10 f32", (422016, 10, torch.float32)),
            ("P 422016 U 10 bf16", (422016, 10, torch.bfloat16))],
        "weighted_agg.ring_agg_worlds": [
            ("P 422016 U 10 W 5 f32", (422016, 10, torch.float32, 5)),
            ("P 422016 U 10 W 15 f32", (422016, 10, torch.float32, 15)),
            ("P 422016 U 10 W 15 bf16", (422016, 10, torch.bfloat16, 15))],
        "cross_entropy.nll_and_lse": [
            ("R 512 V 49152", (512, 49152)),
            ("R 4096 V 49152", (4096, 49152))],
        "decode_attention.decode_attention": [
            ("serve B 8 S 2048", (8, 2048, 15, 5, 64)),
            ("decode_32k B 128 S 32768", (128, 32768, 15, 5, 64)),
            ("mistral-nemo-12b ring B 2 W 4096 G 4",
             (2, 4096, 32, 8, 128)),
            ("qwen1.5-4b slots B 8 S 2048 G 1", (8, 2048, 20, 20, 128)),
            ("internvl2-2b B 4 S 800 G 2", (4, 800, 16, 8, 128)),
            ("musicgen-large slots B 8 S 1024 G 1 hd 64",
             (8, 1024, 32, 32, 64)),
            ("llama4-scout-17b-a16e chunk ring B 1 C 8192 G 5",
             (1, 8192, 40, 8, 128)),
            ("llama4-scout-17b-a16e global cache B 1 S 10272 G 5",
             (1, 10272, 40, 8, 128))],
        "swa_attention.swa_attention": [
            ("prefill S 512 f32", (1, 512, 15, 5, 64, torch.float32)),
            ("prefill S 1024 f32", (1, 1024, 15, 5, 64, torch.float32)),
            ("mistral-nemo-12b window 4096 S 4608 f32",
             (1, 4608, 32, 8, 128, torch.float32)),
            ("chunk reshape 2 x 4096 f32",
             (2, 4096, 32, 8, 128, torch.float32))],
        "swa_attention.swa_attention_bf16": [
            ("prefill S 512 bf16", (1, 512, 15, 5, 64, torch.bfloat16)),
            ("prefill S 1024 bf16", (1, 1024, 15, 5, 64, torch.bfloat16)),
            ("mistral-nemo-12b window 4096 B 2 S 8192 bf16",
             (2, 8192, 32, 8, 128, torch.bfloat16)),
            ("chunk reshape B 2 x 2 chunks of 4096 bf16",
             (4, 4096, 32, 8, 128, torch.bfloat16)),
            ("llama4-scout-17b-a16e chunk reshape 2 chunks of 8192 bf16",
             (2, 8192, 40, 8, 128, torch.bfloat16)),
            ("llama4-scout-17b-a16e global prefill S 10240 bf16",
             (1, 10240, 40, 8, 128, torch.bfloat16))],
    }


def get_report(kernel_id: str) -> KernelReport:
    case = KERNEL_CASES[kernel_id]
    return analyze_launches(kernel_id, case.fn_name, case.launches())


# ---------------------------------------------------------------------------
# tree scan: PAL001/PAL004 on the cases, PAL002/PAL003 on kernels/ sources
# ---------------------------------------------------------------------------
def _def_line(path: Path, fn_name: str) -> int:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == fn_name:
            return node.lineno
    return 0


def _enclosing_defs(tree) -> dict:
    """node -> name of the innermost def containing it."""
    owner = {}

    def visit(node, name):
        for child in ast.iter_child_nodes(node):
            inner = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else name)
            owner[child] = name
            visit(child, inner)
    visit(tree, None)
    return owner


def _lint_kernel_file(f: Path, kernels: set, fns: set) -> list[Finding]:
    path = f.as_posix()
    try:
        tree = ast.parse(f.read_text())
    except SyntaxError as e:
        return [Finding("PAL002", path, e.lineno or 0,
                        f"unparseable kernel file: {e.msg}")]
    findings = []
    owner = _enclosing_defs(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)
            if name == "CudaKernel" and node.args:
                arg = node.args[0]
                kname = (arg.value if isinstance(arg, ast.Constant)
                         else None)
                if kname not in kernels:
                    findings.append(Finding(
                        "PAL002", path, node.lineno,
                        f"CudaKernel {kname!r} has no registered case in "
                        "repro_torch.check.grid_race.KERNEL_CASES"))
            elif (isinstance(fn, ast.Attribute) and fn.attr == "launch"
                    and owner.get(node) not in fns):
                findings.append(Finding(
                    "PAL002", path, node.lineno,
                    f"function {owner.get(node)!r} launches a kernel but "
                    "has no registered case in "
                    "repro_torch.check.grid_race.KERNEL_CASES"))
        if (isinstance(node, ast.Attribute)
                and node.attr in ("is_available", "device_count")):
            findings.append(Finding(
                "PAL003", path, node.lineno,
                f"machine probe .{node.attr} in kernels/: a wrapper follows "
                "its tensor's device (plain version on the CPU, the kernel "
                "or an error on the card)"))
    return findings


def scan(files: list[Path], cases: dict = None
         ) -> tuple[list[KernelReport], list[Finding]]:
    """Analyze the registered corpus and lint the kernels/ source tree.
    ``files`` is the full scan set; only paths under
    ``repro_torch/kernels/`` are inspected here."""
    cases = KERNEL_CASES if cases is None else cases
    findings: list[Finding] = []
    kernel_files = [f for f in files
                    if "repro_torch/kernels/" in f.as_posix()]

    reports = []
    for kid, case in cases.items():
        launches = case.launches()
        rep = analyze_launches(kid, case.fn_name, launches)
        reports.append(rep)
        src = next((f for f in kernel_files
                    if f.as_posix().endswith(case.path)), None)
        line = _def_line(src, case.fn_name) if src else 0
        path = src.as_posix() if src else case.path
        if rep.classification == "racy":
            findings.append(Finding(
                "PAL001", path, line,
                f"kernel {kid} is racy on grid {rep.grid}: two blocks of "
                f"one launch store to the same output element (axes "
                f"{rep.revisit_axes})"))
        for geo in launches:
            for ax, extent in enumerate(geo.grid):
                if extent < 2:
                    findings.append(Finding(
                        "PAL004", path, line,
                        f"case for {kid} launches {geo.kernel} with only "
                        f"{extent} block(s) on grid axis {ax}; aliasing "
                        "there is invisible to the race analysis"))

    kernels = {c.kernel for c in cases.values()}
    fns = {c.fn_name for c in cases.values()}
    for f in kernel_files:
        findings.extend(_lint_kernel_file(f, kernels, fns))
    return reports, findings
