"""The port's CUDA grid-race classifier (``repro_torch.check.grid_race``)
against ``repro``'s Pallas one (``repro.check.pallas_race``): the racy
fixture F1 classifies the same on both, every production kernel of the port
is parallel-safe at its case and at its main-path shapes, and the PAL rules
fire where they should."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.check.fixtures import racy_kernel as jracy
from repro.check.pallas_race import analyze_callable as janalyze
from repro.check.pallas_race import get_report as jget_report
from repro_torch.check import grid_race
from repro_torch.check.corpus import racy_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.geometry import LaunchGeometry, Output
from repro_torch.kernels.weighted_agg import ops as wa_ops

F1_CASE = grid_race.Case(
    "repro_torch/check/corpus/racy_kernel.py", "racy_sum", "racy_sum",
    racy_kernel.geometry, racy_kernel.cu_grids, (8, 2, 2))

# the port's kernel id -> repro's, for the side-by-side verdicts
REPRO_IDS = {
    "weighted_agg.weighted_agg": "weighted_agg.weighted_agg_2d",
    "weighted_agg.ring_agg": "weighted_agg.ring_agg_2d",
    "cross_entropy.nll_and_lse": "cross_entropy.cross_entropy_tiled",
    "decode_attention.decode_attention":
        "decode_attention.decode_attention_bkv",
    "swa_attention.swa_attention": "swa_attention.swa_attention_bhsd",
}


def test_racy_fixture_classifies_as_repro_does():
    mine = grid_race.analyze_callable("fixtures.racy_sum", "racy_sum",
                                      racy_kernel.invoke)
    ref = janalyze("fixtures.racy_sum", "racy_sum", jracy.invoke)
    assert (mine.classification, mine.grid, mine.revisit_axes) == (
        ref.classification, ref.grid, ref.revisit_axes) == (
        "racy", (4, 2), (0,))
    assert mine.compiled_legal == {"gpu": False}


def test_racy_fixture_one_row_tile_is_parallel_safe_on_both():
    mine = grid_race.analyze_launches(
        "f1", "racy_sum", racy_kernel.geometry(2, 2, block_rows=2))
    ref = janalyze("f1", "racy_sum", lambda: jracy.racy_sum(
        jnp.ones((2, 2), jnp.float32), block_rows=2))
    assert (mine.classification, mine.grid, mine.revisit_axes) == (
        ref.classification, ref.grid, ref.revisit_axes) == (
        "parallel-safe", (1, 2), ())


@pytest.mark.parametrize("R, U, br", [(8, 2, 2), (64, 3, 8), (12, 1, 12),
                                      (8192, 2, 2)])
def test_racy_sum_plain_version_is_column_sums(R, U, br):
    """The defined value (zeroed output, no lost update) is numpy's column
    sums; repro's values are not compared: its interpreter leaves the
    uninitialised output NaN."""
    x = np.random.default_rng(R + U).integers(-50, 50, (R, U)).astype(
        np.float32)
    got = racy_kernel.racy_sum(torch.from_numpy(x), block_rows=br)
    np.testing.assert_array_equal(got.numpy(), x.sum(0))


def test_racy_sum_rejects_bad_inputs():
    with pytest.raises(ValueError, match="multiple"):
        racy_kernel.racy_sum(torch.zeros(7, 2), block_rows=2)
    with pytest.raises(ValueError, match="f32"):
        racy_kernel.racy_sum(torch.zeros(8, 2, dtype=torch.float64))


@pytest.mark.parametrize("kernel_id", list(grid_race.KERNEL_CASES))
def test_production_case_is_parallel_safe(kernel_id):
    rep = grid_race.get_report(kernel_id)
    assert rep.classification == "parallel-safe", rep
    assert rep.revisit_axes == () and rep.compiled_legal == {"gpu": True}
    assert all(n >= 2 for n in rep.grid), rep


@pytest.mark.parametrize("kernel_id", list(grid_race.KERNEL_CASES))
def test_production_kernel_parallel_safe_at_main_path_shapes(kernel_id):
    case = grid_race.KERNEL_CASES[kernel_id]
    for label, args in grid_race.main_path_shapes()[kernel_id]:
        rep = grid_race.analyze_launches(kernel_id, case.fn_name,
                                         case.launches(*args))
        assert rep.classification == "parallel-safe", (label, rep)


@pytest.mark.parametrize("kernel_id", list(grid_race.KERNEL_CASES))
def test_case_outputs_are_written_whole(kernel_id):
    """Every element of every output is stored by some block: what the
    card check reads back from NaN-filled outputs."""
    for geo in grid_race.KERNEL_CASES[kernel_id].launches():
        for name in geo.outputs:
            assert geo.written(name).all(), (geo.kernel, name)


def _declared_once(launches) -> int:
    """Asserts that the launches of one call declare every element of each
    output to exactly one block (their sorted ranges tile it); returns the
    outputs' total size."""
    total = 0
    outputs = {name: out for geo in launches
               for name, out in geo.outputs.items()}
    for name, out in outputs.items():
        size = out.size
        spans = sorted((a, b) for geo in launches if name in geo.outputs
                       for blk in geo.blocks()
                       for a, b in geo.outputs[name].ranges(blk) if b > a)
        assert spans[0][0] == 0 and spans[-1][1] == size, name
        assert all(p[1] == q[0] for p, q in zip(spans, spans[1:])), name
        total += size
    return total


@pytest.mark.parametrize("label, kernel_id, args", [
    ("K2 paper CNN f32", "weighted_agg.weighted_agg",
     (grid_race.CNN_SIZES, torch.float32)),
    ("K2 paper CNN bf16", "weighted_agg.weighted_agg",
     (grid_race.CNN_SIZES, torch.bfloat16)),
    ("K2 ragged and empty leaves", "weighted_agg.weighted_agg",
     ((1, 0, 77, 4097, 0, 12345, 8), torch.bfloat16)),
    ("K2 smollm-360m 290 leaves", "weighted_agg.weighted_agg",
     (grid_race.smollm_leaf_sizes(), torch.float32)),
    ("K5 bf16 S 1024 G 3", "swa_attention.swa_attention_bf16",
     (1, 1024, 15, 5, 64, torch.bfloat16)),
    ("K5 bf16 S 1024 G 1", "swa_attention.swa_attention_bf16",
     (1, 1024, 5, 5, 64, torch.bfloat16)),
    ("K5 bf16 S 100 G 3", "swa_attention.swa_attention_bf16",
     (2, 100, 6, 2, 128, torch.bfloat16)),
    ("K5 bf16 S 100 G 1", "swa_attention.swa_attention_bf16",
     (2, 100, 2, 2, 64, torch.bfloat16)),
    ("K1 paper CNN f32", "weighted_agg.ring_agg",
     (422016, 10, torch.float32)),
    ("K1 paper CNN bf16", "weighted_agg.ring_agg",
     (422016, 10, torch.bfloat16)),
    ("K1 packs the grid does not divide", "weighted_agg.ring_agg",
     (128 * 1031, 3, torch.float32)),
    ("K1 fewer packs than blocks", "weighted_agg.ring_agg",
     (128, 1, torch.bfloat16)),
    ("K4 serve B 8 S 2048", "decode_attention.decode_attention",
     (8, 2048, 15, 5, 64)),
    ("K4 decode_32k", "decode_attention.decode_attention",
     (128, 32768, 15, 5, 64)),
    ("K4 one chunk", "decode_attention.decode_attention",
     (1024, 4096, 15, 5, 64)),
    ("K4 G 8 hd 128", "decode_attention.decode_attention",
     (2, 100, 16, 2, 128)),
    ("K4 G 1 hd 128 qwen1.5-4b slots", "decode_attention.decode_attention",
     (8, 2048, 20, 20, 128)),
    ("K4 G 2 hd 128 internvl2-2b", "decode_attention.decode_attention",
     (4, 800, 16, 8, 128)),
    ("K4 G 4 hd 128 swa ring W 4096", "decode_attention.decode_attention",
     (2, 4096, 32, 8, 128)),
    ("K5 bf16 window 4096 < S 8192", "swa_attention.swa_attention_bf16",
     (2, 8192, 32, 8, 128, torch.bfloat16)),
    ("K5 bf16 chunk reshape B 2 x 2", "swa_attention.swa_attention_bf16",
     (4, 4096, 32, 8, 128, torch.bfloat16)),
    ("K5 bf16 chunk reshape 3 chunks of 64",
     "swa_attention.swa_attention_bf16", (3, 64, 4, 2, 128, torch.bfloat16)),
])
def test_every_output_element_declared_by_exactly_one_block(label,
                                                            kernel_id, args):
    case = grid_race.KERNEL_CASES[kernel_id]
    launches = case.launches(*args)
    rep = grid_race.analyze_launches(kernel_id, case.fn_name, launches)
    assert rep.classification == "parallel-safe", (label, rep)
    size = _declared_once(launches)
    if kernel_id == "weighted_agg.weighted_agg":
        sizes, dt = args
        assert len(launches) == wa_ops.launches(sum(1 for n in sizes if n))
        assert size == wa_ops.flat_layout(sizes, dt)[1]
    elif kernel_id == "weighted_agg.ring_agg":
        P, _, _ = args
        (geo,) = launches
        assert size == P and geo.grid[0] % wa_ops.SMS == 0
    elif kernel_id == "decode_attention.decode_attention":
        # one partial-state slot per chunk block, one head range per
        # combine block (or per chunk block when there is one chunk)
        B, S, H, Kv, hd = args
        n = da_ops.split(B, S, Kv)
        if n == 1:
            assert [g.grid for g in launches] == [(B * Kv, 1)]
            assert size == B * H * hd
        else:
            assert [g.grid for g in launches] == [(B * Kv, n), (B * Kv,)]
            assert size == B * H * hd + da_ops.part_size(B, H, hd, n)
    else:
        B, S, H, Kv, hd, _ = args
        assert size == B * S * H * hd
        assert launches[0].grid == (-(-S * (H // Kv) // 64), Kv, B)


def test_smollm_leaf_list_is_the_training_merge():
    sizes = grid_race.smollm_leaf_sizes()
    assert len(sizes) == 290 and sum(sizes) == 361_821_120
    assert [g.grid for g in wa_ops.geometry(sizes, torch.float32)] == [
        (40347,), (29424,), (18614,)]


@pytest.mark.parametrize("kernel_id", list(REPRO_IDS))
def test_port_drops_repro_grid_carries(kernel_id):
    """repro's TPU kernels carry state across sequential grid steps (legal
    on a TPU only); every port kernel is parallel-safe, legal on the card."""
    ref = jget_report(REPRO_IDS[kernel_id])
    assert ref.classification in ("parallel-safe",
                                  "sequential-axis-required")
    assert grid_race.get_report(kernel_id).compiled_legal["gpu"]


def test_two_blocks_on_one_range_is_racy():
    def ranges(block):
        return [(4 * block[0], 4 * block[0] + 4)] if block[0] < 2 else \
            [(2, 6)]
    geo = LaunchGeometry("k", (3, 2), 32, {"out": Output(8, ranges)})
    rep = grid_race.analyze_launches("k", "k", [geo])
    # blocks (x, y) and (x, y') store the same range too: both axes
    assert rep.classification == "racy" and rep.revisit_axes == (0, 1)
    safe = LaunchGeometry("k", (2,), 32, {"out": Output(
        8, lambda b: [(4 * b[0], 4 * b[0] + 4)])})
    assert grid_race.classify_launch(safe) == ("parallel-safe", ())


def test_racy_launch_folds_worst_over_a_call():
    safe = LaunchGeometry("a", (2,), 32, {"out": Output(
        2, lambda b: [(b[0], b[0] + 1)])})
    rep = grid_race.analyze_launches("k", "k", [safe] + racy_kernel.invoke())
    assert rep.classification == "racy" and rep.grid == (4, 2)


def test_store_outside_output_raises():
    geo = LaunchGeometry("k", (2,), 32, {"out": Output(
        4, lambda b: [(0, 8)])})
    with pytest.raises(ValueError, match="outside"):
        grid_race.classify_launch(geo)


def _kernel_file(tmp_path, body):
    f = tmp_path / "src/repro_torch/kernels/extra/ops.py"
    f.parent.mkdir(parents=True)
    f.write_text(body)
    return f


def test_pal001_and_pal004_on_registered_cases():
    _, findings = grid_race.scan([], cases={"f1": F1_CASE})
    assert [f.rule for f in findings] == ["PAL001"]
    one_tile = dataclasses.replace(F1_CASE, args=(2, 2, 2))
    _, findings = grid_race.scan([], cases={"f1": one_tile})
    assert [f.rule for f in findings] == ["PAL004"]
    assert "axis 0" in findings[0].message


def test_pal002_on_unregistered_kernel_and_launch(tmp_path):
    f = _kernel_file(tmp_path, (
        "from repro_torch.kernels.build import CudaKernel\n"
        "KERNEL = CudaKernel('extra', 'extra.cu', {})\n"
        "def extra(x):\n"
        "    KERNEL.launch('extra_f32', x.device)\n"))
    _, findings = grid_race.scan([f])
    assert sorted((x.rule, x.line) for x in findings) == [
        ("PAL002", 2), ("PAL002", 4)]


def test_pal003_on_machine_probe_in_kernels(tmp_path):
    f = _kernel_file(tmp_path, (
        "import torch\n"
        "def pick(x):\n"
        "    return torch.cuda.is_available()\n"))
    _, findings = grid_race.scan([f])
    assert [(x.rule, x.line) for x in findings] == [("PAL003", 3)]
