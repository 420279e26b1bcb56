"""Tests of the port that need an NVIDIA Hopper card.  They skip without
one; on the card run them with

    python -m pytest -q -m cuda tests/test_torch_card.py

The file imports neither jax nor repro, so it runs where only PyTorch is
installed."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.weighted_agg import ops, ref
from repro_torch.models.cnn import CNN_SHAPES

# mixing (1 - alpha, 1.0) and literal (beta, weight) scalar pairs
SCALARS = [(1.0 - 0.0734125, 1.0), (0.5, 0.8719), (0.3, 1.7)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    return torch.device("cuda", 0)


def _int_view(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain_version_on_card(cuda_device, tdt):
    """The hand kernel against its plain version, bitwise, on the card."""
    kernels.reset_launches()
    shapes = list(CNN_SHAPES.values()) + [(12345,), (77,)]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for shape in shapes:
        for off in (0, 1):                   # aligned and misaligned views
            n = int(np.prod(shape))
            g, l = (torch.randn(n + off, generator=gen, device=cuda_device)
                    .to(tdt)[off:].view(shape) for _ in range(2))
            for beta, weight in SCALARS:
                out = ops.weighted_agg(g, l, beta, weight)
                want = ref.weighted_agg(g, l, beta, weight)
                torch.cuda.synchronize()
                assert torch.equal(_int_view(out), _int_view(want)), (
                    shape, off, beta, weight)
    assert ops.KERNEL.launches == len(shapes) * 2 * len(SCALARS)


@pytest.mark.cuda
def test_kernel_path_runs_or_raises_on_card(cuda_device):
    """On a CUDA tensor the wrapper launches the kernel (counted) and
    rejects a non-contiguous input instead of taking the plain version."""
    kernels.reset_launches()
    g = torch.randn(64, 33, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.weighted_agg(g.t(), g.t(), 0.5, 1.0)
    assert ops.KERNEL.launches == 0
    ops.weighted_agg(g, g, 0.5, 1.0)
    assert kernels.launch_counts() == {
        "weighted_agg": 1, "ring_agg": 0, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 0}


@pytest.mark.cuda
def test_slice_on_card_uses_the_kernel(cuda_device):
    """quick-k5 on the card: 8 launches (one per CNN leaf) per merge."""
    from repro_torch.core.scenarios import run_scenario
    kernels.reset_launches()
    res = run_scenario("quick-k5", rounds=4, use_kernel=True,
                       device=cuda_device)
    assert ops.KERNEL.launches == 8 * len(res.rounds) == 32
    assert all(v.is_cuda for v in res.final_params.values())


# K1 ring_agg: chain lengths the fleet engine gives it and beyond one
# shared-memory coefficient tile; the paper CNN's P and a P ragged against
# any power-of-two tile
RING_U = [0, 1, 2, 7, 9, 10, 30, 60, 1500]
RING_P = [422016, 128 * 300]


def _ring_inputs(P, U, tdt, gen, device, neg_zero):
    g = torch.randn(P, generator=gen, device=device)
    locs = torch.randn(U, P, generator=gen, device=device).to(tdt)
    c = torch.rand(U, generator=gen, device=device) * 0.5 + 0.5
    coeffs = torch.stack([c, 1.0 - c], dim=1).contiguous()
    if neg_zero:
        g[::7] = -0.0
        if U:
            locs[:, ::7] = 0.0
            coeffs[0] = torch.tensor([1.0, 0.0], device=device)
    return g, locs, coeffs


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ring_agg_matches_plain_version_on_card(cuda_device, tdt):
    """K1 against its plain version, bitwise, with one launch per chain
    and none for an empty one."""
    kernels.reset_launches()
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    chains = 0
    for P in RING_P:
        for U in RING_U:
            for neg_zero in (False, True):
                g, locs, coeffs = _ring_inputs(P, U, tdt, gen, cuda_device,
                                               neg_zero)
                out = ops.ring_agg(g, locs, coeffs)
                want = ref.ring_agg(g, locs, coeffs)
                torch.cuda.synchronize()
                assert out.dtype == torch.float32 and out.is_cuda
                assert torch.equal(_int_view(out), _int_view(want)), (
                    P, U, neg_zero)
                assert out.data_ptr() != g.data_ptr()
                chains += U > 0
    assert kernels.launch_counts() == {
        "weighted_agg": 0, "ring_agg": chains, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 0}


@pytest.mark.cuda
def test_ring_agg_wrapper_raises_on_card(cuda_device):
    """Non-contiguous, misshaped or misaligned inputs raise before any
    launch; nothing falls back to the plain version."""
    kernels.reset_launches()
    P, U = 128 * 4, 3
    g = torch.zeros(P, device=cuda_device)
    locs = torch.zeros(U, P, device=cuda_device)
    coeffs = torch.zeros(U, 2, device=cuda_device)
    buf = torch.zeros(P + 1, device=cuda_device)
    for bad in [(g, torch.zeros(P, U, device=cuda_device).t(), coeffs),
                (g, torch.zeros(U, P + 128, device=cuda_device), coeffs),
                (g, locs, torch.zeros(U, 3, device=cuda_device)),
                (g, locs, coeffs.cpu()),
                (buf[1:], locs, coeffs)]:
        with pytest.raises((ValueError, TypeError)):
            ops.ring_agg(*bad)
    assert kernels.launch_counts() == {
        "weighted_agg": 0, "ring_agg": 0, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 0}
    ops.ring_agg(g, locs, coeffs)
    assert kernels.launch_counts() == {
        "weighted_agg": 0, "ring_agg": 1, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 0}


def _expected_chains(name, rounds, eval_every):
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import get_scenario
    sc = get_scenario(name)
    plan = jit_engine.plan_fleet(sc.channel(), 0, rounds)
    need = jit_engine.needed_rounds(
        plan, jit_engine.eval_rounds_of(rounds, eval_every))
    return sum(len(jit_engine.chain_bounds(s, e, need))
               for _, s, e in plan.waves)


@pytest.mark.cuda
@pytest.mark.parametrize("ring_dtype", ["f32", "bf16"])
def test_fleet_engine_on_card_uses_only_ring_agg(cuda_device, ring_dtype):
    from repro_torch.core.scenarios import run_scenario
    kernels.reset_launches()
    res = run_scenario("quick-k5", engine="jit", rounds=6, eval_every=3,
                       use_kernel=True, ring_dtype=ring_dtype,
                       device=cuda_device)
    assert len(res.rounds) == 6
    assert kernels.launch_counts() == {
        "weighted_agg": 0, "ring_agg": _expected_chains("quick-k5", 6, 3),
        "decode_attention": 0, "swa_attention": 0, "cross_entropy": 0}
    assert all(v.is_cuda and bool(torch.isfinite(v).all())
               for v in res.final_params.values())


@pytest.mark.cuda
def test_event_loop_never_waits_for_the_card(cuda_device, monkeypatch):
    """The event loop between waves (pops, chain coefficients, ring_agg
    chains) runs with CUDA synchronisation made an error."""
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import run_scenario
    real = jit_engine._event_segment
    segments = []

    def strict(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        segments.append(out[1][0].numel())
        return out

    # build and load the kernel outside the checked region
    ops.ring_agg(*_ring_inputs(128, 1, torch.float32,
                               torch.Generator(device=cuda_device),
                               cuda_device, False))
    monkeypatch.setattr(jit_engine, "_event_segment", strict)
    res = run_scenario("quick-k5", engine="jit", rounds=8,
                       ring_dtype="bf16", device=cuda_device)
    assert sum(segments) == len(res.rounds) == 8 and len(segments) > 1


# K4 decode_attention and K5 swa_attention against their plain versions:
# f32 inputs from N(0, 1) within 2e-5 (the online softmax sums in another
# order than the dense plain version), bf16 within 3e-2 (the plain version
# rounds scores and weights to bf16, the kernel keeps them in f32)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _attn_max_err(out, want):
    assert out.dtype == want.dtype and out.shape == want.shape
    return (out.float() - want.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 4])
def test_decode_attention_matches_plain_version_on_card(cuda_device, tdt,
                                                        hd, G):
    """K4 at pos = 0, S - 1 and a mixed per-row vector, with the sequence
    split into chunks (small batch) and whole (large batch)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    gen = torch.Generator(device=cuda_device).manual_seed(G * hd)
    kernels.reset_launches()
    calls = 0
    for B, S, Kv in [(2, 1000, 2), (64, 300, 5)]:
        q = torch.randn(B, G * Kv, hd, generator=gen,
                        device=cuda_device).to(tdt)
        k, v = (torch.randn(B, S, Kv, hd, generator=gen,
                            device=cuda_device).to(tdt) for _ in range(2))
        mixed = torch.randint(0, S, (B,), generator=gen, device=cuda_device,
                              dtype=torch.int32)
        for pos in (0, S - 1, mixed):
            out = dops.decode_attention(q, k, v, pos)
            want = dref.decode_attention(q, k, v, pos)
            torch.cuda.synchronize()
            assert _attn_max_err(out, want) <= ATTN_TOL[tdt], (B, S, pos)
            calls += 1
    assert kernels.launch_counts()["decode_attention"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 3])
def test_swa_attention_matches_plain_version_on_card(cuda_device, tdt, G):
    """K5 at window = S, windows under S (one not a multiple of the 64-row
    tile) and S not a multiple of the tile."""
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import ref as sref
    gen = torch.Generator(device=cuda_device).manual_seed(G)
    kernels.reset_launches()
    calls = 0
    for B, S, Kv, hd in [(1, 256, 5, 64), (2, 200, 2, 128), (1, 33, 1, 64)]:
        q = torch.randn(B, S, G * Kv, hd, generator=gen,
                        device=cuda_device).to(tdt)
        k, v = (torch.randn(B, S, Kv, hd, generator=gen,
                            device=cuda_device).to(tdt) for _ in range(2))
        for window in (S, 64, 45, 1, 10 * S):
            out = sops.swa_attention(q, k, v, window)
            want = sref.swa_attention(q, k, v, window)
            torch.cuda.synchronize()
            assert _attn_max_err(out, want) <= ATTN_TOL[tdt], (B, S, window)
            calls += 1
    assert kernels.launch_counts()["swa_attention"] == calls


@pytest.mark.cuda
def test_attention_wrappers_reject_on_card(cuda_device):
    """A CPU/CUDA mix, an unsupported dtype or head dim and a
    non-contiguous input raise before any launch; nothing falls back to
    the plain version."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.swa_attention import ops as sops
    kernels.reset_launches()
    q = torch.zeros(2, 6, 64, device=cuda_device)
    k = torch.zeros(2, 32, 2, 64, device=cuda_device)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    for bad in [(q, k.cpu(), k, pos), (q, k, k, pos.cpu()),
                (q.half(), k.half(), k.half(), pos),
                (q[:, :, :32], k[..., :32], k[..., :32], pos),
                (q, k.transpose(1, 2).contiguous().transpose(1, 2), k, pos),
                (torch.zeros(2, 18, 64, device=cuda_device), k, k, pos)]:
        with pytest.raises((ValueError, TypeError)):
            dops.decode_attention(*bad)
    qs = torch.zeros(1, 32, 6, 64, device=cuda_device)
    ks = torch.zeros(1, 32, 2, 64, device=cuda_device)
    for bad in [(qs, ks.cpu(), ks, 32), (qs.half(), ks.half(), ks.half(), 32),
                (qs.transpose(1, 2).contiguous().transpose(1, 2), ks, ks, 32),
                (qs[..., :32], ks[..., :32], ks[..., :32], 32)]:
        with pytest.raises((ValueError, TypeError)):
            sops.swa_attention(*bad)
    assert kernels.launch_counts() == {
        "weighted_agg": 0, "ring_agg": 0, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 0}


@pytest.mark.cuda
def test_reduced_serve_launches_only_the_attention_kernels(cuda_device):
    """A reduced smollm-360m server on the card: one ``swa_attention`` per
    layer per admitted request, one ``decode_attention`` per layer per
    tick, no other kernel, and the same tokens as on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import BatchedServer
    cfg = get_config("smollm-360m").reduced().variant(n_heads=6,
                                                      n_kv_heads=2)
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 70, 9)]
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        srv = BatchedServer(cfg, model.to(dev), n_slots=2, max_seq=96)
        reqs = [srv.submit(p, max_new=6) for p in prompts]
        kernels.reset_launches()
        ticks = srv.run_until_drained()
        counts = kernels.launch_counts()
        outs[dev.type] = [r.out for r in reqs]
        if dev.type == "cuda":
            assert counts == {"weighted_agg": 0, "ring_agg": 0,
                              "decode_attention": cfg.n_layers * ticks,
                              "swa_attention": cfg.n_layers * len(prompts),
                              "cross_entropy": 0}
        else:
            assert not any(counts.values())
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.cuda
def test_decode_step_never_waits_for_the_card(cuda_device):
    """A decode step (cache writes at a pos vector, K4, the MLPs) runs with
    CUDA synchronisation made an error."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("smollm-360m").reduced()
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device=cuda_device)
    cache = T.init_cache(cfg, 3, 64, device=cuda_device)
    token = torch.zeros(3, 1, dtype=torch.int32, device=cuda_device)
    pos = torch.tensor([0, 5, 63], dtype=torch.int32, device=cuda_device)
    T.decode_step(cfg, model, token, cache, pos)     # builds the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = T.decode_step(cfg, model, token, cache, pos)
        logits, _ = T.decode_step(cfg, model, token, cache, 7)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all())


# K3 cross_entropy against its plain version: nll and lse within 1e-4 in
# f32 (repro's bar for its kernel, tests/test_kernels.py) and 3e-2 in bf16;
# rows of +-1e4 logits within 1e-3 (repro's bar for them: lse ~ 1e4, where
# one f32 ulp is 1e-3); the backward's d logits within 1e-6 of plain
# autograd in f32
CE_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
CE_EXTREME_TOL = 1e-3
CE_GRAD_TOL = 1e-6


def _ce_inputs(R, V, tdt, gen, device):
    x = (torch.randn(R, V, generator=gen, device=device) * 3).to(tdt)
    y = torch.randint(0, V, (R,), generator=gen, device=device)
    y[0] = 0
    y[-1] = V - 1
    return x, y


def _ce_err(got, want):
    return max((a - b).abs().max().item() for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cross_entropy_matches_plain_version_on_card(cuda_device, tdt):
    """K3's (nll, lse) at small, ragged (V = 1111: rows not 16-byte
    aligned) and smollm-360m vocab widths, labels at 0, V - 1 and random,
    and rows of +-1e4 logits."""
    from repro_torch.kernels.cross_entropy import ops as ce_ops
    from repro_torch.kernels.cross_entropy import ref as ce_ref
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    kernels.reset_launches()
    calls = 0
    for R in (1, 7, 512):
        for V in (512, 1111, 49152):
            x, y = _ce_inputs(R, V, tdt, gen, cuda_device)
            got = ce_ops.nll_and_lse(x, y)
            torch.cuda.synchronize()
            assert all(t.dtype == torch.float32 and t.shape == (R,)
                       for t in got)
            assert _ce_err(got, ce_ref.nll_and_lse(x, y)) <= CE_TOL[tdt], \
                (R, V)
            calls += 1
    for V in (512, 1111):
        x = torch.tensor([1e4, -1e4, 0.0, 5.0], device=cuda_device).repeat(
            8, V // 4 + 1)[:, :V].contiguous().to(tdt)
        y = torch.tensor([0, 1, 2, 3, V - 1, 0, 1, 2], device=cuda_device)
        got = ce_ops.nll_and_lse(x, y)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(t).all()) for t in got)
        assert _ce_err(got, ce_ref.nll_and_lse(x, y)) <= CE_EXTREME_TOL
        calls += 1
    assert kernels.launch_counts()["cross_entropy"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("R,V", [(7, 1111), (512, 49152)])
def test_cross_entropy_backward_matches_autograd_on_card(cuda_device, R, V):
    """d logits of the kernel-backed ``lm_loss`` against plain autograd of
    ``log_softmax`` on the same f32 logits."""
    from repro_torch.kernels.cross_entropy import ops as ce_ops
    gen = torch.Generator(device=cuda_device).manual_seed(R)
    x, y = _ce_inputs(R, V, torch.float32, gen, cuda_device)
    grads = []
    for use_kernel in (True, False):
        xl = x.clone().requires_grad_()
        loss = ce_ops.lm_loss(xl[None], y[None], use_kernel=use_kernel)
        grads.append(torch.autograd.grad(loss, xl)[0])
    assert (grads[0] - grads[1]).abs().max().item() <= CE_GRAD_TOL


@pytest.mark.cuda
def test_cross_entropy_wrapper_rejects_on_card(cuda_device):
    """A CPU/CUDA mix, an unsupported dtype, a misshaped or
    non-contiguous input raise before any launch; nothing falls back to
    the plain version."""
    from repro_torch.kernels.cross_entropy import ops as ce_ops
    kernels.reset_launches()
    x = torch.zeros(4, 64, device=cuda_device)
    y = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    for bad in [(x, y.cpu()), (x.half(), y), (x, y.float()), (x[0], y),
                (x, y[:3]), (torch.zeros(64, 4, device=cuda_device).t(), y),
                (x[:, :0], y)]:
        with pytest.raises((ValueError, TypeError)):
            ce_ops.nll_and_lse(*bad)
    assert kernels.launch_counts()["cross_entropy"] == 0
    ce_ops.nll_and_lse(x, y.long())
    assert kernels.launch_counts()["cross_entropy"] == 1


@pytest.mark.cuda
def test_train_step_never_waits_for_the_card(cuda_device):
    """A full-width-shaped train step (smollm-360m's widths cut to 2
    layers, B 8, S 64) and the loop's kernel merge run with CUDA
    synchronisation made an error; K3 launches once per step."""
    from repro_torch.configs import get_config
    from repro_torch.core.aggregation import mafl_update
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    cfg = get_config("smollm-360m").variant(n_layers=2)
    model = T.init_params(cfg, torch.Generator(device=cuda_device)
                          .manual_seed(0), device=cuda_device)
    step = make_train_step(cfg, lr=0.05)
    tokens = torch.randint(0, cfg.vocab_size, (8, 65), device=cuda_device)
    params, _ = step(model, T.param_dict(model), {"tokens": tokens})
    torch.cuda.synchronize()                     # kernels built and loaded
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, metrics = step(model, params, {"tokens": tokens})
        merged = mafl_update(T.param_dict(model), params, 0.5, 0.8719,
                             use_kernel=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.launch_counts() == {
        "weighted_agg": len(params), "ring_agg": 0, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 1}
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(bool(torch.isfinite(v).all()) for v in merged.values())


@pytest.mark.cuda
def test_reduced_training_on_card_matches_cpu(cuda_device):
    """``launch/train.py``'s loop on smollm-360m reduced, on the card and
    on the CPU from one init: the same vehicles, losses and final model
    within the f32 band of ``chip_smoke.py``'s card-vs-CPU check, K3 once
    per local step and held-out eval, K2 once per leaf per merge."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    cfg = get_config("smollm-360m").reduced()
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    args = train.build_parser().parse_args(
        ["--reduced", "--rounds", "5", "--l-iters", "2", "--use-kernel"])
    runs = {}
    for dev, model in ((cuda_device, copy.deepcopy(cpu).to(cuda_device)),
                       (torch.device("cpu"), cpu)):
        kernels.reset_launches()
        runs[dev.type] = train.run_training(cfg, model, args,
                                            log=lambda *a: None)
        counts = kernels.launch_counts()
        if dev.type == "cuda":
            assert counts["cross_entropy"] == 5 * 2 + 1
            assert counts["weighted_agg"] == len(T.param_dict(model)) * 5
        else:
            assert not any(counts.values())
    g, c = runs["cuda"], runs["cpu"]
    assert g.vehicles == c.vehicles
    np.testing.assert_allclose([float(v) for v in g.local_losses],
                               [float(v) for v in c.local_losses], rtol=1e-4)
    for k, v in c.params.items():
        torch.testing.assert_close(g.params[k].cpu(), v, atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("R, U", [(2, 2), (512, 3), (4096, 7)])
def test_racy_sum_one_row_tile_matches_plain_version(cuda_device, R, U):
    """F1 with one row tile has one block per column: no race, and on
    integer-valued f32 inputs the sum is exact in any order."""
    from repro_torch.check.corpus import racy_kernel
    x = torch.from_numpy(np.random.default_rng(R).integers(
        -100, 100, (R, U)).astype(np.float32)).to(cuda_device)
    before = racy_kernel.KERNEL.launches
    got = racy_kernel.racy_sum(x, block_rows=R)
    torch.cuda.synchronize()
    assert racy_kernel.KERNEL.launches == before + 1
    assert racy_kernel.KERNEL not in kernels.KERNELS
    assert torch.equal(got, racy_kernel.plain_sum(x, block_rows=R))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_id", [
    "weighted_agg.weighted_agg", "weighted_agg.ring_agg",
    "cross_entropy.nll_and_lse", "decode_attention.decode_attention",
    "swa_attention.swa_attention"])
def test_geometry_exports_match_python_grids(cuda_device, kernel_id):
    """Each ``.cu``'s ``<name>_geometry`` export gives the grids its
    ``ops.geometry`` declares, at the registered case and at every
    main-path shape."""
    from repro_torch.check import grid_race
    case = grid_race.KERNEL_CASES[kernel_id]
    shapes = [("case", case.args)] + grid_race.main_path_shapes()[kernel_id]
    for label, args in shapes:
        assert case.grids(*args) == [g.dim3 for g in case.launches(*args)], \
            label


@pytest.mark.cuda
def test_racy_sum_geometry_export_matches_python_grid(cuda_device):
    from repro_torch.check.corpus import racy_kernel
    for args in ((8, 2, 2), (2, 2, 2), (8192, 2, 2)):
        assert racy_kernel.cu_grids(*args) == [
            g.dim3 for g in racy_kernel.geometry(*args)]
