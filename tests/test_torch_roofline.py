"""The port's roofline (``repro_torch.roofline``) against ``repro``'s.

- The dispatch counter counts a known product's FLOPs exactly
  (``2 m n k``, times the batch for ``bmm``), on ``meta`` tensors and
  below DTensor: a product of sharded operands counts one device's share.
- Collective bytes by kind on a fake process group follow ``repro``'s ring
  conventions: the same all-gather, all-reduce and reduce-scatter written
  as HLO for ``repro``'s parser give the same bytes per kind.
- ``roofline_terms`` gives ``repro``'s dict for the same stats, memory and
  hardware values (the test passes ``repro``'s values: the port carries
  none of them); ``model_flops_estimate`` equals ``repro``'s for every arch
  and legal shape.
- A reduced ``no_remat`` train step on one CPU device: the counter's dot
  FLOPs within 2% of ``repro``'s ``parse_hlo_module(...).dot_flops`` of
  the same jitted step (the port counts the products it dispatches, XLA's
  HLO the dots it kept: both count every weight and attention product of
  the forward and backward).
- A sharded leaf's local bytes are its full bytes over its shard count.

Exact equality everywhere but the 2% band: the counts are arithmetic on
shapes."""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget, get_shape, legal_shapes, \
    list_archs
from repro.launch import steps as jsteps
from repro.models import transformer as jT
from repro.roofline import parse_hlo_module
from repro.roofline.analysis import V5E, model_flops_estimate as jmfe, \
    roofline_terms as jterms
from repro_torch.configs import get_config as tget
from repro_torch.configs.shapes import get_shape as tshape
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as T
from repro_torch.roofline import (Hardware, count_step, model_flops_estimate,
                                  roofline_terms)
from repro_torch.roofline.dispatch_count import local_bytes
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

HLO = """HloModule m

ENTRY %main (p0: f32[64,32]) -> f32[64,64] {
  %p0 = f32[64,32]{1,0} parameter(0)
  %ag = f32[256,32]{1,0} all-gather(%p0), dimensions={0}
  %ar = f32[64,32]{1,0} all-reduce(%p0), to_apply=%add
  %rs = f32[16,32]{1,0} reduce-scatter(%p0), dimensions={0}
  ROOT %d = f32[64,64]{1,0} dot(%p0, %p0), lhs_contracting_dims={1}, rhs_contracting_dims={1}
}
"""


@pytest.fixture
def fake_group():
    """A ``"fake"`` group of 4 ranks in this process and a ``("data",)``
    mesh on it, destroyed after the test."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.dryrun import start_fake_group
    assert not dist.is_initialized()
    start_fake_group(4)
    try:
        yield init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_known_products_are_exact():
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 48, device="meta")
    x = torch.empty(5, 64, 32, device="meta")
    y = torch.empty(5, 32, 16, device="meta")
    bias = torch.empty(48, device="meta")
    _, st, _, _ = count_step(lambda: (a @ b, torch.bmm(x, y),
                                      torch.addmm(bias, a, b)))
    assert st.dot_flops == 2 * 64 * 32 * 48 * 2 + 2 * 5 * 64 * 32 * 16
    assert st.ops["aten::mm"] == 1 and st.ops["aten::bmm"] == 1


def test_collectives_and_shards_on_a_fake_group(fake_group):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = fake_group
    local = torch.empty(64, 32, device="meta")
    shard = DTensor.from_local(local, mesh, [Shard(0)], run_check=False)
    part = DTensor.from_local(local, mesh, [Partial()], run_check=False)
    _, st, _, _ = count_step(lambda: (
        shard.redistribute(placements=[Replicate()]),
        part.redistribute(placements=[Replicate()]),
        part.redistribute(placements=[Shard(0)])))
    want = parse_hlo_module(HLO)
    assert st.collective_bytes == want.collective_bytes
    assert st.collective_counts == {"all-gather": 1, "all-reduce": 1,
                                    "reduce-scatter": 1, "all-to-all": 0,
                                    "collective-permute": 0}
    # below DTensor: a product of row shards is one device's share
    w = DTensor.from_local(torch.empty(32, 48, device="meta"), mesh,
                           [Replicate()], run_check=False)
    _, st, _, _ = count_step(lambda: shard @ w)
    assert st.dot_flops == 2 * 64 * 32 * 48
    # a sharded leaf's local bytes: its full bytes over its shard count
    from repro_torch.sharding import dtensor as dt
    full = torch.empty(256, 96, dtype=torch.bfloat16, device="meta")
    assert local_bytes(dt.shard(mesh, full, [Shard(1)])) == 256 * 96 * 2 // 4
    assert local_bytes(dt.shard(mesh, full, [Replicate()])) == 256 * 96 * 2


def test_roofline_terms_equal_repro():
    stats = parse_hlo_module(HLO)
    memory = SimpleNamespace(argument_size_in_bytes=3e9,
                             output_size_in_bytes=1e9,
                             temp_size_in_bytes=5e9, alias_size_in_bytes=2e8)
    hw = Hardware(**{f.name: getattr(V5E, f.name)
                     for f in dataclasses.fields(Hardware)})
    kw = dict(arch="a", shape="s", mesh_name="m", n_chips=256,
              memory_stats=memory, cost_flops=1.5, model_flops=7e15,
              tokens=1024)
    want = jterms(hlo_stats=stats, hw=V5E, **kw).to_dict()
    assert roofline_terms(stats=stats, hw=hw, **kw).to_dict() == want


def test_model_flops_estimate_equals_repro():
    for arch in list_archs():
        for name in legal_shapes(jget(arch)):
            assert model_flops_estimate(tget(arch), tshape(name)) == \
                jmfe(jget(arch), get_shape(name)), (arch, name)


def test_train_step_dot_flops_match_repro_hlo():
    jcfg = jget("smollm-360m").reduced().variant(no_remat=True)
    tcfg = tget("smollm-360m").reduced().variant(no_remat=True)
    tokens = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, 65)).astype(np.int32)
    jparams = jT.init_params(jcfg, jax.random.PRNGKey(0))
    hlo = jax.jit(jsteps.make_train_step(jcfg)).lower(
        jparams, {"tokens": jnp.asarray(tokens)}).compile().as_text()
    want = parse_hlo_module(hlo).dot_flops
    model = T.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    _, st, _, _ = count_step(tsteps.make_train_step(tcfg), model,
                             T.param_dict(model),
                             {"tokens": torch.from_numpy(tokens)})
    print(f"dot FLOPs: port {st.dot_flops:.6e}, repro HLO {want:.6e}")
    assert abs(st.dot_flops - want) <= 0.02 * want
