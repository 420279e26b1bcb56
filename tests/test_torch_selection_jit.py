"""The port's fleet engine (``engine="jit"``) under vehicle selection
against ``repro``'s, on the CPU, from one (JAX-drawn) init with the kernel
path on (``_torch_engines.py``).

- the K 6 world for the three specs of ``repro``'s own cross-engine
  selection test: the same trace and ``report.selection`` as ``repro``'s,
  times and params within the f32 band of ``_torch_world.py``;
- a bandit world whose re-admission falls between two pops of one segment;
- the waves' training held to ``repro``'s step on the same inputs (the
  reading ``DEVICE_CUT_TOL`` rests on).

Parked vehicles, the bandit guard and the registry's fleet selection
worlds on this engine are in ``test_torch_selection_jit_registry.py``."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.nn.functional as F

import repro.core.client as jclient
import repro.models.cnn as jcnn
import repro_torch.core.client as tclient
import repro_torch.core.jit_engine as tjit
import repro_torch.core.mafl as tmafl
import repro_torch.core.scenarios as tsc
import repro_torch.models.cnn as tcnn
import repro_torch.selection as tsel
from _torch_engines import (SPECS, init, selection_fleet_pair,  # noqa: F401
                            worlds)
from _torch_world import PARAM_TOL, assert_fleet_conforms
from repro_torch.convert import params_from_jax
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("engine", ["jit"])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s["policy"])
def test_engines_conform_under_selection(init, worlds, spec, engine):
    jres, tres = selection_fleet_pair(worlds, init, engine, spec)
    assert tres.report.selection == jres.report.selection
    # the policy parked somebody (the world is bigger than k)
    assert not all(tres.report.selection["admit0"])
    assert_fleet_conforms(jres, tres)


def test_readmission_lands_between_two_pops_of_a_segment(init, worlds,
                                                         monkeypatch):
    """eps-bandit k 3 re-scored every 3 rounds: the re-admission of round 6
    falls inside the segment [3, 9).  It is written after pop 5 and before
    pop 6, and the run matches ``repro``'s fleet engine."""
    spec = dict(policy="eps-bandit", k=3, eps=0.3, resel_every=3)
    plan = tjit.plan_fleet(worlds[1][3], 0, 12, tsel.SelectionSpec(**spec))
    readmits = tjit.readmit_points(plan)
    inside = [b for b in readmits for _, s, e in plan.waves if s < b < e]
    assert inside == [6]
    log = []
    real_pop, real_readmit = tjit._SlotQueue.pop, tjit._SlotQueue.readmit

    def pop(self, mafl, r):
        log.append(("pop", r))
        return real_pop(self, mafl, r)

    def readmit(self, idx, t_b):
        log.append(("readmit", idx.tolist(), float(t_b)))
        return real_readmit(self, idx, t_b)

    monkeypatch.setattr(tjit._SlotQueue, "pop", pop)
    monkeypatch.setattr(tjit._SlotQueue, "readmit", readmit)
    jres, tres = selection_fleet_pair(worlds, init, "jit", spec, rounds=12)
    assert_fleet_conforms(jres, tres)
    assert tres.report.selection == jres.report.selection
    for b, vs in readmits.items():
        k = log.index(("pop", b - 1))
        assert log[k + 1][:2] == ("readmit", vs)
        # at pop b-1's time
        np.testing.assert_allclose(log[k + 1][2], tres.rounds[b - 1].time,
                                   rtol=1e-6)
        assert log[k + 2] == ("pop", b)


def _torch_pre_activations(p, im):
    """The CNN's three pre-ReLU activations of one step's batch, NHWC."""
    x = im.permute(0, 3, 1, 2)
    c1 = tcnn._conv_same(x, p["conv1_w"]) + p["conv1_b"][:, None, None]
    c2 = (tcnn._conv_same(tcnn._max_pool_2x2(F.relu(c1)), p["conv2_w"])
          + p["conv2_b"][:, None, None])
    x = tcnn._max_pool_2x2(F.relu(c2)).permute(0, 2, 3, 1)
    h = x.reshape(x.shape[0], -1) @ p["fc1_w"] + p["fc1_b"]
    return [c1.permute(0, 2, 3, 1).numpy(), c2.permute(0, 2, 3, 1).numpy(),
            h.numpy()]


def _jax_pre_activations(p, im):
    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    c1 = conv(im, p["conv1_w"]) + p["conv1_b"]
    c2 = conv(jcnn._max_pool_2x2(jax.nn.relu(c1)), p["conv2_w"]) + p["conv2_b"]
    x = jcnn._max_pool_2x2(jax.nn.relu(c2))
    h = x.reshape(x.shape[0], -1) @ p["fc1_w"] + p["fc1_b"]
    return [np.asarray(c1), np.asarray(c2), np.asarray(h)]


def _pool_winners(a):
    b, h, w, c = a.shape
    a = np.maximum(a, 0).reshape(b, h // 2, 2, w // 2, 2, c)
    return a.transpose(0, 1, 3, 5, 2, 4).reshape(b, h // 2, w // 2, c,
                                                  4).argmax(-1)


def _crosses_a_kink(tp, jp, im):
    """Whether torch's and XLA's forward of one batch put some value on
    different sides of a ReLU or a max-pool tie."""
    ta = _torch_pre_activations(tp, im)
    ja = _jax_pre_activations(jp, jnp.asarray(im.numpy()))
    if any(((a > 0) != (b > 0)).any() for a, b in zip(ta, ja)):
        return True
    return any((_pool_winners(a) != _pool_winners(b)).any()
               for a, b in zip(ta[:2], ja[:2]))


def test_fleet_waves_train_as_repro_on_the_same_inputs(init, monkeypatch):
    """The fleet engine's wave steps on fleet-k1000-topk cut to K 40, each
    upload held on its own inputs (payload, batches) against the port's
    host step and against repro's step.  Every upload equals the host step
    within PARAM_TOL; an upload off repro's step by more than PARAM_TOL
    has a forward that crosses a kink between torch's and XLA's f32
    rounding, and that is the one reading DEVICE_CUT_TOL rests on."""
    waves = []
    for name in ("_local_scan_shared", "_local_scan_vmap"):
        real = getattr(tclient, name)

        def record(pay, imgs, labs, lr, real=real, shared="shared" in name):
            out, loss = real(pay, imgs, labs, lr)
            waves.append((shared, pay, imgs, labs, lr, out))
            return out, loss
        monkeypatch.setattr(tclient, name, record)
    sc = dataclasses.replace(tsc.get_scenario("fleet-k1000-topk"), K=40,
                             selection_k=5)
    veh, ti, tl, p = tsc.build_world(sc)
    tmafl.run_simulation(
        veh, ti, tl, params=p, rounds=sc.rounds, l_iters=sc.l_iters,
        lr=sc.lr, seed=0, eval_every=10, engine="jit", use_kernel=True,
        selection=sc.selection_spec(), init_params=params_from_jax(init,
                                                                   "cpu"),
        device="cpu")
    n, off = 0, []
    for shared, pay, imgs, labs, lr, out in waves:
        for i in range(imgs.shape[0]):
            tp = pay if shared else {k: v[i] for k, v in pay.items()}
            got = {k: v[i].numpy() for k, v in out.items()}
            host, _ = tclient._local_scan(tp, imgs[i], labs[i], lr)
            jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
            ref, _ = jclient._local_scan_jit(jp, jnp.asarray(imgs[i].numpy()),
                                             jnp.asarray(labs[i].numpy()), lr)
            for k in got:
                np.testing.assert_allclose(got[k], host[k].numpy(),
                                           err_msg=k, **PARAM_TOL)
            if not all(np.allclose(got[k], np.asarray(ref[k]), **PARAM_TOL)
                       for k in got):
                assert imgs.shape[1] == 1, "a kink is read on the first step"
                off.append(_crosses_a_kink(tp, jp, imgs[i, 0]))
            n += 1
    assert n == sc.rounds
    # one upload leaves PARAM_TOL, through a kink; were there none, the
    # cut would go back to PARAM_TOL
    assert off == [True]
