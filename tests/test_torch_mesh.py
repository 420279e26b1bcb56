"""The port's meshes (``launch/mesh.py``) in one process, on the CPU: the
one-rank host mesh (a gloo group of one rank this module starts and ends),
the production meshes' and the engines' refusals, and the pod-local merge
of ``core/hierarchical.py`` against ``repro``'s on the same numpy arrays.
The collectives over several ranks are ``test_torch_mesh_engines.py``'s.

The pod-local merge and ``repro``'s round their products apart by at most
an ulp (atol 1e-6)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core.hierarchical as jh
import repro_torch.core.scenarios as tsc
from _torch_dist import corridor_run, digest, numpy_init
from _torch_threads import one_thread  # noqa: F401
from repro_torch.core.hierarchical import pod_local_mafl
from repro_torch.launch.mesh import (check_mesh_device, make_host_mesh,
                                     make_mesh, make_production_mesh,
                                     mesh_axis)

pytestmark = pytest.mark.usefixtures("one_thread")

EMA_TOL = dict(rtol=0.0, atol=1e-6)


@pytest.fixture(scope="module")
def host_mesh(one_thread):
    """The one-rank ``("data", "model")`` mesh, on a one-rank gloo group
    this module starts and ends."""
    assert not dist.is_initialized()
    mesh = make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def test_pod_local_mafl_matches_repro():
    """The pod-local merge (Eq. 10+11, mixing reading) on one process,
    against ``repro``'s on the same arrays, clipped and unclipped."""
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((8, 6)).astype(np.float32),
         "b": rng.standard_normal(8).astype(np.float32)}
    l = {k: v * 3.0 for k, v in g.items()}
    for beta, weight in ((0.5, 0.8), (0.3, 1.7), (0.9, 0.2)):
        want = jh.pod_local_mafl({k: jnp.asarray(v) for k, v in g.items()},
                                 {k: jnp.asarray(v) for k, v in l.items()},
                                 beta, weight)
        got = pod_local_mafl({k: torch.from_numpy(v) for k, v in g.items()},
                             {k: torch.from_numpy(v) for k, v in l.items()},
                             beta, weight)
        for k, v in want.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       err_msg=k, **EMA_TOL)


def test_production_mesh_refuses_without_its_ranks():
    """With no process group, the production mesh raises rather than
    start one (only a one-rank mesh starts its own group)."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs a process group of 256 "
                       "ranks; none is started"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="call torch.distributed"):
        make_mesh((2,), ("data",), "cpu")
    assert not dist.is_initialized()


def test_host_mesh_runs_the_corridor_bitwise(host_mesh):
    """World size 1: corridor-quick-r2-k8 (cut) on the port's flat corridor
    program with the host mesh (no ``"rsu"`` axis; a ``"data"`` axis of
    1: every wave goes through the split and the sum over one rank)
    returns the unsharded run bit for bit (signed zeros too: the gathered
    rows land on ``-0.0``)."""
    assert mesh_axis(host_mesh, "data").size == 1
    assert mesh_axis(host_mesh, "model").size == 1
    assert mesh_axis(host_mesh, "rsu") is None
    init = numpy_init()
    want = digest(corridor_run("kernel", init))
    got = digest(corridor_run("kernel", init, host_mesh))
    assert got["trace"] == want["trace"]
    assert np.array_equal(got["times"], want["times"])
    for k, v in want["params"].items():
        assert got["params"][k].tobytes() == v.tobytes(), k
    for k, v in want["final_cohorts"].items():
        assert got["final_cohorts"][k].tobytes() == v.tobytes(), k
    assert got["acc"] == want["acc"]


def test_mesh_refusals_in_run_scenario(host_mesh):
    """A mesh reaches the corridor engine only: the serial handover loop
    refuses it (``repro``'s text), and so does a single-RSU world (where
    ``repro`` drops it silently); a mesh on another device type than the
    run's, and anything but a ``DeviceMesh``, refuse too."""
    with pytest.raises(ValueError, match="mesh/record_cohorts require "
                       "engine='corridor'"):
        tsc.run_scenario("corridor-quick-r2-k8", engine="serial",
                         mesh=host_mesh, device="cpu")
    with pytest.raises(ValueError, match="run_simulation_jit"):
        tsc.run_scenario("quick-k5", engine="jit", mesh=host_mesh,
                         device="cpu")
    with pytest.raises(ValueError, match="engine='vmap' has no"):
        tsc.run_scenario("quick-k5", engine="vmap", mesh=host_mesh,
                         device="cpu")
    with pytest.raises(ValueError, match="the mesh's devices are 'cpu' but "
                       "the run's device is cuda"):
        check_mesh_device(host_mesh, torch.device("cuda"))
    with pytest.raises(TypeError, match="DeviceMesh"):
        check_mesh_device(object(), torch.device("cpu"))
    check_mesh_device(host_mesh, torch.device("cpu"))
