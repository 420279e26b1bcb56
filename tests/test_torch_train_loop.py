"""``launch/train.py``'s MAFL loop in the port against ``repro``'s under
mafl and afl without ``--use-kernel`` (``_torch_train_loop.py`` holds the
run and its bands; ``test_torch_train_loop_kernel.py`` the kernel path),
and the CLI."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from _torch_train_loop import assert_training_loop_matches_repro
from repro.checkpointing import load_checkpoint as jload_checkpoint
from repro_torch.checkpointing import latest_checkpoint
from repro_torch.convert import transformer_params_to_numpy
from repro_torch.launch import train as ttrain
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("scheme", ["mafl", "afl"])
@pytest.mark.parametrize("use_kernel", [False], ids=["plain"])
def test_training_loop_matches_repro(monkeypatch, scheme, use_kernel):
    assert_training_loop_matches_repro(monkeypatch, scheme, use_kernel)


def test_cli_on_cpu_writes_a_checkpoint_repro_loads(tmp_path, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu``:
    ``repro``'s printed lines, and a checkpoint in ``repro``'s nested
    layout that ``repro``'s loader restores bit for bit."""
    params = ttrain.main(["--reduced", "--device", "cpu", "--rounds", "5",
                          "--l-iters", "1", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=smollm-360m reduced=True scheme=mafl " \
                     "params=1,246,464"
    assert out[1].startswith("round   5 vehicle ")
    assert out[-1] == f"saved {latest_checkpoint(str(tmp_path))}"
    tree = transformer_params_to_numpy(params)
    restored = jload_checkpoint(latest_checkpoint(str(tmp_path)), tree)
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                              jax.tree_util.tree_leaves_with_path(restored)):
        np.testing.assert_array_equal(a, b)
    assert all(torch.isfinite(v).all() for v in params.values())
