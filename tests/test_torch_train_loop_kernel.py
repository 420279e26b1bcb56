"""``launch/train.py``'s MAFL loop in the port against ``repro``'s under
mafl and afl with ``--use-kernel`` (``_torch_train_loop.py`` holds the run
and its bands)."""
from __future__ import annotations

import pytest

from _torch_train_loop import assert_training_loop_matches_repro
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("scheme", ["mafl", "afl"])
@pytest.mark.parametrize("use_kernel", [True], ids=["kernel"])
def test_training_loop_matches_repro(monkeypatch, scheme, use_kernel):
    assert_training_loop_matches_repro(monkeypatch, scheme, use_kernel)
