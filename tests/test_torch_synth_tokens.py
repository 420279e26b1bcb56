"""``data.synth_tokens`` in the port against ``repro``'s: the same numpy
draws give equal arrays, for the training loop's shard and held-out
shapes and a vocabulary under the bigram fan-out."""
from __future__ import annotations

import numpy as np
import pytest

from repro.data import synth_tokens as jsynth_tokens
from repro_torch.data import synth_tokens
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("n, seq_len, vocab, seed", [
    (8, 65, 512, 0), (32, 65, 49152, 999), (14, 65, 49152, 3),
    (5, 9, 4, 7)])
def test_synth_tokens_equal_repro(n, seq_len, vocab, seed):
    got = synth_tokens(n, seq_len, vocab, seed=seed)
    want = jsynth_tokens(n, seq_len, vocab, seed=seed)
    assert got.dtype == np.int32 and got.shape == (n, seq_len)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < vocab
