"""Modality frontend stubs, the counterpart of ``repro.models.frontends``.

For the vision and audio architectures the port, like ``repro``, implements
the language/decoder transformer only; the ViT and EnCodec feature
extractors are stand-ins that provide correctly shaped embeddings (or token
ids).  Their draws come from a ``torch.Generator``, so they are not
``repro``'s ``jax.random`` draws: to give both packages the same inputs,
pass the same numpy arrays.
"""
from __future__ import annotations

import torch


class VisionFrontendStub:
    """InternViT+projector stand-in: (B, n_tokens, d_model) patch
    embeddings, standard normal times 0.02."""

    def __init__(self, cfg):
        if cfg.frontend != "vision":
            raise ValueError(f"{cfg.name} has no vision frontend")
        self.n_tokens = cfg.n_frontend_tokens
        self.d_model = cfg.d_model

    def __call__(self, generator, batch, dtype=torch.float32, device=None):
        """Drawn on the generator's device, then placed on ``device``
        (``None``: the generator's)."""
        x = torch.randn((batch, self.n_tokens, self.d_model),
                        generator=generator, device=generator.device)
        return (x.to(dtype) * 0.02).to(device or generator.device)


class AudioFrontendStub:
    """EnCodec stand-in: MusicGen consumes codec token ids directly, so the
    stub emits integer codes in [0, vocab)."""

    def __init__(self, cfg):
        if cfg.frontend != "audio":
            raise ValueError(f"{cfg.name} has no audio frontend")
        self.vocab = cfg.vocab_size

    def __call__(self, generator, batch, seq_len):
        """Drawn on the generator's device."""
        return torch.randint(0, self.vocab, (batch, seq_len),
                             generator=generator, device=generator.device,
                             dtype=torch.int32)


def frontend_for(cfg):
    if cfg.frontend == "vision":
        return VisionFrontendStub(cfg)
    if cfg.frontend == "audio":
        return AudioFrontendStub(cfg)
    return None
