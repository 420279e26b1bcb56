"""Mamba (S6 selective SSM) block of the Jamba hybrid, the counterpart of
``repro.models.mamba``.

Prefill and training run the selective scan one step at a time through
``modules.chunked_scan`` (``SCAN_CHUNK`` steps a chunk), as ``repro``'s
``lax.scan``: not a Pallas kernel, so a few small torch ops a step here.
Decode is a single recurrence step.  State:
  conv [B, d_conv - 1, d_inner]   the causal conv's tail (the padded
                                  pre-conv input: zeros behind a prompt
                                  shorter than d_conv - 1)
  ssm  [B, d_inner, d_state]      float32
``A_log`` and ``D`` are float32 whatever the model's dtype, as in
``repro``, and every cast of ``repro``'s is a rounding point kept here.
The step's product with ``C`` is an elementwise product and a sum, not a
``bmm``, so a period's selective checkpoint saves none of a chunk's steps.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.modules import chunked_scan, dense_init

SCAN_CHUNK = 64


def _d_inner(cfg):
    return cfg.mamba_expand * cfg.d_model


def _dt_rank(cfg):
    return max(cfg.d_model // 16, 1)


class Mamba(nn.Module):
    """``in_proj [d, 2 di]``, ``conv_w [d_conv, di]``, ``conv_b [di]``,
    ``x_proj [di, dt_rank + 2 ds]``, ``dt_proj [dt_rank, di]``,
    ``dt_bias [di]``, ``A_log [di, ds]`` and ``D [di]`` (both float32),
    ``out_proj [di, d]``: ``repro``'s ``init_mamba`` leaves."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        d, di, ds = cfg.d_model, _d_inner(cfg), cfg.mamba_d_state
        r, dc = _dt_rank(cfg), cfg.mamba_d_conv
        f32 = torch.float32
        for name, (shape, dt) in {
                "in_proj": ((d, 2 * di), dtype), "conv_w": ((dc, di), dtype),
                "conv_b": ((di,), dtype), "x_proj": ((di, r + 2 * ds), dtype),
                "dt_proj": ((r, di), dtype), "dt_bias": ((di,), dtype),
                "A_log": ((di, ds), f32), "D": ((di,), f32),
                "out_proj": ((di, d), dtype)}.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dt, device=device),
                requires_grad=False))

    def reset_parameters(self, generator):
        """``repro``'s values: ``A_log = log(1 .. ds)`` per channel, unit
        ``D``, zero ``conv_b``, ``dt_bias = log(expm1(0.01))``, the conv
        normal over sqrt(d_conv), dense weights variance-scaled."""
        dev, dt = self.in_proj.device, self.in_proj.dtype
        dc, di = self.conv_w.shape
        ds = self.A_log.shape[1]
        for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
            w = getattr(self, name)
            w.copy_(dense_init(generator, w.shape[0], w.shape[1], dt,
                               device=dev))
        self.conv_w.copy_(torch.randn((dc, di), generator=generator,
                                      device=generator.device)
                          / np.sqrt(dc))
        self.conv_b.zero_()
        self.dt_bias.fill_(float(np.log(np.expm1(0.01))))
        self.A_log.copy_(torch.log(torch.arange(
            1, ds + 1, dtype=torch.float32, device=dev)).expand(di, ds))
        self.D.fill_(1)


def _ssm_params(cfg, p, xc):
    """xc: [..., di] post-conv activations -> (dt, Bm, Cm), float32: dt
    [..., di] (softplus of the rank-``dt_rank`` projection plus the bias),
    Bm and Cm [..., ds]."""
    ds = cfg.mamba_d_state
    r = p.dt_proj.shape[0]
    dbc = xc @ p.x_proj
    dt = F.softplus((dbc[..., :r] @ p.dt_proj).float()
                    + p.dt_bias.float())
    Bm = dbc[..., r:r + ds].float()
    Cm = dbc[..., r + ds:].float()
    return dt, Bm, Cm


def _step(A, h, dt_t, dtx_t, B_t, C_t):
    """One recurrence step, float32.  A: [di, ds]; h: [B, di, ds]; dt_t and
    dtx_t (dt times the post-conv input): [B, di]; B_t, C_t: [B, ds].
    Returns (h, y [B, di])."""
    dA = torch.exp(dt_t[..., None] * A)                  # [B, di, ds]
    h = dA * h + dtx_t[..., None] * B_t[:, None, :]
    y = (h * C_t[:, None, :]).sum(dim=-1)
    return h, y


def _body(A, h, inp):
    return _step(A, h, *inp)


def mamba_fwd(cfg, p, x):
    """x: [B, S, d] -> (y, cache {"conv", "ssm"}) by the full selective
    scan."""
    B, S, d = x.shape
    di, dc = _d_inner(cfg), cfg.mamba_d_conv
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)
    # causal depthwise conv over the zero-padded input
    xp = torch.cat([xin.new_zeros((B, dc - 1, di)), xin], dim=1)
    xc = sum(xp[:, i:i + S, :] * p.conv_w[i] for i in range(dc))
    xc = F.silu((xc + p.conv_b).float()).to(x.dtype)
    dt, Bm, Cm = _ssm_params(cfg, p, xc)
    xcf = xc.float()
    # [S, B, ...]: dt, dt * x (repro's per-step product, taken in bulk), B, C
    xs = tuple(a.transpose(0, 1) for a in (dt, dt * xcf, Bm, Cm))
    h0 = torch.zeros((B, di, cfg.mamba_d_state), dtype=torch.float32,
                     device=x.device)
    h_last, ys = chunked_scan(partial(_body, -torch.exp(p.A_log)), h0, xs,
                              SCAN_CHUNK)
    y = ys.transpose(0, 1) + xcf * p.D                   # [B, S, di] f32
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return y @ p.out_proj, {"conv": xp[:, S:, :], "ssm": h_last}


def mamba_decode(cfg, p, x, cache):
    """x: [B, 1, d]; cache {"conv" [B, dc - 1, di], "ssm" [B, di, ds]},
    read only.  Returns (y, the new cache)."""
    xin, z = (x @ p.in_proj)[:, 0].chunk(2, dim=-1)      # [B, di]
    window = torch.cat([cache["conv"], xin[:, None, :]], dim=1)
    xc = torch.einsum("bci,ci->bi", window, p.conv_w)
    xc = F.silu((xc + p.conv_b).float()).to(x.dtype)
    dt, Bm, Cm = _ssm_params(cfg, p, xc)
    xcf = xc.float()
    h, y = _step(-torch.exp(p.A_log), cache["ssm"], dt, dt * xcf, Bm, Cm)
    y = y + xcf * p.D
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return (y @ p.out_proj)[:, None, :], {"conv": window[:, 1:, :],
                                          "ssm": h}


def init_mamba_cache(cfg, batch, dtype, device):
    """Zero ``conv [batch, d_conv - 1, di]`` and ``ssm [batch, di, ds]``
    (float32)."""
    di = _d_inner(cfg)
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.mamba_d_state),
                           dtype=torch.float32, device=device),
    }
