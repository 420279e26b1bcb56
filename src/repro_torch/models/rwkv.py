"""RWKV6 ("Finch") block, the counterpart of ``repro.models.rwkv``:
time-mix with data-dependent decay and squared-ReLU channel-mix
[arXiv:2404.05892].

Recurrence (per head, head size N):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t ( S_{t-1} + diag(u) k_t v_t^T )
with data-dependent decay w_t = exp(-exp(w0 + tanh(x_t A) B)).  Token-shift
interpolation feeds the r/k/v/w/g projections.

State: ``wkv [B, H, N, N]`` (float32) and ``shift [B, d]`` (the last
token) per block; the channel-mix keeps its own ``shift``.  ``w0`` and
``u`` are float32 whatever the model's dtype, as in ``repro``; every cast
of ``repro``'s is a rounding point kept here.  The recurrence runs one
step at a time through ``modules.chunked_scan`` (``SCAN_CHUNK`` steps a
chunk), each step a few small torch ops: ``repro``'s is a ``lax.scan``,
not a Pallas kernel.  Its products are elementwise products and sums, not
``bmm``, so a period's selective checkpoint (``remat_policy="dots"``)
saves none of a chunk's steps.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.modules import chunked_scan, dense_init

SCAN_CHUNK = 64
DECAY_LORA = 64
OUT_NORM_EPS = 64e-5        # repro's literal in _out_norm, not cfg.norm_eps


def _heads(cfg):
    if cfg.d_model % cfg.rwkv_head_size:
        raise ValueError(f"{cfg.name}: d_model {cfg.d_model} is not a "
                         f"multiple of rwkv_head_size {cfg.rwkv_head_size}")
    return cfg.d_model // cfg.rwkv_head_size


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class TimeMix(nn.Module):
    """``mu [5, d]``, ``w0 [d]`` (float32), ``wA [d, 64]``, ``wB [64, d]``,
    ``wr``/``wk``/``wv``/``wg``/``wo [d, d]``, ``u [H, N]`` (float32) and
    ``ln_scale [d]``: ``repro``'s ``init_time_mix`` leaves."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        d, H, N = cfg.d_model, _heads(cfg), cfg.rwkv_head_size
        shapes = {"mu": ((5, d), dtype), "w0": ((d,), torch.float32),
                  "wA": ((d, DECAY_LORA), dtype),
                  "wB": ((DECAY_LORA, d), dtype),
                  **{n: ((d, d), dtype) for n in ("wr", "wk", "wv", "wg",
                                                    "wo")},
                  "u": ((H, N), torch.float32), "ln_scale": ((d,), dtype)}
        for name, (shape, dt) in shapes.items():
            self.register_parameter(name, _param(shape, dt, device))

    def reset_parameters(self, generator):
        """``repro``'s distributions: ``mu`` uniform in [0.25, 0.75), ``w0``
        -6, the decay LoRA at scale 0.01, ``u`` normal x 0.1, unit
        ``ln_scale``."""
        dev, dt = self.wr.device, self.wr.dtype
        gdev = generator.device
        d = self.wr.shape[0]
        self.mu.copy_(torch.rand(self.mu.shape, generator=generator,
                                 device=gdev) * 0.5 + 0.25)
        self.w0.fill_(-6.0)
        self.wA.copy_(dense_init(generator, d, DECAY_LORA, dt, scale=0.01,
                                 device=dev))
        self.wB.copy_(dense_init(generator, DECAY_LORA, d, dt, scale=0.01,
                                 device=dev))
        for name in ("wr", "wk", "wv", "wg", "wo"):
            getattr(self, name).copy_(dense_init(generator, d, d, dt,
                                                 device=dev))
        self.u.copy_(torch.randn(self.u.shape, generator=generator,
                                 device=gdev) * 0.1)
        self.ln_scale.fill_(1)


class ChannelMix(nn.Module):
    """``mu [2, d]``, ``wk [d, d_ff]``, ``wv [d_ff, d]``, ``wr [d, d]``:
    ``repro``'s ``init_channel_mix`` leaves."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        for name, shape in (("mu", (2, d)), ("wk", (d, f)), ("wv", (f, d)),
                            ("wr", (d, d))):
            self.register_parameter(name, _param(shape, dtype, device))

    def reset_parameters(self, generator):
        dev, dt = self.wk.device, self.wk.dtype
        self.mu.copy_(torch.rand(self.mu.shape, generator=generator,
                                 device=generator.device) * 0.5 + 0.25)
        for name in ("wk", "wv", "wr"):
            w = getattr(self, name)
            w.copy_(dense_init(generator, w.shape[0], w.shape[1], dt,
                               device=dev))


def _shifted(x, x_prev_last):
    """The token before each of ``x [B, S, d]``: ``x_prev_last`` (zeros
    when None) then ``x[:, :-1]``."""
    B, _, d = x.shape
    first = (x.new_zeros((B, 1, d)) if x_prev_last is None
             else x_prev_last[:, None, :])
    return torch.cat([first, x[:, :-1, :]], dim=1)


def _tm_projections(cfg, p, x, x_prev):
    """Token-shift mix (in float32, cast back) then project.  x, x_prev:
    [..., d].  Returns (r, k, v, w, g); w float32, strictly inside (0, 1)
    and data-dependent."""
    mu = p.mu.float()
    xf, xpf = x.float(), x_prev.float()

    def mix(i):
        return (xf + mu[i] * (xpf - xf)).to(x.dtype)
    r = mix(0) @ p.wr
    k = mix(1) @ p.wk
    v = mix(2) @ p.wv
    wx = mix(3)
    g = mix(4) @ p.wg
    dec = wx @ p.wA
    dec = torch.tanh(dec.float()).to(x.dtype) @ p.wB
    logw = p.w0 + dec.float()
    w = torch.exp(-torch.exp(logw))
    return r, k, v, w, g


def _wkv_step(u, S, r_t, k_t, v_t, w_t):
    """S: [B, H, N, N]; r/k/v/w: [B, H, N], all float32.  Returns (S, y
    [B, H, N])."""
    kv = k_t[..., :, None] * v_t[..., None, :]           # [B, H, N, N]
    y = (r_t[..., :, None] * (S + u[..., None] * kv)).sum(dim=-2)
    S = w_t[..., None] * S + kv
    return S, y


def _wkv_body(u, S, inp):
    return _wkv_step(u, S, *inp)


def time_mix_fwd(cfg, p, x, x_prev_last=None):
    """x: [B, S, d] -> (y, cache {"wkv", "shift"})."""
    B, S, d = x.shape
    H, N = _heads(cfg), cfg.rwkv_head_size
    r, k, v, w, g = _tm_projections(cfg, p, x, _shifted(x, x_prev_last))
    # float32 [S, B, H, N]: repro casts each step's inputs inside the step
    xs = tuple(a.float().reshape(B, S, H, N).transpose(0, 1)
               for a in (r, k, v, w))
    S0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device)
    S_last, ys = chunked_scan(partial(_wkv_body, p.u), S0, xs, SCAN_CHUNK)
    y = ys.transpose(0, 1).reshape(B, S, d)              # float32
    y = _out_norm(cfg, p, y, g)
    return y, {"wkv": S_last, "shift": x[:, -1, :]}


def time_mix_decode(cfg, p, x, cache):
    """x: [B, 1, d]; cache {"wkv", "shift"}, read only.  Returns (y, the
    new cache)."""
    B, _, d = x.shape
    H, N = _heads(cfg), cfg.rwkv_head_size
    r, k, v, w, g = _tm_projections(cfg, p, x[:, 0], cache["shift"])
    S, y = _wkv_step(p.u, cache["wkv"],
                     *(a.float().reshape(B, H, N) for a in (r, k, v, w)))
    y = _out_norm(cfg, p, y.reshape(B, 1, d), g[:, None, :])
    return y, {"wkv": S, "shift": x[:, 0, :]}


def _out_norm(cfg, p, y, g):
    """Per-head group norm (population variance, eps 64e-5), the silu gate,
    then the output projection."""
    H, N = _heads(cfg), cfg.rwkv_head_size
    yh = y.reshape(*y.shape[:-1], H, N)
    mu = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + OUT_NORM_EPS)
    y = yh.reshape(y.shape) * p.ln_scale.float()
    y = y.to(g.dtype) * F.silu(g.float()).to(g.dtype)
    return y @ p.wo


# ---------------------------------------------------------------------------
# channel mix
# ---------------------------------------------------------------------------
def channel_mix_fwd(cfg, p, x, x_prev_last=None):
    """x: [B, S, d] -> (y, cache {"shift"})."""
    return _cm(cfg, p, x, _shifted(x, x_prev_last)), {"shift": x[:, -1, :]}


def channel_mix_decode(cfg, p, x, cache):
    """x: [B, 1, d]; cache {"shift"}, read only.  Returns (y, the new
    cache)."""
    return (_cm(cfg, p, x, cache["shift"][:, None, :]),
            {"shift": x[:, 0, :]})


def _cm(cfg, p, x, prev):
    """Token-shift mix, squared ReLU key, sigmoid receptance."""
    mu = p.mu.float()
    xf, pf = x.float(), prev.float()
    xk = (xf + mu[0] * (pf - xf)).to(x.dtype)
    xr = (xf + mu[1] * (pf - xf)).to(x.dtype)
    k = xk @ p.wk
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    v = k @ p.wv
    r = torch.sigmoid((xr @ p.wr).float()).to(x.dtype)
    return r * v


def init_rwkv_cache(cfg, batch, dtype, device):
    """Zero ``wkv [batch, H, N, N]`` (float32) and the time-mix and
    channel-mix shifts ``[batch, d]``."""
    H, N = _heads(cfg), cfg.rwkv_head_size
    return {
        "wkv": torch.zeros((batch, H, N, N), dtype=torch.float32,
                           device=device),
        "shift_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
        "shift_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
    }
