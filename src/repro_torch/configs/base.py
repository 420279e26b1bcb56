"""Architecture config system: a plain-data copy of ``repro.configs.base``.

Every architecture is a frozen ``ArchConfig`` registered under its public id
(``--arch <id>``).  Configs are *data only* — model code interprets them
(``repro_torch.models.transformer``).  ``reduced()`` returns the smoke-test
variant (2 layers, d_model<=512, <=4 experts).

The port registers the architectures whose layers it has; the others that
``repro`` registers raise ``NotImplementedError`` from ``get_config``,
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Sequence

# ---------------------------------------------------------------------------
# Sub-layer kinds (per position inside one scan period)
# ---------------------------------------------------------------------------
MIXER_ATTN = "attn"           # softmax attention (GQA / MHA / SWA / chunked)
MIXER_ATTN_GLOBAL = "attn_global"  # full-context attention inside a local arch
MIXER_MLA = "mla"             # DeepSeek multi-head latent attention
MIXER_MAMBA = "mamba"         # selective SSM
MIXER_RWKV = "rwkv"           # RWKV6 time-mix

MLP_DENSE = "dense"
MLP_MOE = "moe"
MLP_RWKV = "rwkv_cm"          # RWKV channel-mix (token-shifted squared-relu)


@dataclass(frozen=True)
class SubLayer:
    """One (mixer, mlp) pair inside a scan period."""
    mixer: str
    mlp: str


@dataclass(frozen=True)
class ArchConfig:
    # identity -------------------------------------------------------------
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    source: str                      # citation bracket from the assignment
    # trunk ------------------------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    d_ff: int = 0                    # dense-MLP hidden size
    vocab_size: int = 0
    norm_eps: float = 1e-5
    qkv_bias: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # attention variants -----------------------------------------------------
    sliding_window: Optional[int] = None   # SWA width (None = full)
    attn_chunk: Optional[int] = None       # chunked/local attention width
    global_attn_every: int = 0             # 0 = never; k -> every k-th sublayer global
    # MLA (DeepSeek) -----------------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0                   # 0 -> full-rank q projection
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = False               # absorbed decode (beyond-paper perf opt)
    # MoE ----------------------------------------------------------------------
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 0                     # k -> sublayer idx % k == k-1 is MoE; 1 -> all
    first_k_dense: int = 0                 # leading layers forced dense (DeepSeek)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    # hybrid / SSM ---------------------------------------------------------------
    attn_every: int = 0                    # jamba: one attention layer per k
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_size: int = 64
    # modality frontend (stubbed per the brief's carve-out) ----------------------
    frontend: Optional[str] = None         # None | 'vision' | 'audio'
    n_frontend_tokens: int = 0             # prefix embeddings supplied by the stub
    # distribution / memory knobs --------------------------------------------------
    shard_activations: bool = False        # with_sharding_constraint d_model->model
                                           # between layers (sequence-parallel analog)
    microbatches: int = 1                  # grad-accumulation splits of the batch
    grad_accum_dtype: str = "float32"      # bf16 halves accumulator HBM (405B)
    remat_sublayer: bool = False           # checkpoint each sublayer (not just
                                           # the period) — heavy hybrid periods
    no_remat: bool = False                 # skip layer-scan checkpointing
                                           # (small models: trade HBM for the
                                           # ~fwd-worth of recompute FLOPs)
    remat_policy: str = "full"             # full | dots (save matmul outputs,
                                           # recompute elementwise only)
    loss_chunk: int = 0                    # 0: materialise the [B,S,V] logits;
                                           # >0: vocab-chunked CE in chunks of
                                           # this many columns (opt-in)
    # misc -----------------------------------------------------------------------
    scan_period: int = 1                   # layers per scan step (heterogeneous stacks)
    notes: str = ""

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return all(s.mixer == MIXER_RWKV for s in self.sublayers())

    @property
    def supports_long_context(self) -> bool:
        """True iff a 500k-token decode is legal (sub-quadratic / local attention)."""
        kinds = {s.mixer for s in self.sublayers()}
        if kinds <= {MIXER_RWKV, MIXER_MAMBA}:
            return True
        if self.attn_every:
            return True  # hybrid: SSM-dominant, sparse attention is O(S)/step
        if MIXER_MLA in kinds:
            return False
        if MIXER_ATTN in kinds and self.sliding_window is None and self.attn_chunk is None:
            return False
        return True  # SWA / chunked (+ optional sparse globals) or hybrid SSM

    @property
    def n_periods(self) -> int:
        assert (self.n_layers - self.first_k_dense) % self.scan_period == 0, self.name
        return (self.n_layers - self.first_k_dense) // self.scan_period

    def sublayers(self) -> Sequence[SubLayer]:
        """The (mixer, mlp) pattern of ONE scan period."""
        subs = []
        for j in range(self.scan_period):
            if self.attn_every:  # hybrid (jamba): attention once per attn_every
                mixer = MIXER_ATTN if (j % self.attn_every) == self.attn_every // 2 \
                    else MIXER_MAMBA
            elif self.family == "ssm":
                mixer = MIXER_RWKV
            elif self.use_mla:
                mixer = MIXER_MLA
            elif self.global_attn_every and (j % self.global_attn_every) == \
                    self.global_attn_every - 1:
                mixer = MIXER_ATTN_GLOBAL
            else:
                mixer = MIXER_ATTN
            if self.family == "ssm":
                mlp = MLP_RWKV
            elif self.moe_every and (j % self.moe_every) == self.moe_every - 1:
                mlp = MLP_MOE
            else:
                mlp = MLP_DENSE
            subs.append(SubLayer(mixer, mlp))
        return tuple(subs)

    def prefix_sublayer(self) -> SubLayer:
        """Structure of the unrolled leading dense layers (first_k_dense)."""
        base = self.sublayers()[0]
        return SubLayer(base.mixer, MLP_DENSE)

    # -- variants ---------------------------------------------------------------
    def variant(self, **kw) -> "ArchConfig":
        return replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        head_dim = max(d // n_heads, 32)
        ratio = max(self.n_heads // max(self.n_kv_heads, 1), 1)
        n_kv = max(n_heads // ratio, 1)
        # keep the heterogeneous pattern but shrink the period to 2 so the
        # smoke variant is a genuine 2-layer model (one scan period).
        period = min(self.scan_period, 2)
        kw = dict(
            n_layers=2 + self.first_k_dense,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            scan_period=period,
        )
        if self.attn_every:
            kw.update(attn_every=2)         # pattern: [mamba, attn]
        if self.global_attn_every:
            kw.update(global_attn_every=2)  # pattern: [chunked, global]
        if self.n_routed_experts:
            kw.update(
                n_routed_experts=min(self.n_routed_experts, 4),
                n_shared_experts=min(self.n_shared_experts, 1),
                moe_top_k=min(self.moe_top_k, 2),
                moe_d_ff=min(self.moe_d_ff, 256),
            )
        if self.use_mla:
            kw.update(kv_lora_rank=64, q_lora_rank=0, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32, head_dim=0)
        if self.sliding_window:
            kw.update(sliding_window=64)
        if self.attn_chunk:
            kw.update(attn_chunk=64)
        if self.frontend:
            kw.update(n_frontend_tokens=min(self.n_frontend_tokens, 16))
        if self.family == "ssm":
            kw.update(rwkv_head_size=32)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


# registered by ``repro`` but not ported yet: their mixers (Mamba, RWKV)
# and LayerNorm stacks have no port
UNPORTED = ("jamba-v0.1-52b", "rwkv6-1.6b")


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name in UNPORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP queue 1, item 12: "
            f"the transformer extension); ported: {sorted(_REGISTRY)}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_lite_16b, internvl2_2b, llama3_405b,
        llama4_scout_17b_a16e, mistral_nemo_12b, musicgen_large, qwen1_5_4b,
        smollm_360m,
    )
    _LOADED = True
