"""Architecture and shape configuration schema.

Every assigned architecture is one ``ArchConfig`` in its own module under
``repro_torch.configs``; the four assigned input shapes are ``ShapeConfig``
presets.  ``reduced()`` produces the CPU-smoke-test variant of any arch
(same family/topology, tiny dims).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention details
    head_dim: int | None = None            # default d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_window: int | None = None         # SWA window (None = full)
    rope_theta: float = 10000.0

    # MoE
    n_experts: int = 0
    experts_per_token: int = 2
    capacity_factor: float = 1.25

    # layer pattern, cycled over the depth. kinds:
    #   attn (self-attn + ffn/moe), mamba2, slstm, mlstm,
    #   shared_attn (zamba2 shared transformer block),
    #   cross_attn (vlm image cross-attention + ffn)
    block_pattern: tuple[str, ...] = ("attn",)

    # SSM
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4

    # modality frontends (stubs: precomputed embeddings via input_specs)
    frontend: str | None = None            # vision | audio | None
    num_frontend_tokens: int = 0           # e.g. image patch tokens

    # misc
    act: str = "silu"
    ffn_gated: bool = True                 # GLU (3 mats) vs plain MLP (2)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # long-context support: archs whose state is bounded (SSM / SWA) can
    # run the long_500k cell; pure full-attention archs cannot.
    long_context_ok: bool = False
    # documented deviation: window applied to attn blocks in long shapes
    long_context_window: int | None = None

    source: str = ""

    # ---------------- derived ----------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_kinds(self) -> list[str]:
        p = self.block_pattern
        return [p[i % len(p)] for i in range(self.n_layers)]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return max(self.d_inner // self.ssm_head_dim, 1)

    # ---- parameter counts (for MODEL_FLOPS = 6·N·D) ----
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim_
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + bias

    def _ffn_params(self) -> int:
        return (3 if self.ffn_gated else 2) * self.d_model * self.d_ff

    def _moe_params(self, active: bool) -> int:
        e = self.experts_per_token if active else self.n_experts
        return e * self._ffn_params() + self.d_model * self.n_experts

    def _mamba_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        in_proj = d * (2 * di + 2 * n + h)   # z, x, B, C, dt
        conv = (di + 2 * n) * self.conv_width
        out = di * d
        return in_proj + conv + out + 2 * h  # + A, D per head

    def _mlstm_params(self) -> int:
        d, di = self.d_model, self.d_inner
        h = self.ssm_heads
        # q,k,v + i,f gates + output gate + out-projection
        return d * 3 * di + d * 2 * h + d * di + di * d

    def _slstm_params(self) -> int:
        d, di = self.d_model, self.d_inner
        return 4 * d * di + di * d  # z,i,f,o + out

    def layer_params(self, kind: str) -> int:
        if kind == "attn":
            ff = self._moe_params(False) if self.n_experts else self._ffn_params()
            return self._attn_params() + ff
        if kind in ("shared_attn", "cross_attn"):
            return self._attn_params() + self._ffn_params()
        if kind == "mamba2":
            return self._mamba_params()
        if kind == "mlstm":
            return self._mlstm_params()
        if kind == "slstm":
            return self._slstm_params()
        raise ValueError(kind)

    def layer_active_params(self, kind: str) -> int:
        if kind == "attn" and self.n_experts:
            return self._attn_params() + self._moe_params(True)
        return self.layer_params(kind)

    def param_count(self) -> int:
        kinds = self.layer_kinds()
        shared_counted = False
        total = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        for k in kinds:
            if k == "shared_attn":
                if not shared_counted:
                    total += self.layer_params(k)
                    shared_counted = True
                total += self.d_model * self.d_model  # per-use projection
            else:
                total += self.layer_params(k)
        return total

    def active_param_count(self) -> int:
        kinds = self.layer_kinds()
        shared_counted = False
        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        for k in kinds:
            if k == "shared_attn":
                if not shared_counted:
                    total += self.layer_params(k)
                    shared_counted = True
                total += self.d_model * self.d_model
            else:
                total += self.layer_active_params(k)
        return total

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        pattern_period = len(self.block_pattern)
        n_layers = max(pattern_period, 2)
        d_model = 64
        n_heads = 4
        n_kv = max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads < self.n_heads else n_heads
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4),
            capacity_factor=8.0,   # drop-free at smoke-test sizes
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            attn_window=min(self.attn_window, 16) if self.attn_window else None,
            num_frontend_tokens=min(self.num_frontend_tokens, 8),
            long_context_window=(16 if self.long_context_window else None),
            param_dtype="float32",
            compute_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable?, reason) for an (arch × shape) cell — encodes the
    long_500k sub-quadratic requirement (DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return False, ("pure full-attention arch: 512K KV state unbounded; "
                       "skipped per assignment (see DESIGN.md)")
    return True, ""
