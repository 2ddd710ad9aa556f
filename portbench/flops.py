"""The yardstick's arithmetic, frozen here: peaks, FLOPs and bytes.

Copied from the program's ``launch/hlo_analysis.model_flops`` (6·N·D for
training, 2·N per token in inference, the embedding lookup left out,
causal attention's 4·H·Dh·span per token and attention layer on top)
and written against a configuration file of ``configs/``, so that no
later change to the program moves the yardstick. Counts are of the work
the model needs, not of what a kernel happens to do: a padded token, a
dropped expert slot and a re-read byte count nothing.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, without sparsity
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def widths(cfg: dict) -> dict:
    """The sizes the arithmetic needs, from a configuration file."""
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    return {"d": d, "f": cfg["intermediate_size"], "v": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"], "h": h,
            "kv": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim") or d // h,
            "e": cfg.get("num_local_experts", 0),
            "k": cfg.get("num_experts_per_tok", 0),
            "gated": cfg["hidden_act"] == "silu",
            "bias": bool(cfg.get("use_bias", False)),
            "tied": bool(cfg.get("tie_word_embeddings", False)),
            "window": cfg.get("sliding_window") or 0}


def param_count(cfg: dict) -> int:
    """Every parameter, the program's formula term for term (its final
    norm not counted; the dense MLP's biases not counted)."""
    w = widths(cfg)
    d, f, v, L, hd = w["d"], w["f"], w["v"], w["L"], w["hd"]
    n = v * d * (1 if w["tied"] else 2)
    att = d * w["h"] * hd + 2 * d * w["kv"] * hd + w["h"] * hd * d
    if w["bias"]:
        att += w["h"] * hd + 2 * w["kv"] * hd
    mlp = (3 if w["gated"] else 2) * d * f
    if w["e"]:
        mlp = w["e"] * mlp + d * w["e"]
    return n + L * (att + mlp + 2 * d)


def active_param_count(cfg: dict) -> int:
    """Parameters one token runs through: the experts it is not routed
    to left out."""
    w = widths(cfg)
    if not w["e"]:
        return param_count(cfg)
    return param_count(cfg) - w["L"] * (w["e"] - w["k"]) * 3 * w["d"] * w["f"]


def _matmul_params(cfg: dict) -> int:
    """Parameters a token multiplies: the lookup's table left out, save
    where the head is that same table (tied), which is multiplied."""
    w = widths(cfg)
    return active_param_count(cfg) - (0 if w["tied"] else w["v"] * w["d"])


def _attn_per_token(cfg: dict, span: float) -> float:
    w = widths(cfg)
    if w["window"]:
        span = min(span, float(w["window"]))
    return 4.0 * w["h"] * w["hd"] * span * w["L"]


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Forward and backward of ``batch`` sequences of ``seq`` tokens."""
    per_tok = 2.0 * _matmul_params(cfg) + _attn_per_token(cfg, seq / 2)
    return 3.0 * per_tok * batch * seq


def prefill_flops(cfg: dict, prompt_len: int) -> float:
    """One prompt at its own length (causal: the mean span is half)."""
    per_tok = 2.0 * _matmul_params(cfg) + _attn_per_token(cfg,
                                                          prompt_len / 2)
    return per_tok * prompt_len


def decode_flops(cfg: dict, pos: int) -> float:
    """One generated token read against ``pos + 1`` cached positions."""
    return 2.0 * _matmul_params(cfg) + _attn_per_token(cfg, pos + 1)


def request_flops(cfg: dict, prompt_len: int, n_out: int) -> float:
    """A served request: its prompt's prefill and its decoded tokens
    (the first output token comes from the prefill)."""
    return prefill_flops(cfg, prompt_len) + sum(
        decode_flops(cfg, prompt_len + i) for i in range(n_out - 1))


def ring_pack_bytes(n_params: int, compress: str) -> int:
    """Bytes the pack and unpack kernels must move for a flat f32
    gradient of ``n_params`` elements, each byte read once and written
    once: the pack reads the f32 gradient (and, with error feedback, the
    f32 residual), writes the wire (f32, or bf16 with a new f32
    residual); the unpack reads a bf16 wire and writes f32, and an f32
    wire needs no unpack."""
    if compress == "none":
        return 8 * n_params
    if compress == "bf16":
        return (4 + 4 + 2 + 4) * n_params + (2 + 4) * n_params
    raise ValueError(f"no byte count for compress={compress!r}")
