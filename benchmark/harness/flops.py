"""Operation and byte counts from shapes: the work a request, a training
step or a kernel call needs, and the card's published peaks.

Counts are of what the algorithm needs for these inputs: multiply-adds as
2 operations, only the valid (unmasked) keys of an attention, only the
valid tokens of an encoder, and no recomputation (activation
checkpointing re-runs the forward; it is not counted). The served
program's own `utils/profiling.py:dit_step_flops` charges the text and
speaker KV projections and the AdaLN low-rank projections to every latent
token of every step; here the caches are built once a request and AdaLN
once a row a forward (see `benchmark/tests/test_bench_flops.py`).
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3
# bandwidth at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def encoder_flops(layers: int, width: int, ffn: int, tokens: float, keys: float) -> float:
    """Encoder blocks over `tokens` queries, each attending to `keys` keys
    on average: q/k/v/gate/out and SwiGLU products, QK and PV."""
    return layers * (2 * tokens * (5 * width * width + 3 * width * ffn)
                     + 4 * tokens * keys * width)


def kv_flops(c: dict, layers: int, width_in: int, tokens: float) -> float:
    """Per-layer k and v projections of an encoder state into the trunk."""
    return layers * 2 * 2 * tokens * width_in * c["model_size"]


def text_cache_flops(c: dict, tokens: int) -> float:
    return (encoder_flops(c["text_num_layers"], c["text_model_size"], c["text_intermediate_size"],
                          tokens, tokens)
            + kv_flops(c, c["num_layers"], c["text_model_size"], tokens))


def speaker_cache_flops(c: dict, latents: int) -> float:
    """The speaker encoder (patchified, causal) and its caches, over the
    valid prompt latents."""
    n = latents // c["speaker_patch_size"]
    d = c["speaker_model_size"]
    return (2 * n * c["latent_size"] * c["speaker_patch_size"] * d
            + encoder_flops(c["speaker_num_layers"], d, c["speaker_intermediate_size"], n,
                            (n + 1) / 2)
            + kv_flops(c, c["num_layers"], d, n))


def latent_append_flops(c: dict, start: int, new: int) -> float:
    """Appending `new` latents at `start` to the latent-prefix cache: the
    causal latent encoder over the new patches and their trunk caches."""
    p = c["speaker_patch_size"]
    n, pos = new // p, start // p
    d = c["speaker_model_size"]
    return (2 * n * c["latent_size"] * p * d
            + encoder_flops(c["speaker_num_layers"], d, c["speaker_intermediate_size"], n,
                            pos + (n + 1) / 2)
            + kv_flops(c, c["num_layers"], d, n))


def trunk_flops(c: dict, queries: int, keys: float) -> float:
    """One trunk forward of one row: `queries` latents attending to `keys`
    valid keys (their own block and every visible context key)."""
    d, ffn, r = c["model_size"], c["intermediate_size"], c["adaln_rank"]
    te = c["timestep_embed_size"]
    cond = 2 * (te * d + d * d + d * 3 * d) + c["num_layers"] * 6 * 2 * 2 * d * r
    io = 2 * 2 * queries * c["latent_size"] * d
    layer = 2 * queries * (5 * d * d + 3 * d * ffn) + 4 * queries * keys * d
    return cond + io + c["num_layers"] * layer


def cfg_steps(sc: dict) -> int:
    """Steps of the schedule inside the CFG window (three branches each)."""
    ts = (np.linspace(1.0, 0.0, sc["num_steps"] + 1, dtype=np.float32)
          * np.float32(sc["init_scale"])).astype(np.float32)[:-1]
    return int(((ts >= np.float32(sc["cfg_min_t"])) & (ts <= np.float32(sc["cfg_max_t"]))).sum())


def sampler_flops(c: dict, sc: dict, queries: int, text: int, spk_latents: int,
                  prefix: int = 0) -> float:
    """The Euler sampler over one block of `queries` latents: CFG steps run
    [cond, no text, no speaker], the others one branch. `prefix` latents
    before the block are visible through the latent segment."""
    s = spk_latents // c["speaker_patch_size"]
    lat = prefix // c["speaker_patch_size"]
    n_cfg = cfg_steps(sc)
    both = trunk_flops(c, queries, queries + lat + text + s)
    return ((sc["num_steps"] - n_cfg) * both
            + n_cfg * (both + trunk_flops(c, queries, queries + lat + s)
                       + trunk_flops(c, queries, queries + lat + text)))


def _transformer(layers: int, dim: int, ffn: int, t: int, window: int) -> float:
    keys = sum(min(i + 1, window) for i in range(t)) / max(t, 1)
    return layers * (2 * t * (4 * dim * dim + 3 * dim * ffn) + 4 * t * keys * dim)


def _convnext(ch: int, t: int) -> float:
    return 2 * t * (7 * ch + 8 * ch * ch)


def _res_units(ch: int, t: int) -> float:
    return 3 * 2 * t * (7 * ch * ch + ch * ch)


def ae_decode_flops(a: dict, frames: int) -> float:
    """The S1-DAC decode of `frames` latent frames."""
    d = a["latent_dim"]
    f = _transformer(a["q_n_layer"], a["q_dim"], a["q_intermediate_size"], frames,
                     a["q_window_size"])
    t = frames
    for k in reversed(a["downsample_factor"]):
        f += 2 * t * d * d * k
        t *= k
        f += _convnext(d, t)
    ch = a["decoder_dim"]
    f += 2 * t * d * ch * 7
    for s in a["decoder_rates"]:
        f += 2 * t * ch * (ch // 2) * 2 * s
        t *= s
        ch //= 2
        f += _res_units(ch, t)
    return f + 2 * t * ch * 7


def ae_encode_flops(a: dict, samples: int) -> float:
    """The S1-DAC encode (and residual VQ) of `samples` audio samples."""
    t, ch = samples, a["encoder_dim"]
    f = 2 * t * ch * 7
    for i, s in enumerate(a["encoder_rates"]):
        f += _res_units(ch, t)
        t //= s
        f += 2 * t * ch * 2 * ch * 2 * s
        ch *= 2
        if a["encoder_transformer_layers"][i]:
            f += _transformer(a["encoder_transformer_layers"][i], ch, 3 * ch, t,
                              a["enc_window_size"])
    d = a["latent_dim"]
    f += 2 * t * ch * d * 3
    for k in a["downsample_factor"]:
        t //= k
        f += 2 * t * d * d * k + _convnext(d, t)
    f += _transformer(a["q_n_layer"], a["q_dim"], a["q_intermediate_size"], t, a["q_window_size"])
    books = [a["semantic_codebook_size"]] + [a["codebook_size"]] * a["n_codebooks"]
    return f + sum(2 * t * a["codebook_dim"] * (2 * d + k) for k in books)


def attention_call(g: int, b_valid: list, heads: int, s: int, head_dim: int,
                   ctx_rows: list, backward: bool = False):
    """(operations, bytes) one joint-attention call needs. b_valid[i] holds
    row i's valid key count for each branch g (its own block included);
    ctx_rows[i] the union over branches of row i's valid context keys. The
    forward is QK and PV over the valid keys; the backward recomputes
    nothing it could keep: dV, dP, dQ, dK and QK once (2.5 forwards). Bytes:
    q, k_self, v_self and the output (and dO, dQ, dK_self, dV_self, the
    log-sum-exp) in bf16, each row's valid context keys and values once,
    their gradients once."""
    row = heads * s * head_dim * 2
    ops = sum(4 * heads * s * head_dim * v for per in b_valid for v in per)
    by = 4 * g * len(b_valid) * row + sum(2 * heads * t * head_dim * 2 for t in ctx_rows)
    if backward:
        ops *= 2.5
        by = by * 2 + g * len(b_valid) * heads * s * 4
    return ops, by


def bound_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def request_flops(c: dict, a: dict, sc: dict, text: int, spk_latents: int,
                  block_sizes=None) -> float:
    """One served request: its text and speaker caches, the sampler over
    every block, the latent-prefix appends of a stream, and the decode."""
    f = text_cache_flops(c, text) + speaker_cache_flops(c, spk_latents)
    sizes = block_sizes or [sc["sequence_length"]]
    start = 0
    for i, n in enumerate(sizes):
        f += sampler_flops(c, sc, n, text, spk_latents, prefix=start)
        if block_sizes and i + 1 < len(sizes):
            f += latent_append_flops(c, start, n)
        start += n
    return f + ae_decode_flops(a, sc["sequence_length"])


def train_step_flops(c: dict, rows: list, lora_rank: int, lora_shapes: list) -> float:
    """A LoRA step: per row (latents, text, speaker latents) the caches
    (no gradient), the trunk forward, its activation gradients, and the
    adapters' gradients; attention forward and backward over valid keys."""
    d, ffn = c["model_size"], c["intermediate_size"]
    f = 0.0
    for lat, text, spk in rows:
        s = spk // c["speaker_patch_size"]
        f += text_cache_flops(c, text) + speaker_cache_flops(c, spk)
        dense = c["num_layers"] * 2 * lat * (5 * d * d + 3 * d * ffn) + 2 * 2 * lat * 80 * d
        attn = c["num_layers"] * 4 * lat * (lat + text + s) * d
        lora = sum(2 * lat * lora_rank * (i + o) for i, o in lora_shapes)
        f += 2 * dense + attn * 3.5 + 3 * lora
    return f


def mfu_pct(ops: float, seconds: float) -> float:
    return 100.0 * ops / (seconds * PEAK_BF16_FLOPS)
