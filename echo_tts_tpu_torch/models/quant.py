"""Trunk GEMM helpers and the opt-in W8A8 int8 trunk (counterpart of
echo_tts_tpu/models/quant.py).

Plain weights are (in, out) and used as `x @ w`. Quantization is dynamic and
symmetric, with no calibration data:

* weights: per-output-channel int8 codes, `scale = amax_K |w| / 127`
  (`quantize_dit_params`, once);
* activations: per-row int8 codes, `scale = amax_D |h| / 127`, computed on
  the fly (`quant_rows`: kernel K5 on the card, `ops/quant_rows.py`);
* product: int8 x int8 -> int32, dequantized as `acc · (s_row · s_col)` into
  the activation's dtype (`qdot`: kernel K4 on the card, `ops/int8_gemm.py`);
  the projections of one activation (`proj_shared`) share one quantization
  and one K4 launch (`int8_gemm_grouped`, up to four weights a launch).

Under tensor parallelism (`parallel/tp.py`) the products take the tp
group of a sharded tree: a row-sharded weight (wo, w2) sees its rows' K
split over the ranks, so `mm` takes each row's scale as the max of the
ranks' (K5's scale-only mode), codes it at that scale (K5's codes mode),
sums the ranks' int32 products (exact) and dequantizes as K4's epilogue
does, `float(acc) · (s_row · s_col)`: tp=2 gives tp=1's bits. A plain
weight's partial products are summed in its dtype.

A quantized leaf is the dict `{"q": int8, "s": fp32 (…, N)}` and the forward
dispatches on it structurally (`mm`, `proj_shared`, `swiglu_mlp_q`), so the
samplers, the pipelines and the engine take quantized params unchanged.

Where the port's leaf differs from the JAX package's: JAX keeps the codes
as the weight lies, (…, K, N); the port stores them K-major, (…, N, K),
because the card's 8-bit tensor-core operands must be K-major (`mma.sync`
takes the B operand of an s8 product only as "col", and `wgmma` has no
transpose for 8-bit types). `quantize_weight` and
`checkpoints/from_jax.py` make that layout once; no call transposes or
packs a weight. The codes and scales are the JAX package's bit for bit.

The trunk's eight projections (wq wk wv gate wo w1 w3 w2) are quantized;
with `encoders=True` also the encoder blocks and the context-KV projections.
Inference only, as in the JAX package (rounding has no useful gradient):
training always runs the plain weights. Apply after any LoRA merge.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

import torch.distributed as dist

from echo_tts_tpu_torch.models.lora_linear import LoRAWeight, side_product
from echo_tts_tpu_torch.ops.int8_gemm import MAX_GROUPS, int8_gemm, int8_gemm_grouped
from echo_tts_tpu_torch.ops.quant_rows import quant_rows, quant_rows_at, quant_rows_scale
from echo_tts_tpu_torch.parallel.tp import all_reduce_, copy_to_tp, reduce_from_tp

_ATTN_KEYS = ("wq", "wk", "wv", "gate", "wo")
_MLP_KEYS = ("w1", "w3", "w2")
_KV_KEYS = ("wk_text", "wv_text", "wk_speaker", "wv_speaker", "wk_latent", "wv_latent")


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def out_dim(w) -> int:
    """Output dimension N of a plain (…, K, N) or quantized weight leaf."""
    return w["s"].shape[-1] if is_quantized(w) else w.shape[-1]


@torch.no_grad()
def quantize_weight(w: torch.Tensor) -> dict:
    """(…, K, N) weight -> {"q": int8 (…, N, K) contiguous, "s": fp32 (…, N)}
    with symmetric per-output-channel scales, as the JAX package's
    `quantize_weight` computes them (fp32, round half to even)."""
    wf = w.float().transpose(-1, -2)
    s = torch.clamp_min(wf.abs().amax(dim=-1, keepdim=True), 1e-12) / 127.0
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8).contiguous()
    return {"q": q, "s": s.squeeze(-1)}


def _quantize_blocks(blocks: dict) -> dict:
    attn = dict(blocks["attention"])
    mlp = dict(blocks["mlp"])
    for k in _ATTN_KEYS:
        attn[k] = quantize_weight(attn[k])
    for k in _MLP_KEYS:
        mlp[k] = quantize_weight(mlp[k])
    return {**blocks, "attention": attn, "mlp": mlp}


def quantize_dit_params(params: dict, encoders: bool = False) -> dict:
    """A new params dict with the trunk's GEMM weight stacks quantized
    (shallow copies along the touched path; the input is unmodified).
    encoders=True also quantizes the text/speaker/latent encoder blocks and
    the per-layer context-KV projections: their noise is frozen into the KV
    caches for every step (check `bench/quant_snr.py --encoders`)."""
    params = dict(params)
    params["blocks"] = _quantize_blocks(params["blocks"])
    if encoders:
        attn = dict(params["blocks"]["attention"])
        for k in _KV_KEYS:
            if k in attn:
                attn[k] = quantize_weight(attn[k])
        params["blocks"] = {**params["blocks"], "attention": attn}
        for enc in ("text_encoder", "speaker_encoder", "latent_encoder"):
            if enc in params:
                params[enc] = {**params[enc], "blocks": _quantize_blocks(params[enc]["blocks"])}
    return params


def qdot(q: torch.Tensor, s_row: torch.Tensor, w: dict, out_dtype: torch.dtype) -> torch.Tensor:
    """int8 rows (…, K) with their fp32 scales (…, 1) times a quantized
    weight -> (…, N) in out_dtype: `float(q·wᵀ) · (s_row · s_col)`."""
    lead = q.shape[:-1]
    out = int8_gemm(q.reshape(-1, q.shape[-1]), s_row.reshape(-1), w["q"], w["s"], out_dtype)
    return out.reshape(*lead, out.shape[-1])


def qdot_tp(h: torch.Tensor, w: dict, group) -> torch.Tensor:
    """h @ w for a quantized row-sharded weight whose K is split over
    `group`: one scale for each whole row (the max of the ranks' K5
    scales), the codes at it, K4's int32 sums added over the ranks, then
    K4's epilogue. Equal bit for bit to `qdot` of the unsharded product."""
    s = all_reduce_(quant_rows_scale(h), op=dist.ReduceOp.MAX, group=group)
    q = quant_rows_at(h, s)
    lead = q.shape[:-1]
    s_row = s.reshape(-1)
    acc = all_reduce_(int8_gemm(q.reshape(-1, q.shape[-1]), s_row, w["q"], w["s"], torch.int32),
                      group=group)
    out = (acc.float() * (s_row[:, None] * w["s"].float()[None, :])).to(h.dtype)
    return out.reshape(*lead, out.shape[-1])


def mm(h: torch.Tensor, w, group=None) -> torch.Tensor:
    """h @ w for a plain, a quantized or a LoRA-adapted weight leaf (the
    adapter as a side product, `models/lora_linear.py`); h's dtype
    out. With a tp `group`, w is row-sharded and h holds this rank's part of
    K: the result is the sum over the group."""
    if isinstance(w, LoRAWeight):
        return reduce_from_tp(side_product(h, w, group, row=True), group)
    if is_quantized(w):
        if group is not None:
            return qdot_tp(h, w, group)
        q, s = quant_rows(h)
        return qdot(q, s, w, h.dtype)
    return reduce_from_tp(h @ w, group)


def proj_shared(h: torch.Tensor, ws: list, group=None) -> list:
    """Several projections of the same activation (q/k/v/gate; w1/w3; a
    context's k/v): quantized weights share one row quantization of h and
    one grouped K4 launch for up to four of them. With a tp `group` the
    weights are column-sharded and h is replicated: its gradient is summed
    over the group."""
    h = copy_to_tp(h, group)
    if not is_quantized(ws[0]):
        return [side_product(h, w, group) if isinstance(w, LoRAWeight) else h @ w for w in ws]
    q, s = quant_rows(h)
    lead = q.shape[:-1]
    q2, s2 = q.reshape(-1, q.shape[-1]), s.reshape(-1)
    outs = []
    for i in range(0, len(ws), MAX_GROUPS):
        outs += int8_gemm_grouped(q2, s2, [(w["q"], w["s"]) for w in ws[i:i + MAX_GROUPS]],
                                  h.dtype)
    return [o.reshape(*lead, o.shape[-1]) for o in outs]


def swiglu_mlp_q(x: torch.Tensor, p: dict, group=None, gated=None) -> torch.Tensor:
    """w2(silu(w1 x) * w3 x); quantized, the gated product is quantized
    again for w2. With a tp `group`, w1/w3 hold this rank's columns and w2
    the matching rows: the result is summed over the group. `gated(u, g)`
    computes silu(u) * g where given (the DiT trunk passes its K8 or plain
    chain, `ops/trunk_rows.py`)."""
    u, g = proj_shared(x, [p["w1"], p["w3"]], group)
    return mm(F.silu(u) * g if gated is None else gated(u, g), p["w2"], group)


# ---------------------------------------------------------------------------
# A saved quantized base (Engine(int8_cache_path=...), serve --int8-cache)
# ---------------------------------------------------------------------------

INT8_CACHE_FORMAT = "echo_tts_tpu_torch int8 base: q int8 (..., N, K), s fp32 (..., N)"


def _meta_like(tree):
    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta_like(v) for v in tree]
    return torch.empty_like(tree, device="meta")


def _cache_meta(cfg, encoders: bool) -> str:
    import dataclasses
    import json

    return json.dumps({"format": INT8_CACHE_FORMAT, "encoders": bool(encoders),
                       "dit_config": dataclasses.asdict(cfg)}, sort_keys=True)


def save_quantized(path: str, qparams: dict, cfg, encoders: bool = False) -> None:
    """The quantized params of `quantize_dit_params(..., encoders)` for the
    DiT of `cfg`, in the leaf-order npz of `checkpoints/io.py`, with the
    format, the flag and the config beside them. The file is the port's own:
    its codes are K-major, which is not the JAX package's layout."""
    from echo_tts_tpu_torch.checkpoints.io import save_tree_leaves

    save_tree_leaves(path, qparams, meta=_cache_meta(cfg, encoders))


def load_quantized(path: str, base_params: dict, cfg, encoders: bool = False) -> dict:
    """A `save_quantized` file for `base_params` (the plain params of `cfg`),
    on their device, without quantizing: the structure, shapes and dtypes
    come from `quantize_dit_params` run on meta tensors. Raises ValueError
    when the file was written for another config, another `encoders` or
    another format, or a leaf's shape differs."""
    from echo_tts_tpu_torch.checkpoints.io import load_pytree_like, read_tree_meta
    from echo_tts_tpu_torch.train.loop import tree_leaves

    want, got = _cache_meta(cfg, encoders), read_tree_meta(path)
    if got != want:
        raise ValueError(f"int8 cache {path} does not match this model: it was written for "
                         f"{got}, this engine needs {want}")
    template = quantize_dit_params(_meta_like(base_params), encoders=encoders)
    return load_pytree_like(path, template, device=tree_leaves(base_params)[0].device)
