"""Random weights from the run's seed, made on the device in the type they
are served in, in a few large draws: every leaf that shares an initialiser
(uniform ±1/sqrt(fan_in), normal, truncated normal, a constant) is a view
into one buffer drawn in one call. The trees have the layout the served
program's loaders produce (stacked layers, linear weights (in, out),
torch-layout convs), so the same tree goes to the program and, made again
after the program is gone, to the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class _Ref:
    __slots__ = ("value",)


class _Spec:
    """Collects (shape, init) leaves; `build` draws each init's buffer once."""

    def __init__(self):
        self.leaves: List[Tuple[_Ref, tuple, tuple]] = []

    def add(self, init, shape) -> _Ref:
        ref = _Ref()
        self.leaves.append((ref, tuple(int(s) for s in shape), init))
        return ref

    def build(self, tree, device, dtype, gen: torch.Generator):
        groups: Dict[tuple, list] = {}
        for ref, shape, init in self.leaves:
            groups.setdefault(init, []).append((ref, shape))
        for init in sorted(groups, key=repr):  # a fixed draw order
            members = groups[init]
            n = sum(math.prod(s) for _, s in members)
            kind = init[0]
            if kind == "const":
                buf = torch.full((n,), init[1], dtype=dtype, device=device)
            elif kind == "uniform":
                bound = init[1] ** -0.5
                buf = torch.empty(n, dtype=dtype, device=device).uniform_(-bound, bound,
                                                                         generator=gen)
            elif kind == "normal":
                buf = torch.empty(n, dtype=dtype, device=device).normal_(generator=gen)
            elif kind == "trunc":  # scale · N(0, 1) truncated at ±2
                f = torch.empty(n, dtype=torch.float32, device=device)
                torch.nn.init.trunc_normal_(f, 0.0, 1.0, -2.0, 2.0, generator=gen)
                buf = (init[1] * f).to(dtype)
                del f
            else:
                raise ValueError(f"unknown initialiser {init}")
            off = 0
            for ref, shape in members:
                k = math.prod(shape)
                ref.value = buf[off:off + k].view(shape)
                off += k
        return _resolve(tree)


def _resolve(tree):
    if isinstance(tree, dict):
        return {k: _resolve(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_resolve(v) for v in tree]
    return tree.value


def _encoder_blocks(sp: _Spec, n, d, heads, ffn):
    lin = lambda fan, shape: sp.add(("uniform", fan), shape)  # noqa: E731
    return {"attention": {"wq": lin(d, (n, d, d)), "wk": lin(d, (n, d, d)),
                          "wv": lin(d, (n, d, d)), "wo": lin(d, (n, d, d)),
                          "gate": lin(d, (n, d, d)),
                          "q_norm": sp.add(("const", 1.0), (n, heads, d // heads)),
                          "k_norm": sp.add(("const", 1.0), (n, heads, d // heads))},
            "mlp": {"w1": lin(d, (n, d, ffn)), "w3": lin(d, (n, d, ffn)),
                    "w2": lin(ffn, (n, ffn, d))},
            "attention_norm": sp.add(("const", 1.0), (n, d)),
            "mlp_norm": sp.add(("const", 1.0), (n, d))}


def dit_tree(c: dict) -> Tuple[_Spec, dict]:
    """The EchoDiT tree of config `c` (the config file's `dit` object)."""
    sp = _Spec()
    d, l, h = c["model_size"], c["num_layers"], c["num_heads"]
    dt, ds, r = c["text_model_size"], c["speaker_model_size"], c["adaln_rank"]
    one = lambda shape: sp.add(("const", 1.0), shape)  # noqa: E731
    zero = lambda shape: sp.add(("const", 0.0), shape)  # noqa: E731
    lin = lambda fan, shape: sp.add(("uniform", fan), shape)  # noqa: E731

    def adaln():
        out = {}
        for n in ("shift", "scale", "gate"):
            out[f"{n}_down"] = lin(d, (l, d, r))
            out[f"{n}_up"] = {"w": lin(r, (l, r, d)), "b": zero((l, d))}
        return out

    def patch_encoder():
        pin = c["latent_size"] * c["speaker_patch_size"]
        return {"in_proj": {"w": lin(pin, (pin, ds)), "b": zero((ds,))},
                "blocks": _encoder_blocks(sp, c["speaker_num_layers"], ds, c["speaker_num_heads"],
                                          c["speaker_intermediate_size"])}

    te = c["timestep_embed_size"]
    tree = {
        "text_encoder": {"embedding": sp.add(("normal",), (c["text_vocab_size"], dt)),
                         "blocks": _encoder_blocks(sp, c["text_num_layers"], dt,
                                                   c["text_num_heads"],
                                                   c["text_intermediate_size"])},
        "speaker_encoder": patch_encoder(),
        "text_norm": one((dt,)), "speaker_norm": one((ds,)),
        "cond_module": {"w0": lin(te, (te, d)), "w1": lin(d, (d, d)), "w2": lin(d, (d, 3 * d))},
        "in_proj": {"w": lin(c["latent_size"], (c["latent_size"], d)), "b": zero((d,))},
        "blocks": {
            "attention": {"wq": lin(d, (l, d, d)), "wk": lin(d, (l, d, d)),
                          "wv": lin(d, (l, d, d)), "wo": lin(d, (l, d, d)),
                          "gate": lin(d, (l, d, d)),
                          "wk_text": lin(dt, (l, dt, d)), "wv_text": lin(dt, (l, dt, d)),
                          "wk_speaker": lin(ds, (l, ds, d)), "wv_speaker": lin(ds, (l, ds, d)),
                          "q_norm": one((l, h, d // h)), "k_norm": one((l, h, d // h))},
            "mlp": {"w1": lin(d, (l, d, c["intermediate_size"])),
                    "w3": lin(d, (l, d, c["intermediate_size"])),
                    "w2": lin(c["intermediate_size"], (l, c["intermediate_size"], d))},
            "attention_adaln": adaln(), "mlp_adaln": adaln()},
        "out_norm": one((d,)),
        "out_proj": {"w": lin(d, (d, c["latent_size"])), "b": zero((c["latent_size"],))},
    }
    if c["has_latent_modules"]:
        tree["blocks"]["attention"]["wk_latent"] = lin(ds, (l, ds, d))
        tree["blocks"]["attention"]["wv_latent"] = lin(ds, (l, ds, d))
        tree["latent_encoder"] = patch_encoder()
        tree["latent_norm"] = one((ds,))
    return sp, tree


def ae_tree(c: dict) -> Tuple[_Spec, dict]:
    """The S1-DAC tree of config `c` (the config file's `ae` object)."""
    sp = _Spec()
    tr = lambda shape: sp.add(("trunc", 0.02), shape)  # noqa: E731
    full = lambda v, shape: sp.add(("const", v), shape)  # noqa: E731

    def conv(o, i, k, bias=True):
        p = {"w": tr((o, i, k))}
        if bias:
            p["b"] = full(0.0, (o,))
        return p

    def res_unit(ch):
        return {"snake1": full(1.0, (1, ch, 1)), "conv1": conv(ch, ch, 7),
                "snake2": full(1.0, (1, ch, 1)), "conv2": conv(ch, ch, 1)}

    def convnext(ch):
        return {"dwconv": conv(ch, 1, 7),
                "norm": {"w": full(1.0, (ch,)), "b": full(0.0, (ch,))},
                "pwconv1": {"w": tr((ch, 4 * ch)), "b": full(0.0, (4 * ch,))},
                "pwconv2": {"w": tr((4 * ch, ch)), "b": full(0.0, (ch,))},
                "gamma": full(1e-6, (ch,))}

    def transformer(n, dim, ffn):
        return {"layers": [{
            "attention": {"wqkv": {"w": tr((dim, 3 * dim))}, "wo": {"w": tr((dim, dim))}},
            "feed_forward": {"w1": {"w": tr((dim, ffn))}, "w3": {"w": tr((dim, ffn))},
                             "w2": {"w": tr((ffn, dim))}},
            "attention_norm": {"w": full(1.0, (dim,))}, "ffn_norm": {"w": full(1.0, (dim,))},
            "attention_layer_scale": full(1e-2, (dim,)), "ffn_layer_scale": full(1e-2, (dim,)),
        } for _ in range(n)], "norm": {"w": full(1.0, (dim,))}}

    def vq(size):
        return {"in_proj": conv(c["codebook_dim"], c["latent_dim"], 1),
                "out_proj": conv(c["latent_dim"], c["codebook_dim"], 1),
                "codebook": sp.add(("normal",), (size, c["codebook_dim"]))}

    d = c["latent_dim"]
    enc, dim = [], c["encoder_dim"]
    for i, stride in enumerate(c["encoder_rates"]):
        dim *= 2
        blk = {"res_units": [res_unit(dim // 2) for _ in range(3)],
               "snake": full(1.0, (1, dim // 2, 1)), "down": conv(dim, dim // 2, 2 * stride)}
        if c["encoder_transformer_layers"][i]:
            blk["transformer"] = transformer(c["encoder_transformer_layers"][i], dim, dim * 3)
        enc.append(blk)
    dec, ch = [], c["decoder_dim"]
    for i, stride in enumerate(c["decoder_rates"]):
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        dec.append({"snake": full(1.0, (1, cin, 1)),
                    "up": {"w": tr((cin, cout, 2 * stride)), "b": full(0.0, (cout,))},
                    "res_units": [res_unit(cout) for _ in range(3)]})
    out_ch = ch // 2 ** len(c["decoder_rates"])
    tree = {
        "encoder": {"stem": conv(c["encoder_dim"], 1, 7), "blocks": enc,
                    "head_snake": full(1.0, (1, dim, 1)), "head": conv(d, dim, 3)},
        "decoder": {"stem": conv(ch, d, 7), "blocks": dec,
                    "head_snake": full(1.0, (1, out_ch, 1)), "head": conv(1, out_ch, 7)},
        "quantizer": {
            "semantic": [vq(c["semantic_codebook_size"])],
            "residual": [vq(c["codebook_size"]) for _ in range(c["n_codebooks"])],
            "downsample": [{"conv": conv(d, d, f), "convnext": convnext(d)}
                           for f in c["downsample_factor"]],
            "upsample": [{"conv": {"w": tr((d, d, f)), "b": full(0.0, (d,))},
                          "convnext": convnext(d)} for f in c["downsample_factor"]],
            "pre_module": transformer(c["q_n_layer"], c["q_dim"], c["q_intermediate_size"]),
            "post_module": transformer(c["q_n_layer"], c["q_dim"], c["q_intermediate_size"]),
        },
    }
    return sp, tree


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{"dit", "ae", "pca"} for config file `cfg` from `seed`: the DiT and
    the AE in `cfg["dtype"]` on `device`; the PCA (orthonormal rows of a
    QR, a small mean, scale 1) in float32, drawn on the host."""
    dtype = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    sp, tree = dit_tree(cfg["dit"])
    dit = sp.build(tree, device, dtype, gen)
    sp, tree = ae_tree(cfg["ae"])
    ae = sp.build(tree, device, dtype, gen)
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    d_in, d_out = cfg["ae"]["latent_dim"], cfg["dit"]["latent_size"]
    if d_out <= d_in:
        comp = np.linalg.qr(rng.standard_normal((d_in, d_in)))[0][:d_out]
    else:  # toy widths only: more latents than codec channels
        comp = 0.3 * rng.standard_normal((d_out, d_in))
    pca = {"components": torch.as_tensor(comp, dtype=torch.float32, device=device),
           "mean": torch.as_tensor(rng.standard_normal(cfg["ae"]["latent_dim"]) * 0.01,
                                   dtype=torch.float32, device=device),
           "latent_scale": 1.0}
    return {"dit": dit, "ae": ae, "pca": pca}

