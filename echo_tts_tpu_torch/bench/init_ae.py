"""Random S1-DAC weights on the device (counterpart of
echo_tts_tpu/bench/init_ae.py): the same pytree and distributions
(0.02-scaled normals truncated at ±2, zero biases, unit norms and snakes,
small layer scales), drawn from a torch.Generator, so the numbers differ
from jax.random's."""
from __future__ import annotations

import torch

from echo_tts_tpu_torch.core.config import AEConfig
from echo_tts_tpu_torch.core.device import resolve_device


class _Init:
    def __init__(self, device, seed: int, dtype):
        self.device, self.dtype = device, dtype
        # meta tensors (shapes alone, bench/fast_init.py) take no generator
        self.gen = (None if device.type == "meta"
                    else torch.Generator(device=device).manual_seed(seed))

    def trunc(self, shape, std=0.02):
        w = torch.empty(shape, dtype=torch.float32, device=self.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=self.gen)
        return (std * w).to(self.dtype)

    def normal(self, shape):
        w = torch.empty(shape, dtype=torch.float32, device=self.device)
        return w.normal_(generator=self.gen).to(self.dtype)

    def full(self, shape, value):
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def conv(self, out_ch, in_ch, ks, bias=True):
        p = {"w": self.trunc((out_ch, in_ch, ks))}
        if bias:
            p["b"] = self.full((out_ch,), 0.0)
        return p

    def tconv(self, in_ch, out_ch, ks):
        return {"w": self.trunc((in_ch, out_ch, ks)), "b": self.full((out_ch,), 0.0)}

    def snake(self, ch):
        return self.full((1, ch, 1), 1.0)

    def res_unit(self, ch):
        return {"snake1": self.snake(ch), "conv1": self.conv(ch, ch, 7),
                "snake2": self.snake(ch), "conv2": self.conv(ch, ch, 1)}

    def convnext(self, ch):
        return {
            "dwconv": self.conv(ch, 1, 7),
            "norm": {"w": self.full((ch,), 1.0), "b": self.full((ch,), 0.0)},
            "pwconv1": {"w": self.trunc((ch, 4 * ch)), "b": self.full((4 * ch,), 0.0)},
            "pwconv2": {"w": self.trunc((4 * ch, ch)), "b": self.full((ch,), 0.0)},
            "gamma": self.full((ch,), 1e-6),
        }

    def transformer(self, n_layers, dim, ffn):
        return {"layers": [{
            "attention": {"wqkv": {"w": self.trunc((dim, 3 * dim))},
                          "wo": {"w": self.trunc((dim, dim))}},
            "feed_forward": {"w1": {"w": self.trunc((dim, ffn))},
                             "w3": {"w": self.trunc((dim, ffn))},
                             "w2": {"w": self.trunc((ffn, dim))}},
            "attention_norm": {"w": self.full((dim,), 1.0)},
            "ffn_norm": {"w": self.full((dim,), 1.0)},
            "attention_layer_scale": self.full((dim,), 1e-2),
            "ffn_layer_scale": self.full((dim,), 1e-2),
        } for _ in range(n_layers)], "norm": {"w": self.full((dim,), 1.0)}}

    def vq(self, input_dim, codebook_size, codebook_dim):
        return {"in_proj": self.conv(codebook_dim, input_dim, 1),
                "out_proj": self.conv(input_dim, codebook_dim, 1),
                "codebook": self.normal((codebook_size, codebook_dim))}


def init_ae_params(cfg: AEConfig, dtype: torch.dtype = torch.float32, device=None,
                   seed: int = 0) -> dict:
    ini = _Init(resolve_device(device), seed, dtype)
    d = cfg.latent_dim

    enc_blocks = []
    dim = cfg.encoder_dim
    for i, stride in enumerate(cfg.encoder_rates):
        dim *= 2
        blk = {"res_units": [ini.res_unit(dim // 2) for _ in range(3)],
               "snake": ini.snake(dim // 2),
               "down": ini.conv(dim, dim // 2, 2 * stride)}
        if cfg.encoder_transformer_layers[i] > 0:
            blk["transformer"] = ini.transformer(cfg.encoder_transformer_layers[i], dim, dim * 3)
        enc_blocks.append(blk)

    dec_blocks = []
    ch = cfg.decoder_dim
    for i, stride in enumerate(cfg.decoder_rates):
        in_ch, out_ch = ch // (2 ** i), ch // (2 ** (i + 1))
        dec_blocks.append({"snake": ini.snake(in_ch),
                           "up": ini.tconv(in_ch, out_ch, 2 * stride),
                           "res_units": [ini.res_unit(out_ch) for _ in range(3)]})
    out_ch = cfg.decoder_dim // (2 ** len(cfg.decoder_rates))

    return {
        "encoder": {"stem": ini.conv(cfg.encoder_dim, 1, 7), "blocks": enc_blocks,
                    "head_snake": ini.snake(dim), "head": ini.conv(d, dim, 3)},
        "decoder": {"stem": ini.conv(cfg.decoder_dim, d, 7), "blocks": dec_blocks,
                    "head_snake": ini.snake(out_ch), "head": ini.conv(1, out_ch, 7)},
        "quantizer": {
            "semantic": [ini.vq(d, cfg.semantic_codebook_size, cfg.codebook_dim)],
            "residual": [ini.vq(d, cfg.codebook_size, cfg.codebook_dim)
                         for _ in range(cfg.n_codebooks)],
            "downsample": [{"conv": ini.conv(d, d, f), "convnext": ini.convnext(d)}
                           for f in cfg.downsample_factor],
            "upsample": [{"conv": ini.tconv(d, d, f), "convnext": ini.convnext(d)}
                         for f in cfg.downsample_factor],
            "pre_module": ini.transformer(cfg.q_n_layer, cfg.q_dim, cfg.q_intermediate_size),
            "post_module": ini.transformer(cfg.q_n_layer, cfg.q_dim, cfg.q_intermediate_size),
        },
    }
