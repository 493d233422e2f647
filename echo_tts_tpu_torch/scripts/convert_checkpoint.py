"""One-time checkpoint conversion (counterpart of scripts/convert_checkpoint.py):
the reference's safetensors -> an npz of the JAX-layout tree (weight norm
folded, the blockwise modules optionally stripped, the dtype applied), which
both packages load with `load_pytree` (the port then through
`checkpoints/from_jax.py`).

    python -m echo_tts_tpu_torch.scripts.convert_checkpoint dit pytorch_model.safetensors \\
        dit.npz [--delete-blockwise] [--dtype bf16] [--cpu]
    python -m echo_tts_tpu_torch.scripts.convert_checkpoint ae fish.safetensors ae.npz \\
        [--dtype f32] [--cpu]

The DiT is converted on the card (on the CPU with --cpu); prints the JAX
script's line, `wrote <dst>: <n>M params, dtype <name>`.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f16": torch.float16}
_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.float16: "float16"}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from echo_tts_tpu_torch.bench.timing import entry_device
    from echo_tts_tpu_torch.checkpoints.io import (
        load_ae_from_safetensors,
        load_dit_from_safetensors,
        save_pytree,
    )
    from echo_tts_tpu_torch.train.loop import tree_leaves

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kind", choices=["dit", "ae"])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--delete-blockwise", action="store_true")
    ap.add_argument("--dtype", default=None, choices=list(DTYPES))
    ap.add_argument("--cpu", action="store_true", help="convert on the CPU")
    args = ap.parse_args(argv)
    device = entry_device(args.cpu)

    if args.kind == "dit":
        dtype = DTYPES[args.dtype or "bf16"]
        params, cfg = load_dit_from_safetensors(
            args.src, dtype=dtype, delete_blockwise_modules=args.delete_blockwise, device=device)
    else:
        dtype = DTYPES[args.dtype or "f32"]
        params, cfg = load_ae_from_safetensors(args.src, dtype=dtype, device=device)
    save_pytree(args.dst, params)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"wrote {args.dst}: {n / 1e6:.1f}M params, dtype {_NAMES[dtype]}", flush=True)
    return {"params": n, "cfg": cfg}


if __name__ == "__main__":
    main()
