"""LoRA finetuning from checkpoint files (counterpart of scripts/finetune_lora.py):
transcripts -> dataset (audio pre-encoded to latents through the S1-DAC)
-> LoRA r16 / alpha 32 -> AdamW 5e-5 with warmup-cosine -> the adapter of
the best validation loss.

    python -m echo_tts_tpu_torch.scripts.finetune_lora --audio-dir DIR \\
        --transcripts t.json --dit dit.safetensors --ae ae.safetensors \\
        --pca pca.safetensors --out lora_best.npz [--epochs 20] [--rank 16] [--lr 5e-5]

Without --transcripts the clips are transcribed by ASR
(`train/data.py:transcribe_audio_files`). On the card the DiT trains in
bf16 and the AE encodes in bf16; on the CPU (--cpu) both run in fp32.
Prints a line an epoch, then one JSON line (the losses of every step and
epoch, the best validation loss, the adapter's path).
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--audio-dir", required=True)
    ap.add_argument("--transcripts", help="json {audio_path: text}; omit to run ASR")
    ap.add_argument("--dit", required=True)
    ap.add_argument("--ae", required=True)
    ap.add_argument("--pca", required=True)
    ap.add_argument("--out", default="lora_best.npz")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=32.0)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--val-frac", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU")
    return ap.parse_args(argv)


def prepare(args: argparse.Namespace) -> dict:
    """The run's state before its first step: the loaded models, the
    train/validation datasets, the configs and the data-order rng (after
    the shuffle that splits the samples)."""
    from echo_tts_tpu_torch.bench.timing import entry_device
    from echo_tts_tpu_torch.checkpoints.io import (
        load_ae_from_safetensors,
        load_dit_from_safetensors,
    )
    from echo_tts_tpu_torch.models.pca import PCAState
    from echo_tts_tpu_torch.train.data import (
        AUDIO_EXTENSIONS,
        EchoTTSDataset,
        prepare_samples_from_directory,
        transcribe_audio_files,
    )
    from echo_tts_tpu_torch.train.loop import TrainConfig
    from echo_tts_tpu_torch.train.lora import LoRAConfig

    device = entry_device(args.cpu)
    model_dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    dit_params, dit_cfg = load_dit_from_safetensors(
        args.dit, delete_blockwise_modules=True, dtype=model_dtype, device=device)
    # the AE in bf16 on the card, where K2 takes bf16 activations
    ae_params, ae_cfg = load_ae_from_safetensors(args.ae, dtype=model_dtype, device=device)
    pca = PCAState.from_safetensors(args.pca, device=device)

    if args.transcripts:
        with open(args.transcripts) as f:
            transcripts = json.load(f)
    else:
        from pathlib import Path

        paths = [str(p) for ext in AUDIO_EXTENSIONS for p in Path(args.audio_dir).glob(f"*{ext}")]
        transcripts = transcribe_audio_files(sorted(paths))

    samples = prepare_samples_from_directory(args.audio_dir, transcripts)
    print(f"{len(samples)} samples", flush=True)
    rng = np.random.default_rng(args.seed)
    rng.shuffle(samples)
    n_val = max(1, int(len(samples) * args.val_frac))
    val_samples, train_samples = samples[:n_val], samples[n_val:]
    ds = EchoTTSDataset(train_samples, ae_params, ae_cfg, pca)
    val_ds = EchoTTSDataset(val_samples, ae_params, ae_cfg, pca)

    steps_per_epoch = max(1, len(ds) // args.batch_size)
    return {"device": device, "model_dtype": model_dtype, "dit_params": dit_params,
            "dit_cfg": dit_cfg, "ds": ds, "val_ds": val_ds, "rng": rng,
            "lc": LoRAConfig(rank=args.rank, alpha=args.alpha),
            "tc": TrainConfig(learning_rate=args.lr, warmup_steps=steps_per_epoch,
                              total_steps=steps_per_epoch * args.epochs)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from echo_tts_tpu_torch.train.data import batches, batches_prefetch
    from echo_tts_tpu_torch.train.loop import make_train_step
    from echo_tts_tpu_torch.train.lora import apply_lora, init_lora, save_lora_checkpoint
    from echo_tts_tpu_torch.train.loss import compute_diffusion_loss

    args = parse_args(argv)
    run = prepare(args)
    device, model_dtype, dit_params, dit_cfg = (run["device"], run["model_dtype"],
                                                run["dit_params"], run["dit_cfg"])
    lc, rng = run["lc"], run["rng"]
    lora = init_lora(torch.Generator(device=device).manual_seed(args.seed), dit_params, lc)
    opt, step = make_train_step(dit_cfg, run["tc"], model_dtype=model_dtype, lora_cfg=lc)
    opt_state = opt.init(lora)

    @torch.no_grad()
    def val_loss(lora) -> float:
        params_eff = apply_lora(dit_params, lora, lc)
        tot, n = 0.0, 0
        for b in batches(run["val_ds"], args.batch_size, np.random.default_rng(0)):
            jb = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
            tot += float(compute_diffusion_loss(
                params_eff, dit_cfg, torch.Generator(device=device).manual_seed(0),
                jb["latent"], jb["latent_mask"], jb["text_input_ids"], jb["text_mask"],
                jb["speaker_latent"], jb["speaker_mask"], model_dtype=model_dtype))
            n += 1
        return tot / max(n, 1)

    best = float("inf")
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    step_losses, epochs = [], []
    for epoch in range(args.epochs):
        tot, n = 0.0, 0
        # a producer thread collates the next batches while the device steps
        for b in batches_prefetch(run["ds"], args.batch_size, rng, prefetch=2):
            lora, opt_state, loss = step(dit_params, lora, opt_state, gen, b)
            step_losses.append(float(loss))
            tot += step_losses[-1]
            n += 1
        vl = val_loss(lora)
        epochs.append({"epoch": epoch, "train": tot / max(n, 1), "val": vl})
        print(f"epoch {epoch}: train {tot / max(n, 1):.4f} val {vl:.4f}", flush=True)
        if vl < best:
            best = vl
            save_lora_checkpoint(args.out, lora, lc, extra={"epoch": epoch, "val_loss": vl})
            print(f"  saved {args.out}", flush=True)
    summary = {"steps": len(step_losses), "step_losses": step_losses, "epochs": epochs,
               "best_val_loss": best if math.isfinite(best) else None, "out": args.out,
               "device": str(device)}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
