"""Serving driver of the port: batched greedy decoding with KV caches
(mirrors ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --batch 4 --prompt-len 32 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced   # card

Runs on the card; ``--device cpu`` runs on the CPU.  ``--no-reduced``
keeps the published widths and ``--layers`` cuts depth.  Every config
serves: MLA decodes against its latent cache; Qwen2-VL decodes text
only; whisper's decoder reads the encoder's output over zero frames,
computed in f32 as the reference's CLI does; Jamba's Mamba layers and
xLSTM's mLSTM and sLSTM layers decode against their recurrent states
(f32, whatever the caches' dtype).  The flash-attention kernel belongs
to the full-sequence forward (``launch/steps.py::make_prefill_step``
with ``use_flash`` set on the config) of GQA attention layers without a
sliding window, as in the reference: MLA and Mixtral's window bypass
it, so do the encoder, the cross-attention and the recurrent mixers, and
decoding feeds one token at a time and never reaches it.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import model as M
from repro_torch.models import transformer as T


def generate(cfg, params, prompt: torch.Tensor, gen_len: int,
             extra_batch=None, cache_len: int = 0) -> torch.Tensor:
    """Greedy decode: feeds the prompt token by token (prefill through the
    decode path, as the reference does), then takes the argmax.  The
    entries of ``extra_batch`` (e.g. ``encoder_out``) join every decode
    step's batch.  Returns the prompt and the generated tokens,
    (B, S + gen_len)."""
    B, S = prompt.shape
    extra = extra_batch or {}
    with torch.inference_mode():
        caches = M.init_caches(cfg, B, cache_len or (S + gen_len),
                               dtype=torch.float32, device=prompt.device)
        serve = make_serve_step(cfg)
        tok = prompt[:, :1]
        out = [tok]
        for t in range(S + gen_len - 1):
            nxt, caches = serve(params, {"tokens": tok, **extra}, caches)
            tok = (prompt[:, t + 1:t + 2] if t + 1 < S
                   else nxt[:, None].to(prompt.dtype))
            out.append(tok)
        return torch.cat(out, dim=1)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="tiny smoke widths (--no-reduced: published widths)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0 = keep)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> torch.Tensor:
    args = parse_args(argv)
    run = get_config(args.arch)
    cfg = reduced(run.model) if args.reduced else run.model
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = M.init_params(args.seed, cfg, device=args.device)
    device = params["embed"].device
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device, dtype=torch.int32)
    extra = {}
    if cfg.encoder is not None:
        frames = torch.zeros((args.batch, cfg.encoder.n_frames, cfg.d_model),
                             device=device)
        with torch.inference_mode():
            extra["encoder_out"] = T.encoder_forward(params["encoder"],
                                                     frames, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    out = generate(cfg, params, prompt, args.gen, extra_batch=extra)
    sample = out[0, -min(16, args.gen):].tolist()   # waits for the device
    dt = time.time() - t0
    n_new = args.batch * args.gen
    print(f"[{args.arch}] generated {n_new} tokens in {dt:.1f}s "
          f"({n_new / dt:.1f} tok/s)")
    print("sample:", sample)
    if out.shape != (args.batch, args.prompt_len + args.gen):
        raise RuntimeError(f"output shape {tuple(out.shape)}")
    if int(out.max()) >= cfg.vocab_size or int(out.min()) < 0:
        raise RuntimeError("a generated token lies outside the vocabulary")
    return out


if __name__ == "__main__":
    main()
