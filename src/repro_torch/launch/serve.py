"""Batched serving CLI: prefill a batch of prompts, then decode
autoregressively with the KV cache (a ring cache under a sliding window).

PyTorch counterpart of ``repro.launch.serve``, with the same flags and
defaults plus ``--device`` (default: the card; ``cpu`` runs the plain
versions of the kernels). The port serves the dense family (qwen3-14b,
qwen2.5-14b, starcoder2-15b):

    PYTHONPATH=src python -m repro_torch.launch.serve --preset tiny --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --preset full

Weights are random, drawn from ``--seed`` on the device; the prompt is
random ids drawn from seed 1. Greedy decoding (``--temperature 0``)
gives the same ids as the JAX package for the same weights and prompt.
Temperature sampling draws Gumbel noise from a ``torch.Generator`` keyed
by the seed and the step. Prints the JAX CLI's two lines, then the
decode rate in tokens/s and the peak device memory.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import ARCHS, preset_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, build_model


def _sample(logits: torch.Tensor, temperature: float, seed: int,
            step: int) -> torch.Tensor:
    """One categorical draw per row of logits / temperature (Gumbel-max),
    from a generator keyed by (seed, step)."""
    gen = torch.Generator(device=logits.device).manual_seed(
        (seed + 2) * 1_000_003 + step)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / temperature + gumbel, dim=-1,
                        keepdim=True)


def generate(model: Model, params, tokens: torch.Tensor, gen: int, *,
             temperature: float = 0.0, seed: int = 0) -> dict:
    """Prefill ``tokens`` (B, S), then decode until ``gen`` tokens are out
    (the first from the prefill's logits). Times both phases on the
    tokens' device (synchronized on the card). Returns the generated ids
    (B, gen), the prefill logits, the final cache and the two times in
    seconds."""
    cfg = model.config
    b, s = tokens.shape
    total = s + gen
    length = min(total, cfg.window) if cfg.window else total
    cuda = tokens.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(tokens.device)

    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens},
                                      length=length)
        sync()
        t_prefill = time.perf_counter() - t0
        prefill_logits = logits
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out: List[torch.Tensor] = [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = model.decode_step(params, cache, tok, s + i)
            if temperature > 0:
                tok = _sample(logits[:, -1], temperature, seed, i)
            else:
                tok = torch.argmax(logits[:, -1:], dim=-1)
            out.append(tok)
        sync()
        t_decode = time.perf_counter() - t0
    return {"ids": torch.cat(out, dim=1), "prefill_logits": prefill_logits,
            "cache": cache, "t_prefill": t_prefill, "t_decode": t_decode}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen3-14b")
    ap.add_argument("--preset", choices=["tiny", "100m", "full"],
                    default="tiny")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    model = build_model(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(args.seed, dev)
    b, s = args.batch, args.prompt_len
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    r = generate(model, params, tokens, args.gen,
                 temperature=args.temperature, seed=args.seed)
    t_prefill, t_decode = r["t_prefill"], r["t_decode"]
    print(f"arch={cfg.arch} prefill {s} toks x{b}: {t_prefill*1e3:.1f} ms; "
          f"decode {args.gen} toks: {t_decode*1e3:.1f} ms "
          f"({t_decode/max(args.gen-1,1)*1e3:.2f} ms/tok)")
    print("generated ids[0,:16]:", r["ids"][0, :16].tolist())
    rate = b * (args.gen - 1) / t_decode if args.gen > 1 else 0.0
    if dev.type == "cuda":
        peak = f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"
        where = torch.cuda.get_device_name(dev)
    else:
        peak, where = "not measured (cpu)", "cpu"
    print(f"device {where}: decode {rate:.1f} tokens/s (batch {b}); "
          f"peak device memory {peak}")
    return r


if __name__ == "__main__":
    main()
