"""Federated LM training driver (real execution).

PyTorch counterpart of ``repro.launch.train``, with the same flags,
defaults, help texts and printed lines, plus ``--device`` (default: the
card; ``cpu`` runs the plain versions of the kernels). Clients hold
Dirichlet-partitioned shards of a synthetic token stream; each round
computes the client gradients of the model's ``loss_fn``, passes them
through the simulated OTA MAC and applies the adaptive server update.

The training state lives as a slab-resident ``SlabTrainState`` across
rounds, and ``run_rounds_slab`` drives ``make_slab_round_runner`` in
chunks of ``--scan-rounds`` rounds (a host loop; the JAX package scans
them). Checkpoints (``--ckpt-dir``, every ``--ckpt-every`` rounds) store
the slabs raw with a layout fingerprint, in the JAX package's npz
format; ``--resume`` continues bitwise from the latest one: the draws
(``TorchDraws``, Philox) and the batches are keyed by the absolute
round. ``--uplink`` / ``--downlink`` / ``--error-feedback`` /
``--sign-pack`` / ``--sr-inkernel`` pick the wire, ``--client-chunk`` /
``--sample-rate`` / ``--client-weights`` / ``--double-buffer`` the
streamed client axis, and ``--alpha-opt`` / ``--track-alpha`` the
optimizer's tail index (a float, or tracked online), as in the JAX CLI.

``--backend pallas_sharded --mesh P`` (or ``A,B``) runs the sharded
engine (``repro_torch.core.shard``) on a client mesh of that shape
(default ``2``, as in the JAX CLI), with ``--comm-buckets`` for its
overlap engine. Each rank is a process with one device
(``launch.mesh.run_on_mesh``): under ``--device cpu`` P workers over
gloo; on the cards one rank a card over NCCL, so one H100 runs
``--mesh 1`` (in this process) and a larger mesh is refused. Rank 0
prints and writes the checkpoints, which hold the gathered (resident)
state, the same file whatever the mesh; a resume hands each rank its
slices again.

What has no meaning here is refused by name: ``--no-interpret`` (the
port has no Pallas interpret mode), ``--no-donate`` and
``--donation-report`` (no XLA buffer donation: the slabs update in
place) and ``--backend jnp`` (no backend switch: the device decides).
``--backend`` accepts ``pallas``, its default, and ``pallas_sharded``.
The dense, moe, mla, rwkv and hybrid families train. The vlm
(llama-3.2-vision-11b) and encdec (whisper-medium) archs are refused by
name: the CLI's batches hold tokens only, as the JAX CLI's do (on which
those models fail), and these families need ``image_embed`` /
``audio_embed`` in every batch; they train through the round API
(``make_slab_round_runner`` + ``run_rounds_slab``) with batches that
carry them.

    PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
        --rounds 3 --clients 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
        --rounds 3 --clients 4 --device cpu --backend pallas_sharded --mesh 2
    PYTHONPATH=src python -m repro_torch.launch.train --preset 100m --rounds 300
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.checkpoint as ckpt
from repro_torch.configs import (ARCHS, PORT_ARCHS, get_config,
                                 preset_config)
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                 run_rounds_slab)
from repro_torch.core.shard import (client_axes_of, gather_train_state,
                                    linear_shard_index, n_client_shards,
                                    shard_train_state)
from repro_torch.core.slab import make_slab_spec
from repro_torch.core.slab_state import SlabTrainState, init_train_state
from repro_torch.data import dirichlet_partition, token_stream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import check_cards, parse_mesh, run_on_mesh
from repro_torch.models.model import build_model

CORPUS_TOKENS = 2_000_000
N_DOMAINS = 16


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's parser, flag for flag, with ``--backend`` defaulting
    to ``pallas`` and ``--device`` added (``--sign-pack``'s help drops
    the JAX text's note of when its int8 container came in)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS + PORT_ARCHS, default="qwen3-14b")
    ap.add_argument("--preset", choices=["tiny", "100m", "full"],
                    default="tiny")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--client-chunk", type=int, default=None,
                    help="stream the client axis in chunks of this many "
                         "rows (per device under pallas_sharded): peak "
                         "memory O(chunk * d) instead of O(N * d); must "
                         "divide the per-device client count. Default: "
                         "resident (all clients at once)")
    ap.add_argument("--sample-rate", type=float, default=1.0,
                    help="per-round Bernoulli participation probability; "
                         "< 1 samples a client subset each round (keyed "
                         "off the round key, identical on all backends)")
    ap.add_argument("--client-weights", default="uniform",
                    choices=["uniform", "datasize"],
                    help="per-client aggregation weights: 'uniform' "
                         "(1/N, default) or 'datasize' (proportional to "
                         "the client's Dirichlet shard size)")
    ap.add_argument("--batch", type=int, default=2, help="per-client batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="adam_ota",
                    choices=["adam_ota", "adagrad_ota", "amsgrad_ota",
                             "yogi_ota", "fedavgm", "fedavg"])
    ap.add_argument("--backend", default="pallas",
                    choices=["jnp", "pallas", "pallas_sharded"],
                    help="round-step backend: per-leaf jnp tree.map, the "
                         "fused Pallas slab engine (2 kernel launches/"
                         "round), or the mesh-distributed slab engine "
                         "(2 launches per DEVICE + cross-client psum)")
    ap.add_argument("--mesh", default=None,
                    help="client-mesh shape for --backend pallas_sharded, "
                         "comma-separated (e.g. '2' or '4,2', default 2); "
                         "the client count must be divisible by its product")
    ap.add_argument("--uplink", default="f32",
                    choices=["f32", "int8", "sign"],
                    help="MAC payload format: f32 is the analog uplink "
                         "(today's behaviour, bitwise); int8 quantizes each "
                         "transmitter's faded partial sum to int8 + "
                         "per-128-block f32 scales (stochastic rounding) — "
                         "~4x fewer collective bytes on the sharded MAC; "
                         "sign is the 1-bit signSGD payload with blockwise "
                         "mean-magnitude scales (deterministic, ~32x)")
    ap.add_argument("--downlink", default="f32", choices=["f32", "int8"],
                    help="model-broadcast format: f32 (default, bitwise) "
                         "or int8 (per-128-block scales + stochastic "
                         "rounding, ~4x fewer broadcast bytes; clients see "
                         "the reconstruction, the server keeps f32 master "
                         "weights)")
    ap.add_argument("--error-feedback", action="store_true",
                    help="carry each transmitter's quantization residual "
                         "across rounds and add it back before the next "
                         "quantize (needs --uplink int8 or sign); resident "
                         "in the slab state and checkpointed, so --resume "
                         "continues the residual bitwise")
    ap.add_argument("--no-interpret", action="store_true",
                    help="force-compile the Pallas kernels instead of the "
                         "platform default (auto: compiled on TPU, "
                         "interpret mode elsewhere; see also the "
                         "REPRO_PALLAS_INTERPRET env var)")
    ap.add_argument("--sign-pack", default="fold",
                    choices=["fold", "planes", "int8"],
                    help="wire container for --uplink sign: 'fold' packs "
                         "the signs into uint32 bitplanes at 1 bit/coord "
                         "(exact zeros fold to +1, all-zero blocks keep "
                         "scale 0 so the padded tail survives), 'planes' "
                         "keeps a separate nonzero-mask plane (2 bits/"
                         "coord, zeros exact), 'int8' is the "
                         "byte-per-coord container")
    ap.add_argument("--sr-inkernel", action="store_true",
                    help="draw the int8 stochastic-rounding uniforms "
                         "inside the Pallas transmit kernel (pltpu PRNG) "
                         "instead of streaming a host-drawn f32 row "
                         "through HBM; compiled mode only (ignored under "
                         "interpret / --backend jnp), same one-block-"
                         "scale quantization contract, different uniform "
                         "stream — not bitwise vs the host-drawn path")
    ap.add_argument("--comm-buckets", type=int, default=1,
                    help="split the sharded MAC collective into this many "
                         "slab buckets, interleaved with the per-bucket "
                         "transmit epilogue (pallas_sharded only; the "
                         "overlap engine, tolerance-tier vs the default); "
                         "1 (default) keeps the single-collective graph "
                         "bitwise")
    ap.add_argument("--double-buffer", action="store_true",
                    help="two-slot pipeline for the streamed client scan: "
                         "chunk c's gradients are computed while chunk "
                         "c-1's slot folds into the accumulators (needs "
                         "--client-chunk; tolerance-tier reassociation "
                         "of the per-chunk fold)")
    ap.add_argument("--ckpt-async", action="store_true",
                    help="write checkpoints on a background thread: the "
                         "host snapshot is taken synchronously (safe "
                         "under donation), the npz encode + atomic "
                         "rename overlap training; files are bitwise "
                         "identical to the blocking path and all writes "
                         "are joined at loop exit")
    ap.add_argument("--no-donate", action="store_true",
                    help="keep a second resident copy of the slab state "
                         "across the scan dispatch instead of donating "
                         "the input slabs to the compiled runner "
                         "(donation is safe here: run_rounds_slab "
                         "threads the state linearly)")
    ap.add_argument("--donation-report", action="store_true",
                    help="before training, lower+compile the round runner "
                         "and print how many donated input bytes the "
                         "executable actually aliases to outputs "
                         "(verifies the slabs are updated in place, not "
                         "copied)")
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--alpha", type=float, default=1.5,
                    help="TRUE tail index of the channel's alpha-stable "
                         "interference (what the simulator injects)")
    ap.add_argument("--alpha-opt", default=None,
                    help="tail index the server OPTIMIZER assumes: a float "
                         "(fixed assumption — set != --alpha for mismatch "
                         "experiments) or 'auto' (closed-loop online "
                         "estimation from the fused pilot statistics). "
                         "Default: 'auto' under --track-alpha, else "
                         "--alpha (matched, the old conflated behaviour)")
    ap.add_argument("--track-alpha", action="store_true",
                    help="shorthand for --alpha-opt auto: estimate the "
                         "interference tail index online (log-moment "
                         "stats fused into the OTA kernel epilogue, EMA "
                         "resident in the slab state, checkpointed) and "
                         "feed it back into the adaptive update")
    ap.add_argument("--xi-scale", type=float, default=0.05)
    ap.add_argument("--dir", type=float, default=0.5,
                    help="Dirichlet concentration (data heterogeneity)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir "
                         "(bitwise-identical continuation: round keys are "
                         "derived from the absolute round index)")
    ap.add_argument("--scan-rounds", type=int, default=8,
                    help="rounds fused into one jax.lax.scan dispatch over "
                         "the resident slab state (clipped to log/ckpt "
                         "boundaries)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def refuse_unported(ap: argparse.ArgumentParser,
                    args: argparse.Namespace) -> None:
    """``ap.error`` for each flag that has no meaning in the port, naming
    the reason, and for the JAX CLI's sharded-only flags without
    ``--backend pallas_sharded``."""
    if args.no_interpret:
        ap.error("--no-interpret: the port has no Pallas interpret mode; "
                 "the device decides (the CUDA kernels on the card, their "
                 "plain versions under --device cpu)")
    for flag, on in (("--no-donate", args.no_donate),
                     ("--donation-report", args.donation_report)):
        if on:
            ap.error(f"{flag}: the port has no XLA buffer donation; its "
                     "slabs update in place")
    if args.backend == "jnp":
        ap.error("--backend jnp: the port has no backend switch; the "
                 "device decides (the CUDA kernels on the card, their plain "
                 "versions under --device cpu), so --backend takes pallas")
    if args.mesh is not None and args.backend != "pallas_sharded":
        ap.error(f"--mesh only applies to --backend pallas_sharded "
                 f"(got --backend {args.backend}); it would be silently "
                 f"ignored on a single-device backend")
    if args.comm_buckets > 1 and args.backend != "pallas_sharded":
        ap.error("--comm-buckets > 1 buckets the sharded MAC collective; "
                 f"it needs --backend pallas_sharded (got {args.backend})")
    needs = {"vlm": "image_embed", "encdec": "audio_embed"}.get(
        get_config(args.arch).family)
    if needs:
        ap.error(f"--arch {args.arch}: its model needs batch[{needs!r}] "
                 "beside the tokens, and the CLI's batches hold tokens only "
                 "(as the JAX CLI's, on which it fails too); train it "
                 "through make_slab_round_runner + run_rounds_slab with "
                 f"batches that carry {needs}")


def client_corpus(vocab: int, seq: int, n_clients: int, batch: int,
                  dir_alpha: float, seed: int
                  ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """One shared token stream, its window starts and the clients'
    Dirichlet shards of window ids (by "domain", so clients see different
    mixtures: non-iid), as the JAX CLI makes them."""
    toks = token_stream(CORPUS_TOKENS, vocab=vocab, seed=seed)
    n_windows = (len(toks) - seq - 1) // seq
    starts_all = np.arange(n_windows) * seq
    domain = (starts_all // (len(toks) // N_DOMAINS)).astype(np.int64)
    parts = dirichlet_partition(domain, n_clients, dir_alpha, seed=seed,
                                min_per_client=batch)
    return toks, starts_all, parts


def make_batch_fn(toks: np.ndarray, starts_all: np.ndarray,
                  parts: Sequence[np.ndarray], batch: int, seq: int,
                  seed: int) -> Callable[[int], Dict[str, torch.Tensor]]:
    """``batch_fn(t)``: the (clients, batch, seq) int32 token windows of
    round t, keyed by the ABSOLUTE round index (not by call count) so a
    resumed process draws the same batches for round t as the
    uninterrupted one; the JAX CLI's numpy body, so the ids are bitwise
    its."""
    def batch_fn(t: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((seed, t))
        out = np.empty((len(parts), batch, seq), np.int32)
        for c, p in enumerate(parts):
            pick = rng.choice(p, size=batch, replace=len(p) < batch)
            for j, w in enumerate(pick):
                s = starts_all[w]
                out[c, j] = toks[s:s + seq]
        return {"tokens": torch.from_numpy(out)}

    return batch_fn


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI on ``argv`` (default: the command line). Returns the
    history, the final ``SlabTrainState`` and the seconds the round loop
    took (synchronized on the card)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    if args.scan_rounds < 1:
        ap.error("--scan-rounds must be >= 1")
    if args.comm_buckets < 1:
        ap.error("--comm-buckets must be >= 1")
    refuse_unported(ap, args)

    # Resolve the optimizer's assumed alpha: --track-alpha and
    # --alpha-opt auto are synonyms; a bare float pins the assumption
    # (mismatch scenarios); unset follows the true channel alpha.
    if args.alpha_opt is None:
        alpha_opt = "auto" if args.track_alpha else args.alpha
    elif args.alpha_opt == "auto":
        alpha_opt = "auto"
    else:
        try:
            alpha_opt = float(args.alpha_opt)
        except ValueError:
            ap.error(f"--alpha-opt must be a float or 'auto', "
                     f"got {args.alpha_opt!r}")
        if args.track_alpha:
            ap.error("--track-alpha conflicts with a fixed --alpha-opt "
                     f"{alpha_opt}; drop one of the two")
    if args.error_feedback and args.uplink == "f32":
        ap.error("--error-feedback needs a quantized uplink "
                 "(--uplink int8 or sign); the f32 payload has no residual")
    if args.sr_inkernel and args.uplink != "int8":
        ap.error("--sr-inkernel applies to the stochastically rounded "
                 f"int8 uplink only (got --uplink {args.uplink})")
    if args.double_buffer and args.client_chunk is None:
        ap.error("--double-buffer pipelines the streamed client scan; "
                 "it needs --client-chunk")

    if args.backend != "pallas_sharded":
        return _train(args, alpha_opt)
    try:
        mesh_shape = parse_mesh(args.mesh or "2")
    except ValueError:
        ap.error(f"--mesh must be comma-separated positive ints "
                 f"(e.g. '2' or '4,2'), got {args.mesh!r}")
    try:
        check_cards(math.prod(mesh_shape),
                    torch.device(args.device or "cuda").type)
    except ValueError as e:
        ap.error(f"--mesh {args.mesh or '2'}: {e}")
    out = run_on_mesh(_train_rank, mesh_shape, args.device,
                      args=(args, alpha_opt))
    if isinstance(out["state"], dict):       # from a worker process
        out["state"] = _state_from_numpy(out["state"])
    return out


def _state_to_numpy(state: SlabTrainState) -> dict:
    return {"step": state.step.cpu().numpy(), "w": state.w.cpu().numpy(),
            "opt": [o.cpu().numpy() for o in state.opt],
            "alpha_hat": state.alpha_hat.cpu().numpy(), "spec": state.spec,
            "ef": None if state.ef is None else state.ef.cpu().numpy()}


def _state_from_numpy(d: dict) -> SlabTrainState:
    return SlabTrainState(
        torch.from_numpy(d["step"]), torch.from_numpy(d["w"]),
        tuple(torch.from_numpy(o) for o in d["opt"]),
        torch.from_numpy(d["alpha_hat"]), d["spec"],
        None if d["ef"] is None else torch.from_numpy(d["ef"]))


def _train_rank(mesh, args: argparse.Namespace, alpha_opt) -> dict:
    """Worker entry point of ``--backend pallas_sharded``: the run on
    this rank of ``mesh`` (rank 0's result is the caller's; a worker
    process's state comes back as numpy)."""
    out = _train(args, alpha_opt, mesh)
    if dist.get_world_size() > 1:
        out["state"] = _state_to_numpy(out["state"])
    return out


def _train(args: argparse.Namespace, alpha_opt, mesh=None) -> dict:
    """The run: on this process's device, or on this rank of ``mesh``
    (the sharded engine; every rank runs it, rank 0 prints and writes).
    Returns the history, the final (gathered) state and the seconds."""
    track = alpha_opt == "auto"
    rank0 = mesh is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    dev = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    model = build_model(cfg)
    say(f"arch={cfg.arch} params={cfg.n_params()/1e6:.1f}M "
        f"vocab={cfg.vocab} clients={args.clients} "
        f"alpha={args.alpha} alpha_opt={alpha_opt}")

    toks, starts_all, parts = client_corpus(cfg.vocab, args.seq,
                                            args.clients, args.batch,
                                            args.dir, args.seed)
    batch_fn = make_batch_fn(toks, starts_all, parts, args.batch, args.seq,
                             args.seed)

    ch = OTAChannelConfig(alpha=args.alpha, xi_scale=args.xi_scale,
                          uplink=UplinkConfig(
                              mode=args.uplink,
                              error_feedback=args.error_feedback,
                              sign_pack=args.sign_pack,
                              sr_inkernel=args.sr_inkernel),
                          downlink=args.downlink,
                          comm_buckets=args.comm_buckets)
    ad = AdaptiveConfig(optimizer=args.optimizer, lr=args.lr,
                        alpha=alpha_opt, beta2=0.3)
    n_shards, shard_index = 1, None
    if mesh is not None:
        n_shards = n_client_shards(mesh)
        shard_index = linear_shard_index(mesh, client_axes_of(mesh))
        shape = {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}
        say(f"client mesh {shape} ({dist.get_world_size()} devices visible)")
    weights = None
    if args.client_weights == "datasize":
        weights = tuple(float(len(p)) for p in parts)
    fl = FLConfig(n_clients=args.clients, client_chunk=args.client_chunk,
                  sample_rate=args.sample_rate, client_weights=weights,
                  double_buffer=args.double_buffer)
    run_chunk = make_slab_round_runner(
        model.loss_fn, ch, ad, fl, device=dev,
        backend=None if mesh is None else "pallas_sharded", mesh=mesh)
    params = model.init(args.seed, dev)
    spec = make_slab_spec(params, shards=n_shards)
    state = init_train_state(ad, params, spec=spec,
                             error_feedback=args.error_feedback, device=dev)
    del params   # resident from here on; pytrees only at boundaries

    start_round = 0
    if args.resume:
        latest = ckpt.latest_round(args.ckpt_dir)
        if latest is None:
            say(f"no checkpoint under {args.ckpt_dir}; starting fresh")
        else:
            state, _ = ckpt.load_slab_state(latest, spec, device=dev)
            start_round = int(state.step)
            say(f"resumed from {latest} at round {start_round}")
            # Reconcile the EF slab with this run's flags: a pre-EF (or
            # EF-off) checkpoint resumed WITH --error-feedback starts
            # the residual loop fresh (zeros); an EF checkpoint resumed
            # WITHOUT the flag drops the carried residual.
            if args.error_feedback and state.ef is None:
                say("checkpoint carries no error-feedback residual; "
                    "starting the EF loop from zeros")
                state = dataclasses.replace(
                    state, ef=torch.zeros((spec.shards, spec.padded),
                                          dtype=torch.float32, device=dev))
            elif not args.error_feedback and state.ef is not None:
                say("checkpoint carries an error-feedback residual but "
                    "--error-feedback is off; dropping it")
                state = dataclasses.replace(state, ef=None)
    if mesh is not None:
        state = shard_train_state(state, mesh)

    draws = TorchDraws(ch, spec, args.clients, seed=args.seed + 1,
                       device=dev, sample_rate=args.sample_rate,
                       shard_index=shard_index)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def full(st):
        return st if mesh is None else gather_train_state(st, mesh)

    sync()
    t0 = time.time()

    def chunk_hook(t, st, history):
        # run_rounds_slab clips chunks to the align periods, so every
        # log/checkpoint multiple lands exactly on a chunk boundary.
        if args.log_every and t % args.log_every == 0:
            rec = history[-1]
            dt = time.time() - t0
            a_col = (f"  a^ {rec['alpha_hat']:.3f}" if track else "")
            say(f"round {t:5d}  loss {rec['loss']:.4f}  "
                f"|g| {rec['grad_norm']:.3e}{a_col}  "
                f"({dt / (t - start_round):.2f}s/round)", flush=True)
        if args.ckpt_dir and args.ckpt_every and t % args.ckpt_every == 0:
            st = full(st)            # a collective: every rank gathers
            if rank0:
                ckpt.save_slab_state(os.path.join(args.ckpt_dir,
                                                  f"round_{t}.npz"), st,
                                     blocking=not args.ckpt_async)

    state, history = run_rounds_slab(
        run_chunk, state, draws, batch_fn, args.rounds,
        chunk=args.scan_rounds, start_round=start_round,
        chunk_hook=chunk_hook, log=say,
        align=(args.log_every, args.ckpt_every if args.ckpt_dir else 0))
    sync()
    seconds = time.time() - t0
    state = full(state)
    if args.ckpt_async and rank0:
        ckpt.wait_for_async_saves()
    if args.history_out and rank0:
        os.makedirs(os.path.dirname(os.path.abspath(args.history_out)),
                    exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump(history, f)
    if history:
        a_col = (f"  alpha_hat {history[-1]['alpha_hat']:.4f} "
                 f"(true {args.alpha})" if track else "")
        say(f"done: final loss {history[-1]['loss']:.4f} "
            f"(started {history[0]['loss']:.4f}){a_col}")
    else:
        say(f"done: nothing to do (resumed at round {start_round} "
            f">= --rounds {args.rounds})")
    return {"history": history, "state": state, "seconds": seconds}


if __name__ == "__main__":
    main()
