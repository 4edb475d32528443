"""Multi-round trajectory parity check of the sharded engine (CLI).

PyTorch counterpart of ``repro.launch.shard_check``, with the same
flags, tiers and closing ``PARITY OK`` line, plus ``--device``. Runs R
full ADOTA rounds several ways and reports the largest end-of-trajectory
deviation of params / optimizer state / metrics:

* the reference: the per-round pytree API (``make_round_step``, a host
  loop), or the slab-resident runner where that API refuses the config
  (alpha "auto", a streamed round, error feedback, the int8 downlink);
* the slab-resident single-device runner (``make_slab_round_runner``);
* the sharded engine (``backend="pallas_sharded"``) on each client-mesh
  shape, each rank carrying only its slices, and the per-round pytree
  API over it for one optimizer of each state-slab row count (0-3).

The JAX tool forces host devices; here each mesh is P worker processes
(``launch.mesh.run_on_mesh``: gloo under ``--device cpu``, NCCL on the
cards, one a rank), which run every optimizer's rounds in one start.
The sharded trajectory runs twice and must be bitwise equal to itself.
Draws come from ``TorchDraws`` (seed 7), each rank drawing its
transmitter's rounding.

``--uplink int8`` / ``sign``, ``--error-feedback`` and ``--downlink
int8`` run the quantized wire: P > 1 meshes quantize per transmitter,
so they agree with the single-device engines to accumulated
quantization-error order (default tol 0.25), while the (1,)-mesh stays
bitwise the resident engine. ``--comm-buckets`` > 1 runs the mesh rows
on the overlap engine (default f32 tol 1e-4).

    PYTHONPATH=src python -m repro_torch.launch.shard_check \\
        --meshes 1 2 2,2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.shard_check \\
        --uplink int8 --meshes 1 2 --device cpu

``run_cases`` is the worker entry point the tests drive with the JAX
package's own draws.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
from repro_torch.core.draws import RoundDraws, TorchDraws
from repro_torch.core.fl import (FLConfig, RoundMetrics, init_server,
                                 make_round_step, make_sharded_round_step,
                                 make_slab_round_runner)
from repro_torch.core.ota import psum_axes
from repro_torch.core.shard import (all_gather_slab, client_axes_of,
                                    exchange_uplink_payload,
                                    gather_train_state, linear_shard_index,
                                    make_shard_slab_step, n_client_shards,
                                    psum_scatter_slab, shard_train_state)
from repro_torch.core.slab import (make_slab_spec, tree_flatten, tree_map,
                                   tree_unflatten)
from repro_torch.core.slab_state import (SlabTrainState, init_train_state,
                                         unpack_train_state)
from repro_torch.launch.mesh import parse_mesh, run_on_mesh

ALL_OPTIMIZERS = ["adagrad_ota", "adam_ota", "amsgrad_ota", "yogi_ota",
                  "fedavgm", "fedavg"]

# One optimizer per state-slab row count (3/2/1/0): enough to cover
# every pack/unpack shape of the pytree-per-round boundary wrapper.
PERROUND_OPTIMIZERS = ("amsgrad_ota", "adam_ota", "fedavgm", "fedavg")
METRICS = RoundMetrics._fields


def quadratic_loss(p, batch):
    """The JAX tool's loss: sum over leaves of mean((x - t)^2)."""
    return sum(torch.mean((x - t) ** 2)
               for x, t in zip(tree_flatten(p)[0], tree_flatten(batch)[0]))


def check_params(bucketed: bool, seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX tool's parameter shapes (4096 entries under buckets, so
    every mesh's per-shard block count divides by 2 and 4), random."""
    rng = np.random.default_rng(seed)
    shapes = ({"emb": (16, 128), "w": (2047,), "b": (1,)} if bucketed else
              {"emb": (7, 33), "w": (257,), "b": (1,)})
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


def configs(case: dict):
    """The case's (channel, adaptive, fl) configs from plain dicts."""
    ch = dict(case["channel"])
    ch["uplink"] = UplinkConfig(**ch.get("uplink", {}))
    fl = dict(case["fl"])
    if fl.get("client_weights") is not None:
        fl["client_weights"] = tuple(fl["client_weights"])
    return (OTAChannelConfig(**ch), AdaptiveConfig(**case["adaptive"]),
            FLConfig(**fl))


def _round_draws(d: dict, t: int, idx: int) -> RoundDraws:
    """Round t's draws of transmitter ``idx`` from the arrays ``d``
    (per round: h, u, e; optional r_dl, mask; r_up (P, 2, padded))."""
    def get(name):
        return (None if d.get(name) is None
                else torch.from_numpy(np.asarray(d[name][t])))
    r_up = d.get("r_up")
    return RoundDraws(
        get("h"), get("u"), get("e"),
        r_up=None if r_up is None else torch.from_numpy(r_up[t, idx, 0]),
        r_dl=get("r_dl"), mask=get("mask"),
        r_clean=None if r_up is None else torch.from_numpy(r_up[t, idx, 1]),
        shard=idx)


def _np_state(state) -> dict:
    return {"w": state.w.cpu().numpy(),
            "opt": [o.cpu().numpy() for o in state.opt],
            "alpha_hat": float(state.alpha_hat), "step": int(state.step),
            "ef": None if state.ef is None else state.ef.cpu().numpy()}


def _np_metrics(ms: RoundMetrics) -> dict:
    return {f: getattr(ms, f).cpu().numpy() for f in METRICS}


def run_cases(mesh, cases: List[dict], device: str = "cpu") -> dict:
    """Worker entry point: run each case on this rank of ``mesh`` and
    return (on every rank; the launcher keeps rank 0's) one result a
    case, numpy only.

    A case is ``{"name", "kind", "channel", "adaptive", "fl", "params",
    "batches", "rounds"}`` plus ``"draws"`` (arrays as ``_round_draws``
    reads them) or ``"seed"`` (``TorchDraws``). Kinds: ``"runner"`` (the
    sharded runner from the resident initial state; the gathered final
    state and the stacked metrics, plus ``"rerun_equal"`` when
    ``"rerun"`` is set), ``"perround"`` (``make_round_step(backend=
    "pallas_sharded")``; the final params and optimizer state as leaves)
    and ``"psum"`` (``make_sharded_round_step``, one client a rank; the
    final leaves and the losses)."""
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)
    axes = client_axes_of(mesh)
    idx = linear_shard_index(mesh, axes)
    n_shards = n_client_shards(mesh)
    out = {}
    for case in cases:
        ch, ad, fl = configs(case)
        params = tree_map(lambda x: torch.as_tensor(x, device=dev),
                          case["params"])
        batches = case["batches"]
        rounds = case["rounds"]
        # the per-leaf round draws for the unsharded layout, one fading
        # draw a rank; the slab engine for the mesh's
        psum = case["kind"] == "psum"
        spec = make_slab_spec(params, shards=1 if psum else n_shards)
        if case.get("draws") is not None:
            draws = [_round_draws(case["draws"], t, idx)
                     for t in range(rounds)]
        else:
            prov = TorchDraws(ch, spec, fl.n_clients, seed=case["seed"],
                              device=dev, sample_rate=fl.sample_rate,
                              shard_index=None if psum else idx)
            draws = [prov(t) for t in range(rounds)]
        if case["kind"] == "runner":
            run = make_slab_round_runner(quadratic_loss, ch, ad, fl,
                                         device=dev, backend="pallas_sharded",
                                         mesh=mesh)
            stacked = tree_map(lambda b: np.stack([b] * rounds), batches)

            def trajectory():
                state = shard_train_state(
                    init_train_state(ad, params, spec=spec,
                                     error_feedback=ch.uplink.error_feedback,
                                     device=dev), mesh)
                state, ms = run(state, draws, stacked)
                return _np_state(gather_train_state(state, mesh)), \
                    _np_metrics(ms)

            state, ms = trajectory()
            res = {"state": state, "metrics": ms}
            if case.get("rerun"):
                again, ms2 = trajectory()
                res["rerun_equal"] = _equal((state, ms), (again, ms2))
        elif case["kind"] == "perround":
            step = make_round_step(quadratic_loss, ch, ad, fl, device=dev,
                                   backend="pallas_sharded", mesh=mesh)
            p, s = params, init_server(params, ad)
            for t in range(rounds):
                p, s, m = step(p, s, draws[t], batches)
            res = {"leaves": [x.cpu().numpy() for x in
                              tree_flatten((p, s))[0]],
                   "metrics": _np_metrics(m)}
        else:
            body = make_sharded_round_step(quadratic_loss, ch, ad, mesh,
                                           client_axes=axes)
            local = tree_map(lambda b: torch.as_tensor(b[idx:idx + 1],
                                                       device=dev), batches)
            p, s, losses = params, init_server(params, ad), []
            for t in range(rounds):
                p, s, loss = body(p, s, draws[t].to(dev), local)
                losses.append(float(loss))
            res = {"leaves": [x.cpu().numpy() for x in
                              tree_flatten((p, s))[0]],
                   "losses": np.asarray(losses, np.float32)}
        out[case["name"]] = res
    return out


def collective_inputs(seed: int, idx: int, n_shards: int,
                      shard_len: int = 256) -> Dict[str, np.ndarray]:
    """Rank ``idx``'s inputs of ``collectives``, from ``(seed, idx)``."""
    rng = np.random.default_rng((seed, idx))
    width = n_shards * shard_len
    words = rng.integers(0, 2 ** 32, (n_shards, 2, shard_len // 32),
                         dtype=np.uint64).astype(np.uint32)
    return {"rows": rng.normal(size=(2, width)).astype(np.float32),
            "flat": rng.normal(size=(width,)).astype(np.float32),
            "slice": rng.normal(size=(shard_len,)).astype(np.float32),
            "ef": rng.normal(size=(1, width)).astype(np.float32),
            "q": rng.integers(-127, 128, (n_shards, 2, shard_len),
                              dtype=np.int8),
            "words": words,
            "scales": rng.random((n_shards, 2, shard_len // 128),
                                 dtype=np.float32),
            "scalar": rng.normal(size=(3,)).astype(np.float32)}


def collectives(mesh, seed: int = 0) -> dict:
    """Worker entry point: the sharded engine's collectives and
    boundaries on this mesh, each rank's inputs from
    ``collective_inputs(seed, rank's linear index)``. Returns every
    rank's outputs (numpy, in rank order) and the messages of the
    refusals that need P > 1 ranks: ``n_clients`` not divisible by P,
    ``comm_buckets`` not dividing a shard's block count."""
    axes = client_axes_of(mesh)
    sizes = tuple(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)
    n_shards = n_client_shards(mesh)
    idx = linear_shard_index(mesh, axes)
    x = {k: torch.from_numpy(v)
         for k, v in collective_inputs(seed, idx, n_shards).items()}
    mine = {"idx": idx,
            "scatter_rows": psum_scatter_slab(x["rows"], mesh, axes, dim=1),
            "scatter_flat": psum_scatter_slab(x["flat"], mesh, axes),
            "gather": all_gather_slab(x["slice"], mesh, axes),
            "gather_rows": all_gather_slab(x["ef"], mesh, axes),
            "q": exchange_uplink_payload(x["q"], mesh, axes, sizes),
            "words": exchange_uplink_payload(x["words"], mesh, axes, sizes),
            "scales": exchange_uplink_payload(x["scales"], mesh, axes,
                                              sizes),
            "psum": psum_axes(x["scalar"], mesh, axes)}
    # the state boundary: this rank's slices of a resident state, and
    # the state gathered back from every rank's slices
    params = {"w": torch.from_numpy(np.arange(300, dtype=np.float32))}
    ad = AdaptiveConfig(optimizer="amsgrad_ota")
    full = init_train_state(ad, params, shards=n_shards,
                            error_feedback=True, device="cpu")
    full = dataclasses.replace(
        full, opt=tuple(full.w * (i + 2) for i in range(len(full.opt))),
        ef=torch.arange(full.ef.numel(), dtype=torch.float32).reshape(
            full.ef.shape))
    back = gather_train_state(shard_train_state(full, mesh), mesh)
    mine["roundtrip"] = _equal(_np_state(full), _np_state(back))
    mine = {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in mine.items()}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    refusals = {}
    ch = OTAChannelConfig(comm_buckets=4)
    for what, fl, state in (
            ("n_clients", FLConfig(n_clients=n_shards + 1), None),
            ("comm_buckets", FLConfig(n_clients=n_shards),
             shard_train_state(init_train_state(
                 AdaptiveConfig(), params, shards=n_shards, device="cpu"),
                 mesh))):
        try:
            step = make_shard_slab_step(quadratic_loss, ch, AdaptiveConfig(),
                                        fl, mesh, device="cpu")
            step(state, TorchDraws(ch, state.spec, fl.n_clients,
                                   device="cpu")(0),
                 {"w": np.zeros((fl.n_clients, 300), np.float32)})
        except ValueError as e:
            refusals[what] = str(e)
    return {"ranks": ranks, "refusals": refusals}


def _equal(a, b) -> bool:
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def _max_dev(a, b) -> float:
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb), (len(la), len(lb))
    dev = 0.0
    for x, y in zip(la, lb):
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        dev = max(dev, float(np.max(np.abs(x - y)
                                    / np.maximum(np.abs(x), 1.0))))
    return dev


def _devs(ref, out, tol, track_alpha=False):
    """The JAX tool's columns: params, delta, nu, loss, |g_t| (and a^)."""
    (p_ref, s_ref, m_ref), (p, s, m) = ref, out
    devs = {
        "params": _max_dev(p_ref, p),
        "delta": _max_dev(s_ref.delta, s.delta),
        "nu": _max_dev(s_ref.nu, s.nu),
        "loss": abs(float(m_ref["loss"]) - float(m["loss"])),
        "|g_t|": abs(float(m_ref["noisy_grad_norm"])
                     - float(m["noisy_grad_norm"]))
        / max(abs(float(m_ref["noisy_grad_norm"])), 1.0),
    }
    if track_alpha:
        devs["a^"] = abs(float(m_ref["alpha_hat"]) - float(m["alpha_hat"]))
    return devs, max(devs.values()) <= tol


def _last(ms: dict) -> dict:
    return {f: np.asarray(v)[-1] for f, v in ms.items()}


def _pytrees(ad, spec, state: dict):
    """(params, ServerOptState) of a gathered numpy state."""
    st = SlabTrainState(torch.tensor(state["step"]),
                        torch.from_numpy(state["w"]),
                        tuple(torch.from_numpy(o) for o in state["opt"]),
                        torch.tensor(state["alpha_hat"]), spec)
    return unpack_train_state(ad, st)


def _single_device(params, batches, ch, ad, fl, rounds, dev, per_round):
    """The reference (per-round API) or the resident runner, in this
    process: ``(params, ServerOptState, last metrics)``."""
    tp = tree_map(lambda x: torch.as_tensor(x, device=dev), params)
    prov = TorchDraws(ch, make_slab_spec(tp), fl.n_clients, seed=7,
                      device=dev, sample_rate=fl.sample_rate)
    if per_round:
        step = make_round_step(quadratic_loss, ch, ad, fl, device=dev)
        p, s = tp, init_server(tp, ad)
        for t in range(rounds):
            p, s, m = step(p, s, prov(t), batches)
        return p, s, {f: getattr(m, f).cpu().numpy() for f in METRICS}
    run = make_slab_round_runner(quadratic_loss, ch, ad, fl, device=dev)
    state = init_train_state(ad, tp, error_feedback=ch.uplink.error_feedback,
                             device=dev)
    state, ms = run(state, [prov(t) for t in range(rounds)],
                    tree_map(lambda b: np.stack([b] * rounds), batches))
    p, s = unpack_train_state(ad, state)
    return p, s, _last(_np_metrics(ms))


def _case_dict(ch: OTAChannelConfig, ad: AdaptiveConfig, fl: FLConfig,
               **kw) -> dict:
    chd = dataclasses.asdict(ch)
    return dict(channel=chd, adaptive=dataclasses.asdict(ad),
                fl=dataclasses.asdict(fl), **kw)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", nargs="+", default=["1", "2", "4,2"],
                    help="client-mesh shapes, e.g. --meshes 1 2 4,2")
    ap.add_argument("--optimizers", nargs="+", default=ALL_OPTIMIZERS)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--client-chunk", type=int, default=None,
                    help="stream the client axis in chunks of this many "
                         "rows (per rank on sharded meshes)")
    ap.add_argument("--sample-rate", type=float, default=1.0,
                    help="per-round Bernoulli participation probability "
                         "(< 1 activates partial participation)")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="the JAX tool's forced host device count; each "
                         "rank here is a process with one device, so it "
                         "is accepted and not used")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--uplink", default="f32",
                    choices=["f32", "int8", "sign"],
                    help="MAC payload format under test. f32 is the "
                         "f32-rounding parity contract (tol ~1e-5); "
                         "int8/sign meshes with P > 1 quantize per "
                         "transmitter (default tol 0.25)")
    ap.add_argument("--downlink", default="f32", choices=["f32", "int8"],
                    help="model-broadcast format under test")
    ap.add_argument("--error-feedback", action="store_true",
                    help="carry per-transmitter error feedback (needs a "
                         "quantized --uplink)")
    ap.add_argument("--track-alpha", action="store_true",
                    help="run every trajectory with the closed alpha loop "
                         "(AdaptiveConfig.alpha='auto'); the alpha_hat "
                         "deviation joins the parity columns")
    ap.add_argument("--comm-buckets", type=int, default=1,
                    help="bucket the sharded MAC collectives (the overlap "
                         "engine) on the mesh rows; > 1 loosens the "
                         "default f32 tol to 1e-4")
    ap.add_argument("--tol", type=float, default=None,
                    help="max relative end-of-trajectory deviation "
                         "(default 1e-5 for --uplink f32, 0.25 for int8)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: NCCL, one card a rank) or cpu "
                         "(gloo)")
    args = ap.parse_args(argv)
    if args.error_feedback and args.uplink == "f32":
        ap.error("--error-feedback needs a quantized uplink "
                 "(--uplink int8 or sign)")
    if args.tol is None:
        if args.uplink == "f32" and args.downlink == "f32":
            args.tol = 1e-4 if args.comm_buckets > 1 else 1e-5
        else:
            args.tol = 0.25
    try:
        shapes = [parse_mesh(m) for m in args.meshes]
    except ValueError:
        ap.error(f"--meshes takes comma-separated positive ints, got "
                 f"{args.meshes}")
    device = args.device or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    params = check_params(args.comm_buckets > 1)
    rng = np.random.default_rng(3)
    batches = {k: rng.normal(size=(args.clients,) + p.shape).astype(
        np.float32) for k, p in params.items()}
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1,
                          uplink=UplinkConfig(
                              mode=args.uplink,
                              error_feedback=args.error_feedback),
                          downlink=args.downlink)
    fl = FLConfig(n_clients=args.clients, client_chunk=args.client_chunk,
                  sample_rate=args.sample_rate)
    print(f"uplink={args.uplink} downlink={args.downlink} "
          f"ef={args.error_feedback} track_alpha={args.track_alpha} "
          f"chunk={args.client_chunk} sample_rate={args.sample_rate:g} "
          f"comm_buckets={args.comm_buckets} "
          f"rounds={args.rounds} tol={args.tol:g}")
    ch_mesh = dataclasses.replace(ch, comm_buckets=args.comm_buckets)
    slab_ref = (args.track_alpha or fl.dynamic_round
                or args.error_feedback or args.downlink != "f32")
    ads = {opt: AdaptiveConfig(optimizer=opt, lr=0.05,
                               alpha="auto" if args.track_alpha else 1.5,
                               beta2=0.3)
           for opt in args.optimizers}
    failures = 0
    refs = {}
    for opt, ad in ads.items():
        refs[opt] = _single_device(params, batches, ch, ad, fl, args.rounds,
                                   dev, per_round=not slab_ref)
        out = _single_device(params, batches, ch, ad, fl, args.rounds, dev,
                             per_round=False)
        devs, ok = _devs(refs[opt], out, args.tol, args.track_alpha)
        failures += not ok
        print(f"{opt:12s} resident          "
              + " ".join(f"{k}={v:.2e}" for k, v in devs.items())
              + ("  OK" if ok else "  FAIL"))
    for shape, mesh_str in zip(shapes, args.meshes):
        cases = []
        for opt, ad in ads.items():
            cases.append(_case_dict(ch_mesh, ad, fl, name=f"{opt} runner",
                                    kind="runner", params=params,
                                    batches=batches, rounds=args.rounds,
                                    seed=7, rerun=True))
            if opt in PERROUND_OPTIMIZERS and not slab_ref:
                cases.append(_case_dict(
                    ch_mesh, ad, fl, name=f"{opt} perround", kind="perround",
                    params=params, batches=batches, rounds=args.rounds,
                    seed=7))
        got = run_on_mesh(run_cases, shape, device, args=(cases, dev.type))
        spec = make_slab_spec(params, shards=int(np.prod(shape)))
        for opt, ad in ads.items():
            res = got[f"{opt} runner"]
            p, s = _pytrees(ad, spec, res["state"])
            devs, ok = _devs(refs[opt], (p, s, _last(res["metrics"])),
                             args.tol, args.track_alpha)
            failures += not ok
            print(f"{opt:12s} resident mesh={mesh_str:5s} "
                  + " ".join(f"{k}={v:.2e}" for k, v in devs.items())
                  + ("  OK" if ok else "  FAIL"))
            if f"{opt} perround" in got:
                pr = got[f"{opt} perround"]
                tp = tree_map(torch.as_tensor, params)
                _, treedef = tree_flatten((tp, init_server(tp, ad)))
                p, s = tree_unflatten(treedef, pr["leaves"])
                devs, ok = _devs(refs[opt], (p, s, pr["metrics"]), args.tol)
                failures += not ok
                print(f"{opt:12s} perround mesh={mesh_str:5s} "
                      + " ".join(f"{k}={v:.2e}" for k, v in devs.items())
                      + ("  OK" if ok else "  FAIL"))
            if not res["rerun_equal"]:
                print(f"{opt:12s} resident mesh={mesh_str}: "
                      "NONDETERMINISTIC rerun")
                failures += 1
    print("PARITY OK" if failures == 0 else f"PARITY FAIL ({failures})")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
