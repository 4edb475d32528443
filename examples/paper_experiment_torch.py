"""Paper-style experiment script on the PyTorch port: reproduce the Fig. 2
comparison and the alpha sweep (Fig. 5) on the CPU-sized synthetic
stand-ins, printing the orderings the paper claims, plus the Remark-3
scenario: the server does NOT know the channel's tail index. The twin
of ``examples/paper_experiment.py``: the same figures, checks and
printout, through ``repro_torch.experiments.paper_figs`` (the per-round
API) and ``examples/alpha_mismatch_torch.py``, on the card.

``--rounds`` reaches every figure here (the JAX script's figures run 80
rounds whatever it says). The draws are the port's own (``TorchDraws``,
Philox), so the numbers are not the JAX script's.

    PYTHONPATH=src python examples/paper_experiment_torch.py [--rounds 80]
        [--skip-mismatch] [--device cpu]
"""

import argparse
import importlib.util
import pathlib

from repro_torch.experiments import paper_figs


def _sibling(name: str):
    """An example module beside this file (the examples directory is not
    a package)."""
    path = pathlib.Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


alpha_mismatch = _sibling("alpha_mismatch_torch")


def main(argv=None) -> dict:
    """Runs the figures (and the Remark-3 trainings unless skipped);
    returns their records: ``fig2``, ``fig5``, ``fig5_ok`` and
    ``mismatch`` (None when skipped)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--skip-mismatch", action="store_true",
                    help="skip the Remark-3 alpha-mismatch / online-"
                         "tracking section")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    saved, paper_figs.ROUNDS = paper_figs.ROUNDS, args.rounds
    try:
        return _experiment(args)
    finally:
        paper_figs.ROUNDS = saved


def _experiment(args) -> dict:
    print("=== Fig.2: ADOTA vs FedAvgM (logreg / EMNIST-like, Dir=0.1, a=1.5)")
    fig2 = paper_figs.fig2(device=args.device)
    for r in fig2:
        print(f"  {r['optimizer']:12s} loss {r['final_loss']:.4f} "
              f"acc {r['accuracy']:.4f}")
    by = {r["optimizer"]: r for r in fig2}
    if not by["adam_ota"]["accuracy"] >= by["fedavgm"]["accuracy"]:
        raise AssertionError(
            "paper claim violated: Adam-OTA should beat FedAvgM")

    print("=== Fig.5: tail-index sweep (AdaGrad-OTA)")
    fig5 = paper_figs.fig5(device=args.device)
    for r in fig5:
        print(f"  alpha={r['alpha']:.1f} loss {r['final_loss']:.4f}")
    losses = [r["final_loss"] for r in fig5]
    fig5_ok = losses[0] >= losses[-1]
    print("  (expected: loss decreases as alpha rises)",
          "OK" if fig5_ok else "VIOLATED")

    mismatch = None
    if not args.skip_mismatch:
        true_alpha = alpha_mismatch.TRUE_ALPHA
        print("=== Remark 3: unknown alpha — mismatch vs online tracking "
              f"(true alpha={true_alpha})")
        loss_m, _, _ = alpha_mismatch.train(true_alpha, args.rounds,
                                            args.device)
        loss_g, _, _ = alpha_mismatch.train(2.0, args.rounds, args.device)
        loss_t, _, a_hat = alpha_mismatch.train("auto", args.rounds,
                                                args.device)
        ok = loss_t <= loss_g and abs(a_hat - true_alpha) < 0.15
        print(f"  (expected: tracked ~ matched < gaussian-assumed; "
              f"alpha_hat -> {true_alpha})", "OK" if ok else "VIOLATED")
        mismatch = {"matched": loss_m, "mismatched": loss_g,
                    "tracked": loss_t, "alpha_hat": a_hat, "ok": ok}
    return {"fig2": fig2, "fig5": fig5, "fig5_ok": fig5_ok,
            "mismatch": mismatch}


if __name__ == "__main__":
    main()
