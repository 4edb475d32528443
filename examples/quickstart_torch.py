"""Quickstart on the PyTorch port: 60 rounds of ADOTA-FL (Adam-OTA) on a
synthetic federated classification task, next to the FedAvgM baseline.
The twin of ``examples/quickstart.py``: the same task, configs and
printout, through ``repro_torch``'s per-round API on the card.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.fl import (FLConfig, init_server, make_round_step,
                                 run_rounds)
from repro_torch.core.slab import make_slab_spec
from repro_torch.data import FederatedBatcher, gaussian_mixture
from repro_torch.models.vision import accuracy, logistic_regression


def train(optimizer: str, lr: float, device=None, rounds: int = 60,
          log_every: int = 20):
    """Returns the final accuracy and the round history."""
    n_clients = 20
    data = gaussian_mixture(4000, 32, 10, seed=0)
    model = logistic_regression(32, 10)
    batcher = FederatedBatcher(data, n_clients, 16, dir_alpha=0.1)

    channel = OTAChannelConfig(alpha=1.5, xi_scale=0.5)   # strong interference
    server = AdaptiveConfig(optimizer=optimizer, lr=lr, alpha=1.5, beta2=0.3)
    round_step = make_round_step(model.loss_fn, channel, server,
                                 FLConfig(n_clients=n_clients), device=device)
    params = model.init(seed=0, device=device)
    state = init_server(params, server)
    draws = TorchDraws(channel, make_slab_spec(params), n_clients, seed=1,
                       device=device)

    params, state, hist = run_rounds(round_step, params, state, draws,
                                     batcher, n_rounds=rounds,
                                     log_every=log_every)
    acc = accuracy(model, params, data.x, data.y)
    print(f"{optimizer:12s} final loss {hist[-1]['loss']:.4f}  acc {acc:.4f}")
    return acc, hist


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--rounds", type=int, default=60)
    args = ap.parse_args(argv)
    print("== Adam-OTA (paper algorithm) ==")
    acc_adam, _ = train("adam_ota", lr=0.05, device=args.device,
                        rounds=args.rounds)
    print("== FedAvgM-OTA (paper baseline) ==")
    acc_avgm, _ = train("fedavgm", lr=0.01, device=args.device,
                        rounds=args.rounds)
    print(f"\nADOTA improvement: +{(acc_adam - acc_avgm) * 100:.1f} pts "
          "accuracy under alpha=1.5 interference")


if __name__ == "__main__":
    main()
