"""The int8-quantized over-the-air MAC on the PyTorch port: adam_ota
convergence is preserved when the uplink carries int8 payloads +
per-128-block f32 scales instead of raw f32, at ~4x fewer wire bytes per
round. The twin of ``examples/quantized_uplink.py``: the same task,
configs and printout, through ``repro_torch``'s per-round API on the
card.

Runs the same ADOTA task twice (the same draws seed, so both
trajectories see the same fading and interference) and prints the
loss / accuracy side by side with the per-round MAC payload sizes.

    PYTHONPATH=src python examples/quantized_uplink_torch.py [--device cpu]
"""

import argparse

from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.fl import (FLConfig, init_server, make_round_step,
                                 run_rounds)
from repro_torch.core.slab import make_slab_spec
from repro_torch.data import FederatedBatcher, gaussian_mixture
from repro_torch.models.vision import accuracy, logistic_regression

N_CLIENTS = 20
ROUNDS = 60


def train(uplink: str, device=None, rounds: int = ROUNDS,
          log_every: int = 20):
    data = gaussian_mixture(4000, 32, 10, seed=0)
    model = logistic_regression(32, 10)
    batcher = FederatedBatcher(data, N_CLIENTS, 16, dir_alpha=0.1)

    channel = OTAChannelConfig(alpha=1.5, xi_scale=0.5,   # strong interference
                               uplink=UplinkConfig(mode=uplink))
    server = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha=1.5,
                            beta2=0.3)
    round_step = make_round_step(model.loss_fn, channel, server,
                                 FLConfig(n_clients=N_CLIENTS), device=device)
    params = model.init(seed=0, device=device)
    state = init_server(params, server)
    spec = make_slab_spec(params)
    # The f32 wire draws h, u and e only; the int8 wire draws the same
    # h, u and e first and its rounding uniforms after them.
    draws = TorchDraws(channel, spec, N_CLIENTS, seed=1, device=device)

    params, state, hist = run_rounds(round_step, params, state, draws,
                                     batcher, n_rounds=rounds,
                                     log_every=log_every)
    acc = accuracy(model, params, data.x, data.y)
    wire = (spec.padded * 1 + (spec.padded // 128) * 4 if uplink == "int8"
            else spec.padded * 4)
    print(f"uplink={uplink:5s} final loss {hist[-1]['loss']:.4f}  "
          f"acc {acc:.4f}  MAC payload {wire} B/round")
    return hist[-1]["loss"], acc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    print("== analog f32 uplink (paper Eq. 7) ==")
    loss_f32, acc_f32 = train("f32", device=args.device, rounds=args.rounds)
    print("== int8 uplink (quantize-on-write MAC) ==")
    loss_i8, acc_i8 = train("int8", device=args.device, rounds=args.rounds)
    print(f"\naccuracy delta under the quantized MAC: "
          f"{(acc_i8 - acc_f32) * 100:+.2f} pts "
          "(rounding noise is tiny next to the channel noise)")


if __name__ == "__main__":
    main()
