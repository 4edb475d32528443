"""Alpha mismatch on the PyTorch port: what tracking the tail index online
buys. The twin of ``examples/alpha_mismatch.py``: the same task, configs
and printout, through ``repro_torch``'s slab runner on the card.

The ADOTA stepsize divides by the nu-accumulator's alpha-ROOT, so the
optimizer's assumed tail index shapes every update (paper Remark 3).
Three AdaGrad-OTA trainings on a heavy-tailed channel (true alpha =
1.2):

* ``matched``    -- the server knows alpha = 1.2;
* ``mismatched`` -- the server assumes Gaussian interference (alpha = 2);
* ``tracked``    -- ``alpha = "auto"``: the closed loop estimates alpha
  from the log-moment pilot statistics the channel kernel reduces every
  round, an EMA resident in the slab state on the card, fed back into
  the fused update.

Expected: ``tracked`` follows the matched trajectory (alpha_hat near 1.2
after 80 rounds) with no oracle knowledge, while the Gaussian assumption
trails on final loss. The draws are the port's own (``TorchDraws``,
Philox), so the numbers are not the JAX script's.

    PYTHONPATH=src python examples/alpha_mismatch_torch.py [--rounds 80] [--device cpu]
"""

import argparse

from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                 run_rounds_slab)
from repro_torch.core.slab_state import init_train_state, unpack_train_state
from repro_torch.data import FederatedBatcher, gaussian_mixture
from repro_torch.models.vision import accuracy, logistic_regression

TRUE_ALPHA = 1.2
N_CLIENTS = 20


def train(alpha_opt, rounds: int, device=None):
    """One AdaGrad-OTA training; returns its final loss, accuracy and
    alpha_hat (the alpha the last update used)."""
    data = gaussian_mixture(4000, 32, 10, seed=0)
    model = logistic_regression(32, 10)
    batcher = FederatedBatcher(data, N_CLIENTS, 16, dir_alpha=0.1)

    channel = OTAChannelConfig(alpha=TRUE_ALPHA, xi_scale=0.3)
    server = AdaptiveConfig(optimizer="adagrad_ota", lr=0.05,
                            alpha=alpha_opt, beta2=0.3)
    run = make_slab_round_runner(model.loss_fn, channel, server,
                                 FLConfig(n_clients=N_CLIENTS), device=device)
    state = init_train_state(server, model.init(seed=0, device=device),
                             device=device)
    draws = TorchDraws(channel, state.spec, N_CLIENTS, seed=1, device=device)
    state, hist = run_rounds_slab(run, state, draws, batcher, rounds,
                                  chunk=8)
    params, _ = unpack_train_state(server, state)
    acc = accuracy(model, params, data.x, data.y)
    name = "auto" if alpha_opt == "auto" else f"{alpha_opt:.1f}"
    print(f"  alpha_opt={name:5s} final loss {hist[-1]['loss']:.4f}  "
          f"acc {acc:.4f}  alpha_hat {hist[-1]['alpha_hat']:.4f}")
    return hist[-1]["loss"], acc, hist[-1]["alpha_hat"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=80)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    print(f"== AdaGrad-OTA on a true-alpha={TRUE_ALPHA} channel ==")
    loss_m, _, _ = train(TRUE_ALPHA, args.rounds, args.device)   # matched
    loss_g, _, _ = train(2.0, args.rounds, args.device)      # Gaussian guess
    loss_t, _, a_hat = train("auto", args.rounds, args.device)  # closed loop

    err = abs(a_hat - TRUE_ALPHA)
    print(f"\ntracked alpha_hat = {a_hat:.4f} (true {TRUE_ALPHA}, "
          f"err {err:.4f})")
    print(f"loss: matched {loss_m:.4f} | tracked {loss_t:.4f} | "
          f"gaussian-assumed {loss_g:.4f}")
    recovered = abs(loss_t - loss_m) <= max(
        0.5 * abs(loss_g - loss_m), 0.02)
    print("tracking recovers the matched trajectory:",
          "OK" if recovered else "VIOLATED")
    return {"matched": loss_m, "mismatched": loss_g, "tracked": loss_t,
            "alpha_hat": a_hat, "recovered": recovered}


if __name__ == "__main__":
    main()
