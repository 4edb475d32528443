"""Paper-figure reproductions on the port (CPU-sized synthetic stand-ins).

PyTorch counterpart of ``benchmarks/paper_figs.py``. One function per
figure of the paper; each runs the REAL system end to end (clients ->
OTA MAC -> adaptive server) through the per-round API
(``core.fl.make_round_step`` + ``init_server`` + ``run_rounds``): on the
f32 uplink a round is one ``ota_channel_slab`` and one
``adaptive_update_slab`` launch. Returns records with the JAX module's
keys, in its order.

  fig2  — Adam-OTA vs AdaGrad-OTA vs FedAvgM-OTA, non-iid Dir=0.1, a=1.5
  fig3  — same at a=1.8, scale=0.01 (milder channel)
  fig4  — beta2 sweep for Adam-OTA
  fig5  — tail-index (alpha) sweep for AdaGrad-OTA
  fig6  — client-count (N) sweep for AdaGrad-OTA
  fig7  — Dirichlet heterogeneity sweep for AdaGrad-OTA

Two differences from the JAX module. ``_run`` reads ``ROUNDS`` when it
is called, so setting ``paper_figs.ROUNDS`` reaches every figure (the
JAX ``_run`` binds its default at import, and runs 80 rounds whatever
``ROUNDS`` says later). The round is the JAX package's
``backend="pallas"`` round (the interference drawn over the slab), fed
the port's own draws (``TorchDraws``, Philox), so the numbers are not
the JAX script's. Each run, and each figure, takes ``device`` (default:
the card).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.fl import (FLConfig, init_server, make_round_step,
                                 run_rounds)
from repro_torch.core.slab import make_slab_spec
from repro_torch.data import (FederatedBatcher, gaussian_mixture,
                              synthetic_images)
from repro_torch.device import DeviceLike
from repro_torch.models.vision import (accuracy, logistic_regression, mlp,
                                      resnet_tiny)

ROUNDS = 80


def _run(optimizer: str, *, task: str = "logreg", alpha=1.5, scale=0.1,
         n_clients=50, dir_alpha=0.1, lr=0.05, beta2=0.3, rounds=None,
         seed=0, device: DeviceLike = None) -> Dict:
    """One training run; ``rounds=None`` means ``ROUNDS`` as it stands
    at the call."""
    rounds = ROUNDS if rounds is None else rounds
    if task == "logreg":
        data = gaussian_mixture(6000, 32, 10, seed=seed)
        model = logistic_regression(32, 10)
        batch_size = 16
    elif task == "mlp":
        data = gaussian_mixture(6000, 32, 10, seed=seed)
        model = mlp(32, 10, hidden=64)
        batch_size = 16
    else:  # "cnn" — the ResNet-tiny / CIFAR-like task
        data = synthetic_images(3000, 16, 3, 10, seed=seed)
        model = resnet_tiny(10, channels=(8, 16), blocks_per_stage=1)
        batch_size = 8

    fb = FederatedBatcher(data, n_clients, batch_size, dir_alpha=dir_alpha,
                          seed=seed)
    ch = OTAChannelConfig(alpha=alpha, xi_scale=scale)
    ad = AdaptiveConfig(optimizer=optimizer, lr=lr, alpha=alpha, beta2=beta2)
    rs = make_round_step(model.loss_fn, ch, ad, FLConfig(n_clients=n_clients),
                         device=device)
    params = model.init(seed=seed, device=device)
    state = init_server(params, ad)
    draws = TorchDraws(ch, make_slab_spec(params), n_clients, seed=seed + 1,
                       device=device)

    t0 = time.time()
    params, state, hist = run_rounds(rs, params, state, draws, fb, rounds)
    dt = time.time() - t0
    losses = [h["loss"] for h in hist]
    acc = accuracy(model, params, data.x, data.y)
    return dict(optimizer=optimizer, task=task, alpha=alpha, scale=scale,
                n_clients=n_clients, dir_alpha=dir_alpha, beta2=beta2,
                final_loss=float(np.mean(losses[-10:])),
                # convergence-speed proxy: mean loss over the first half of
                # training (the paper's figs compare convergence CURVES)
                speed_loss=float(np.mean(losses[:max(rounds // 2, 1)])),
                first_loss=losses[0], accuracy=acc,
                seconds=round(dt, 1), us_per_round=dt / rounds * 1e6,
                loss_curve=[round(l, 4) for l in losses])


def fig2(task: str = "logreg", device: DeviceLike = None) -> List[Dict]:
    """ADOTA vs FedAvgM under heavy-tailed channel (a=1.5, Dir=0.1).

    Channel scale calibrated to 0.3 for the synthetic stand-in: the
    paper's 0.1 is relative to ResNet-on-CIFAR gradient magnitudes; on
    the (easier) gaussian-mixture logreg task 0.1 barely perturbs
    training and ALL methods converge — 0.3 restores the signal-to-
    interference regime the paper operates in (documented substitution).
    """
    out = []
    for opt, lr in [("adam_ota", 0.05), ("adagrad_ota", 0.05),
                    ("fedavgm", 0.01)]:
        out.append(_run(opt, task=task, lr=lr, scale=0.3, device=device))
    return out


def fig3(device: DeviceLike = None) -> List[Dict]:
    """Milder channel: a=1.8, scale=0.01 (paper Fig. 3 setup)."""
    out = []
    for opt, lr in [("adam_ota", 0.05), ("adagrad_ota", 0.05),
                    ("fedavgm", 0.01)]:
        out.append(_run(opt, alpha=1.8, scale=0.01, lr=lr, device=device))
    return out


def fig4(device: DeviceLike = None) -> List[Dict]:
    """beta2 sweep (paper found 0.3 best, extremes worse)."""
    return [_run("adam_ota", beta2=b2, device=device)
            for b2 in (0.1, 0.3, 0.6, 0.9)]


def fig5(device: DeviceLike = None) -> List[Dict]:
    """alpha sweep for AdaGrad-OTA (heavier tail -> slower)."""
    return [_run("adagrad_ota", alpha=a, scale=0.3, device=device) for a in
            (1.2, 1.5, 1.8, 2.0)]


def fig6(device: DeviceLike = None) -> List[Dict]:
    """client count sweep (more clients -> better, Remark 12).

    Strong-interference regime (scale 0.5): Upsilon's 1/N^{a/2} term
    damps the FADING noise, so the effect is visible when the channel
    actually stresses training (calibrated like fig2)."""
    return [_run("adagrad_ota", n_clients=n, dir_alpha=0.2, scale=0.5,
                 device=device)
            for n in (2, 10, 50, 100)]


def fig7(device: DeviceLike = None) -> List[Dict]:
    """heterogeneity sweep (smaller Dir -> slower convergence). Compared
    on the convergence-speed proxy (mean first-half loss), the quantity
    the paper's Fig. 7 curves actually show; run on the non-convex MLP
    where client drift matters."""
    return [_run("adagrad_ota", task="mlp", dir_alpha=d, scale=0.3,
                 device=device)
            for d in (0.05, 0.1, 0.5, 10.0)]


def beyond_yogi(device: DeviceLike = None) -> List[Dict]:
    """Beyond-paper: FedYogi-style alpha-power variant vs Adam-OTA."""
    return [_run("yogi_ota", device=device), _run("adam_ota", device=device)]
