"""The port's resident round on ResNet-tiny against the JAX package's.

A small ResNet-tiny (channels (8, 16), one block per stage, 8x8x3
images) exercises the convolution, GroupNorm and residual paths of
``repro_torch.models.vision`` under ``torch.func.vmap`` of
``grad_and_value``, through two rounds of the resident slab engine on
the CPU, fed the JAX package's own draws (``tests/_torch_ref.py``).
"""

import numpy as np

from _torch_ref import (METRICS, assert_close, assert_states, max_rel_err,
                        run_both)
from repro.models import vision as jvision
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.fl import FLConfig
from repro_torch.models import vision as tvision


def test_resnet_tiny_two_rounds_match_jax():
    """Small ResNet-tiny, 2 rounds of adam_ota.

    Looser tier, 1e-4: torch's CPU convolutions and GroupNorm means sum
    in another order than XLA's, so per-client gradients differ by f32
    ulps, and the alpha-root step (Delta / v^{1/alpha}) passes that on
    to w. Measured here: w within 6e-8 absolute (4.8e-6 relative above
    1e-3), the optimizer slabs within 4e-6 absolute on values up to 25,
    the metrics within 8e-6 absolute (the noisy-gradient norm is ~40).
    The tier leaves headroom for the convolution algorithms other CPUs
    pick. The JAX side is the jnp backend: the same round, compiled in
    a fraction of the Pallas-interpret graph's time.
    """
    tol = 1e-4
    jm = jvision.resnet_tiny(10, channels=(8, 16), blocks_per_stage=1)
    tm = tvision.resnet_tiny(10, channels=(8, 16), blocks_per_stage=1)
    # Random weights made by the port's init (the JAX init is slow
    # un-jitted); both packages get the same numpy arrays.
    params = {k: v.numpy() for k, v in tm.init(seed=3, device="cpu").items()}
    rng = np.random.default_rng(5)
    n, b = 3, 2
    batches = [{"x": rng.normal(size=(n, b, 8, 8, 3)).astype(np.float32),
                "y": rng.integers(0, 10, (n, b)).astype(np.int64)}
               for _ in range(2)]
    ch = OTAChannelConfig()
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.01)
    fl = FLConfig(n_clients=n)
    jstate, tstate, ms = run_both(jm, tm, params, batches, ch, ad, fl,
                                   "jnp")
    assert_states(jstate, tstate, tol)
    for jmet, tmet in ms:
        for f in METRICS:
            assert_close(getattr(tmet, f), getattr(jmet, f), tol, tol, f)
    assert max_rel_err(tstate.w, jstate.w, floor=1e-3) < tol
