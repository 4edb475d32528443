"""The JAX package's side of ``tests/test_torch_shard_jax.py``: run every
case of ``_torch_shard_cases.CASES`` on a client mesh of forced host
devices and write, for each, the trajectory and the draws each rank of
the port must take, to the ``.npz`` named on the command line:

    python tests/_torch_shard_jax.py OUT.npz

Keys are ``<case>/<field>``: the runner's gathered final state (``w``,
``opt<i>``, ``alpha_hat``, ``step``, ``ef``) and every round's metrics
(``m_<field>``), or the final leaves (``leaf<i>``) and losses; the draws
``h``, ``u``, ``e``, ``r_dl``, ``mask`` per round and ``r_up`` (rounds,
P, 2, padded), the transmitters' ``uplink_sr_slab_inputs``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from repro.launch.hostdev import force_host_devices  # noqa: E402

force_host_devices(4)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _torch_shard_cases import CASES, ROUNDS, inputs  # noqa: E402
from repro.compat import shard_map  # noqa: E402
from repro.core.adaptive import AdaptiveConfig  # noqa: E402
from repro.core.channel import (OTAChannelConfig, UplinkConfig,  # noqa: E402
                                sample_fading)
from repro.core.fl import (FLConfig, init_server, make_round_step,  # noqa: E402
                           make_sharded_round_step, make_slab_round_runner)
from repro.core.ota import (_cms_slab_inputs, downlink_sr_slab_inputs,  # noqa: E402
                            uplink_sr_slab_inputs)
from repro.core.slab import make_slab_spec  # noqa: E402
from repro.core.slab_state import init_train_state  # noqa: E402
from repro.core.stream import participation_mask  # noqa: E402
from repro.launch.mesh import make_client_mesh  # noqa: E402


def _loss_fn(p, batch):
    return sum(jnp.mean((x - t) ** 2)
               for x, t in zip(jax.tree.leaves(p), jax.tree.leaves(batch)))


def _configs(case):
    ch = dict(case["channel"])
    ch["uplink"] = UplinkConfig(**ch["uplink"])
    fl = dict(case["fl"])
    return (OTAChannelConfig(**ch, backend="pallas_sharded"),
            AdaptiveConfig(**case["adaptive"]), FLConfig(**fl))


def _draws(key, ch, fl, spec, n_shards, n):
    """The round's draws as the sharded JAX round makes them from
    ``key``: full-round fields and each transmitter's rounding rows."""
    kh, kx = jax.random.split(key)
    out = {"h": sample_fading(kh, ch, (n,))}
    if ch.interference:
        out["u"], out["e"] = _cms_slab_inputs(kx, spec)
    else:
        out["u"] = jnp.zeros((spec.padded,), jnp.float32)
        out["e"] = jnp.ones((spec.padded,), jnp.float32)
    if ch.downlink == "int8":
        out["r_dl"] = downlink_sr_slab_inputs(key, spec.padded)
    if fl.sample_rate < 1.0:
        out["mask"] = participation_mask(key, n, fl.sample_rate)
    if ch.uplink.mode == "int8" and ch.uplink.stochastic_rounding:
        out["r_up"] = jnp.stack([uplink_sr_slab_inputs(key, spec, p)
                                 for p in range(n_shards)])
    return out


def run(case):
    ch, ad, fl = _configs(case)
    mesh = make_client_mesh(case["mesh"])
    n_shards = int(np.prod(case["mesh"]))
    params_np, batches_np = inputs(case)
    params = jax.tree.map(jnp.asarray, params_np)
    batches = jax.tree.map(jnp.asarray, batches_np)
    keys = [jax.random.fold_in(jax.random.key(7), t) for t in range(ROUNDS)]
    out = {}
    if case["kind"] == "runner":
        runner = make_slab_round_runner(_loss_fn, ch, ad, fl,
                                        backend="pallas_sharded", mesh=mesh)
        state = init_train_state(ad, params, shards=n_shards,
                                 error_feedback=ch.uplink.error_feedback)
        spec = state.spec
        stacked = jax.tree.map(lambda b: jnp.stack([b] * ROUNDS), batches)
        state, ms = runner(state, jnp.stack(keys), stacked)
        out.update(w=state.w, alpha_hat=state.alpha_hat, step=state.step)
        for i, o in enumerate(state.opt):
            out[f"opt{i}"] = o
        if state.ef is not None:
            out["ef"] = state.ef
        for f in ms._fields:
            out[f"m_{f}"] = getattr(ms, f)
        n = fl.n_clients
    elif case["kind"] == "perround":
        spec = make_slab_spec(params, shards=n_shards)
        step = make_round_step(_loss_fn, ch, ad, fl,
                               backend="pallas_sharded", mesh=mesh)
        p, s = params, init_server(params, ad)
        for k in keys:
            p, s, m = step(p, s, k, batches)
        for i, x in enumerate(jax.tree.leaves((p, s))):
            out[f"leaf{i}"] = x
        for f in m._fields:
            out[f"m_{f}"] = getattr(m, f)
        n = fl.n_clients
    else:
        spec = make_slab_spec(params)
        body = make_sharded_round_step(_loss_fn, ch, ad,
                                       client_axes=("data",))
        sharded = jax.jit(shard_map(
            body, mesh, in_specs=(P(), P(), P(), P("data")),
            out_specs=(P(), P(), P())))
        p, s, losses = params, init_server(params, ad), []
        for k in keys:
            p, s, loss = sharded(p, s, k, batches)
            losses.append(loss)
        for i, x in enumerate(jax.tree.leaves((p, s))):
            out[f"leaf{i}"] = x
        out["losses"] = jnp.stack(losses)
        n = n_shards
    draws = [_draws(k, ch, fl, spec, n_shards, n) for k in keys]
    for name in draws[0]:
        out[name] = jnp.stack([d[name] for d in draws])
    return {f"{case['name']}/{k}": np.asarray(v) for k, v in out.items()}


def main(path):
    arrays = {}
    for case in CASES:
        arrays.update(run(case))
    np.savez(path, **arrays)


if __name__ == "__main__":
    main(sys.argv[1])
