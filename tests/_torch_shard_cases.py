"""The sharded-engine parity cases shared by ``tests/_torch_shard_jax.py``
(the JAX package's side, run in a subprocess with forced host devices)
and ``tests/test_torch_shard_jax.py`` (the port's side). Plain Python:
both sides build their configs from these dicts.

A case runs ``ROUNDS`` rounds of the quadratic loss of
``repro.launch.shard_check`` (parameters as there, from ``seed`` with
numpy; the same client batches every round) on a client mesh:

* ``runner``: the resident sharded runner (``make_slab_round_runner(
  backend="pallas_sharded")``), the gathered final state and the metrics
  of every round compared;
* ``perround``: ``make_round_step(backend="pallas_sharded")``, the final
  params and optimizer state;
* ``psum``: ``make_sharded_round_step``, one client a rank, the final
  params, optimizer state and losses.
"""

N_CLIENTS = 8
ROUNDS = 5
OPTIMIZERS = ("adagrad_ota", "adam_ota", "amsgrad_ota", "yogi_ota",
              "fedavgm", "fedavg")
# one optimizer per state-slab row count (3/2/1/0)
PERROUND_OPTIMIZERS = ("amsgrad_ota", "adam_ota", "fedavgm", "fedavg")
WEIGHTS = (1.0, 3.0, 0.5, 2.0, 1.0, 4.0, 0.25, 1.5)


def _ad(optimizer="adam_ota", alpha=1.5):
    return dict(optimizer=optimizer, lr=0.05, alpha=alpha, beta2=0.3)


def _case(name, mesh, kind="runner", uplink=None, channel=None, ad=None,
          fl=None, bucketed=False, tol=1e-5, n_clients=N_CLIENTS):
    ch = dict(alpha=1.5, xi_scale=0.1, uplink=dict(uplink or {}))
    ch.update(channel or {})
    return dict(name=name, mesh=mesh, kind=kind, channel=ch,
                adaptive=ad or _ad(), fl=dict(n_clients=n_clients,
                                              **(fl or {})),
                bucketed=bucketed, tol=tol)


CASES = (
    [_case(f"f32-{opt}-p2", (2,), ad=_ad(opt)) for opt in OPTIMIZERS]
    + [_case(f"f32-{opt}-p2x2", (2, 2), ad=_ad(opt)) for opt in OPTIMIZERS]
    + [_case("int8-ef-dl8-p2", (2,),
             uplink=dict(mode="int8", error_feedback=True),
             channel=dict(downlink="int8")),
       _case("sign-fold-ef-p2", (2,),
             uplink=dict(mode="sign", error_feedback=True)),
       _case("f32-auto-p2", (2,), ad=_ad(alpha="auto")),
       _case("stream-ragged-weights-p2", (2,),
             fl=dict(client_chunk=3, sample_rate=0.5,
                     client_weights=WEIGHTS)),
       _case("stream-int8-ef-db-p2", (2,),
             uplink=dict(mode="int8", error_feedback=True),
             fl=dict(client_chunk=2, sample_rate=0.5, double_buffer=True)),
       _case("buckets2-auto-p2", (2,), channel=dict(comm_buckets=2),
             ad=_ad(alpha="auto"), bucketed=True, tol=1e-4)]
    + [_case(f"perround-{opt}-p2", (2,), kind="perround", ad=_ad(opt))
       for opt in PERROUND_OPTIMIZERS]
    + [_case("psum-adam-p2", (2,), kind="psum", n_clients=2)]
)


def inputs(case):
    """(params, batches) of a case as numpy: the parameters of
    ``repro.launch.shard_check`` (4096 entries for the bucketed engine),
    the clients' batches in the parameters' shapes."""
    import numpy as np
    from repro_torch.launch.shard_check import check_params
    params = check_params(case["bucketed"])
    rng = np.random.default_rng(3)
    n = case["fl"]["n_clients"]
    batches = {k: rng.normal(size=(n,) + p.shape).astype(np.float32)
               for k, p in params.items()}
    return params, batches
