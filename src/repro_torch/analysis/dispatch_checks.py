"""Dispatch-tier checks: contracts read off the aten ops of a real round.

The port's twin of ``repro.analysis.jaxpr_checks``. Where the JAX
package traces a jaxpr, the port runs one resident round
(``make_slab_round_step``) of a tiny cell on the CPU under a
``TorchDispatchMode`` (``OpLedger``), which sees every aten op the round
dispatches, the clients' ``vmap(grad)`` included:

* ``round-draws``: the round dispatches no aten random op on any wire.
  Its randomness comes in as ``RoundDraws``, drawn before the round.
* ``draw-ledger``: every draws provider gives the same ``RoundDraws``
  fields, shapes and dtypes, and so the same number of draws a round,
  on every wire (``WIRES``): the fields the round reads for that
  configuration (``required_draws``, the contract of ``core/draws.py``).
  The port's provider, ``TorchDraws``, must also make each drawn field
  with exactly one aten random op. The reference provider that draws
  with the JAX package's own functions lives beside the tests, which
  pass it in (``check_draw_ledgers(providers)``).
* ``wire-downcast``: the all-f32 wire's round narrows no f32 tensor
  (no ``_to_copy`` or ``copy_`` from f32 to bf16, f16, int8 or uint8).

The JAX tier's third check, buffer donation, has no twin: the port's
round writes new outputs and donates no buffer.

Heavier than the AST tier (it imports torch and runs the engine): run
it with ``python -m repro_torch.analysis --dispatch``. Findings anchor
to ``src/repro_torch/core/fl.py``, the round-step builder that owns
these contracts, with the wire's name as the stable baseline snippet.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
from repro_torch.core.draws import RoundDraws, TorchDraws
from repro_torch.core.fl import FLConfig, make_slab_round_step
from repro_torch.core.slab import SlabSpec, make_slab_spec
from repro_torch.core.slab_state import init_train_state

DISPATCH_RULES = {
    "round-draws":
        "the round dispatches an aten random op (draws come as RoundDraws)",
    "draw-ledger":
        "a draws provider's RoundDraws fields, shapes or dtypes differ "
        "from the round's on a wire",
    "wire-downcast":
        "the all-f32 wire's round narrows an f32 tensor",
    "dispatch-internal-error":
        "a dispatch-tier check itself crashed (API drift?)",
}

# Contracts live in the round-step builder; findings anchor there.
_ANCHOR = "src/repro_torch/core/fl.py"

# aten random ops by overload packet, the in-place forms without "_"
_RANDOM_OPS = {"rand", "randn", "randint", "randperm", "rand_like",
               "randn_like", "randint_like", "normal", "uniform",
               "exponential", "bernoulli", "multinomial", "poisson",
               "random", "geometric", "log_normal", "cauchy",
               "native_dropout"}
_NARROW = (torch.bfloat16, torch.float16, torch.int8, torch.uint8)
# RoundDraws' draw fields (``shard`` is the transmitter's index)
_FIELDS = ("h", "u", "e", "r_up", "r_dl", "sr_seed", "mask", "r_clean",
           "sr_seed_clean")

# A provider: (channel config, slab spec, clients, sample rate, round)
# -> that round's RoundDraws.
Provider = Callable[[OTAChannelConfig, SlabSpec, int, float, int],
                    RoundDraws]

_CH = dict(alpha=1.5, xi_scale=0.1)
# wire name -> (channel config, sample rate)
WIRES: Dict[str, Tuple[OTAChannelConfig, float]] = {
    "f32": (OTAChannelConfig(**_CH), 1.0),
    "f32-sampled": (OTAChannelConfig(**_CH), 0.5),
    "int8-ef": (OTAChannelConfig(**_CH, uplink=UplinkConfig(
        mode="int8", error_feedback=True)), 1.0),
    "int8-ef-dl8": (OTAChannelConfig(**_CH, downlink="int8",
                                     uplink=UplinkConfig(
                                         mode="int8", error_feedback=True)),
                    1.0),
    "sign-fold-ef": (OTAChannelConfig(**_CH, uplink=UplinkConfig(
        mode="sign", error_feedback=True)), 1.0),
}
F32_WIRES = ("f32", "f32-sampled")
N_CLIENTS = 2


class OpLedger(TorchDispatchMode):
    """Counts, while active, the aten random ops (by name) and the
    narrowing casts of f32 tensors (by target dtype) that run."""

    def __init__(self):
        super().__init__()
        self.random: Counter = Counter()
        self.downcasts: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name.rstrip("_") in _RANDOM_OPS:
            self.random[name] += 1
        src = dst = None
        if name == "_to_copy" and torch.is_tensor(args[0]):
            src, dst = args[0].dtype, kwargs.get("dtype")
        elif name == "copy_" and all(torch.is_tensor(a) for a in args[:2]):
            src, dst = args[1].dtype, args[0].dtype
        if src == torch.float32 and dst in _NARROW:
            self.downcasts[str(dst).removeprefix("torch.")] += 1
        return func(*args, **kwargs)


def op_ledger(fn: Callable, *args, **kwargs) -> Tuple[OpLedger, object]:
    """Run ``fn(*args, **kwargs)`` under an ``OpLedger``; returns the
    ledger and ``fn``'s result."""
    with OpLedger() as ledger:
        out = fn(*args, **kwargs)
    return ledger, out


def draw_ledger(draws: RoundDraws) -> Counter:
    """The multiset of (field, shape, dtype) of the draw fields a
    ``RoundDraws`` carries (an int seed as shape () and "int")."""
    out: Counter = Counter()
    for f in _FIELDS:
        x = getattr(draws, f)
        if torch.is_tensor(x):
            out[(f, tuple(x.shape), str(x.dtype).removeprefix("torch."))] += 1
        elif x is not None:
            out[(f, (), "int")] += 1
    return out


def required_draws(ch: OTAChannelConfig, spec: SlabSpec, n: int,
                   sample_rate: float) -> Counter:
    """The draw fields a single-device round on the CPU reads for this
    configuration (``core/draws.py``'s contract): h (n,), u and e over
    the padded slab; ``r_up`` for the int8 uplink with stochastic
    rounding, ``sr_seed`` beside it under ``sr_inkernel``; ``r_dl`` for
    the int8 downlink; ``mask`` (n,) under partial participation."""
    padded = spec.padded
    want = Counter({("h", (n,), "float32"): 1,
                    ("u", (padded,), "float32"): 1,
                    ("e", (padded,), "float32"): 1})
    up = ch.uplink
    if up.mode == "int8" and up.stochastic_rounding:
        want[("r_up", (padded,), "float32")] += 1
        if up.sr_inkernel:
            want[("sr_seed", (), "int")] += 1
    if ch.downlink == "int8":
        want[("r_dl", (padded,), "float32")] += 1
    if sample_rate < 1.0:
        want[("mask", (n,), "float32")] += 1
    return want


def torch_draws(ch: OTAChannelConfig, spec: SlabSpec, n: int,
                sample_rate: float, t: int) -> RoundDraws:
    """The port's provider, on the CPU, seed 0."""
    return TorchDraws(ch, spec, n, seed=0, device="cpu",
                      sample_rate=sample_rate)(t)


PORT_PROVIDER = "TorchDraws"


def tiny_params() -> dict:
    """The tiny cell's parameters: two leaves, one with a partial final
    128-lane block (the JAX tier's cell)."""
    return {"a": torch.ones((3, 5)), "b": torch.ones((130,))}


def _quad_loss(p, batch):
    return sum(torch.mean((p[k] - batch[k]) ** 2) for k in sorted(p))


@dataclasses.dataclass
class Cell:
    """One wire's round: ``step(state, draws, batches)`` and its inputs."""
    step: Callable
    state: object
    draws: RoundDraws
    batches: dict


def tiny_cell(wire: str, provider: Provider = torch_draws) -> Cell:
    """``wire``'s tiny round on the CPU: adam_ota, N_CLIENTS clients,
    round 0's draws from ``provider``."""
    ch, rate = WIRES[wire]
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha=1.5, beta2=0.3)
    fl = FLConfig(n_clients=N_CLIENTS, sample_rate=rate)
    params = tiny_params()
    step = make_slab_round_step(_quad_loss, ch, ad, fl, device="cpu")
    state = init_train_state(ad, params,
                             error_feedback=ch.uplink.error_feedback,
                             device="cpu")
    batches = {k: torch.zeros((N_CLIENTS, *v.shape))
               for k, v in params.items()}
    draws = provider(ch, state.spec, N_CLIENTS, rate, 0)
    return Cell(step, state, draws, batches)


def _finding(rule: str, message: str, wire: str) -> Finding:
    return Finding(_ANCHOR, 1, rule, "error", message, snippet=wire)


def check_round_draws(cells: Optional[Dict[str, Cell]] = None
                      ) -> List[Finding]:
    """No wire's round dispatches an aten random op."""
    cells = cells if cells is not None else {w: tiny_cell(w) for w in WIRES}
    findings = []
    for wire, c in cells.items():
        ledger, _ = op_ledger(c.step, c.state, c.draws, c.batches)
        if ledger.random:
            ops = ", ".join(f"{k} x{v}" for k, v in
                            sorted(ledger.random.items()))
            findings.append(_finding(
                "round-draws", f"the {wire} round dispatches random ops "
                f"({ops}): its randomness must come in as RoundDraws",
                wire))
    return findings


def check_draw_ledgers(providers: Optional[Dict[str, Provider]] = None,
                       wires=tuple(WIRES)) -> List[Finding]:
    """Each provider's round-0 draws on each wire carry exactly the
    fields, shapes and dtypes the round reads; the port's provider makes
    each drawn tensor field with one aten random op."""
    providers = providers or {PORT_PROVIDER: torch_draws}
    spec = make_slab_spec(tiny_params())
    findings = []
    for wire in wires:
        ch, rate = WIRES[wire]
        want = required_draws(ch, spec, N_CLIENTS, rate)
        for name, provider in providers.items():
            ledger, draws = op_ledger(provider, ch, spec, N_CLIENTS, rate, 0)
            got = draw_ledger(draws)
            if got != want:
                diff = "; ".join(
                    f"{f}{list(s)} {d}: round x{want[(f, s, d)]} vs "
                    f"{name} x{got[(f, s, d)]}"
                    for f, s, d in sorted(set(want) | set(got), key=repr)
                    if want[(f, s, d)] != got[(f, s, d)])
                findings.append(_finding(
                    "draw-ledger", f"{name}'s draws on the {wire} wire "
                    f"differ from what the round reads: {diff}", wire))
            drawn = sum(v for (f, s, d), v in got.items() if d != "int")
            n_ops = sum(ledger.random.values())
            if name == PORT_PROVIDER and n_ops != drawn:
                findings.append(_finding(
                    "draw-ledger", f"{name} makes the {wire} wire's {drawn} "
                    f"drawn fields with {n_ops} random ops, not one each",
                    wire))
    return findings


def check_wire_downcast(cells: Optional[Dict[str, Cell]] = None
                        ) -> List[Finding]:
    """The all-f32 wires' rounds narrow no f32 tensor."""
    cells = (cells if cells is not None else
             {w: tiny_cell(w) for w in F32_WIRES})
    findings = []
    for wire, c in cells.items():
        ledger, _ = op_ledger(c.step, c.state, c.draws, c.batches)
        if ledger.downcasts:
            casts = ", ".join(f"{k} x{v}" for k, v in
                              sorted(ledger.downcasts.items()))
            findings.append(_finding(
                "wire-downcast", f"the {wire} round narrows f32 tensors "
                f"({casts}): narrowing belongs to a quantized wire only",
                wire))
    return findings


def run_dispatch_checks() -> List[Finding]:
    """All dispatch-tier checks; a crashing check is a finding."""
    findings: List[Finding] = []
    for check in (check_round_draws, check_draw_ledgers,
                  check_wire_downcast):
        try:
            findings += check()
        except Exception as exc:  # noqa: BLE001 - surfaced, not hidden
            findings.append(Finding(
                _ANCHOR, 1, "dispatch-internal-error", "error",
                f"{check.__name__} crashed: {type(exc).__name__}: {exc}",
                snippet=check.__name__))
    return findings
