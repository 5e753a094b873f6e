"""Paper §5.1.2 — execution-score-guided workload distribution (+ §5.3.2 RMAS).

Port of the JAX package's ``repro/core/distribution.py``.  The paper
distributes the routing procedure across HMC vaults along exactly one of the
three parallelizable dimensions (B / L / H), chosen offline by the execution
score

    S = 1 / (alpha * E + beta * M)                                  (paper §5.1.2)

where E is the largest per-vault operation count (Eq.7/9/11), M the inter-vault
bytes moved (Eq.8/10/12), alpha a device compute coefficient (1/throughput) and
beta a communication coefficient (1/bisection bandwidth).

On the card a vault is a rank of a ``torch.distributed`` device mesh
(``runtime.mesh_utils``); the chosen dimension becomes the sharded dim of a
``core.router.ExecutionPlan`` (``plan="auto"`` runs this planner inside
``build_router``).  The port's default device model is ``DeviceModel.h100``
(nominal data-sheet rates), so its pick can differ from the reference's for
the same shape: that is a different device, not a different planner.  The
closed forms are the paper's, as printed.

Also kept: the multi-dimensional planner (``plan_multi``), the MoE
token-vs-expert planner and the RMAS host-vs-PIM arbitration optimum
n_h = floor(sqrt(n_max * gamma_h / (Q * gamma_v))) (§5.3.2), which has no
execution role here either.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Literal

Dim = Literal["B", "L", "H"]
DIMS: tuple[Dim, ...] = ("B", "L", "H")


@dataclass(frozen=True)
class RPShape:
    """Routing-procedure shape parameters (paper Table 3 symbols)."""
    n_b: int      # N_B: batch size
    n_l: int      # N_L: number of low-level capsules
    n_h: int      # N_H: number of high-level capsules
    c_l: int      # C_L: scalars per L capsule
    c_h: int      # C_H: scalars per H capsule
    iters: int    # I: routing iterations

    @classmethod
    def from_caps_config(cls, cfg) -> "RPShape":
        return cls(n_b=cfg.batch_size, n_l=cfg.num_l_caps, n_h=cfg.num_h_caps,
                   c_l=cfg.l_caps_dim, c_h=cfg.h_caps_dim, iters=cfg.routing_iters)


@dataclass(frozen=True)
class DeviceModel:
    """Device-dependent coefficients (paper: HMC frequency & inter-vault BW).

    alpha: seconds per scalar operation on one shard (1 / (FLOP/s per shard)).
    beta:  seconds per byte moved between shards (1 / interconnect GB/s).
    n_vault: number of shards ("vaults") the RP is distributed over.
    """
    alpha: float
    beta: float
    n_vault: int

    @classmethod
    def h100(cls, n_vault: int, flops: float = 67e12,
             link_bytes_per_s: float = 450e9) -> "DeviceModel":
        """One NVIDIA H100 per vault.  Nominal rates from the NVIDIA H100
        SXM5 80GB data sheet at 700 W: 67 TFLOP/s fp32 (outside the tensor
        cores) and 450 GB/s each way over NVLink (900 GB/s total).  Not
        measured; the planner only ranks dimensions with them."""
        return cls(alpha=1.0 / flops, beta=1.0 / link_bytes_per_s,
                   n_vault=n_vault)

    @classmethod
    def hmc(cls, n_vault: int = 32, freq_hz: float = 312.5e6,
            pes_per_vault: int = 16,
            xbar_bytes_per_s: float = 512e9) -> "DeviceModel":
        """The paper's HMC operating point (Table 4)."""
        return cls(alpha=1.0 / (freq_hz * pes_per_vault),
                   beta=1.0 / xbar_bytes_per_s, n_vault=n_vault)


SIZE_F32 = 4
SIZE_PKT = 16  # packet head+tail bytes (HMC spec 2.1 flit overhead)


def workload_E(dim: Dim, s: RPShape, n_vault: int) -> float:
    """Largest per-vault operation count for a distribution dimension.

    Paper Eq.7 (B), Eq.9 (L), Eq.11 (H) — simplified closed forms (the paper
    simplifies Eq.6 -> Eq.7 using N_L >> 1).
    """
    if dim == "B":
        shard = math.ceil(s.n_b / n_vault)
        return shard * s.n_l * s.n_h * (
            (4 * s.iters - 1) * s.c_h + 2 * s.c_l * s.c_h - s.iters)
    if dim == "L":
        shard = math.ceil(s.n_l / n_vault)
        return s.n_b * shard * s.n_h * (
            2 * s.iters * (2 * s.c_h - 1) + s.c_h * (2 * s.c_l - 1))
    if dim == "H":
        shard = math.ceil(s.n_h / n_vault)
        return s.n_b * s.n_l * shard * s.c_h * (2 * s.c_l - 1 + 2 * s.iters)
    raise ValueError(dim)


def comm_M(dim: Dim, s: RPShape, n_vault: int,
           size_var: int = SIZE_F32, size_pkt: int = SIZE_PKT) -> float:
    """Inter-vault bytes moved per RP execution.

    Paper Eq.8 (B: gather pre-aggregated b_ij, scatter c_ij),
    Eq.10 (L: all-reduce s_j, broadcast v_j), Eq.12 (H: all-reduce b_ij rows,
    broadcast c_ij).
    """
    nv = n_vault
    if dim == "B":
        return s.iters * ((nv - 1) * s.n_l * s.n_h * (size_var + size_pkt)
                          + (nv - 1) * s.n_l * s.n_h * (size_var + size_pkt))
    if dim == "L":
        return s.iters * (s.n_b * (nv - 1) * s.n_h * (s.c_h * size_var + size_pkt)
                          + s.n_b * (nv - 1) * s.n_h * (s.c_h * size_var + size_pkt))
    if dim == "H":
        return s.iters * ((nv - 1) * s.n_l * (size_var + size_pkt)
                          + s.n_l * (size_var + size_pkt))
    raise ValueError(dim)


def execution_score(dim: Dim, s: RPShape, dev: DeviceModel) -> float:
    """Paper: S = 1/(alpha*E + beta*M)."""
    return 1.0 / (dev.alpha * workload_E(dim, s, dev.n_vault)
                  + dev.beta * comm_M(dim, s, dev.n_vault))


def score_table(s: RPShape, dev: DeviceModel) -> Dict[Dim, float]:
    return {d: execution_score(d, s, dev) for d in DIMS}


def plan(s: RPShape, dev: DeviceModel) -> Dim:
    """Offline distribution-dimension selection (paper §5.1.2: "the
    distribution strategy can be determined off-line before the actual
    inference")."""
    table = score_table(s, dev)
    return max(table, key=table.__getitem__)


def estimated_time_s(dim: Dim, s: RPShape, dev: DeviceModel) -> float:
    """1/S — the modeled RP execution time used by benchmarks (Fig.15/18)."""
    return 1.0 / execution_score(dim, s, dev)


# ---------------------------------------------------------------------------
# §5.3.2 RMAS — runtime memory access scheduler arbitration optimum.
# No execution role (one memory master per card); kept for model
# completeness.
# ---------------------------------------------------------------------------

def rmas_overhead(n_h: int, n_max: int, q_bar: float,
                  gamma_v: float, gamma_h: float) -> float:
    """kappa = gamma_v * n_h * Q_bar + gamma_h * n_max / n_h   (paper Eq.15)."""
    if n_h == 0:
        return math.inf
    return gamma_v * n_h * q_bar + gamma_h * n_max / n_h


def rmas_optimal_grant(n_max: int, q_bar: float,
                       gamma_v: float, gamma_h: float) -> int:
    """n_h* = floor(sqrt(n_max*gamma_h / (Q_bar*gamma_v))), clamped [0,n_max]."""
    if q_bar <= 0 or gamma_v <= 0:
        return n_max
    n = int(math.floor(math.sqrt(n_max * gamma_h / (q_bar * gamma_v))))
    return max(0, min(n_max, n))


# ---------------------------------------------------------------------------
# Beyond-paper: multi-dimensional distribution (a 2-D mesh).
# The paper distributes on exactly ONE of {B, L, H}; a 2-D device mesh
# supports sharding two dims at once, localizing each aggregation to one
# ring of the mesh instead of the whole group.  Same enumerate/E/M/argmax
# structure, ring-all-reduce byte model.
# ---------------------------------------------------------------------------

def ring_allreduce_bytes(n: int, payload_bytes: float) -> float:
    """Per-device link bytes of a ring all-reduce over n members."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * payload_bytes


def workload_E_multi(axes: Dict[str, int], s: RPShape) -> float:
    """Largest per-shard op count with dims sharded per ``axes``
    (dim -> shard count); generalizes Eq.7/9/11's leading structure."""
    b_loc = math.ceil(s.n_b / axes.get("B", 1))
    l_loc = math.ceil(s.n_l / axes.get("L", 1))
    h_loc = math.ceil(s.n_h / axes.get("H", 1))
    return b_loc * l_loc * h_loc * (4 * s.iters * s.c_h
                                    + 2 * s.c_l * s.c_h)


def comm_M_ring(axes: Dict[str, int], s: RPShape,
                size_var: int = SIZE_F32) -> float:
    """Per-device inter-shard bytes per RP execution under ring
    all-reduces (the paper's aggregations as all-reduces):
      L sharded -> psum s (B_loc, H_loc, C_H) per iteration
      B sharded -> psum db (L_loc, H_loc) per iteration
      H sharded -> psum softmax max+sum (L_loc, 1) x2 per iteration
    """
    b_loc = math.ceil(s.n_b / axes.get("B", 1))
    l_loc = math.ceil(s.n_l / axes.get("L", 1))
    h_loc = math.ceil(s.n_h / axes.get("H", 1))
    per_iter = 0.0
    if axes.get("L", 1) > 1:
        per_iter += ring_allreduce_bytes(
            axes["L"], b_loc * h_loc * s.c_h * size_var)
    if axes.get("B", 1) > 1:
        per_iter += ring_allreduce_bytes(
            axes["B"], l_loc * h_loc * size_var)
    if axes.get("H", 1) > 1:
        per_iter += ring_allreduce_bytes(axes["H"], 2 * l_loc * size_var)
    return s.iters * per_iter


def plan_multi(s: RPShape, dev: DeviceModel,
               candidates: Dict[str, Dict[str, int]]) -> str:
    """argmax of the execution score over named candidate distributions
    (each a dim -> shard-count map whose product is dev.n_vault)."""
    def cost(axes):
        return (dev.alpha * workload_E_multi(axes, s)
                + dev.beta * comm_M_ring(axes, s))
    return min(candidates, key=lambda k: cost(candidates[k]))


# ---------------------------------------------------------------------------
# Beyond-paper: the same planner structure applied to MoE dispatch.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEShape:
    tokens: int        # tokens per step (global)
    d_model: int
    d_ff: int          # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


def moe_plan(s: MoEShape, dev: DeviceModel,
             bytes_per_el: int = 2) -> Dict[str, float]:
    """Model per-shard work E and inter-shard bytes M for the two canonical
    MoE shardings on one mesh axis of size n_vault:

    'expert'   : experts sharded, activations replicated on the axis; each
                 shard FFNs only tokens routed to its local experts and the
                 outputs are psum-combined (bytes: tokens*d_model per layer).
    'token'    : tokens sharded, experts replicated; zero dispatch collectives
                 but every shard holds all expert weights (E epsilon-higher
                 from worse locality; M counts the weight all-gather amortised
                 to zero in steady state -> dominated by the router psum).
    'a2a'      : tokens and experts both sharded; all-to-all dispatch+return
                 (bytes: 2 * tokens*top_k/nv * d_model * (nv-1)/nv).
    Returns modeled seconds per MoE layer for each strategy.
    """
    nv = dev.n_vault
    ffn_flops = 2 * s.tokens * s.top_k * (3 * s.d_model * s.d_ff)  # gate/up/down
    out = {}
    # expert-sharded: work balanced by capacity; comm = psum of outputs
    e_exp = ffn_flops / nv * s.capacity_factor
    m_exp = 2.0 * s.tokens * s.d_model * bytes_per_el  # reduce-scatter+all-gather
    out["expert"] = dev.alpha * e_exp + dev.beta * m_exp
    # token-sharded: work balanced by tokens; comm ~ router stats psum only
    e_tok = ffn_flops / nv
    m_tok = s.n_experts * SIZE_F32 * math.log2(max(nv, 2))
    out["token"] = dev.alpha * e_tok + dev.beta * m_tok
    # all-to-all: balanced work, 2x a2a of the routed activations
    e_a2a = ffn_flops / nv * s.capacity_factor
    m_a2a = 2.0 * s.tokens * s.top_k / nv * s.d_model * bytes_per_el * (nv - 1)
    out["a2a"] = dev.alpha * e_a2a + dev.beta * m_a2a
    return out
