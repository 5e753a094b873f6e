"""The paper's inter-vault distribution (§5.1) on the PyTorch/CUDA port,
executed over ranks through the unified Router API: shard the routing
procedure on B / L / H, verify all three give the same answer, show the
planner's choice, and let ``plan="auto"`` pick the dimension itself.

The twin of ``distributed_routing.py``.  In place of the reference's 8
fake host devices, ``-n`` ranks (2 by default, an even number) started by
``repro_torch.launch.ranks``: gloo ranks on the CPU, and on the H100 gloo
ranks that share the card (NCCL takes one rank a card).  Every rank makes
the same inputs from one numpy seed, and rank 0 prints and returns.  In
place of the collectives the reference reads from the compiled HLO, the
collectives each sharded call issued (``mesh_utils.COLLECTIVE_HOOKS``).

    PYTHONPATH=src python examples/torch_distributed_routing.py
    PYTHONPATH=src python examples/torch_distributed_routing.py -n 4 \\
        --device cpu
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.core import distribution as D
from repro_torch.core.router import ExecutionPlan, RouterSpec, build_router
from repro_torch.kernels import resolve_device
from repro_torch.launch import ranks
from repro_torch.runtime import mesh_utils

B, L, H, C = 16, 64, 8, 16
_TAG = {"torch": "", "cuda": " (cuda kernels)"}


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", "--ranks", type=int, default=2,
                    help="ranks of the 'vault' axis (an even number)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds after which the ranks are terminated")
    args = ap.parse_args(argv)
    if args.ranks < 2 or args.ranks % 2:
        ap.error(f"-n must be an even number of ranks; got {args.ranks}")
    return args


def _collectives(call):
    """(call(), the sorted kinds of the collectives it issued)."""
    kinds = set()

    def hook(kind, nbytes, size):
        kinds.add(kind)
    mesh_utils.COLLECTIVE_HOOKS.append(hook)
    try:
        out = call()
    finally:
        mesh_utils.COLLECTIVE_HOOKS.remove(hook)
    return out, sorted(kinds)


def rank_main(argv) -> dict:
    """One rank's part (``launch.ranks`` runs it on every rank)."""
    args = _args(argv)
    dev = resolve_device(args.device)
    n = ranks.world_size()
    say = print if torch.distributed.get_rank() == 0 else (lambda *a: None)
    out = {"ranks": n, "device": str(dev)}
    mesh = mesh_utils.make_mesh((n,), ("vault",), dev)
    say(f"mesh: {n} ranks on one 'vault' axis (paper: 32 HMC vaults)")

    rng = np.random.default_rng(0)
    u_hat = torch.from_numpy(rng.standard_normal(
        (B, L, H, C), dtype=np.float32)).to(dev)
    spec = RouterSpec(algorithm="dynamic", iterations=3)
    v_ref = build_router(spec, device=dev)(u_hat)

    for backend in ("torch", "cuda"):
        for dim in ("B", "L", "H"):
            routed = build_router(
                spec._replace(backend=backend),
                ExecutionPlan(mesh=mesh, axes=((dim, "vault"),)),
                device=dev)
            v, colls = _collectives(lambda: routed(u_hat))
            err = float((v - v_ref).abs().max())
            say(f"  {dim}-sharded{_TAG[backend]}: max err vs unsharded "
                f"{err:.2e}; collectives: {colls}")
            out[f"{dim}_{backend}"] = {"err": err, "collectives": colls}

    # beyond the paper: 2D distribution on a (2, n/2) mesh — one
    # ExecutionPlan, two sharded dims
    mesh2 = mesh_utils.make_mesh((2, n // 2), ("data", "model"), dev)
    routed2 = build_router(spec, ExecutionPlan(
        mesh=mesh2, axes=(("B", "data"), ("L", "model"))), device=dev)
    err2 = float((routed2(u_hat) - v_ref).abs().max())
    say(f"  B x L 2D-sharded: max err {err2:.2e}")
    out["BxL"] = {"err": err2}

    # planner -> execution, closed loop: plan="auto" runs §5.1.2 inside
    # build_router and shards the argmax dimension
    s = D.RPShape(n_b=B, n_l=L, n_h=H, c_l=8, c_h=C, iters=3)
    devm = D.DeviceModel.h100(n)
    auto = build_router(spec, ExecutionPlan(mesh=mesh, auto=True,
                                            device=devm, rp_shape=s),
                        device=dev)
    err3 = float((auto(u_hat) - v_ref).abs().max())
    scores = D.score_table(s, devm)
    say(f"planner pick for this shape: {D.plan(s, devm)} (scores: "
        f"{ {d: round(v, 3) for d, v in scores.items()} })")
    say(f"  plan='auto' resolved {tuple(auto.resolve(u_hat))}, max err "
        f"{err3:.2e}")
    out["auto"] = {"pick": D.plan(s, devm),
                   "axes": tuple(auto.resolve(u_hat)), "err": err3}

    # EM routing through the SAME entry point (paper §2.2 generality claim)
    votes = torch.from_numpy(rng.standard_normal(
        (B, L, 4, 8), dtype=np.float32)).to(dev)
    a_in = torch.sigmoid(torch.from_numpy(rng.standard_normal(
        (B, L), dtype=np.float32))).to(dev)
    em = RouterSpec(algorithm="em")
    pose_ref, act_ref = build_router(em, device=dev)(votes, a_in)
    for backend in ("torch", "cuda"):
        em_l = build_router(em._replace(backend=backend),
                            ExecutionPlan(mesh=mesh, axes=(("L", "vault"),)),
                            device=dev)
        pose, act = em_l(votes, a_in)
        errs = (float((pose - pose_ref).abs().max()),
                float((act - act_ref).abs().max()))
        say(f"  EM L-sharded{_TAG[backend]}: max pose err {errs[0]:.2e}, "
            f"max act err {errs[1]:.2e}")
        out[f"EM_L_{backend}"] = {"pose_err": errs[0], "act_err": errs[1]}
    return out


def main(argv=None) -> dict:
    """Start ``-n`` ranks (or, inside a group of that size, run as this
    rank) and return rank 0's results."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _args(argv)
    if ranks.world_size() == args.ranks:
        return rank_main(argv)
    return ranks.run(rank_main, argv, args.ranks, args.device,
                     timeout_s=args.timeout)


if __name__ == "__main__":
    main()
