"""Quickstart on the PyTorch/CUDA port: the paper's technique in five
steps, on the H100 (``--device cpu`` runs the same steps on the CPU).

The twin of ``quickstart.py``, through ``repro_torch``'s public API:

1. Build a CapsNet (paper Fig.2) and run inference with dynamic routing.
2. Swap in the paper's §5.2.2 approximated special functions through the
   unified Router API — same classification, one extra multiply per op.
3. Ask the §5.1.2 planner which dimension to distribute the routing
   procedure on — and let ``plan="auto"`` make the same choice inside
   ``build_router`` (the planner -> execution loop, closed).
4. Run the routing procedure through the hand-written Hopper kernel
   (``RouterSpec(backend="cuda")``) and hold it against the eager torch
   backend, and the kernel against its plain PyTorch version on the same
   votes (on the CPU the cuda backend runs that plain version).
5. Serve the deep-edge tier — int8 û streaming + per-capsule early exit
   in the procedure kernel — and read the kernel's own work counter
   showing the routing work saved.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS, smoke_caps
from repro_torch.core import distribution as D
from repro_torch.core.router import ExecutionPlan, RouterSpec, build_router
from repro_torch.data.synthetic import SyntheticCapsDataset
from repro_torch.kernels import resolve_device
from repro_torch.kernels.routing import kernel as rt_kernel
from repro_torch.kernels.routing import ops as rt_ops
from repro_torch.models import capsnet


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    result = {"device": str(dev)}

    cfg = smoke_caps()
    net = capsnet.CapsNet(cfg, device=dev, seed=0)
    ds = SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                              cfg.num_h_caps)
    images = torch.from_numpy(ds.batch(0, 8)["images"]).to(dev)

    with torch.no_grad():
        # 1 — exact dynamic routing (paper Algorithm 1; default RouterSpec)
        out = capsnet.forward(net, images)
        probs = out["class_probs"]
        print("capsule norms (input 0):",
              [f"{p:.3f}" for p in probs[0].tolist()])
        result["class_probs"] = probs.cpu()

        # 2 — approximated special functions (paper §5.2.2), via the
        #     Router API: one spec field, same call site.
        router_apx = build_router(RouterSpec(iterations=cfg.routing_iters,
                                             use_approx=True), device=dev)
        probs_apx = capsnet.forward(net, images,
                                    router=router_apx)["class_probs"]
        drift = float((probs - probs_apx).abs().max())
        same = bool((probs.argmax(-1) == probs_apx.argmax(-1)).all())
        print(f"approx routing: max prob drift {drift:.4f}, "
              f"same classification: {same}")
        result["approx"] = {"drift": drift, "same_classification": same}

        # 3 — the execution-score planner (paper §5.1.2, S = 1/(aE + bM)),
        #     and plan="auto": build_router runs the same planner
        #     internally and picks the sharded dimension itself.
        s = D.RPShape.from_caps_config(CAPS_BENCHMARKS["Caps-MN1"])
        result["planner"] = {}
        for dev_name, devm in [("HMC 32 vaults (paper Table 4)",
                                D.DeviceModel.hmc()),
                               ("H100 x 8, one host",
                                D.DeviceModel.h100(8))]:
            table = D.score_table(s, devm)
            pick = D.plan(s, devm)
            auto_router = build_router(
                RouterSpec(iterations=s.iters),
                ExecutionPlan(auto=True, device=devm, rp_shape=s),
                device=dev)
            auto_axes = auto_router.resolve(
                torch.zeros((s.n_b, s.n_l, s.n_h, s.c_h), device=dev))
            print(f"planner[{dev_name}]: scores "
                  + ", ".join(f"{d}={v:.3g}" for d, v in table.items())
                  + f" -> distribute on {pick}; plan='auto' resolves "
                  + f"{tuple(auto_axes) or 'unsharded'}")
            result["planner"][dev_name] = {
                "scores": dict(table), "pick": pick,
                "auto_axes": tuple(auto_axes)}

        # 4 — the hand-written routing kernel: the cuda backend against the
        #     torch backend, and the kernel against its plain version on
        #     the same votes
        router_cuda = build_router(RouterSpec(iterations=cfg.routing_iters,
                                              backend="cuda"), device=dev)
        out_cuda = capsnet.forward(net, images, router=router_cuda)
        err = float((out["v"] - out_cuda["v"]).abs().max())
        u_hat = capsnet.encode_votes(net, images).contiguous()
        B, L, H, C = u_hat.shape
        print(f"cuda backend ({router_cuda.resolve(u_hat).fusion} kernel) "
              f"vs torch backend routing: max |dv| = {err:.2e}")
        lt = rt_ops.procedure_l_tile(B, L, H, C, "fp32")
        launches = rt_kernel.routing_procedure_fused.launches
        v_kernel = rt_kernel.routing_procedure_fused(
            u_hat, iterations=cfg.routing_iters, l_tile=lt)
        launched = rt_kernel.routing_procedure_fused.launches - launches
        v_plain = rt_kernel.routing_procedure_fused_plain(
            u_hat, iterations=cfg.routing_iters, l_tile=lt)
        kerr = float((v_kernel - v_plain).abs().max())
        print(f"routing_procedure_fused on {dev} (kernel launches: "
              f"{launched}) vs its plain PyTorch version: max |dv| = "
              f"{kerr:.2e}")
        result["kernel"] = {"backend_err": err, "kernel_vs_plain": kerr,
                            "launches": launched}

        # 5 — the deep-edge tier: int8 û codes quarter the kernel's
        #     dominant stream, early exit freezes converged capsule tiles.
        #     Inference-only, accuracy-gated (untrained smoke weights here).
        router_edge = build_router(RouterSpec(iterations=cfg.routing_iters,
                                              backend="cuda",
                                              stream_dtype="int8",
                                              early_exit_eps=0.05),
                                   device=dev)
        probs_edge = capsnet.forward(net, images,
                                     router=router_edge)["class_probs"]
        drift = float((probs - probs_edge).abs().max())
        agree = float((probs.argmax(-1) == probs_edge.argmax(-1))
                      .float().mean())
        print(f"deep edge {router_edge.resolve()}: max prob drift "
              f"{drift:.4f}, top-1 agreement {agree:.0%} (untrained smoke "
              f"weights — the trained gate lives in bench_accuracy)")
        # the kernel's own work counter: effective tile-iterations done vs
        # the fixed iterations x L_tiles grid, as eps loosens (eps=0 is
        # bit-identical full work; a huge eps freezes every tile after its
        # mandatory first two passes)
        lt = rt_ops.procedure_l_tile(B, L, H, C, "fp32", early_exit=True)
        full = cfg.routing_iters * (L // lt)
        effs = {}
        for eps in (0.0, 8.0, 1e6):
            _, eff = rt_ops.dynamic_routing_procedure_stats(
                u_hat, iterations=cfg.routing_iters, l_tile=lt,
                early_exit_eps=eps)
            effs[eps] = int(eff)
        print(f"early-exit work (l_tile={lt}): "
              + ", ".join(f"eps={eps:g}: {e}/{full}"
                          for eps, e in effs.items())
              + " tile-iterations")
        result["deep_edge"] = {"drift": drift, "agreement": agree,
                               "work": effs, "full": full}
    return result


if __name__ == "__main__":
    main()
