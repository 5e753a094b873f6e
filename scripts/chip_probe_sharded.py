"""Quick probe of the sharded routing path on one H100.

Builds every kernel with nvcc; holds the three stage-split kernels (and
the procedure kernel) against their plain versions on random votes
(N(0, 1) × 0.05) at the Table-1 shapes, with median CUDA-event times; runs
the four collectives and the sharded router on a 1-rank NCCL group; then
starts two gloo ranks sharing the card and repeats both there.

    python3 scripts/chip_probe_sharded.py

``chip_smoke.py`` phase 7 is the full check; this script is the quick
first look at a new kernel build.
"""
import os
import statistics
import subprocess
import sys
import tempfile
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

SHAPES = [(100, 1152, 10, 16), (100, 2048, 62, 16), (100, 2304, 11, 16),
          (8, 1152, 10, 16)]


def timed(fn, runs=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def sc(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def stage_kernels(K, ops, g):
    for (B, L, H, C) in SHAPES:
        u32 = torch.randn((B, L, H, C), generator=g, device="cuda") * 0.05
        for sd in ("fp32", "bf16"):
            u = u32.to(ops.STREAM_DTYPES[sd]).contiguous()
            lt = ops.auto_l_tile(B, L, H, C, sd)
            c = torch.softmax(torch.randn((L, H), generator=g,
                                          device="cuda"), -1)
            b = torch.randn((L, H), generator=g, device="cuda")
            sk = K.routing_stage_votes(u, c, l_tile=lt)
            sk2 = K.routing_stage_votes(u, c, l_tile=lt)
            s = K.routing_stage_votes_plain(u, c, l_tile=lt)
            for ua in (False, True):
                vk, dk = K.routing_stage_update(u, s, l_tile=lt,
                                                use_approx=ua)
                vp, dp = K.routing_stage_update_plain(u, s, l_tile=lt,
                                                      use_approx=ua)
                fk = K.routing_stage_update_fold(u, s, b, l_tile=lt,
                                                 use_approx=ua)
                fk2 = K.routing_stage_update_fold(u, s, b, l_tile=lt,
                                                  use_approx=ua)
                fp = K.routing_stage_update_fold_plain(u, s, b, l_tile=lt,
                                                       use_approx=ua)
                torch.cuda.synchronize()
                ms = (timed(lambda: K.routing_stage_votes(u, c, l_tile=lt)),
                      timed(lambda: K.routing_stage_update(
                          u, s, l_tile=lt, use_approx=ua)),
                      timed(lambda: K.routing_stage_update_fold(
                          u, s, b, l_tile=lt, use_approx=ua)))
                print(B, L, H, C, sd, "approx" if ua else "exact",
                      "votes", f"{sc(sk, s):.2e}", torch.equal(sk, sk2),
                      "update v", f"{sc(vk, vp):.2e}", "db",
                      f"{sc(dk, dp):.2e}",
                      "fold", [f"{sc(x, y):.2e}" for x, y in zip(fk, fp)],
                      all(torch.equal(x, y) for x, y in zip(fk, fk2)),
                      "ms votes %.4f update %.4f fold %.4f" % ms, flush=True)
        # the procedure kernel, whose source shares the squash and softmax
        lt = ops.procedure_l_tile(B, L, H, C)
        for ua in (False, True):
            vk = K.routing_procedure_fused(u32, iterations=3, l_tile=lt,
                                           use_approx=ua)
            vp = K.routing_procedure_fused_plain(u32, iterations=3,
                                                 l_tile=lt, use_approx=ua)
            print("procedure", ua, f"{float((vk - vp).abs().max()):.2e}",
                  flush=True)
        del u32, u
        torch.cuda.empty_cache()


def one_rank(K, g):
    from repro_torch.core.router import ExecutionPlan, RouterSpec, build_router
    from repro_torch.runtime import mesh_utils
    mesh = mesh_utils.make_mesh((1,), ("vault",), device="cuda")
    print("nccl mesh", mesh, dist.get_backend(), flush=True)
    with mesh_utils.active(mesh):
        x = torch.arange(4.0, device="cuda")
        print("nccl collectives", mesh_utils.psum(x, "vault"),
              mesh_utils.pmax(x, "vault"),
              mesh_utils.all_gather(x, "vault", 0),
              mesh_utils.broadcast(x, "vault", 0), flush=True)
    u = torch.randn((100, 1152, 10, 16), generator=g, device="cuda") * 0.05
    want = build_router(RouterSpec(backend="torch"))(u)
    for dim in "BLH":
        r = build_router(RouterSpec(backend="cuda"),
                         ExecutionPlan(mesh=mesh, axes=((dim, "vault"),)))
        with torch.inference_mode():
            got = r(u)
        print("1-rank", dim, float((got - want).abs().max()),
              K.launch_counts(), flush=True)
    print("auto resolves", build_router(RouterSpec(backend="cuda"),
                                        "auto").resolve(u), flush=True)


WORKER = r'''
import os, sys
sys.path.insert(0, os.environ["SRC"])
import torch, torch.distributed as dist
rank = int(sys.argv[1]); path = sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(path, 2), rank=rank,
                        world_size=2)
from repro_torch.runtime import mesh_utils
from repro_torch.core.router import RouterSpec, ExecutionPlan, build_router
mesh = mesh_utils.make_mesh((2,), ("vault",), device="cuda")
print(rank, "mesh", mesh, flush=True)
with mesh_utils.active(mesh):
    x = torch.arange(4.0, device="cuda") + rank
    for name, fn in (("psum", lambda: mesh_utils.psum(x, "vault")),
                     ("pmax", lambda: mesh_utils.pmax(x, "vault")),
                     ("gather", lambda: mesh_utils.all_gather(x, "vault", 0)),
                     ("bcast", lambda: mesh_utils.broadcast(x, "vault", 1))):
        try:
            print(rank, name, fn(), flush=True)
        except Exception as e:
            print(rank, name, "FAILED", repr(e)[:500], flush=True)
g = torch.Generator(device="cuda").manual_seed(0)
u = torch.randn((100, 1152, 10, 16), generator=g, device="cuda") * 0.05
want = build_router(RouterSpec(backend="torch"))(u)
for dim in "BLH":
    with torch.inference_mode():
        got = build_router(RouterSpec(backend="cuda"), ExecutionPlan(
            mesh=mesh, axes=((dim, "vault"),)))(u)
    print(rank, "2-rank", dim, float((got - want).abs().max()), flush=True)
dist.destroy_process_group()
'''


def two_ranks():
    d = tempfile.mkdtemp()
    wp = os.path.join(d, "w.py")
    with open(wp, "w") as f:
        f.write(WORKER)
    env = dict(os.environ, SRC=SRC)
    ps = [subprocess.Popen([sys.executable, wp, str(r),
                            os.path.join(d, "store")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True) for r in range(2)]
    for p in ps:
        try:
            out = p.communicate(timeout=240)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0] + "\nTIMEOUT"
        print(out[-4000:], flush=True)


def main():
    print("torch", torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    from repro_torch.kernels import cudalib
    from repro_torch.kernels.routing import kernel as K
    from repro_torch.kernels.routing import ops
    t0 = time.time()
    try:
        cudalib.build()
    except Exception as e:
        print("BUILD FAILED", str(e)[-6000:])
        return 1
    print("build", time.time() - t0, cudalib.build_info.compiled,
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    stage_kernels(K, ops, g)
    try:
        one_rank(K, g)
    except Exception:
        import traceback
        traceback.print_exc()
    two_ranks()
    if dist.is_initialized():
        dist.destroy_process_group()
    print("probe done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
