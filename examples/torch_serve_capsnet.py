"""Serving the paper's workload on the PyTorch/CUDA port: continuous
batching over the §4 pipeline, on the H100 (``--device cpu`` for the CPU).

The twin of ``serve_capsnet.py``, a guided tour of
``repro_torch.runtime.caps_serve``:

1. Build a CapsNet and a continuous-batching server whose waves run
   through the software form of the paper's host‖PIM pipeline.
2. Submit ragged arrivals (3, then 0, then 7, ... requests per tick) and
   watch the queue pad them into fixed microbatch lanes.
3. Check the serving transform is exact: the pipelined wave's class
   scores equal the plain unpipelined Router path's.
4. Let ``routing_plan="auto"`` put the §5.1.2 planner inside the routing
   stage — pipeline x distribution, composed.
5. Go asynchronous: ``serve_forever(stop_event)`` forms waves on a
   background thread while client threads submit concurrently, with
   back-pressure from a bounded queue.

    PYTHONPATH=src python examples/torch_serve_capsnet.py
    PYTHONPATH=src python examples/torch_serve_capsnet.py --device cpu
"""
import argparse
import threading

import torch

from repro_torch.configs.caps_benchmarks import smoke_caps
from repro_torch.data.synthetic import SyntheticCapsDataset
from repro_torch.kernels import resolve_device
from repro_torch.models import capsnet
from repro_torch.runtime.caps_serve import (CapsServer, ServeConfig,
                                            make_wave_fn)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    caps_cfg = smoke_caps()
    net = capsnet.CapsNet(caps_cfg, device=dev, seed=0)
    ds = SyntheticCapsDataset(caps_cfg.image_hw, caps_cfg.image_channels,
                              caps_cfg.num_h_caps)
    result = {"device": str(dev)}

    # 1 — a server: 2 microbatches x 4 lanes per wave, §4 pipeline inside
    cfg = ServeConfig(microbatch=4, n_micro=2, pipeline="software")
    server = CapsServer(net, cfg=cfg, device=dev)

    # 2 — ragged arrivals; the queue pads each wave to the constant shape
    done = []
    for tick, count in enumerate([3, 0, 7, 1, 5]):
        if count:
            server.submit(ds.batch(tick, count)["images"])
        for c in server.step():
            done.append(c)
            print(f"tick {tick}: request {c.rid} -> class {c.pred} "
                  f"({c.latency_s * 1e3:.1f} ms)")
    done += server.drain()
    s = server.metrics.summary()
    print(f"waves={s['waves']} padded_lanes={s['padded_lanes']} "
          f"p50={s['p50_latency_s'] * 1e3:.1f}ms "
          f"throughput={s['throughput_rps']:.0f} req/s")
    result["ragged"] = {"completed": len(done), "waves": s["waves"],
                        "padded_lanes": s["padded_lanes"]}

    # 3 — the pipeline transform is exact under serving traffic
    lanes = cfg.wave_lanes
    images = torch.from_numpy(ds.batch(9, lanes)["images"]).to(dev).reshape(
        cfg.n_micro, cfg.microbatch, caps_cfg.image_hw, caps_cfg.image_hw,
        caps_cfg.image_channels)
    micro = {"images": images,
             "mask": torch.ones((cfg.n_micro, cfg.microbatch), device=dev)}
    with torch.no_grad():
        piped = make_wave_fn(net, None, cfg)(micro)
        plain = make_wave_fn(
            net, None,
            ServeConfig(microbatch=4, n_micro=2, pipeline=None))(micro)
        gap = float((piped - plain).abs().max())
        print("pipelined == unpipelined:", gap <= 1e-5)
        result["pipelined_gap"] = gap

        # 4 — §5.1.2 planner inside the routing stage (pipeline x
        #     distribution)
        auto_cfg = ServeConfig(microbatch=4, n_micro=2, pipeline="software",
                               routing_plan="auto")
        auto = make_wave_fn(net, None, auto_cfg)(micro)
        torch.testing.assert_close(auto, plain, rtol=1e-4, atol=1e-5)
        result["auto_gap"] = float((auto - plain).abs().max())
        print("auto-planned routing stage agrees")

    # 5 — async admission: serve_forever drives waves on its own thread
    # while clients submit concurrently (bounded queue = back-pressure)
    server = CapsServer(net, cfg=ServeConfig(microbatch=4, n_micro=2,
                                             max_queue=64), device=dev)
    stop = threading.Event()
    done = []
    driver = threading.Thread(
        target=lambda: done.extend(server.serve_forever(stop)))
    driver.start()

    def client(worker):
        for tick, count in enumerate([2, 3, 1]):
            server.submit(ds.batch(worker * 10 + tick, count)["images"])

    clients = [threading.Thread(target=client, args=(w,)) for w in range(2)]
    for c in clients:
        c.start()
    for c in clients:
        c.join()
    stop.set()
    driver.join()
    m = server.metrics
    assert m.submitted == m.completed + m.shed + server.pending() == 12
    print(f"async: {m.completed} completed over {m.waves} waves, "
          f"invariant holds; serving path OK")
    result["async"] = {"submitted": m.submitted, "completed": m.completed,
                       "shed": m.shed, "waves": m.waves}
    return result


if __name__ == "__main__":
    main()
