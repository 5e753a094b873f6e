"""Continuous-batching CapsNet serving over the §4 host‖PIM pipeline.

Port of the JAX package's ``repro/runtime/caps_serve.py``: the CapsNet
adapter behind the model-agnostic ``runtime.wave_serve`` core.
``CapsAdapter`` packs image payloads into masked microbatch lanes on the
net's device and builds the wave function with ``make_wave_fn``;
``CapsServer`` binds that adapter under the reference's constructor, with
a ``CapsNet`` in place of (params, caps_cfg).

Padding note: the routing logits ``b`` are shared across the batch (the
paper's Table-2 B-dim aggregation), so batch lanes couple through Eq.4 and
zero-image padding would perturb real lanes once biases are non-zero.  The
encoder stage therefore multiplies the votes by a per-lane mask — masked
lanes contribute exactly zero to every cross-lane sum, whatever their
images hold.

    net = CapsNet(CAPS_BENCHMARKS["Caps-MN1"])           # on the card
    server = CapsServer(net, RouterSpec(backend="cuda"))
    server.submit(images)           # any count, any tick, any thread
    done = server.step()            # one wave: [Completion(rid, pred, ...)]

On a CUDA device the cuda backend's kernels (dynamic or EM routing) are
built when the wave function is made, so a kernel that does not build
raises out of the ``CapsServer`` constructor instead of surfacing as
failed waves.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import router as router_lib
from repro_torch.kernels import cudalib, resolve_device
from repro_torch.models import capsnet
from repro_torch.runtime import spans, wave_serve
from repro_torch.runtime.wave_serve import (  # noqa: F401 — the reference's API
    OVERFLOW_POLICIES,
    QUEUE_ORDERS,
    Completion,
    QueueFullError,
    ReplicaCrash,
    Request,
    ServeConfig,
    ServeMetrics,
    TenantMetrics,
    WaveServer,
    WorkloadAdapter,
)


def validate_arrival(images: Sequence[np.ndarray],
                     image_shape: tuple) -> np.ndarray:
    """The validate half of validate-then-mutate admission: assemble an
    arrival into one ``(n,) + image_shape`` float32 array or raise without
    side effects."""
    try:
        arr = np.asarray(images, np.float32)
    except (ValueError, TypeError) as e:
        raise ValueError(
            "ragged arrival: could not assemble the images into one "
            f"(n,) + {image_shape} float array — every image "
            "must be a numeric array of that shape") from e
    if arr.ndim != 1 + len(image_shape) or arr.shape[1:] != image_shape:
        got = (arr.shape[1:] if arr.ndim == 1 + len(image_shape)
               else arr.shape)
        raise ValueError(f"image shape {got} != {image_shape}")
    return arr


def make_wave_fn(net: capsnet.CapsNet,
                 spec: Optional[router_lib.RouterSpec],
                 cfg: ServeConfig) -> Callable:
    """Build the wave function on the net's device.

    wave({"images": (n_micro, microbatch, H, W, C),
          "mask":   (n_micro, microbatch)}) -> class_scores
                                               (n_micro, microbatch, N_H)

    The encoder stage masks the Eq.1 votes per lane and the routing stage
    runs through ``core.router.build_router`` — pipelined per
    ``cfg.pipeline`` ("software": the skewed loop; "two_stage": encoder and
    routing on the two halves of ``cfg.pipeline_axis`` of ``cfg.mesh``;
    None: one microbatch after the other), with the routing stage
    distributed per ``cfg.routing_plan`` (None, "auto" — the §5.1.2
    planner — or ((dim, mesh_axis), ...)) over ``cfg.mesh`` (None: every
    rank on one "vault" axis).  ``spec.algorithm`` selects the stage
    hand-off: "dynamic" hands the router the votes and scores classes as
    ‖v‖; "em" hands it (votes, a_in), a_in the lane mask broadcast over the
    L capsules, and scores classes as the EM output activations.  Each
    microbatch's encoder stage, mask included, runs in the
    ``capsnet.encode`` span and its routing in ``capsnet.route``
    (``runtime.spans``)."""
    if spec is None:
        spec = router_lib.RouterSpec(iterations=net.cfg.routing_iters)
    algo = router_lib.get_algorithm(spec.algorithm)
    device = net.device

    def encode(micro):
        with spans.span("capsnet.encode"):
            votes = capsnet.encode_votes(net, micro["images"])
            return votes * micro["mask"][:, None, None, None]

    if algo.num_inputs == 1:
        stage_a = encode

        def score(v):
            return torch.linalg.vector_norm(v, dim=-1)
    elif spec.algorithm == "em":
        def stage_a(micro):
            votes = encode(micro)
            return votes, micro["mask"][:, None].expand(votes.shape[:2])

        def score(out):
            return out[1]
    else:
        raise ValueError(
            f"no serving wave recipe for algorithm {spec.algorithm!r} "
            f"({algo.num_inputs} inputs); register one in make_wave_fn")

    auto = cfg.routing_plan == "auto"
    axes = (tuple(cfg.routing_plan)
            if isinstance(cfg.routing_plan, (tuple, list)) else ())
    if cfg.pipeline is not None:
        plan = router_lib.ExecutionPlan(
            mesh=cfg.mesh, axes=axes, auto=auto, pipeline=cfg.pipeline,
            pipeline_axis=cfg.pipeline_axis, stage_a=stage_a)
        router = router_lib.build_router(spec, plan, device=device)

        def run(micro):
            return score(router(micro))
    else:
        # unpipelined reference arm: the same stages, strictly one
        # microbatch after the other
        plan = (router_lib.ExecutionPlan(mesh=cfg.mesh, axes=axes,
                                         auto=auto)
                if (axes or auto or cfg.mesh is not None) else None)
        core = router_lib.build_router(spec, plan, device=device)

        def run_one(m):
            h = stage_a(m)
            return core(*h) if isinstance(h, tuple) else core(h)

        def run(micro):
            n = pipeline_lib.n_micro(micro)
            return score(pipeline_lib.tree_stack(
                [run_one(pipeline_lib.microbatch_at(micro, t))
                 for t in range(n)]))

    if spec.backend == "cuda" and device.type == "cuda":
        cudalib.build()

    def wave(micro):
        with torch.inference_mode():
            return run(micro)

    return wave


# ---------------------------------------------------------------------------
# CapsAdapter — the CapsNet workload behind the WaveServe core
# ---------------------------------------------------------------------------

class CapsAdapter(wave_serve.WorkloadAdapter):
    """CapsNet classification as a ``WorkloadAdapter``: payloads are
    ``(H, W, C)`` float32 images, the wave function is ``make_wave_fn``'s
    §4 pipeline, packing zero-pads the tail microbatch with a per-lane vote
    mask and moves the wave to the net's device, and completions are
    argmax class predictions over the wave scores.  The output-guard
    reference is the eager torch router (``core.router.reference_spec``)."""

    def __init__(self, net: capsnet.CapsNet,
                 spec: Optional[router_lib.RouterSpec] = None):
        self.net = net
        self.caps_cfg = net.cfg
        self.spec = spec
        self.image_shape = (net.cfg.image_hw, net.cfg.image_hw,
                            net.cfg.image_channels)

    def validate(self, items) -> np.ndarray:
        return validate_arrival(items, self.image_shape)

    def make_wave_fn(self, cfg: ServeConfig) -> Callable:
        return make_wave_fn(self.net, self.spec, cfg)

    def make_reference_wave_fn(self, cfg: ServeConfig) -> Callable:
        ref = (router_lib.reference_spec(self.spec)
               if self.spec is not None else None)
        return make_wave_fn(self.net, ref, cfg)

    def pack(self, payloads: Sequence[np.ndarray], cfg: ServeConfig):
        shape = self.image_shape
        images = np.zeros((cfg.wave_lanes,) + shape, np.float32)
        mask = np.zeros((cfg.wave_lanes,), np.float32)
        for i, payload in enumerate(payloads):
            images[i] = payload
            mask[i] = 1.0
        dev = self.net.device
        return {
            "images": torch.from_numpy(images).reshape(
                (cfg.n_micro, cfg.microbatch) + shape).to(dev),
            "mask": torch.from_numpy(mask).reshape(
                cfg.n_micro, cfg.microbatch).to(dev),
        }

    def unpack(self, out, n: int) -> List[int]:
        scores = out.detach().cpu().numpy()
        preds = scores.reshape(-1, scores.shape[-1]).argmax(-1)
        return [int(p) for p in preds[:n]]

    def cache_key(self):
        return self.spec


# ---------------------------------------------------------------------------
# CapsServer — queue -> pad -> microbatch -> pipeline
# ---------------------------------------------------------------------------

class CapsServer(wave_serve.WaveServer):
    """Continuous-batching CapsNet classification server.

    ``submit()`` admits any number of requests at any time from any thread;
    ``step()`` drains up to one wave (``cfg.wave_lanes`` requests), pads the
    tail microbatch, runs the wave through the pipelined router and returns
    per-request completions with queue+compute latency.  ``drain()`` steps
    until the queue is empty; ``serve_forever(stop_event)`` is the async
    driver.

    ``device`` (the card by default; raises when there is none) is where
    the server runs; ``net`` must already live there.
    """

    def __init__(self, net: capsnet.CapsNet,
                 spec: Optional[router_lib.RouterSpec] = None,
                 cfg: Optional[ServeConfig] = None, *,
                 device="cuda",
                 clock: Callable[[], float] = time.perf_counter,
                 wave_fn: Optional[Callable] = None,
                 watchdog=None,
                 sleep: Callable[[float], None] = time.sleep):
        dev = resolve_device(device)
        if net.device.type != dev.type:
            raise ValueError(f"the CapsNet lives on {net.device}; this "
                             f"server runs on {dev}")
        adapter = CapsAdapter(net, spec)
        super().__init__(adapter, cfg=cfg, clock=clock, wave_fn=wave_fn,
                         watchdog=watchdog, sleep=sleep)
        self.caps_cfg = net.cfg
        self.net = net
