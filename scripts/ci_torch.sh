#!/usr/bin/env bash
# CI entry point of the PyTorch/CUDA port, on the CPU: the port's tests,
# the six examples' twins and the port's CLI smoke runs, each with
# ``--device cpu`` (the port runs on the card by default).  The twin of
# scripts/ci.sh; on the H100 the same paths run in ``python3 chip_smoke.py``.
#
#   scripts/ci_torch.sh            # the port's tests + smoke runs
#   scripts/ci_torch.sh --fast     # the port's tests only
set -euo pipefail
cd "$(dirname "$0")/.."
ROOT="$(pwd)"
export PYTHONPATH="$ROOT/src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS=cpu          # the tests hold the port to the JAX package

echo "== tests: the port against the JAX package (tests/test_torch_*.py) =="
python -m pytest -q tests/test_torch_*.py

if [[ "${1:-}" != "--fast" ]]; then
  SMOKE_DIR="$(mktemp -d)"
  trap 'rm -rf "$SMOKE_DIR"' EXIT

  echo "== smoke: the examples' twins (examples/torch_*.py --device cpu) =="
  python examples/torch_quickstart.py --device cpu
  python examples/torch_distributed_routing.py -n 2 --device cpu
  python examples/torch_serve_capsnet.py --device cpu
  python examples/torch_train_capsnet.py --smoke --routing fused \
    --ckpt-dir "$SMOKE_DIR/capsnet_ckpt" --device cpu
  python examples/torch_serve_lm.py --device cpu
  python examples/torch_train_lm.py --steps 20 --device cpu

  # the benchmark steps of scripts/ci.sh (benchmarks.run --only
  # rp_speedup, accuracy, train, serving and their JSON checks) wait for
  # the port's benchmark PR: the port has no benchmark yet

  echo "== smoke: repro_torch.launch.serve_caps (continuous batching) =="
  python -m repro_torch.launch.serve_caps --smoke --device cpu
  python -m repro_torch.launch.serve_caps --smoke --async --device cpu
  python -m repro_torch.launch.serve_caps --smoke --replicas 2 --tenants 2 \
    --slo-ms 5000 --device cpu
  python -m repro_torch.launch.serve_caps --smoke --chaos --device cpu
  python -m repro_torch.launch.serve_caps --smoke --chaos --replicas 2 \
    --tenants 2 --slo-ms 5000 --device cpu
  python -m repro_torch.launch.serve_caps --smoke --model lm --device cpu
  python -m repro_torch.launch.serve_caps --smoke --model moe --device cpu

  echo "== smoke: the LM and CapsNet training and serving CLIs =="
  python -m repro_torch.launch.train_capsnet --smoke --steps 2 \
    --routing fused --ckpt-dir "$SMOKE_DIR/train_capsnet_ckpt" --device cpu
  python -m repro_torch.launch.serve --smoke --device cpu
  python -m repro_torch.launch.train --smoke --steps 3 \
    --ckpt-dir "$SMOKE_DIR/lm_ckpt" --device cpu
fi

echo "CI (port) OK"
