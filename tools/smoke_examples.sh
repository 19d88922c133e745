#!/bin/bash
# Smoke-run every example on CPU (forced via jax.config inside a runpy
# wrapper).  Plot artifacts land in a temp dir, not the repo.  Exit 0
# iff every example runs to completion.
set -u
repo=$(cd "$(dirname "$0")/.." && pwd)
workdir=$(mktemp -d)
trap 'rm -rf "$workdir"' EXIT
fail=0
run_cpu () {
  local name=$repo/$1; shift
  echo "=== $name $* ==="
  (cd "$workdir" && timeout 900 python -c "
import sys, jax, runpy
jax.config.update('jax_platforms', 'cpu')
sys.argv = ['$name'] + [a for a in '$*'.split() if a]
runpy.run_path('$name', run_name='__main__')
") || { echo "FAILED: $name"; fail=1; }
}
run_cpu examples/01_offline_pipeline.py --iters 2
run_cpu examples/02_online_streaming.py
run_cpu examples/03_custom_potentials.py
run_cpu examples/04_pose_graph_loop_closure.py
XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  run_cpu examples/05_multichip_sharding.py
XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  run_cpu examples/06_fleet_mode.py
run_cpu examples/07_live_rosbridge.py
echo "=== examples done (fail=$fail) ==="
exit $fail
