#!/bin/bash
# Tensor-parallel measurements on four cards, one process per card (NCCL).
# The dense and MoE set: qwen2-0.5b's pooled training round with no mesh
# and on (data 1, model 2), (data 2, model 2), (data 1, model 4);
# deepseek-moe-16b at full depth on the per-leaf route at (data 1, model
# 4), with remat none then full; and deepseek-moe-16b served with no mesh
# and at model 2 and 4, at full depth in bf16 (timed), then at 4 layers in
# f32.  The ssm and hybrid set ("families"): mamba2-370m (full depth) and
# zamba2-7b (13 of its 81 layers: two groups of six and a one-layer tail)
# trained pooled with no mesh and on the same three meshes; both served
# 4 x 1024 with no mesh and at model 2 and 4 in bf16 (timed; zamba2-7b
# at the same 13 layers), then in f32 at 4 layers (mamba2-370m) and 7
# (zamba2-7b: one group and a one-layer tail).  Every f32 serve's greedy
# tokens on a mesh must equal the no-mesh run's (the script exits 1 when
# they do not, or when a run exits non-zero; in bf16 an ulp between the
# summation orders can move a greedy pick or the MoE's routing, so the
# bf16 runs' tokens are compared and reported only).
# The slot-lane set ("slots"): the continuous-batching lane (8 slots,
# prompts of 512, 64 tokens a request, Poisson arrivals) with no mesh and
# at (data 4, model 1), (2, 2) and (1, 4): qwen2-0.5b and mamba2-370m at
# full depth and zamba2-7b at 13 layers in bf16 (timed: tok/s, device ms
# a decode step split into the compute kernels' and NCCL's, TTFT; 16
# requests, mamba2-370m 8), then in f32 at reduced depth (qwen2-0.5b and
# mamba2-370m 4 layers, zamba2-7b 7; 8 requests), whose token matrices
# on every mesh must equal the no-mesh run's.
# The per-leaf ZeRO set ("zero"): the per-leaf fused route (--update-impl
# pallas), each data rank holding its ZeRO blocks of params, moments and
# the delayed buffer: qwen2-0.5b at full depth (remat none, the main
# path's) with no mesh and at (data 4, model 1) and (2, 2); zamba2-7b at
# full depth (81 layers) at (4, 1) and deepseek-moe-16b at full depth at
# (2, 2), both with remat full (every gathered layer freed after use), two
# rounds after one warm-up.  Each run's line in train.jsonl holds its warm
# ms a round, peak and state GiB a card, collectives and update kernel
# launches a round and the profiled device time split into the compute
# kernels' and NCCL's.
# The sequence-parallel set ("seq"): qwen2-0.5b (whose 14 heads do not
# divide a model axis of 4) with no mesh and at (data 1, model 4) under
# the default rules and under --auto-rules (SEQ_PARALLEL_RULES: each rank
# holds its block of the rows between blocks), in bf16: the pooled
# training round, then the 4 x 1024 prefill and decode (the prefill's
# profiled flash device time a rank in serve.jsonl); then in f32 at 4
# layers, whose greedy tokens on the mesh must equal the no-mesh run's.
#   bash measure_tp.sh [OUT_DIR] [serve|families|slots|zero|seq]   # from the repository root
# With "serve" only the dense and MoE set's serving runs are made; with
# "families" only the ssm and hybrid set; with "slots" only the slot-lane
# set; with "zero" only the per-leaf ZeRO set; with "seq" only the
# sequence-parallel set.  Each run's log goes to
# OUT_DIR/runN.log and its numbers to OUT_DIR/{train,serve,slots}.jsonl
# (OUT_DIR defaults to build/tp4); a run still going after 900 s is stopped
# and counts as failed.
export PYTHONPATH=src
OUT=${1:-build/tp4}
mkdir -p $OUT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
T=$OUT/train.jsonl; S=$OUT/serve.jsonl
n=0; failed=0
run() {
  n=$((n + 1)); local p=$1; shift
  echo "== [$n] nproc $p: $*"
  local t0=$SECONDS
  timeout 900 torchrun --standalone --nproc-per-node $p -m "$@" > $OUT/run$n.log 2>&1
  local rc=$?
  [ $rc = 0 ] || failed=$((failed + 1))
  echo "rc=$rc in $((SECONDS - t0)) s"; grep -E "ms per round|profiled|prefill .* ms|tok/s|Error|error" $OUT/run$n.log | head -5
}
PT=repro_torch.launch.profile_train; PS=repro_torch.launch.profile_serve
if [ "$2" = slots ]; then
  S=$OUT/slots.jsonl
  for A in "--arch qwen2-0.5b --slot-requests 2" "--arch mamba2-370m --slot-requests 1" \
           "--arch zamba2-7b --n-layers 13 --slot-requests 2" \
           "--arch qwen2-0.5b --n-layers 4 --f32 --slot-requests 1" \
           "--arch mamba2-370m --n-layers 4 --f32 --slot-requests 1" \
           "--arch zamba2-7b --n-layers 7 --f32 --slot-requests 1"; do
    run 1 $PS $A --slots 8 --json-out $S
    for M in data=4,model=1 data=2,model=2 data=1,model=4; do
      run 4 $PS $A --slots 8 --mesh $M --json-out $S
    done
  done
fi
if [ "$2" = families ]; then
  for A in "--arch mamba2-370m" "--arch zamba2-7b --n-layers 13 --rounds 2 --warmup 1"; do
    run 1 $PT $A --update-impl pallas_pooled --json-out $T
    run 2 $PT $A --update-impl pallas_pooled --mesh data=1,model=2 --json-out $T
    run 4 $PT $A --update-impl pallas_pooled --mesh data=2,model=2 --json-out $T
    run 4 $PT $A --update-impl pallas_pooled --mesh data=1,model=4 --json-out $T
  done
  for A in "--arch mamba2-370m" "--arch zamba2-7b --n-layers 13" \
           "--arch mamba2-370m --n-layers 4 --f32" "--arch zamba2-7b --n-layers 7 --f32"; do
    run 1 $PS $A --json-out $S
    run 2 $PS $A --mesh data=1,model=2 --json-out $S
    run 4 $PS $A --mesh data=1,model=4 --json-out $S
  done
fi
if [ "$2" = zero ]; then
  run 1 $PT --update-impl pallas --json-out $T
  run 4 $PT --update-impl pallas --mesh data=4,model=1 --json-out $T
  run 4 $PT --update-impl pallas --mesh data=2,model=2 --json-out $T
  run 4 $PT --arch zamba2-7b --update-impl pallas --remat full --mesh data=4,model=1 --rounds 2 --warmup 1 --json-out $T
  run 4 $PT --arch deepseek-moe-16b --update-impl pallas --remat full --mesh data=2,model=2 --rounds 2 --warmup 1 --json-out $T
fi
if [ "$2" = seq ]; then
  run 1 $PT --update-impl pallas_pooled --json-out $T
  run 4 $PT --update-impl pallas_pooled --mesh data=1,model=4 --json-out $T
  run 4 $PT --update-impl pallas_pooled --mesh data=1,model=4 --auto-rules --json-out $T
  for A in "--arch qwen2-0.5b" "--arch qwen2-0.5b --n-layers 4 --f32"; do
    run 1 $PS $A --json-out $S
    run 4 $PS $A --mesh data=1,model=4 --json-out $S
    run 4 $PS $A --mesh data=1,model=4 --auto-rules --json-out $S
  done
fi
if [ "$2" != serve ] && [ "$2" != families ] && [ "$2" != slots ] && [ "$2" != zero ] && [ "$2" != seq ]; then
  run 1 $PT --update-impl pallas_pooled --json-out $T
  run 2 $PT --update-impl pallas_pooled --mesh data=1,model=2 --json-out $T
  run 4 $PT --update-impl pallas_pooled --mesh data=2,model=2 --json-out $T
  run 4 $PT --update-impl pallas_pooled --mesh data=1,model=4 --json-out $T
  run 4 $PT --arch deepseek-moe-16b --update-impl pallas --mesh data=1,model=4 --rounds 2 --warmup 1 --json-out $T
  run 4 $PT --arch deepseek-moe-16b --update-impl pallas --remat full --mesh data=1,model=4 --rounds 2 --warmup 1 --json-out $T
fi
if [ "$2" != families ] && [ "$2" != slots ] && [ "$2" != zero ] && [ "$2" != seq ]; then
  run 1 $PS --arch deepseek-moe-16b --json-out $S
  run 2 $PS --arch deepseek-moe-16b --mesh data=1,model=2 --json-out $S
  run 4 $PS --arch deepseek-moe-16b --mesh data=1,model=4 --json-out $S
  F32="--arch deepseek-moe-16b --n-layers 4 --f32 --json-out $S"
  run 1 $PS $F32
  run 2 $PS $F32 --mesh data=1,model=2
  run 4 $PS $F32 --mesh data=1,model=4
fi
python - "$S" "$failed" <<'PY'
import json, os, sys
runs = [json.loads(line) for line in open(sys.argv[1])] \
    if os.path.exists(sys.argv[1]) else []
bad = int(sys.argv[2])
if bad:
    print(f"{bad} run(s) exited non-zero")
for r in runs:
    if r["mesh"] is None:
        continue
    one = [o for o in runs if o["mesh"] is None and all(
        o.get(k) == r.get(k) for k in ("arch", "n_layers", "dtype",
                                       "lane"))][-1]
    same = one["tokens"] == r["tokens"]
    print(f"{r['arch']} L={r['n_layers']} {r['dtype']} mesh={r['mesh']} "
          f"rules={r.get('rules', 'default')}: "
          f"greedy tokens {'equal to' if same else 'DIFFER from'} no mesh's")
    bad += not same and r["dtype"] == "float32"
sys.exit(1 if bad else 0)
PY
