#!/usr/bin/env bash
# Local devnet of the PyTorch/CUDA port: N validators (+ optional clients)
# of snarkos_tpu_torch in tmux panes, devnet.sh's loop over the port's CLI.
# Every node runs on the card (--device cuda, the default); pass a device as
# the third argument to run elsewhere (cpu: the plain versions, slow).
#
# Usage: ./devnet_torch.sh [num_validators] [num_clients] [device]
set -euo pipefail

NUM_VALIDATORS="${1:-4}"
NUM_CLIENTS="${2:-0}"
DEVICE="${3:-cuda}"
SESSION="snarkos-tpu-torch-devnet"
ROOT="$(cd "$(dirname "$0")" && pwd)"

command -v tmux >/dev/null || { echo "tmux is required"; exit 1; }

tmux kill-session -t "$SESSION" 2>/dev/null || true
tmux new-session -d -s "$SESSION" -n devnet

for i in $(seq 0 $((NUM_VALIDATORS - 1))); do
  CMD="cd $ROOT && python -m snarkos_tpu_torch.node.cli start --validator --dev $i \
       --dev-num-validators $NUM_VALIDATORS --translucent --dev-txs --verbosity 1 \
       --device $DEVICE"
  if [ "$i" -eq 0 ]; then
    tmux send-keys -t "$SESSION" "$CMD" Enter
  else
    tmux split-window -t "$SESSION" -d
    tmux select-layout -t "$SESSION" tiled
    tmux send-keys -t "$SESSION.$i" "$CMD" Enter
  fi
done

for j in $(seq 0 $((NUM_CLIENTS - 1))); do
  idx=$((NUM_VALIDATORS + j))
  tmux split-window -t "$SESSION" -d
  tmux select-layout -t "$SESSION" tiled
  tmux send-keys -t "$SESSION.$idx" \
    "cd $ROOT && python -m snarkos_tpu_torch.node.cli start --client --dev $idx \
     --dev-num-validators $NUM_VALIDATORS --verbosity 1 --device $DEVICE" Enter
done

echo "devnet '$SESSION' started: $NUM_VALIDATORS validators, $NUM_CLIENTS clients on $DEVICE"
echo "attach with: tmux attach -t $SESSION"
