#!/bin/bash
# Restart-on-hang supervisor for the port's training runs on one NVIDIA GPU:
# the twin of scripts/run_supervised_train.sh, with a CUDA probe in place of
# the TPU's.
#
# Recovery recipe:
#   1. train with --watchdog_exit, so that a hung step dumps its stacks and
#      the process dies;
#   2. this loop probes the card until it answers, then restarts the
#      trainer, which resumes from its newest checkpoint.
#
# Usage: scripts/run_supervised_train_torch.sh python3 scripts/train_synthetic_torch.py --watchdog_exit [args...]
# Exits 0 when the wrapped command completes normally, 2 when the card never
# answers the probe, 1 when MAX_ATTEMPTS attempts all failed.
#
# Knobs (environment): MAX_ATTEMPTS (40), PROBE_TRIES (120), PROBE_SLEEP_S
# (60, the sleep between failed probes), SETTLE_S (90, the sleep after a
# probe before each attempt).
set -u
MAX_ATTEMPTS=${MAX_ATTEMPTS:-40}
PROBE_TRIES=${PROBE_TRIES:-120}
PROBE_SLEEP_S=${PROBE_SLEEP_S:-60}

if [ "$#" -eq 0 ]; then
  echo "usage: $0 python3 scripts/train_synthetic_torch.py --watchdog_exit [args...]" >&2
  exit 64
fi

probe_card() {
  for _ in $(seq 1 "$PROBE_TRIES"); do
    if timeout 180 python3 -c \
      "import torch; torch.zeros(8, device='cuda').sum().item(); print('card ok:', torch.cuda.get_device_name(0))"; then
      return 0
    fi
    echo "[supervisor] card probe failed; retrying in ${PROBE_SLEEP_S}s" >&2
    sleep "$PROBE_SLEEP_S"
  done
  return 1
}

for attempt in $(seq 1 "$MAX_ATTEMPTS"); do
  if ! probe_card; then
    echo "[supervisor] card never came back; giving up" >&2
    exit 2
  fi
  sleep "${SETTLE_S:-90}"
  echo "[supervisor] attempt $attempt: $*" >&2
  "$@"
  rc=$?
  if [ "$rc" -eq 0 ]; then
    echo "[supervisor] run completed cleanly" >&2
    exit 0
  fi
  echo "[supervisor] attempt $attempt exited rc=$rc; restarting from latest checkpoint in 30s" >&2
  sleep 30
done
echo "[supervisor] attempt budget exhausted" >&2
exit 1
