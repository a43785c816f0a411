"""A worker process of the puzzle's reference: reads one JSON task on
standard input ({"epoch_hash": hex, "address", "nonces", "log_degree"}),
writes the solutions of its nonces as one JSON list on standard output
(commitment and witness as hex, eval_y and solution_id as ints).

    python3 -m benchmark.reference.worker < task.json
"""

import json
import sys

from benchmark.reference import puzzle


def main() -> int:
    task = json.loads(sys.stdin.read())
    epoch_hash = bytes.fromhex(task["epoch_hash"])
    k = 1 << task["log_degree"]
    program = puzzle.EpochProgram(epoch_hash, k)
    out = []
    for nonce in task["nonces"]:
        s = puzzle.solution(program, epoch_hash, task["address"], nonce, k)
        out.append({"commitment": s["commitment"].hex(), "eval_y": s["eval_y"],
                    "witness": s["witness"].hex(), "solution_id": s["solution_id"]})
    sys.stdout.write(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
