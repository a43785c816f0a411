"""chip_smoke.py's exit on a machine without a card, and the clean-up that
stops every process it started before it exits (the resource tracker of
multiprocessing, a child, an orphaned grandchild)."""

import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

_CLEANUP = r"""
import json, multiprocessing, subprocess, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke._adopt_orphans()
multiprocessing.get_context("spawn").Lock()  # starts the resource tracker
tracker = multiprocessing.resource_tracker._resource_tracker._pid
child = subprocess.Popen(["sleep", "60"], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
orphan = int(subprocess.run(["sh", "-c", "sleep 60 > /dev/null 2>&1 & echo $!"],
                            capture_output=True, text=True, check=True).stdout)
before = sorted(chip_smoke._children())
stopped = chip_smoke._stop_children(grace_s=2.0)
print(json.dumps({"pids": [tracker, child.pid, orphan], "before": before,
                  "stopped": stopped, "left": sorted(chip_smoke._children())}))
"""


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as fh:
            stat = fh.read()
    except OSError:
        return False
    return stat[stat.rfind(")") + 2] != "Z"


def test_stop_children_stops_tracker_child_and_orphan():
    out = subprocess.run([sys.executable, "-c", _CLEANUP, ROOT], capture_output=True,
                         text=True, timeout=60, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    tracker, child, orphan = res["pids"]
    # the orphan was adopted: all three were this process's children
    assert sorted(res["pids"]) == res["before"]
    assert res["left"] == []
    # the tracker ends through its pipe; the other two had to be signalled
    assert len(res["stopped"]) == 2 and all("sleep 60" in c for c in res["stopped"])
    assert not any(_alive(p) for p in (tracker, child, orphan))


def test_no_card_exits_nonzero_without_result():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "torch.cuda.is_available() is false" in out.stderr
