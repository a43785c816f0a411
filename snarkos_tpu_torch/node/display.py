"""Terminal UI (display crate semantics): two tabs (Overview / Logs),
1-second tick, Esc/q to quit. Built on curses (stdlib) instead of
ratatui; consumes a log queue like the reference's mpsc channel.

The port of ``snarkos_tpu/node/display.py``; it reads the node's state only."""

from __future__ import annotations

import asyncio
import collections
import time


class Display:
    def __init__(self, node, log_queue=None):
        self.node = node
        self.log_lines: collections.deque = collections.deque(maxlen=500)
        self.log_queue = log_queue
        self.tab = 0
        self._running = False

    def push_log(self, line: str) -> None:
        self.log_lines.append(line)

    async def run(self) -> None:
        import curses

        def _main(stdscr):
            curses.curs_set(0)
            stdscr.nodelay(True)
            while self._running:
                ch = stdscr.getch()
                if ch in (27, ord("q")):
                    self._running = False
                    break
                if ch == ord("\t"):
                    self.tab = 1 - self.tab
                stdscr.erase()
                h, w = stdscr.getmaxyx()
                header = " snarkos-tpu — [Tab] switch  [q] quit "
                tabs = "  Overview  |  Logs  " if self.tab == 0 else "  Overview  |  Logs* "
                stdscr.addnstr(0, 0, header + tabs, w - 1, curses.A_REVERSE)
                if self.tab == 0:
                    self._draw_overview(stdscr, h, w)
                else:
                    for i, line in enumerate(list(self.log_lines)[-(h - 3):]):
                        stdscr.addnstr(2 + i, 1, line, w - 2)
                stdscr.refresh()
                time.sleep(1.0)

        self._running = True
        await asyncio.get_event_loop().run_in_executor(None, __import__("curses").wrapper, _main)

    def _draw_overview(self, stdscr, h, w):
        node = self.node
        rows = [
            ("address", getattr(node.account, "address", "?")),
            ("peers", str(node.router.number_of_connected_peers())),
        ]
        ledger = getattr(node, "ledger", None)
        if ledger is not None:
            rows += [
                ("height", str(ledger.latest_height)),
                ("round", str(ledger.latest_round)),
                ("proof target", str(ledger.latest_proof_target)),
            ]
        consensus = getattr(node, "consensus", None)
        if consensus is not None:
            rows += [
                ("bft round", str(consensus.storage.current_round())),
                ("mempool", str(len(consensus.primary.worker.ready))),
            ]
        for i, (k, v) in enumerate(rows):
            stdscr.addnstr(2 + i, 2, f"{k:>14}: {v}", w - 4)

    def stop(self):
        self._running = False
