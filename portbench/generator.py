"""The one traffic generator: it reads a traffic mix's parameters
(portbench/traffic/<name>.json) and drives the server with them, sending
by the mix's arrival process, portbench/arrivals/<arrival>.py, found by
its name. An arrival module gives `send_all(window) -> requests sent`: it
calls window.send(i) for request i = 0, 1, ... until window.end, with
`due=` the time it was due where the mix times requests from then (open
loop), and may wait on window.answered, released once per answer or
refusal (closed loop).

Request i is the pool's entry reqs.entry(i). The window is
[t0, t0 + seconds]; after it closes the generator sends nothing more and
waits for every request it sent, up to DRAIN_S (an answer that comes late
is late, not missing).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .spec import part
from .trace import WINDOW

DRAIN_S = 60.0


@dataclass
class Log:
    t0: float = 0.0
    t1: float = 0.0
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    unanswered: int = 0
    completed_in_window: int = 0
    latencies_ms: list = field(default_factory=list)
    lags_ms: list = field(default_factory=list)
    answers: dict = field(default_factory=dict)


class Window:
    """What an arrival process sees: the mix, the seed, the window's
    bounds, `send` and `answered`."""

    def __init__(self, server, reqs, traffic: dict, seed: int, log: Log,
                 seconds: float):
        self.server, self.reqs, self.log = server, reqs, log
        self.traffic, self.seed, self.seconds = traffic, seed, seconds
        self.t0 = log.t0
        self.end = log.t0 + seconds
        self.answered = threading.Semaphore(0)
        self.futures: dict = {}
        self.done_at: dict = {}
        self.due: dict = {}
        self._lock = threading.Lock()

    def _on_done(self, i):
        t = time.perf_counter()
        with self._lock:
            self.done_at[i] = t
        self.answered.release()

    def send(self, i: int, due: float | None = None) -> None:
        if due is not None:
            self.due[i] = due
            self.log.lags_ms.append((time.perf_counter() - due) * 1e3)
        e = self.reqs.entry(i)
        try:
            fut = self.server.submit(self.reqs.texts[e], **self.reqs.image(e))
        except Exception:                 # refused: counts as failed
            with self._lock:
                self.log.failed += 1
            self.answered.release()
            return
        self.futures[i] = fut
        fut.add_done_callback(lambda f, i=i: self._on_done(i))


def drive(server, reqs, traffic: dict, seed: int, seconds: float,
          t_start: float, span) -> Log:
    log = Log()
    arrival = part("arrivals", traffic["arrival"])
    with span(WINDOW):
        log.t0 = time.perf_counter()
        log.setup_s = log.t0 - t_start
        w = Window(server, reqs, traffic, seed, log, seconds)
        log.attempted = arrival.send_all(w)
        log.t1 = w.end
    deadline = time.perf_counter() + DRAIN_S
    for j, fut in w.futures.items():
        try:
            res = fut.result(timeout=max(0.0, deadline - time.perf_counter()))
        except TimeoutError:
            log.unanswered += 1
            continue
        except Exception:                 # the server's error for this one
            log.failed += 1
            continue
        log.answers[j] = res
    for j, t in w.done_at.items():
        if j not in log.answers:
            continue
        if log.t0 <= t <= log.t1:
            log.completed_in_window += 1
        if j in w.due:
            log.latencies_ms.append((t - w.due[j]) * 1e3)
    return log
