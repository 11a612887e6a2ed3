"""Closed loop: `outstanding` requests in flight; each answer sends the
next (callers that wait for their answer: an offline question set)."""

import time


def send_all(w) -> int:
    i = 0
    while True:
        if i >= w.traffic["outstanding"]:
            w.answered.acquire()
        if time.perf_counter() >= w.end:
            return i
        w.send(i)
        i += 1
